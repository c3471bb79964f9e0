"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device.  The file
imports no JAX, so it runs where only PyTorch is installed; tests/conftest.py
imports JAX, so on such a machine run it as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances are for f32 on both sides: rtol and atol 1e-4 on SPD inputs of
norm O(n), where the kernels and cuBLAS/cuSOLVER sum in different orders.
Gradients of the kernel path (f32) are held against autograd of the plain
path in f64, at 1e-3 of the largest entry: f32 through a factorization and
its pullback.
"""

import numpy as np
import pytest
import torch

from gogp_torch import GP, rbf, uniform_noise
from gogp_torch.gp import core
from gogp_torch.models import params
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import _build, fused_gp, linalg

TOL = dict(rtol=1e-4, atol=1e-4)
B = cb.DEFAULT_BLOCK  # the one tile size K2 and K5 are built for


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd(n, device, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return torch.as_tensor(a @ a.T + n * np.eye(n), dtype=dtype, device=device)


def _rel(got, want):
    """Largest error relative to the largest entry of want, in f64."""
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_cholesky_inv_tile(cuda):
    A = _spd(B, cuda)
    before = cb.LAUNCHES["chol_inv_tile"]
    L, V = cb.cholesky_inv_tile(A)
    Lp, Vp = cb.cholesky_inv_tile_plain(A)
    torch.testing.assert_close(L, Lp, **TOL)
    torch.testing.assert_close(V, Vp, **TOL)
    assert cb.LAUNCHES["chol_inv_tile"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("row", [10, 0, 31, 32, 100, 127])
def test_cholesky_inv_tile_non_positive_pivot_is_nan(cuda, row):
    """A non-positive pivot at row ``row`` (the edges of the tile body's
    32-wide diagonal blocks among them): NaN on L's diagonal from there on,
    L finite above and left of it, and the launch returns; K6 alike."""
    A = _spd(B, cuda)
    A[row, row] = -1.0
    L, V = cb.cholesky_inv_tile(A)
    L6 = cb.cholesky_tile(A)
    torch.cuda.synchronize()
    for got in (L, L6):
        assert torch.isnan(got.diagonal()[row:]).all()
        assert torch.isfinite(got[:row, :row]).all()
    assert torch.isnan(V).any()


def _spd_cond(n, cond, device, seed=0):
    """An n x n SPD matrix Q diag(eig) Q^T with eigenvalues log-spaced from 1
    to ``cond`` and a random orthogonal Q, in f64 on the device."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    a = (q * np.logspace(0, np.log10(cond), n)) @ q.T
    return torch.as_tensor(0.5 * (a + a.T), dtype=torch.float64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [1e1, 1e3, 1e5])
def test_tile_body_across_conditioning(cuda, cond):
    """K2 and K6 (the tile body) on tiles of condition number 1e1 to 1e5:
    within 1e-5 of the largest entry of the f64 factor and inverse, or within
    four times cuSOLVER's own f32 error where the conditioning makes that
    larger; the same bits over five runs."""
    A64 = _spd_cond(B, cond, cuda)
    A = A64.float()
    L, V = cb.cholesky_inv_tile(A)
    L6 = cb.cholesky_tile(A)
    L64, V64 = cb.cholesky_inv_tile_plain(A64)
    Lp, Vp = cb.cholesky_inv_tile_plain(A)
    for got, plain, want in ((L, Lp, L64), (V, Vp, V64), (L6, Lp, L64)):
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= max(1e-5, 4 * _rel(plain, want)), (cond, _rel(got, want), _rel(plain, want))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L)) and torch.equal(torch.triu(V, 1), torch.zeros_like(V))
    for _ in range(5):
        L2, V2 = cb.cholesky_inv_tile(A)
        assert torch.equal(L2, L) and torch.equal(V2, V)
        assert torch.equal(cb.cholesky_tile(A), L6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k2", "k7_96", "k7_128", "k1_1536", "k1_4096"])
def test_tile_body_on_ill_conditioned_gp_covariances(cuda, case):
    """The ill phase's cases (chip_smoke.ill_case): K2, K7's blocked
    classes and K1 on rbf covariances with small jitter, column by column
    against f64, within chip_smoke.ILL_BOUNDS (10 times the JAX twin's f32
    errors) and, on the inverse of the kernel's own factor, within 3 times
    the plain f32 version's; K7's L^-1 has the bits of K2's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.ill_case(case, cuda)
    assert out["misses"] == [], out


@pytest.mark.cuda
@pytest.mark.parametrize("ld", [200, 131])
def test_tile_body_in_place_inside_a_larger_matrix(cuda, ld):
    """K2 as the stepwise driver calls it: the tile a view into a larger
    matrix (row stride ``ld``: float4 rows at 200, scalar at 131), factored
    in place, V written into another view; nothing outside the tile
    changes."""
    big = torch.randn(3 * B, ld, device=cuda)
    A = _spd(B, cuda, seed=4)
    col = 40 if ld % 4 == 0 else 3
    tile = big[B:2 * B, col:col + B]
    tile.copy_(A)
    before = big.clone()
    Vbig = torch.full((B + 5, ld), 7.0, device=cuda)
    cb._cholesky_inv_tile_into(tile, tile, Vbig[5:, 1:1 + B])
    Lp, Vp = cb.cholesky_inv_tile_plain(A)
    torch.testing.assert_close(tile, Lp, **TOL)
    torch.testing.assert_close(Vbig[5:, 1:1 + B], Vp, **TOL)
    mask = torch.ones_like(big, dtype=torch.bool)
    mask[B:2 * B, col:col + B] = False
    assert torch.equal(big[mask], before[mask])
    vmask = torch.ones_like(Vbig, dtype=torch.bool)
    vmask[5:, 1:1 + B] = False
    assert (Vbig[vmask] == 7.0).all()


@pytest.mark.cuda
def test_tril_inv_tile_stack(cuda):
    b = B
    L = torch.linalg.cholesky(_spd(4 * b, cuda))
    tiles = torch.stack([L[k * b:(k + 1) * b, k * b:(k + 1) * b] for k in range(4)])
    torch.testing.assert_close(cb._tile_invs(L, b), cb.tril_inv_tile_plain(tiles), **TOL)
    torch.testing.assert_close(cb.tril_inv_tile(tiles[1].contiguous()), cb.tril_inv_tile_plain(tiles[1]), **TOL)


def _tril_tiles(count, device, seed=0):
    """count Cholesky factors of (b, b) SPD matrices A A^T + b I, f32."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((count, B, B), generator=g, device=device)
    return torch.linalg.cholesky(a @ a.mT + B * torch.eye(B, device=device)).contiguous()


def _k5_split(tiles, split):
    out = torch.empty_like(tiles)
    _build.check(_build.library().gogp_tril_inv_tiles_split(
        tiles.data_ptr(), out.data_ptr(), tiles.shape[0], B, split, torch.cuda.current_stream().cuda_stream), "K5")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 12, 32, 64, 128, 200])
def test_tril_inv_tile_counts_and_splits(cuda, count):
    """K5 at each path's count of tiles, at 1 and past the card's 132 SMs,
    through the wrapper (one launch) and at each split of a tile over CTAs,
    within 1e-5 of the largest entry of its plain version (f32 on both
    sides; the card showed at most 7e-7)."""
    tiles = _tril_tiles(count, cuda, seed=count)
    want = cb.tril_inv_tile_plain(tiles)
    before = cb.LAUNCHES["tril_inv_tile"]
    got = cb.tril_inv_tile(tiles)
    assert cb.LAUNCHES["tril_inv_tile"] == before + 1
    assert _rel(got, want) <= 1e-5
    for split in (1, 2, 4):
        assert _rel(_k5_split(tiles, split), want) <= 1e-5, split


def _ill_conditioned_tiles(count, device):
    """chip_smoke.ill_conditioned_tiles: Cholesky factors of rbf covariances
    on b points of [0, 1] plus jitter 1e-7, length scales 0.05 to 1; their
    diagonals run from 1 down to 4e-4-2e-3."""
    x = np.linspace(0, 1, B)
    tiles = [np.linalg.cholesky(np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / ell**2) + 1e-7 * np.eye(B))
             for ell in np.logspace(np.log10(0.05), 0, count)]
    return torch.as_tensor(np.stack(tiles), dtype=torch.float32, device=device)


@pytest.mark.cuda
def test_tril_inv_tile_ill_conditioned_against_f64(cuda):
    """K5 on ill-conditioned tiles against the f64 inverse of the same f32
    tiles, column by column (a column's largest error over its largest
    entry): within 3e-3 (K5_ILL_RTOL in chip_smoke.py), 10 times what an
    H100 showed; forward substitution loses 2.7e-4 there."""
    tiles = _ill_conditioned_tiles(16, cuda)
    got, want = cb.tril_inv_tile(tiles).double(), cb.tril_inv_tile_plain(tiles.double())
    col = ((got - want).abs().amax(dim=-2) / want.abs().amax(dim=-2)).max()
    assert float(col) <= 3e-3


@pytest.mark.cuda
def test_tril_inv_tile_nan_and_same_bits(cuda):
    """A NaN in a tile gives NaN in its inverse and leaves the other tiles
    alone; two launches give the same bits."""
    tiles = _tril_tiles(32, cuda, seed=5)
    first = cb.tril_inv_tile(tiles)
    assert torch.equal(cb.tril_inv_tile(tiles), first)
    bad = tiles.clone()
    bad[3, 100, 20] = float("nan")
    out = cb.tril_inv_tile(bad)
    assert torch.isnan(out[3]).any()
    others = [t for t in range(32) if t != 3]
    assert torch.equal(out[others], first[others])


def _factor(n, device, seed=0):
    """The stepwise factorization's factor and tile inverses of an SPD matrix,
    and a right-hand side."""
    with cb.no_fused_whole():
        L, invs = cb.blocked_cholesky_invs(_spd(n, device, seed), B)
    y = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=n), dtype=torch.float32, device=device)
    return L, invs, y


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 512, 1024, 1536, 4096, 8064])
def test_trsv_both_directions(cuda, n):
    """K3, one CTA per block row, against its plain version within 1e-5 of
    the largest entry, one launch each way; the sums run in a fixed order, so
    five more runs give the same bits."""
    L, invs, y = _factor(n, cuda)
    before = dict(cb.LAUNCHES)
    z = cb.trsv_lower(L, y, invs, B)
    x = cb.trsv_lower_t(L, y, invs, B)
    assert cb.LAUNCHES["trsv_lower"] == before["trsv_lower"] + 1
    assert cb.LAUNCHES["trsv_lower_t"] == before["trsv_lower_t"] + 1
    assert _rel(z, cb.trsv_lower_plain(L.double(), y.double())) <= 1e-5
    assert _rel(x, cb.trsv_lower_t_plain(L.double(), y.double())) <= 1e-5
    for _ in range(5):
        assert torch.equal(cb.trsv_lower(L, y, invs, B), z)
        assert torch.equal(cb.trsv_lower_t(L, y, invs, B), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_trsv_back_to_back_launches_give_the_same_bits(cuda, n):
    """200 launches each way queued on one stream without a synchronize: the
    ticket and the ready flags are zeroed per launch, on the stream, so no
    launch sees another's."""
    L, invs, y = _factor(n, cuda, seed=3)
    for solve in (cb.trsv_lower, cb.trsv_lower_t):
        outs = [solve(L, y, invs, B) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_trsv_nan_in_gives_nan_out(cuda):
    """A NaN in L or in y flows into x, and the launch does not hang: every
    block row's flag is still published."""
    n = 1024
    L, invs, _ = _factor(n, cuda)
    y = torch.ones(n, device=cuda)
    Lnan = L.clone()
    Lnan[300, 200] = float("nan")  # block row 2, block column 1
    ynan = y.clone()
    ynan[5] = float("nan")
    for solve in (cb.trsv_lower, cb.trsv_lower_t):
        out = solve(Lnan, y, invs, B)
        torch.cuda.synchronize()
        assert torch.isnan(out).any()
        assert torch.isnan(solve(L, ynan, invs, B)).any()
    z = cb.trsv_lower(Lnan, y, invs, B)
    assert torch.isfinite(z[:256]).all() and torch.isnan(z[256:]).all()


@pytest.mark.cuda
def test_trsv_raises_on_bad_input(cuda):
    """K3 is built for the tile size alone, like K4."""
    L = torch.eye(256, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cb.trsv_lower(L, torch.ones(256, device=cuda), torch.eye(64, device=cuda).repeat(4, 1, 1), 64)
    with pytest.raises(ValueError):
        cb.trsv_lower(L, torch.ones(255, device=cuda), torch.eye(B, device=cuda).repeat(2, 1, 1), B)
    with pytest.raises(TypeError):
        cb.trsv_lower_t(L.double(), torch.ones(256, device=cuda), torch.eye(B, device=cuda).repeat(2, 1, 1), B)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 8192, 8320])
def test_trsv2d_both_directions(cuda, n):
    """K4 on the stepwise driver's factor, at powers of two and at n = 8320
    (65 tiles), against its plain version: one launch each way."""
    with cb.no_fused_whole():
        L, invs = cb.blocked_cholesky_invs(_spd(n, cuda), B)
    y = torch.as_tensor(np.random.default_rng(2).normal(size=n), dtype=torch.float32, device=cuda)
    before = dict(cb.LAUNCHES)
    z = cb.trsv2d_lower(L, y, invs, B)
    x = cb.trsv2d_lower_t(L, y, invs, B)
    assert cb.LAUNCHES["trsv2d_lower"] == before["trsv2d_lower"] + 1
    assert cb.LAUNCHES["trsv2d_lower_t"] == before["trsv2d_lower_t"] + 1
    torch.testing.assert_close(z, cb.trsv2d_lower_plain(L, y), **TOL)
    torch.testing.assert_close(x, cb.trsv2d_lower_t_plain(L, y), **TOL)
    # the sums run in a fixed order: the same inputs give the same bits
    assert torch.equal(cb.trsv2d_lower(L, y, invs, B), z)
    assert torch.equal(cb.trsv2d_lower_t(L, y, invs, B), x)


def _synthetic_factor(n, device):
    """chip_smoke.synthetic_factor: unit-scale diagonal in [1, 2), entries
    below it 0.5 N(0, 1) / sqrt(n), its tile inverses and a right-hand side."""
    g = torch.Generator(device=device).manual_seed(n)
    L = torch.randn((n, n), generator=g, device=device).mul_(0.5 / np.sqrt(n)).tril_()
    L.diagonal().copy_(1.0 + torch.rand(n, generator=g, device=device))
    tiles = L.view(n // B, B, n // B, B).diagonal(dim1=0, dim2=2).permute(2, 0, 1).contiguous()
    return L, cb.tril_inv_tile(tiles), torch.randn(n, generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 133 * B])
def test_trsv2d_large_and_uneven(cuda, n):
    """K4 and K3 at the large path's n and at 133 block rows (more than the
    132 SMs that the persistent grid has CTAs, and a work list that does not
    divide among them), on a synthetic factor, against the f64 solve within
    1e-5 of its largest entry; two launches give the same bits."""
    L, invs, y = _synthetic_factor(n, cuda)
    want_z = cb.trsv_lower_plain(L.double(), y.double())
    want_x = cb.trsv_lower_t_plain(L.double(), y.double())
    for fwd, bwd in ((cb.trsv2d_lower, cb.trsv2d_lower_t), (cb.trsv_lower, cb.trsv_lower_t)):
        z, x = fwd(L, y, invs, B), bwd(L, y, invs, B)
        assert _rel(z, want_z) <= 1e-5 and _rel(x, want_x) <= 1e-5, fwd.__name__
        assert torch.equal(fwd(L, y, invs, B), z) and torch.equal(bwd(L, y, invs, B), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_trsv2d_back_to_back_launches_give_the_same_bits(cuda, n):
    """200 launches each way queued on one stream without a synchronize: the
    counters are zeroed per launch, on the stream, so no launch sees
    another's."""
    L, invs, y = _factor(n, cuda, seed=3)
    for solve in (cb.trsv2d_lower, cb.trsv2d_lower_t):
        outs = [solve(L, y, invs, B) for _ in range(200)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_trsv2d_nan_in_gives_nan_out(cuda):
    """A NaN in L or in y flows into x, and the launch does not hang: every
    block's flag is still published."""
    n = 1024
    with cb.no_fused_whole():
        L, invs = cb.blocked_cholesky_invs(_spd(n, cuda), B)
    y = torch.ones(n, device=cuda)
    Lnan = L.clone()
    Lnan[300, 200] = float("nan")  # block row 2, block column 1
    for solve in (cb.trsv2d_lower, cb.trsv2d_lower_t):
        out = solve(Lnan, y, invs, B)
        torch.cuda.synchronize()
        assert torch.isnan(out).any()
        ynan = y.clone()
        ynan[5] = float("nan")
        assert torch.isnan(solve(L, ynan, invs, B)).any()
    z = cb.trsv2d_lower(Lnan, y, invs, B)
    assert torch.isfinite(z[:256]).all() and torch.isnan(z[256:]).all()


@pytest.mark.cuda
def test_trsv2d_raises_on_bad_input(cuda):
    L, invs = torch.eye(256, device=cuda), torch.eye(B, device=cuda).repeat(2, 1, 1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cb.trsv2d_lower(L, torch.ones(256, device=cuda), torch.eye(64, device=cuda).repeat(4, 1, 1), 64)
    with pytest.raises(ValueError):
        cb.trsv2d_lower(L, torch.ones(255, device=cuda), invs, B)
    with pytest.raises(TypeError):
        cb.trsv2d_lower_t(L.double(), torch.ones(256, device=cuda), invs, B)


@pytest.mark.cuda
def test_cholesky_tile(cuda):
    """K6 against its plain version, and NaN from a non-positive pivot."""
    A = _spd(B, cuda)
    before = cb.LAUNCHES["chol_tile"]
    torch.testing.assert_close(cb.cholesky_tile(A), cb.cholesky_tile_plain(A), **TOL)
    assert cb.LAUNCHES["chol_tile"] == before + 1
    assert torch.equal(torch.triu(cb.cholesky_tile(A), 1), torch.zeros_like(A))
    A[10, 10] = -1.0
    assert torch.isnan(cb.cholesky_tile(A)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("gate,solver", [(16384, "trsv_lower"), (None, "trsv2d_lower")])
def test_lml_core_at_8192_on_either_side_of_the_gate(cuda, monkeypatch, gate, solver):
    """At n = 8192 the front door's lml_core solves with K4 both ways (no K3)
    as the measured gate (1024) stands, and with K3 both ways with the gate
    raised above 8192; either way its value and gradient agree with autograd
    of the plain path in f64.  At "tensorfloat32" the rescue is engaged, and
    the result is finite and within 1e-2 (TF32 keeps about three decimal
    digits)."""
    if gate is not None:
        monkeypatch.setattr(cb, "_TRSV2D_MIN_N", gate)
    other = "trsv2d_lower" if solver == "trsv_lower" else "trsv_lower"
    n = 8192
    x = torch.linspace(0, 400, n, device=cuda, dtype=torch.float64)
    K64 = (-0.5 * (x[:, None] - x[None, :]) ** 2).exp_()
    K64.diagonal().add_(1.0)
    y64 = torch.sin(x / 3.0)
    K, y = K64.float().requires_grad_(True), y64.float()
    cb.reset_launch_counts()
    value = linalg.lml_core(K, y)
    value.backward()
    assert (cb.LAUNCHES[solver], cb.LAUNCHES[f"{solver}_t"]) == (1, 1), cb.LAUNCHES
    assert cb.LAUNCHES[other] == cb.LAUNCHES[f"{other}_t"] == 0
    K64.requires_grad_(True)
    with linalg.force_plain():
        want = linalg.lml_core(K64, y64)
    want.backward()
    assert abs(float(value.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert _rel(K.grad, K64.grad) <= 1e-3
    assert linalg._rescue_engaged(n, "tensorfloat32")
    tf32 = linalg.lml_core(K.detach(), y, precision="tensorfloat32")
    assert torch.isfinite(tf32) and abs(float(tf32) - float(want)) <= 1e-2 * abs(float(want))


@pytest.mark.cuda
def test_blocked_driver_matches_cusolver(cuda):
    """The stepwise driver (kept off K1 by no_fused_whole)."""
    K = _spd(1024, cuda)
    with cb.no_fused_whole():
        L, _ = cb.blocked_cholesky_invs(K, 128)
    torch.testing.assert_close(L, torch.linalg.cholesky(K), **TOL)


@pytest.mark.cuda
def test_fused_cholesky_invs_back_to_back_launches_give_the_same_bits(cuda):
    """200 launches of K1 queued on one stream without a synchronize give the
    same bits: whatever the launch keeps between its CTAs is reset per
    launch, on the stream."""
    K = _spd(1536, cuda, seed=5)
    outs = [cb.fused_cholesky_invs(K) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(L, outs[0][0]) and torch.equal(v, outs[0][1]) for L, v in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1152, 1536, 1792, 2048, 3072, 4096])
def test_fused_cholesky_invs_matches_plain(cuda, n):
    """K1 in one launch at the train path's sizes and up to its gate (4096,
    serving's n), the driver's dispatch to it, and the same bits over five
    more runs: every sum runs in a fixed order, no float atomics."""
    K = _spd(n, cuda)
    before = cb.LAUNCHES["fused_cholesky_invs"]
    L, invs = cb.fused_cholesky_invs(K)
    Lp, invp = cb.fused_cholesky_invs_plain(K)
    torch.testing.assert_close(L, Lp, **TOL)
    torch.testing.assert_close(invs, invp, **TOL)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    cb.blocked_cholesky_invs(K)
    assert cb.LAUNCHES["fused_cholesky_invs"] == before + 2
    for _ in range(5):
        L2, invs2 = cb.fused_cholesky_invs(K)
        assert torch.equal(L2, L) and torch.equal(invs2, invs)


@pytest.mark.cuda
@pytest.mark.parametrize("row", [300, 7, 5 * 128 + 7, 1536 - 128 + 7])
def test_fused_cholesky_invs_non_positive_pivot_is_nan(cuda, row):
    """A non-positive pivot in block column 2, 0, 5 or the last of n = 1536:
    NaN on L's diagonal from there on, L finite before that block column,
    and the launch does not hang: every work item still publishes its
    counter."""
    K = _spd(1536, cuda)
    K[row, row] = -1.0
    L, _ = cb.fused_cholesky_invs(K)
    torch.cuda.synchronize()
    assert torch.isnan(L.diagonal()[row:]).all()
    c0 = row // B * B
    assert torch.isfinite(L[:c0, :c0]).all()


@pytest.mark.cuda
def test_fused_cholesky_invs_raises_on_bad_input(cuda):
    with pytest.raises(TypeError):
        cb.fused_cholesky_invs(_spd(1024, cuda).double())
    with pytest.raises(ValueError):
        cb.fused_cholesky_invs(_spd(1024, cuda).T.contiguous()[:, :1000])  # not square
    with pytest.raises(ValueError):
        cb.fused_cholesky_invs(_spd(1024, cuda).T)  # not contiguous
    for n in (512, cb._FUSED_MAX_N + 128, 1000):
        with pytest.raises(ValueError):
            cb.fused_cholesky_invs(_spd(n, cuda))  # outside [1024, 4096] or not a tile multiple
    with pytest.raises(ValueError):
        cb.fused_cholesky_invs(_spd(1024, cuda), 64)  # built for b = 128 only


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_input(cuda):
    with pytest.raises(TypeError):
        cb.cholesky_inv_tile(torch.eye(B, dtype=torch.float64, device=cuda))
    with pytest.raises(RuntimeError, match="invalid argument"):
        cb.cholesky_inv_tile(torch.eye(64, device=cuda))  # K2 is built for B only
    with pytest.raises(RuntimeError, match="invalid argument"):
        cb.tril_inv_tile(torch.eye(256, device=cuda))  # so is K5
    with pytest.raises(ValueError):
        cb.tril_inv_tile(torch.eye(B, device=cuda).T)  # not contiguous
    with pytest.raises(ValueError):
        cb.trsv_lower(torch.eye(256, device=cuda), torch.ones(256, device=cuda),
                      torch.ones(2, 64, 64, device=cuda), B)  # invs of the wrong shape


@pytest.mark.cuda
def test_slice_kernel_path_matches_f64_plain_path(cuda):
    """absorb / lml / predict at n = 1024 through the front door: kernels in
    f32 against the plain path in f64, and every kernel launched."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 25, (1024, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=1024)
    z = np.linspace(0, 25, 64)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def run(dtype):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)  # noqa: E731
        ts, tn = t([1.0, 1.0]), t([1.0])
        post = core.absorb(gp, ts, tn, t(x), t(y))
        return (core.lml_from_posterior(post), core.lml(gp, ts, tn, t(x), t(y)),
                *core.predict_from_posterior(gp, post, t(z)))

    cb.reset_launch_counts()
    got = run(torch.float32)
    # n = 1024: K1 factors (not K2), and no call asks for a gradient (no
    # transpose solve)
    launched = {k for k, n in cb.LAUNCHES.items() if n >= 1}
    assert launched == {"fused_cholesky_invs", "trsv2d_lower", "tril_inv_tile"}, cb.LAUNCHES
    with linalg.force_plain():
        want = run(torch.float64)
    for g, w in zip(got[:2], want[:2]):
        assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w))
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g.double(), w, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_lml_core_backward_matches_plain_autograd(cuda):
    """The GPML-5.9 backward on the kernel path (K1, and K4 both ways, as the
    measured K3/K4 gate gives n = 1024) against autograd of torch.linalg in
    f64."""
    K64 = _spd(1024, cuda, dtype=torch.float64)
    y64 = torch.sin(torch.arange(1024, dtype=torch.float64, device=cuda) / 30.0)
    K, y = K64.float().requires_grad_(True), y64.float().requires_grad_(True)
    cb.reset_launch_counts()
    linalg.lml_core(K, y).backward()
    assert cb.LAUNCHES["fused_cholesky_invs"] == 1 and cb.LAUNCHES["trsv2d_lower_t"] == 1
    Kr, yr = K64.clone().requires_grad_(True), y64.clone().requires_grad_(True)
    with linalg.force_plain():
        linalg.lml_core(Kr, yr).backward()
    assert _rel(K.grad, Kr.grad) <= 1e-3
    assert _rel(y.grad, yr.grad) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["lml_from_posterior", "predict_mean", "predict_std", "gp_observe"])
def test_blocked_path_backward_matches_plain_autograd(cuda, output):
    """The gradient with respect to log-theta through each output of the
    kernel path (the Cholesky, TRSM and GPML-5.9 pullbacks around K1, K3 and
    K5) against autograd of the plain path in f64."""
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def grad(dtype):
        x = torch.linspace(0, 25, 1024, dtype=dtype, device=cuda)[:, None]
        y = torch.sin(x[:, 0] / 3.0)
        z = torch.linspace(0, 25, 64, dtype=dtype, device=cuda)
        v = torch.zeros(gp.n_theta, dtype=dtype, device=cuda, requires_grad=True)
        post = params.gp_posterior(gp, v, x=x, y=y)
        value = {
            "lml_from_posterior": lambda: core.lml_from_posterior(post),
            "predict_mean": lambda: core.predict_from_posterior(gp, post, z)[0].sum(),
            "predict_std": lambda: core.predict_from_posterior(gp, post, z)[1].sum(),
            "gp_observe": lambda: params.gp_observe(gp, v, x=x, y=y),
        }[output]()
        (g,) = torch.autograd.grad(value, v)
        return g

    cb.reset_launch_counts()
    got = grad(torch.float32)
    assert cb.LAUNCHES["fused_cholesky_invs"] >= 1
    with linalg.force_plain():
        want = grad(torch.float64)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-3, (got, want)


@pytest.mark.cuda
def test_lml_core_beyond_k3_limit_takes_torch_linalg(cuda):
    """At n = 54016, the first multiple of the tile that K3's shared memory
    could not take while it kept the solution there, the front door's
    lml_core stays on the blocked path and solves with K4, past the measured
    K3/K4 gate; both keep x in global memory (about 12 GB per n x n f32
    matrix)."""
    n = 54016
    x = torch.linspace(0, 100, n, device=cuda)
    K = x[:, None] - x[None, :]
    K.square_().mul_(-0.5).exp_()
    K.diagonal().add_(1.0)
    y = torch.sin(x / 3.0)
    cb.reset_launch_counts()
    got = float(linalg.lml_core(K, y))
    assert cb.LAUNCHES["trsv2d_lower"] == 1 and cb.LAUNCHES["trsv_lower"] == 0, cb.LAUNCHES
    with linalg.force_plain():
        want = float(linalg.lml_core(K, y))
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want)


def _spd_batch(batch, n, device, seed=0):
    """A batch of SPD matrices shaped like the hyperpriors covariances:
    unit-scale kernels plus a small diagonal."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, (batch, n, 1)), axis=1)
    ell = rng.uniform(0.5, 2.0, (batch, 1, 1))
    K = np.exp(-0.5 * ((x - x.transpose(0, 2, 1)) / ell) ** 2) + 0.01 * np.eye(n)
    return torch.as_tensor(K, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 64, 257])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 44, 63, 64, 65, 96, 97, 127, 128])
def test_fused_gp_linv_matches_plain(cuda, n, batch):
    """K7 against its plain version in f64 at the edges of its size classes
    (32, 48 and 64 columns in a warp's registers, 96 and 128 in a CTA's
    shared memory) and at batches that leave the last CTA ragged: 5e-4 of the
    largest entry, since L^-1 of a covariance with noise variance 0.01
    carries the f32 rounding of K's condition number."""
    K = _spd_batch(batch, n, cuda)
    before = cb.LAUNCHES["fused_gp_linv"]
    got = fused_gp.fused_gp_linv(K)
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1
    want = fused_gp.linv_plain(K.double())
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 5e-4
    assert (torch.triu(got, diagonal=1) == 0).all()
    # two runs give the same bits
    assert torch.equal(got, fused_gp.fused_gp_linv(K))
    # an unaligned batch (a view one matrix in) takes the scalar loads
    if batch > 1 and n % 2 == 1:
        assert torch.equal(fused_gp.fused_gp_linv(K[1:]), got[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 44, 64, 100, 128])
def test_fused_gp_linv_non_positive_pivot_is_nan(cuda, n):
    """A matrix that is not positive definite, or holds a NaN, gives NaN
    throughout its own L^-1, as the plain version does, and leaves the other
    matrices of the batch alone."""
    K = _spd_batch(5, n, cuda)
    K[1, n // 2, n // 2] = -1.0
    K[3, 2, 1] = K[3, 1, 2] = float("nan")
    got = fused_gp.fused_gp_linv(K)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert torch.isnan(got[i]).all()
    want = fused_gp.linv_plain(K.double())
    for i in (0, 2, 4):
        assert torch.isfinite(got[i]).all() and _rel(got[i], want[i]) <= 5e-4


@pytest.mark.cuda
def test_fused_gp_linv_raises_on_bad_input(cuda):
    with pytest.raises(TypeError):
        fused_gp.fused_gp_linv(_spd_batch(2, 8, cuda).double())
    with pytest.raises(ValueError):
        fused_gp.fused_gp_linv(_spd_batch(1, fused_gp.K7_MAX_N + 1, cuda))


@pytest.mark.cuda
def test_fused_value_and_grad_route_matches_f64_plain(cuda):
    """The K7 route in f32 against the reference route in f64 on the card:
    one K7 launch per call, value 1e-5 relative, gradient 1e-3 of its
    largest entry."""
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 10, 40))
    y = np.sin(x) + 0.1 * rng.normal(size=40)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    V = 0.2 * rng.normal(size=(64, gp.n_theta))

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    vg = fused_gp.make_fused_value_and_grad(gp, t(x, torch.float32), t(y, torch.float32))
    ref = fused_gp.make_reference_value_and_grad(gp, t(x, torch.float64), t(y, torch.float64))
    before = cb.LAUNCHES["fused_gp_linv"]
    val, grad = vg(t(V, torch.float32))
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1
    want_val, want_grad = ref(t(V, torch.float64))
    assert float(((val.double() - want_val).abs() / want_val.abs()).max()) <= 1e-5
    assert _rel(grad, want_grad) <= 1e-3
    with linalg.force_plain():
        vg(t(V, torch.float32))
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1


def _prefix_batch(study, x, y, device, dtype):
    """The rolling forecast's fitted prefixes of a series of n points: one
    mask a row for ends 1..n-1, and starting log-thetas 0.1 N(0, 1)."""
    n = x.shape[0]
    masks = (np.arange(n)[None, :] < np.arange(1, n)[:, None]).astype(float)
    V = 0.1 * np.random.default_rng(3).normal(size=(n - 1, study.gp.n_theta))
    priors = study.make_priors(x, y) if study.make_priors else None

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    tm = t(masks)
    return (t(x), t(y), tm, None if priors is None else (lambda Vt: priors(Vt, tm))), t(V)


@pytest.mark.cuda
@pytest.mark.parametrize("study_name", ["barebones", "hyperpriors"])
def test_per_row_mask_k7_route_matches_f64_reference(cuda, study_name):
    """The evaluate path's batch on the K7 route in f32, one mask a prefix:
    barebones at n = 128 (bench.py's generator, 127 x 128 x 128, the widest
    K7 takes) and hyperpriors' 44 points (43 x 44 x 44), against the
    reference route in f64: value 1e-5 relative (to at least 1: a short
    prefix's LML can be near 0), gradient 1e-3 of its largest entry; one K7
    launch a call, none under force_plain."""
    from gogp_torch.tutorial import barebones, hyperpriors
    from gogp_torch.tutorial import io as tio

    if study_name == "barebones":
        study = barebones.make_study()
        rng = np.random.default_rng(0)
        x = np.sort(rng.uniform(0, 100, (128, 1)), axis=0)
        y = tio.normalize(np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=128))[0]
    else:
        study = hyperpriors.make_study()
        x, y = tio.load_csv(hyperpriors.selfcheck_data())
        y = tio.normalize(y)[0]
    args32, V32 = _prefix_batch(study, x, y, cuda, torch.float32)
    args64, V64 = _prefix_batch(study, x, y, cuda, torch.float64)
    vg = fused_gp.make_fused_value_and_grad(study.gp, *args32)
    ref = fused_gp.make_reference_value_and_grad(study.gp, *args64)
    before = cb.LAUNCHES["fused_gp_linv"]
    val, grad = vg(V32)
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1
    want_val, want_grad = ref(V64)
    assert float(((val.double() - want_val).abs() / want_val.abs().clamp(min=1.0)).max()) <= 1e-5
    assert _rel(grad, want_grad) <= 1e-3
    with linalg.force_plain():
        vg(V32)
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1


def _sparse_problem(n, m, device, dtype):
    """The sparse phase's problem (chip_smoke.py) at n points: inputs on [0,
    1000], Z = m of them about 1 apart at lengthscale 1."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1000.0, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x, y = (torch.as_tensor(a, dtype=dtype, device=device) for a in (x, y))
    return gp, x, y, x[:: n // m][:m].contiguous()


@pytest.mark.cuda
def test_sgpr_kernel_path_matches_f64_plain(cuda):
    """SGPR's value and gradient over [log theta | Z] at m = 1024 on the
    kernel path (K1 for Kuu and B, K5 in each TRSM and pullback) against
    the plain path in f64."""
    from gogp_torch.gp import sparse
    from gogp_torch.models import masked_value_and_grad

    out = {}
    for dtype in (torch.float32, torch.float64):
        gp, x, y, z = _sparse_problem(8192, 1024, cuda, dtype)
        v0 = sparse.join_sparse_params(gp, torch.zeros(gp.n_theta, dtype=dtype, device=cuda), z)
        vg = masked_value_and_grad(sparse.make_sgpr_logp(gp, x, y, 1024))
        if dtype == torch.float32:
            cb.reset_launch_counts()
            out[dtype] = vg(v0)
            torch.cuda.synchronize()
            assert (cb.LAUNCHES["fused_cholesky_invs"], cb.LAUNCHES["tril_inv_tile"]) == (2, 8)
        else:
            with linalg.force_plain():
                out[dtype] = vg(v0)
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert abs(float(v32) - float(v64)) <= 1e-4 * abs(float(v64))
    assert _rel(g32, g64) <= 1e-3


@pytest.mark.cuda
def test_natgrad_step_kernel_path_matches_f64_plain(cuda):
    """One natural-gradient step at m = 1024 (K1 five times, K5 seven)
    against the plain path in f64, and its gamma = 1 anchor: the step's
    ELBO equals the closed-form optimum's."""
    from gogp_torch.gp import sparse

    out = {}
    for dtype in (torch.float32, torch.float64):
        gp, x, y, z = _sparse_problem(8192, 1024, cuda, dtype)
        ones = torch.ones(gp.n_theta_simil, dtype=dtype, device=cuda), torch.ones(1, dtype=dtype, device=cuda)
        if dtype == torch.float32:
            cb.reset_launch_counts()
            out[dtype] = sparse.svgp_natgrad_step(gp, *ones, sparse.svgp_init(gp, z), x, y, 1.0)
            torch.cuda.synchronize()
            assert (cb.LAUNCHES["fused_cholesky_invs"], cb.LAUNCHES["tril_inv_tile"]) == (5, 7)
            e_step = float(sparse.svgp_elbo(gp, *ones, out[dtype], x, y))
            e_opt = float(sparse.svgp_elbo(gp, *ones, sparse.svgp_optimal_state(gp, *ones, x, y, z), x, y))
            assert abs(e_step - e_opt) <= 1e-5 * abs(e_opt)
        else:
            with linalg.force_plain():
                out[dtype] = sparse.svgp_natgrad_step(gp, *ones, sparse.svgp_init(gp, z), x, y, 1.0)
    for got, want in zip(out[torch.float32][1:], out[torch.float64][1:]):
        assert _rel(got, want) <= 1e-3


# -- the batched route: K2 over a stack, K4 over a batch, the vmapped LML ----------


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_cholesky_inv_tile_over_a_stack_in_one_launch(cuda, batch):
    """K2 on the diagonal tiles of a (B, n, n) stack, in place, one launch,
    each tile as the single-tile launch gives it."""
    K = torch.stack([_spd(2 * B, cuda, seed=s) for s in range(batch)])
    A = K.clone()
    V = torch.empty(batch, B, B, device=cuda)
    before = cb.LAUNCHES["chol_inv_tile"]
    cb._cholesky_inv_tile_into(A[:, B:, B:], A[:, B:, B:], V)
    assert cb.LAUNCHES["chol_inv_tile"] == before + 1
    for i in range(batch):
        L1, V1 = cb.cholesky_inv_tile(K[i, B:, B:].contiguous())
        assert torch.equal(A[i, B:, B:], L1) and torch.equal(V[i], V1)
    assert torch.equal(A[:, :B], K[:, :B])  # the rest of the stack untouched


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(2, 1024), (8, 1024), (3, 4096)])
def test_trsv2d_over_a_batch_matches_each_solve(cuda, batch, n):
    """K4 with a batch axis: one launch each way, each element bit for bit
    the single solve, and both against solve_triangular."""
    K = torch.stack([_spd(n, cuda, seed=s) for s in range(batch)])
    L = torch.linalg.cholesky(K).contiguous()
    invs = cb._tile_invs(L, B)
    y = torch.randn(batch, n, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    before = dict(cb.LAUNCHES)
    z = cb.trsv2d_lower(L, y, invs, B)
    x = cb.trsv2d_lower_t(L, z, invs, B)
    assert cb.LAUNCHES["trsv2d_lower"] == before["trsv2d_lower"] + 1
    assert cb.LAUNCHES["trsv2d_lower_t"] == before["trsv2d_lower_t"] + 1
    for i in range(batch):
        assert torch.equal(z[i], cb.trsv2d_lower(L[i], y[i], invs[i], B))
        assert torch.equal(x[i], cb.trsv2d_lower_t(L[i], z[i], invs[i], B))
    torch.testing.assert_close(z, cb.trsv_lower_plain(L, y), **TOL)
    torch.testing.assert_close(x, cb.trsv_lower_t_plain(L, z), **TOL)


@pytest.mark.cuda
def test_vmapped_lml_takes_the_batched_route(cuda):
    """``torch.func.vmap`` of the front door's LML at n = 1024 on 8
    covariances: K5 once and K4 once each way for the whole batch, no K1 or
    K2; value and gradient against autograd of the plain path in f64."""
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x = torch.linspace(0, 100, 1024, device=cuda)[:, None]
    y = torch.sin(x[:, 0] / 3.0)
    V = (0.05 * torch.randn(8, 3, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
         + torch.tensor([0.8, 0.0, -2.0], device=cuda)).requires_grad_(True)
    cb.reset_launch_counts()
    v = torch.func.vmap(lambda t: params.gp_observe(gp, t, x=x, y=y))(V)
    (g,) = torch.autograd.grad(v.sum(), V)
    assert {k: n for k, n in cb.LAUNCHES.items() if n} == {"tril_inv_tile": 1, "trsv2d_lower": 1,
                                                             "trsv2d_lower_t": 1}
    V64 = V.detach().double().requires_grad_(True)
    with linalg.force_plain():
        v64 = torch.stack([params.gp_observe(gp, t, x=x.double(), y=y.double()) for t in V64])
        (g64,) = torch.autograd.grad(v64.sum(), V64)
    assert _rel(v.detach(), v64.detach()) < 1e-4
    assert _rel(g, g64) < 1e-2


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["chol_inv_tile", "tril_inv_tile", "fused_gp_linv"])
def test_kernels_on_the_second_card(second_card, key):
    """K2, K5 and K7 on tensors of cuda:1 while cuda:0 is current: the
    wrapper launches on the tensor's card (``cb._launch`` switches to it),
    once, and its result lies there and matches the plain version computed
    on the same card (K2 at TOL, K5 within 1e-5 and K7 within 5e-4 of the
    largest entry, their own tests' bounds); cuda:0 stays current."""
    dev = second_card
    with torch.cuda.device(0):
        before = cb.LAUNCHES[key]
        if key == "chol_inv_tile":
            A = _spd(B, dev)
            got, want = cb.cholesky_inv_tile(A), cb.cholesky_inv_tile_plain(A)
        elif key == "tril_inv_tile":
            tiles = _tril_tiles(12, dev)
            got, want = (cb.tril_inv_tile(tiles),), (cb.tril_inv_tile_plain(tiles),)
        else:
            K = _spd_batch(16, 44, dev)
            got, want = (fused_gp.fused_gp_linv(K),), (fused_gp.linv_plain(K.double()),)
        assert torch.cuda.current_device() == 0
        assert cb.LAUNCHES[key] == before + 1
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert g.device == dev and torch.isfinite(g).all()
        if key == "chol_inv_tile":
            torch.testing.assert_close(g, w, **TOL)
        else:
            assert _rel(g, w) <= (1e-5 if key == "tril_inv_tile" else 5e-4)
