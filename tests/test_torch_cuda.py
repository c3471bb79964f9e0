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
from gogp_torch.ops import fused_gp, linalg

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
def test_cholesky_inv_tile_non_positive_pivot_is_nan(cuda):
    A = _spd(B, cuda)
    A[10, 10] = -1.0
    L, _ = cb.cholesky_inv_tile(A)
    assert torch.isnan(L).any()


@pytest.mark.cuda
def test_tril_inv_tile_stack(cuda):
    b = B
    L = torch.linalg.cholesky(_spd(4 * b, cuda))
    tiles = torch.stack([L[k * b:(k + 1) * b, k * b:(k + 1) * b] for k in range(4)])
    torch.testing.assert_close(cb._tile_invs(L, b), cb.tril_inv_tile_plain(tiles), **TOL)
    torch.testing.assert_close(cb.tril_inv_tile(tiles[1].contiguous()), cb.tril_inv_tile_plain(tiles[1]), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1024, B), (512, B), (512, 64)])
def test_trsv_both_directions(cuda, n, b):
    """K3 at the driver's tile and, from the driver's factor, at b = 64: the
    solve takes any multiple of 32 that divides its 1024 threads."""
    L, _ = cb.blocked_cholesky_invs(_spd(n, cuda), B)
    tiles = L.view(n // b, b, n // b, b).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    invs = cb.tril_inv_tile_plain(tiles).contiguous()
    y = torch.as_tensor(np.random.default_rng(1).normal(size=n), dtype=torch.float32, device=cuda)
    torch.testing.assert_close(cb.trsv_lower(L, y, invs, b), cb.trsv_lower_plain(L, y), **TOL)
    torch.testing.assert_close(cb.trsv_lower_t(L, y, invs, b), cb.trsv_lower_t_plain(L, y), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 8192, 8320])
def test_trsv2d_both_directions(cuda, n):
    """K4 on the stepwise driver's factor, at a power of two and at n = 8320
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
def test_lml_core_takes_k4_from_8192(cuda):
    """At n = 8192 the front door's lml_core solves with K4 both ways (no
    K3), and its value and gradient agree with autograd of the plain path
    in f64; at "tensorfloat32" the rescue is engaged, and the result is
    finite and within 1e-2 (TF32 keeps about three decimal digits)."""
    n = 8192
    x = torch.linspace(0, 400, n, device=cuda, dtype=torch.float64)
    K64 = (-0.5 * (x[:, None] - x[None, :]) ** 2).exp_()
    K64.diagonal().add_(1.0)
    y64 = torch.sin(x / 3.0)
    K, y = K64.float().requires_grad_(True), y64.float()
    cb.reset_launch_counts()
    value = linalg.lml_core(K, y)
    value.backward()
    assert (cb.LAUNCHES["trsv2d_lower"], cb.LAUNCHES["trsv2d_lower_t"]) == (1, 1), cb.LAUNCHES
    assert cb.LAUNCHES["trsv_lower"] == cb.LAUNCHES["trsv_lower_t"] == 0
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
@pytest.mark.parametrize("n", [1024, 1792])
def test_fused_cholesky_invs_matches_plain(cuda, n):
    """K1 in one cooperative launch, and the driver's dispatch to it."""
    K = _spd(n, cuda)
    before = cb.LAUNCHES["fused_cholesky_invs"]
    L, invs = cb.fused_cholesky_invs(K)
    Lp, invp = cb.fused_cholesky_invs_plain(K)
    torch.testing.assert_close(L, Lp, **TOL)
    torch.testing.assert_close(invs, invp, **TOL)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    cb.blocked_cholesky_invs(K)
    assert cb.LAUNCHES["fused_cholesky_invs"] == before + 2


@pytest.mark.cuda
def test_fused_cholesky_invs_non_positive_pivot_is_nan(cuda):
    """NaN from the bad pivot on, and the grid does not hang: every block
    still reaches every grid-wide barrier."""
    K = _spd(1024, cuda)
    K[300, 300] = -1.0
    L, _ = cb.fused_cholesky_invs(K)
    torch.cuda.synchronize()
    assert torch.isnan(L).any() and torch.isfinite(L[:256, :256]).all()


@pytest.mark.cuda
def test_fused_cholesky_invs_raises_on_bad_input(cuda):
    with pytest.raises(TypeError):
        cb.fused_cholesky_invs(_spd(1024, cuda).double())
    with pytest.raises(ValueError):
        cb.fused_cholesky_invs(_spd(1024, cuda).T.contiguous()[:, :1000])  # not square
    with pytest.raises(ValueError):
        cb.fused_cholesky_invs(_spd(1024, cuda).T)  # not contiguous
    for n in (512, 2048, 1000):
        with pytest.raises(ValueError):
            cb.fused_cholesky_invs(_spd(n, cuda))  # outside [1024, 2047] or not a tile multiple
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
    # n = 1024: K1 factors (not K2), and no call asks for a gradient (no K3
    # transpose solve)
    launched = {k for k, n in cb.LAUNCHES.items() if n >= 1}
    assert launched == {"fused_cholesky_invs", "trsv_lower", "tril_inv_tile"}, cb.LAUNCHES
    with linalg.force_plain():
        want = run(torch.float64)
    for g, w in zip(got[:2], want[:2]):
        assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w))
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g.double(), w, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_lml_core_backward_matches_plain_autograd(cuda):
    """The GPML-5.9 backward on the kernel path (K1, K3 both ways) against
    autograd of torch.linalg in f64."""
    K64 = _spd(1024, cuda, dtype=torch.float64)
    y64 = torch.sin(torch.arange(1024, dtype=torch.float64, device=cuda) / 30.0)
    K, y = K64.float().requires_grad_(True), y64.float().requires_grad_(True)
    cb.reset_launch_counts()
    linalg.lml_core(K, y).backward()
    assert cb.LAUNCHES["fused_cholesky_invs"] == 1 and cb.LAUNCHES["trsv_lower_t"] == 1
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
    cannot take, the C side refuses K3, and the front door's lml_core stays
    on the blocked path with K4, as the JAX package does, where it used to
    take torch.linalg (about 12 GB per n x n f32 matrix)."""
    n = 54016
    assert not cb.trsv_fits(n, B)
    x = torch.linspace(0, 100, n, device=cuda)
    K = x[:, None] - x[None, :]
    K.square_().mul_(-0.5).exp_()
    K.diagonal().add_(1.0)
    y = torch.sin(x / 3.0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cb.trsv_lower(K, y, torch.zeros(n // B, B, B, device=cuda), B)
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
@pytest.mark.parametrize("n", [1, 44, 64, fused_gp.K7_MAX_N])
def test_fused_gp_linv_matches_plain(cuda, n):
    """K7 against its plain version (f32 cuSOLVER and a triangular solve):
    1e-3 of the largest entry, as for K1, since L^-1 of a covariance with
    noise variance 0.01 carries the f32 rounding of K's condition number."""
    K = _spd_batch(16, n, cuda)
    before = cb.LAUNCHES["fused_gp_linv"]
    got = fused_gp.fused_gp_linv(K)
    assert cb.LAUNCHES["fused_gp_linv"] == before + 1
    want = fused_gp.linv_plain(K)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel(got, want.double()) <= 1e-3
    assert (torch.triu(got, diagonal=1) == 0).all()
    # two runs give the same bits
    assert torch.equal(got, fused_gp.fused_gp_linv(K))


@pytest.mark.cuda
def test_fused_gp_linv_non_positive_pivot_is_nan(cuda):
    K = _spd_batch(3, 44, cuda)
    K[1, 20, 20] = -1.0
    got = fused_gp.fused_gp_linv(K)
    assert torch.isnan(got[1]).any()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


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
