"""The port's blocked linear algebra (gogp_torch.ops) against the JAX Pallas
kernels, run in interpret mode on the CPU.

On the CPU each kernel wrapper takes its plain PyTorch version, so these tests
hold the plain versions and the blocked drivers around them against the
Pallas kernels K1 (whole-matrix Cholesky + tile inverses), K2 (tile
Cholesky + inverse), K3 (streaming TRSV, both directions) and K5 (tile
inverse).  Everything runs in float64.  Tolerance:
atol 1e-10 on factors, inverses and solves of SPD matrices with entries of
order n (f64, the same factorization, a different summation order).

The CUDA kernels themselves are tested on the card by test_torch_cuda.py.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.ops import linalg as jlinalg
from gogp_torch.ops import _build
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

ATOL = 1e-10
REPO = pathlib.Path(__file__).resolve().parents[1]


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def T(a):
    return torch.tensor(np.asarray(a))


# -- each plain kernel version against its Pallas kernel ---------------------


def test_cholesky_inv_tile_matches_pallas():
    A = spd(64, seed=1)
    with cp.force_interpret():
        Lj, Vj = cp.pallas_cholesky_inv_tile(jnp.asarray(A))
    Lt, Vt = cb.cholesky_inv_tile(T(A))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=ATOL)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=ATOL)


def test_tril_inv_tile_matches_pallas():
    L = np.linalg.cholesky(spd(64, seed=2))
    with cp.force_interpret():
        want = cp.pallas_tril_inv_tile(jnp.asarray(L))
    np.testing.assert_allclose(cb.tril_inv_tile(T(L)).numpy(), np.asarray(want), atol=ATOL)


def test_tile_invs_stack_matches_pallas():
    """_tile_invs: the (nb, b, b) stack in one call, as JAX vmaps K5."""
    L = np.linalg.cholesky(spd(256, seed=3))
    with cp.force_interpret():
        want = cp._tile_invs(jnp.asarray(L), 64)
    got = cb._tile_invs(T(L), 64)
    assert got.shape == (4, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def tril_inv_blocked(L, block=32):
    """K5's algorithm (gogp_torch/csrc/tril_inv_tile.cu) in plain PyTorch, for
    these tests only: blocked forward substitution, block row by block row,
    V_pq = inv(L_pp) (delta_pq I - sum_{k=q}^{p-1} L_pk V_kq), the sum taken
    product by product in k order, each solve row by row with reciprocal
    pivots, x_i = (rhs_i - L[i, :i] x[:i]) * (1 / L_ii)."""
    nb = L.shape[-1] // block
    V = torch.zeros_like(L)
    eye = torch.eye(block, dtype=L.dtype)

    def blk(i):
        return slice(i * block, (i + 1) * block)

    for p in range(nb):
        Lpp = L[blk(p), blk(p)]
        dinv = 1 / torch.diagonal(Lpp)
        for q in range(p + 1):
            rhs = eye if q == p else -sum(L[blk(p), blk(k)] @ V[blk(k), blk(q)] for k in range(q, p))
            X = torch.zeros_like(rhs)
            for i in range(block):
                X[i] = (rhs[i] - Lpp[i, :i] @ X[:i]) * dinv[i]
            V[blk(p), blk(q)] = X
    return V


def gp_tile(b=128, ell=0.05, jitter=1e-7):
    """An ill-conditioned factor tile: the Cholesky factor of an rbf
    covariance on b points of [0, 1] (length scale ell) plus jitter; its
    diagonal runs from 1 down to 2.2e-3."""
    x = np.linspace(0, 1, b)
    return np.linalg.cholesky(np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / ell**2) + jitter * np.eye(b))


def col_rel(got, want):
    """The largest error in a column over that column's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want).max(0) / np.abs(want).max(0)).max())


# K5's rendering against the exact inverse of the same rounded tile (f64),
# column by column, about 10 times what it showed on the CPU: f64 1.4e-16
# (random tile) and 3.8e-13 (GP tile), f32 5.8e-8 and 1.3e-4.  Forward
# substitution (the plain version, the Pallas kernel) showed 4e-17-7.5e-8
# and 3.5e-13-8.3e-5; the product-of-inverses recursion 4e-3 to 3e-2 on GP
# tiles in f32 (PERF.md).
K5_COL_RTOL = {("f64", "random"): 2e-15, ("f64", "gp"): 4e-12, ("f32", "random"): 6e-7, ("f32", "gp"): 1.3e-3}


@pytest.mark.parametrize("tile", ["random", "gp"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_tril_inv_blocked_rendering_matches_pallas_and_plain(dtype, tile):
    """The blocked forward substitution K5 runs on the card, rendered in plain
    PyTorch at the kernel's tile (b = 128, 32-blocks), on a random factor
    tile and on an ill-conditioned GP tile (gp_tile), in f32 and f64: within
    K5_COL_RTOL of the exact inverse, as the Pallas kernel in interpret mode
    and tril_inv_tile_plain are."""
    np_dtype = np.float32 if dtype == "f32" else np.float64
    L = (np.linalg.cholesky(spd(128, seed=6)) if tile == "random" else gp_tile()).astype(np_dtype)
    exact = np.linalg.inv(L.astype(np.float64))
    with cp.force_interpret():
        pallas = np.asarray(cp.pallas_tril_inv_tile(jnp.asarray(L)))
    got = tril_inv_blocked(T(L)).numpy()
    bound = K5_COL_RTOL[dtype, tile]
    assert got.dtype == np_dtype
    assert col_rel(got, exact) <= bound
    assert col_rel(pallas, exact) <= bound
    assert col_rel(cb.tril_inv_tile_plain(T(L)).numpy(), exact) <= bound


@pytest.fixture(scope="module")
def factor256():
    """(K, y, L, invs) at n = 256, b = 64 from the JAX stepwise driver."""
    K = spd(256, seed=4)
    y = np.random.default_rng(5).normal(size=256)
    with cp.force_interpret(), cp.no_fused_whole():
        L, invs = cp.blocked_cholesky_invs(jnp.asarray(K), 64)
    return K, y, np.asarray(L), np.asarray(invs)


def test_trsv_lower_matches_pallas(factor256):
    _, y, L, invs = factor256
    with cp.force_interpret():
        want = cp.pallas_trsv_lower(jnp.asarray(L), jnp.asarray(y), jnp.asarray(invs), 64)
    got = cb.trsv_lower(T(L), T(y), T(invs), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_trsv_lower_t_matches_pallas(factor256):
    _, y, L, invs = factor256
    with cp.force_interpret():
        want = cp.pallas_trsv_lower_t(jnp.asarray(L), jnp.asarray(y), jnp.asarray(invs), 64)
    got = cb.trsv_lower_t(T(L), T(y), T(invs), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_blocked_driver_matches_pallas(factor256):
    """The stepwise driver at n = 256, b = 64 (K2 per diagonal tile); both
    drivers under no_fused_whole(), which keeps them off K1."""
    K, _, L, invs = factor256
    with cb.no_fused_whole():
        Lt, invt = cb.blocked_cholesky_invs(T(K), 64)
    np.testing.assert_allclose(Lt.numpy(), L, atol=ATOL)
    np.testing.assert_allclose(invt.numpy(), invs, atol=ATOL)


def test_blocked_trsm_lower_matches_pallas(factor256):
    _, _, L, _ = factor256
    B = np.random.default_rng(6).normal(size=(256, 9))
    with cp.force_interpret():
        want = cp.blocked_trsm_lower(jnp.asarray(L), jnp.asarray(B), 64)
    got = cb.blocked_trsm_lower(T(L), T(B), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    got1 = cb.blocked_trsm_lower(T(L), T(B[:, 0]), 64)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want)[:, 0], atol=ATOL)


def test_lml_core_forward_matches_pallas(factor256):
    """The lml_core forward, directly and through the front door."""
    K, y, _, _ = factor256
    with cp.force_interpret(), cp.no_fused_whole():
        want = float(cp.lml_core(jnp.asarray(K), jnp.asarray(y), 64))
    with cb.no_fused_whole():
        got = float(cb.lml_core(T(K), T(y), 64))
    assert abs(got - want) <= 1e-9 * abs(want)
    with cb.force_blocked(64), cb.no_fused_whole():
        got_front = float(linalg.lml_core(T(K), T(y)))
    assert abs(got_front - want) <= 1e-9 * abs(want)


def test_fused_cholesky_invs_plain_matches_pallas(factor256):
    """K1's plain version against K1 in interpret mode, n = 256, b = 64."""
    K, _, _, _ = factor256
    with cp.force_interpret():
        Lj, invj = cp.fused_cholesky_invs(jnp.asarray(K), 64)
    Lt, invt = cb.fused_cholesky_invs(T(K), 64)  # CPU tensor: the plain version
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=ATOL)
    np.testing.assert_allclose(invt.numpy(), np.asarray(invj), atol=ATOL)


# -- dispatch ----------------------------------------------------------------


def test_driver_takes_k1_up_to_fused_max_n(monkeypatch):
    """As cholesky_pallas.py:624-645: K1 for a 2-D matrix with n <=
    _FUSED_MAX_N unless no_fused_whole(); the stepwise driver above it or
    under no_fused_whole().  The port's gate is its own, measured on the H100
    (4096, where the JAX twin has 2047).  On CUDA, K1 also needs block 128
    and n >= 1024."""
    taken = []
    monkeypatch.setattr(cb, "fused_cholesky_invs", lambda K, b: taken.append("K1"))
    monkeypatch.setattr(cb, "_stepwise_cholesky_invs", lambda K, b: taken.append("stepwise"))
    cb.blocked_cholesky_invs(torch.zeros(256, 256), 64)
    cb.blocked_cholesky_invs(torch.zeros(4096, 4096), 128)
    cb.blocked_cholesky_invs(torch.zeros(4224, 4224), 128)
    with cb.no_fused_whole():
        cb.blocked_cholesky_invs(torch.zeros(256, 256), 64)
    assert taken == ["K1", "K1", "stepwise", "stepwise"]
    assert cb._FUSED_MAX_N == 4096 and cp._FUSED_MAX_N == 2047
    monkeypatch.setattr(cb, "_is_cuda", lambda *ts: True)  # the CUDA rule, on the CPU
    for n, block, route in [(1024, 128, True), (1536, 128, True), (2048, 128, True), (4096, 128, True),
                            (512, 128, False), (1024, 64, False), (4224, 128, False)]:
        assert cb._takes_fused(torch.zeros(n, n), block) is route, (n, block)




def test_eligible_block_rules():
    assert cb._eligible_block(torch.zeros(4096, 4096)) is None  # CPU
    assert cb._eligible_block(torch.zeros(256, 128)) is None  # not square
    with cb.force_blocked(64):
        assert cb._eligible_block(torch.zeros(256, 256, dtype=torch.float64)) == 64
        assert cb._eligible_block(torch.zeros(100, 100)) is None
    assert cb._eligible_block(torch.zeros(256, 256)) is None


def test_trsv_fits_is_k3_shared_memory_limit():
    """K3 used to hold the solution in one block's shared memory and refuse
    n > 53888 (``trsv_fits``).  It keeps x in global memory now, so the rule
    is gone: the sizes on either side of the old limit take the same solver
    (K4, past the measured K3/K4 gate), and the binding passes K3 its
    workspace (the ticket and ready flags) as K4's does."""
    assert not hasattr(cb, "trsv_fits")
    assert cb.trsv_solvers(53888, 128) == cb.trsv_solvers(54016, 128) == (cb.trsv2d_lower, cb.trsv2d_lower_t)
    for entry in ("gogp_trsv_lower", "gogp_trsv_lower_t"):
        # L, y, invs, x, counters, n, b, stream
        assert len(_build.SIGNATURES[entry]) == 8
        assert len(_build.SIGNATURES[entry.replace("trsv", "trsv2d")]) == 9  # and partial


def test_lml_core_beyond_k3_limit_takes_torch_linalg(monkeypatch, factor256):
    """The front door's lml_core stays on the blocked path on either side of
    the K3/K4 gate: K3 below it (n = 256 under the measured gate of 1024), K4
    from a lowered gate on, with the same value."""
    K, y, _, _ = factor256
    taken = []

    def spy(name, fn):
        return lambda *a: taken.append(name) or fn(*a)

    with cp.force_interpret(), cp.no_fused_whole():
        want = float(cp.lml_core(jnp.asarray(K), jnp.asarray(y), 64))
    monkeypatch.setattr(cb, "trsv_lower", spy("K3", cb.trsv_lower))
    monkeypatch.setattr(cb, "trsv2d_lower", spy("K4", cb.trsv2d_lower))
    with cb.force_blocked(64), cb.no_fused_whole():
        got_k3 = float(linalg.lml_core(T(K), T(y)))
        monkeypatch.setattr(cb, "_TRSV2D_MIN_N", 256)
        got_k4 = float(linalg.lml_core(T(K), T(y)))
    assert taken == ["K3", "K4"]
    assert abs(got_k3 - want) <= 1e-9 * abs(want)
    assert abs(got_k4 - want) <= 1e-9 * abs(want)


def test_forward_only_backward_raises():
    """The wrapper every raw CUDA kernel wrapper runs in (here around K2's
    plain version, as cholesky_inv_tile wraps the kernel on CUDA): values
    pass through, and a backward through any output raises instead of
    treating the kernel's outputs as constants, pointing at the pullbacks."""
    A = torch.tensor(spd(8, seed=12), requires_grad=True)
    L, V = cb._ForwardOnly.apply("cholesky_inv_tile", cb.cholesky_inv_tile_plain, A)
    np.testing.assert_allclose(L.detach().numpy(), np.linalg.cholesky(spd(8, seed=12)), atol=ATOL)
    with pytest.raises(NotImplementedError, match="cholesky_inv_tile.*lml_core, cholesky"):
        V.sum().backward()


def test_cpu_takes_plain_versions_and_counts_nothing(factor256):
    K, y, _, _ = factor256
    cb.reset_launch_counts()
    cb.lml_core(T(K), T(y), 64)
    cb.blocked_trsm_lower(T(K), T(y), 64)
    assert all(v == 0 for v in cb.LAUNCHES.values()), cb.LAUNCHES


def test_other_devices_raise_instead_of_falling_back():
    A = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cb.cholesky_inv_tile(A)
    with pytest.raises(ValueError, match="unsupported device"):
        cb.tril_inv_tile(A)


def test_force_plain_bypasses_blocked_driver(monkeypatch, factor256):
    K, y, _, _ = factor256

    def boom(*a, **k):
        raise AssertionError("blocked path taken inside force_plain")

    monkeypatch.setattr(cb, "blocked_cholesky_invs", boom)
    monkeypatch.setattr(cb, "lml_core", boom)
    monkeypatch.setattr(cb, "blocked_trsm_lower", boom)
    with cb.force_blocked(64), linalg.force_plain():
        L = linalg.cholesky(T(K))
        linalg.lml_core(T(K), T(y))
        linalg.trsm_lower(L, T(K[:, :3]))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), atol=ATOL)


def test_cholesky_failure_is_nan_and_jitter_matches_jax():
    """Not positive definite -> NaN factor (JAX's contract, not torch's
    exception); cholesky_with_jitter then escalates as in JAX."""
    x = np.linspace(0, 1, 6)
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.3**2)
    K[0, 0] -= 0.5  # indefinite
    assert torch.isnan(linalg.cholesky(T(K))).any()
    Lj, jit_j = jlinalg.cholesky_with_jitter(jnp.asarray(K), initial_jitter=1.0)
    Lt, jit_t = linalg.cholesky_with_jitter(T(K), initial_jitter=1.0)
    assert float(jit_t) > 0
    np.testing.assert_allclose(float(jit_t), float(jit_j), rtol=1e-12)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=ATOL)


def test_c_interface_matches_bindings():
    """Every C entry point in csrc/ has a ctypes signature with the same
    number of arguments, and vice versa."""
    found = {}
    for src in (REPO / "gogp_torch" / "csrc").glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (gogp_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len(args.split(","))
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}
