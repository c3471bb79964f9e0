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
    """As cholesky_pallas.py:624-645: K1 for a 2-D matrix with n <= 2047
    unless no_fused_whole(); the stepwise driver above it or under
    no_fused_whole().  On CUDA, K1 also needs block 128 and n >= 1024."""
    taken = []
    monkeypatch.setattr(cb, "fused_cholesky_invs", lambda K, b: taken.append("K1"))
    monkeypatch.setattr(cb, "_stepwise_cholesky_invs", lambda K, b: taken.append("stepwise"))
    cb.blocked_cholesky_invs(torch.zeros(256, 256), 64)
    cb.blocked_cholesky_invs(torch.zeros(1920, 1920), 128)
    cb.blocked_cholesky_invs(torch.zeros(2048, 2048), 128)
    with cb.no_fused_whole():
        cb.blocked_cholesky_invs(torch.zeros(256, 256), 64)
    assert taken == ["K1", "K1", "stepwise", "stepwise"]
    assert cb._FUSED_MAX_N == cp._FUSED_MAX_N == 2047
    monkeypatch.setattr(cb, "_is_cuda", lambda *ts: True)  # the CUDA rule, on the CPU
    for n, block, route in [(1024, 128, True), (1536, 128, True), (512, 128, False),
                            (1024, 64, False), (2048, 128, False)]:
        assert cb._takes_fused(torch.zeros(n, n), block) is route, (n, block)




def test_eligible_block_rules():
    assert cb._eligible_block(torch.zeros(4096, 4096)) is None  # CPU
    assert cb._eligible_block(torch.zeros(256, 128)) is None  # not square
    with cb.force_blocked(64):
        assert cb._eligible_block(torch.zeros(256, 256, dtype=torch.float64)) == 64
        assert cb._eligible_block(torch.zeros(100, 100)) is None
    assert cb._eligible_block(torch.zeros(256, 256)) is None


def test_trsv_fits_is_k3_shared_memory_limit():
    """K3 holds n + b + 4096 floats in one block's 227 KB of shared memory:
    n = 53888 (421 tiles of 128) fits, the next multiple of the tile does
    not.  test_torch_cuda.py checks the C side refuses the same n."""
    assert cb.trsv_fits(53888, 128)
    assert not cb.trsv_fits(54016, 128)
    assert cb.trsv_fits(4096, cb.DEFAULT_BLOCK)


def test_lml_core_beyond_k3_limit_takes_torch_linalg(monkeypatch, factor256):
    """Where K3 cannot take the size, the front door's lml_core runs
    torch.linalg (JAX would take K4, not ported) instead of raising."""
    K, y, _, _ = factor256

    def boom(*a, **k):
        raise AssertionError("blocked lml_core taken beyond K3's limit")

    with cp.force_interpret(), cp.no_fused_whole():
        want = float(cp.lml_core(jnp.asarray(K), jnp.asarray(y), 64))
    monkeypatch.setattr(cb, "trsv_fits", lambda n, block: False)
    monkeypatch.setattr(cb, "lml_core", boom)
    with cb.force_blocked(64):
        got = float(linalg.lml_core(T(K), T(y)))
    assert abs(got - want) <= 1e-9 * abs(want)


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
