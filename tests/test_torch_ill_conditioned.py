"""The ill phase's covariances (chip_smoke.ILL_CASES) on the CPU: the port's
plain versions of K2, K7 and K1 against their JAX twins, the twins' f32
errors that the phase's bounds are written from, and the panels of the
stepwise driver and of the row-sharded Cholesky solved against L_kk.

The cases are rbf covariances on equispaced points of [0, 1] with jitter
1e-5 (128-point tiles, length scales 0.05 to 1; K7's batches their leading
96 and 128 blocks) or 1e-4 (one covariance at n = 1536, length scale 0.05).
The twins run as the JAX package's tests run them: every Pallas kernel in
interpret mode (tests/ill_bounds.py's ``twin``; K7's twin is linv_value's
two loops, chol_value then lower_inv_value).

- In f64 the port's plain versions hold the twins to 1e-9 of each column's
  largest entry (chip_smoke.col_rel_err; 2.5e-10 measured).
- In f32 the twins' errors against f64 (chip_smoke.ill_errors: the factor,
  the inverses, and the inverses against the f64 inverse of their own
  factor) are those chip_smoke.ILL_TWIN_F32 records, within a factor of 2,
  so the bounds (10 times these) stay tied to what the twins do; the port's
  plain versions stay within 3 times the twins' errors.
- Each case's jitter is the smallest of chip_smoke.ILL_JITTERS at which the
  f32 factors, LAPACK's and the twin's, are finite; but for the two cases
  at n = 1536, jitter 1e-5, where LAPACK's is and the twin's is not, whose
  bounds come from LAPACK's f32 errors (chip_smoke.ILL_LAPACK_F32).
- At n = 1536 in f32, jitter 1e-5 and 1e-4, the stepwise driver (a stack of
  one) and cholesky_rowsharded (a gloo group of one in this process) are
  finite and within chip_smoke.ILL_PLAIN_FACTOR times LAPACK's column
  error, the row-sharded one within 2 times its twin's (one-device
  shard_map).  With their panels multiplied by inv(L_kk), as both formed
  them before, they are NaN at 1e-5 and miss that factor at 1e-4.

tests/ill_bounds.py prints the same numbers for every case, n = 4096 and
8192 among them (minutes at those sizes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import distributed as dops
from gogp_torch.ops import fused_gp
from gogp_torch.parallel import mesh as pmesh
from gogp_tpu.ops import distributed as jdist
from gogp_tpu.parallel import DATA_AXIS
from gogp_tpu.parallel import make_mesh as jmake_mesh
from ill_bounds import chip_smoke, twin

CASES = ("k2", "k7_96", "k7_128", "k1_1536")
LAPACK_CASES = tuple(chip_smoke.ILL_LAPACK_F32)  # n = 1536, jitter 1e-5
F64_RTOL = 1e-9


def plain(case, A):
    """(L, V) of the port's plain version: cholesky_inv_tile_plain,
    linv_plain (with the factor it takes) or fused_cholesky_invs_plain."""
    if case == "k2":
        return cb.cholesky_inv_tile_plain(A)
    if case.startswith("k7"):
        return cb.plain_cholesky(A), fused_gp.linv_plain(A)
    L, invs = cb.fused_cholesky_invs_plain(A[0], chip_smoke.BLOCK)
    return L[None], invs[None]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_twin_in_f64(case):
    A = chip_smoke.ill_covariances(case)
    Lj, Vj = twin(case, A)
    Lt, Vt = plain(case, torch.as_tensor(A))
    assert Vt.dtype == torch.float64
    assert chip_smoke.col_rel_err(Vt, torch.tensor(Vj)) <= F64_RTOL
    assert chip_smoke.col_rel_err(Lt, torch.tensor(Lj)) <= F64_RTOL


@pytest.mark.parametrize("case", CASES)
def test_twin_f32_errors_behind_the_bounds(case):
    block = chip_smoke.ILL_CASES[case][3]
    A = torch.as_tensor(chip_smoke.ill_covariances(case), dtype=torch.float32)
    Lj, Vj = twin(case, A.numpy())
    assert Vj.dtype == np.float32
    got = chip_smoke.ill_errors(A, torch.tensor(Lj), torch.tensor(Vj), block)
    recorded = chip_smoke.ILL_TWIN_F32[case]
    assert set(got) == set(recorded) == set(chip_smoke.ILL_BOUNDS[case])
    for metric, err in got.items():
        assert recorded[metric] / 2 <= err <= 2 * recorded[metric], (metric, err, recorded[metric])
    ours = chip_smoke.ill_errors(A, *chip_smoke.ill_plain(case, A), block)
    for metric, err in got.items():
        assert ours[metric] <= 3 * err, (metric, ours[metric], err)


@pytest.mark.parametrize("case", CASES)
def test_jitter_is_the_smallest_with_finite_f32_factors(case):
    jitters = chip_smoke.ILL_JITTERS
    jitter = chip_smoke.ILL_CASES[case][2]

    def finite(j):
        A = chip_smoke.ill_covariances(case, j).astype(np.float32)
        if not torch.isfinite(cb.plain_cholesky(torch.as_tensor(A))).all():
            return False
        return all(np.isfinite(out).all() for out in twin(case, A))

    assert finite(jitter)
    assert jitter == jitters[0] or not finite(jitters[jitters.index(jitter) - 1])


@pytest.mark.parametrize("case", ["k2", "k1_1536", "k1_1536_1e-5"])
def test_ill_case_on_the_cpu(case):
    """The phase's per-case check on CPU tensors, where every wrapper is its
    plain version: the kernel's errors are the plain version's, and no bound
    is missed."""
    out = chip_smoke.ill_case(case, torch.device("cpu"))
    assert out["misses"] == []
    assert out["col_rel_err_vs_f64"] == out["plain_f32"] == out["library_f32"]
    assert out["cusolver_smallest_finite_jitter"] <= out["jitter"]
    assert out["finite_f32_at"][out["jitter"]] == {"cusolver": True, "kernel": True}


# --- the panels solved against L_kk (n = 1536, block 128, f32) ---------------------


@pytest.fixture(scope="module")
def world1():
    """A 1x1 mesh on a gloo group of one in this process (init_multihost's
    in-memory store), destroyed after the module."""
    assert not dist.is_initialized()
    pmesh.init_multihost(backend="gloo")
    yield pmesh.make_mesh(1, 1)
    dist.destroy_process_group()


def rbf32(jitter):
    """The stepwise case's covariance (chip_smoke.ILL_ROWS_CASE: n = 1536,
    length scale 0.05) at ``jitter``, in f32, and its f64 factor."""
    A = torch.as_tensor(chip_smoke.ill_covariances(chip_smoke.ILL_ROWS_CASE, jitter)[0], dtype=torch.float32)
    return A, torch.linalg.cholesky(A.double())


def factor(route, A, mesh):
    """L of the stepwise driver (a stack of one, as the twin's custom_vmap
    reroutes it) or of the row-sharded Cholesky on ``mesh``."""
    if route == "stepwise":
        return cb.blocked_cholesky_invs(A[None], chip_smoke.BLOCK)[0][0]
    with mesh:
        return dops.cholesky_rowsharded(A, pmesh.DATA_AXIS, chip_smoke.BLOCK)


def lapack_err(A, L64):
    return chip_smoke.col_rel_err(cb.plain_cholesky(A), L64)


@pytest.mark.parametrize("jitter", [1e-5, 1e-4])
@pytest.mark.parametrize("route", ["stepwise", "rowsharded"])
def test_panels_by_substitution_within_lapack(world1, route, jitter):
    A, L64 = rbf32(jitter)
    L = factor(route, A, world1)
    assert torch.isfinite(L).all()
    err, lapack = chip_smoke.col_rel_err(L, L64), lapack_err(A, L64)
    assert err <= chip_smoke.ILL_PLAIN_FACTOR * lapack, (err, lapack)


@pytest.mark.parametrize("route", ["stepwise", "rowsharded"])
def test_panels_by_inverse_product_were_nan(world1, monkeypatch, route):
    """The panel as both formed it before, C @ inv(L_kk)^T with inv(L_kk)
    a solve against I: NaN at jitter 1e-5, and at 1e-4 finite but past
    ILL_PLAIN_FACTOR times LAPACK's error."""
    solve = torch.linalg.solve_triangular

    def inverse_product(M, C, *, upper, left=True):
        if upper and not left:  # X L_kk^T = C, the panel
            return C @ solve(M.mT, torch.eye(M.shape[-1], dtype=M.dtype), upper=False).mT
        return solve(M, C, upper=upper, left=left)

    monkeypatch.setattr(torch.linalg, "solve_triangular", inverse_product)
    A, _ = rbf32(1e-5)
    assert not torch.isfinite(factor(route, A, world1)).all()
    A, L64 = rbf32(1e-4)
    L = factor(route, A, world1)
    assert torch.isfinite(L).all()
    assert chip_smoke.col_rel_err(L, L64) > chip_smoke.ILL_PLAIN_FACTOR * lapack_err(A, L64)


@pytest.mark.parametrize("jitter", [1e-5, 1e-4])
def test_rowsharded_within_twice_its_twin(world1, jitter):
    A, L64 = rbf32(jitter)
    jmesh = jmake_mesh(n_chain=1, n_data=1, devices=jax.devices()[:1])
    fn = functools.partial(jdist.cholesky_rowsharded, axis=DATA_AXIS, block=chip_smoke.BLOCK, unroll=True)
    Lj = np.asarray(jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(P(DATA_AXIS, None),),
                                          out_specs=P(DATA_AXIS, None), check_vma=False))(jnp.asarray(A.numpy())))
    assert Lj.dtype == np.float32
    twin_err = chip_smoke.col_rel_err(torch.tensor(Lj), L64)
    assert chip_smoke.col_rel_err(factor("rowsharded", A, world1), L64) <= 2 * twin_err


@pytest.mark.parametrize("case", LAPACK_CASES)
def test_lapack_f32_errors_behind_the_bounds(case):
    """ILL_LAPACK_F32 is the plain f32 version's (LAPACK's factor and its
    tiles' inverses) within a factor of 2."""
    A = torch.as_tensor(chip_smoke.ill_covariances(case), dtype=torch.float32)
    got = chip_smoke.ill_errors(A, *chip_smoke.ill_plain(case, A), chip_smoke.ILL_CASES[case][3])
    recorded = chip_smoke.ILL_LAPACK_F32[case]
    assert set(got) == set(recorded) == set(chip_smoke.ILL_BOUNDS[case])
    for metric, err in got.items():
        assert recorded[metric] / 2 <= err <= 2 * recorded[metric], (metric, err, recorded[metric])


def test_lapack_cases_sit_where_the_twin_is_nan():
    """At n = 1536, jitter 1e-5 LAPACK's f32 factor is finite (and at 1e-6
    not), and the twin's fused kernel's is NaN: hence LAPACK's bounds."""
    case = "k1_1536_1e-5"
    jitter = chip_smoke.ILL_CASES[case][2]
    lapack_finite = {j: bool(torch.isfinite(cb.plain_cholesky(torch.as_tensor(
        chip_smoke.ill_covariances(case, j), dtype=torch.float32))).all()) for j in chip_smoke.ILL_JITTERS}
    assert lapack_finite[jitter] and not lapack_finite[chip_smoke.ILL_JITTERS[chip_smoke.ILL_JITTERS.index(jitter) - 1]]
    Lj, _ = twin(case, chip_smoke.ill_covariances(case).astype(np.float32))
    assert not np.isfinite(Lj).all()


def test_ill_rowsharded_on_the_cpu(world1):
    """The parallel phase's row-sharded case on CPU tensors misses no bound."""
    out = chip_smoke.ill_rowsharded(torch.device("cpu"), world1)
    assert out["misses"] == []
    assert out["col_rel_err_vs_f64"]["L"] <= chip_smoke.ILL_PLAIN_FACTOR * out["plain_f32"]["L"]
