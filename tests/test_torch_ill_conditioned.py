"""The ill phase's covariances (chip_smoke.ILL_CASES) on the CPU: the port's
plain versions of K2, K7 and K1 against their JAX twins, and the twins' f32
errors that the phase's bounds are written from.

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
  f32 factors, LAPACK's and the twin's, are finite.

tests/ill_bounds.py prints the same numbers for every case, n = 4096 and
8192 among them (minutes at those sizes).
"""

import numpy as np
import pytest
import torch

from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import fused_gp
from ill_bounds import chip_smoke, twin

CASES = ("k2", "k7_96", "k7_128", "k1_1536")
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


@pytest.mark.parametrize("case", ["k2", "k1_1536"])
def test_ill_case_on_the_cpu(case):
    """The phase's per-case check on CPU tensors, where every wrapper is its
    plain version: the kernel's errors are the plain version's, and no bound
    is missed."""
    out = chip_smoke.ill_case(case, torch.device("cpu"))
    assert out["misses"] == []
    assert out["col_rel_err_vs_f64"] == out["plain_f32"] == out["library_f32"]
    assert out["cusolver_smallest_finite_jitter"] <= out["jitter"]
    assert out["finite_f32_at"][out["jitter"]] == {"cusolver": True, "kernel": True}
