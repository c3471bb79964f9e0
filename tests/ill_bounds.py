"""The CPU errors behind ``chip_smoke.py``'s bounds of the ill phase: the
JAX twin of each kernel the phase checks, in f32 on the CPU, on the phase's
covariances (``chip_smoke.ILL_CASES``), column by column against f64
(``chip_smoke.ill_errors``), beside the port's plain f32 versions there and
whether each f32 factor is finite at each jitter of ``chip_smoke.ILL_JITTERS``.

- k2: ``pallas_cholesky_inv_tile`` on each tile;
- k7_96, k7_128: ``linv_value``'s two loops, ``chol_value`` then
  ``lower_inv_value``, on the batch;
- k1_1536, k1_4096, stepwise_8192: ``blocked_cholesky_invs`` at block 128
  (the twin's fused kernel at n = 1536, its stepwise driver above its
  ``_FUSED_MAX_N``);
- k1_1536_1e-5, stepwise_1536_1e-5: the same at n = 1536, jitter 1e-5, the
  stepwise case under ``no_fused_whole``; both twins are NaN there;

every Pallas kernel in interpret mode.  Prints one JSON line a case; the
phase's bounds are 10x the twin's errors ("twin_f32"), or where the twin is
NaN 10x LAPACK's ("plain_f32": the plain version, LAPACK's factor and the
inverses of its tiles), as "bound_source" says.  About 5 min, most of it
the twin at n = 8192 (several GB); ``--cases k2,k7_96`` runs some.

    python tests/ill_bounds.py
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gogp_torch.ops import cholesky_blocked as cb  # noqa: E402
from gogp_tpu.ops import cholesky_pallas as cp  # noqa: E402
from gogp_tpu.ops import fused_gp as jfused_gp  # noqa: E402


def twin(case: str, A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The JAX twin's (L, V) of the case on the (count, n, n) covariances
    A, in A's dtype."""
    with cp.force_interpret():
        if case == "k2":
            tile = jax.jit(cp.pallas_cholesky_inv_tile)
            out = [tile(jnp.asarray(a)) for a in A]
            return np.stack([np.asarray(o[0]) for o in out]), np.stack([np.asarray(o[1]) for o in out])
        if case.startswith("k7"):
            L = jax.jit(jfused_gp.chol_value)(jnp.asarray(A))
            return np.asarray(L), np.asarray(jax.jit(jfused_gp.lower_inv_value)(L))
        with cp.no_fused_whole() if case.startswith("stepwise") else contextlib.nullcontext():
            L, invs = jax.jit(lambda a: cp.blocked_cholesky_invs(a, chip_smoke.BLOCK))(jnp.asarray(A[0]))
        return np.asarray(L)[None], np.asarray(invs)[None]


def finite_f32(case: str) -> dict:
    """Per jitter of ILL_JITTERS: is LAPACK's f32 factor of every matrix of
    the case finite?"""
    return {jitter: bool(torch.isfinite(cb.plain_cholesky(torch.as_tensor(
        chip_smoke.ill_covariances(case, jitter), dtype=torch.float32))).all()) for jitter in chip_smoke.ILL_JITTERS}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", type=lambda v: v.split(","), default=list(chip_smoke.ILL_CASES))
    args = parser.parse_args()
    for case in args.cases:
        t0 = time.perf_counter()
        block = chip_smoke.ILL_CASES[case][3]
        A = torch.as_tensor(chip_smoke.ill_covariances(case), dtype=torch.float32)
        Lt, Vt = twin(case, A.numpy())
        Lp, Vp = chip_smoke.ill_plain(case, A)
        twin_errs = chip_smoke.ill_errors(A, torch.tensor(Lt), torch.tensor(Vt), block)
        plain_errs = chip_smoke.ill_errors(A, Lp, Vp, block)
        print(json.dumps({"case": case, "twin_f32": twin_errs, "plain_f32": plain_errs,
                          "bound_source": "plain_f32" if case in chip_smoke.ILL_LAPACK_F32 else "twin_f32",
                          "twin_finite": bool(np.isfinite(Lt).all() and np.isfinite(Vt).all()),
                          "lapack_f32_finite_at": finite_f32(case),
                          "min_diag_L64": float(torch.linalg.cholesky(A.double()).diagonal(dim1=-2, dim2=-1).min()),
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
