"""Whether the anynoise study's LBFGS fits part under rounding in the JAX
package itself.

The rolling forecast of the anynoise study at the fixtures' configuration
(``tests/fixtures/forecast_anynoise.csv``: LBFGS 200, seed 0, CPU float64)
ends on rows whose optimum in the port differs from JAX's
(``OTHER_OPTIMA`` in ``tests/test_torch_evaluate.py``).  This runs JAX's own
batched rolling forecast twice on the CPU in float64, once on the study's
data as it is and once with every observation moved by one ulp (or, with
``--perturb x``, every input), and the port's once, and prints one JSON
object: the rows whose final LML moves (relative change above 1e-8) in JAX
under the one-ulp change, the rows where the port's fit ends on another
optimum than the fixture's, and the rows in both.

    python tests/anynoise_ulp.py              # about 2 min on one CPU
    python tests/anynoise_ulp.py --perturb x

Not collected by pytest (no ``test_`` prefix).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

MOVED_RTOL = 1e-8  # the fixture test's test of "another optimum"
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "forecast_anynoise.csv"


def jax_rows(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    from gogp_tpu.tutorial import anynoise
    from gogp_tpu.tutorial.evaluate import EvalConfig, evaluate

    cfg = EvalConfig(alg="lbfgs", iters=200, seed=0, out_of_sample=False)
    return np.asarray(evaluate(anynoise.make_study(), x, y, config=cfg).rows, dtype=np.float64)


def port_rows(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The port's batched rolling forecast on the CPU in float64, with JAX's
    jitter draws (as the fixture test runs it)."""
    import jax.numpy as jnp

    from gogp_torch.tutorial import anynoise
    from gogp_torch.tutorial import evaluate as tev

    study = anynoise.make_study()
    draws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (x.shape[0], study.gp.n_theta), dtype=jnp.float64))
    cfg = tev.EvalConfig(alg="lbfgs", iters=200, seed=0)
    return np.asarray(tev.evaluate(study, x, y, config=cfg, device="cpu", draws=draws).rows, dtype=np.float64)


def moved(a: np.ndarray, b: np.ndarray) -> list[int]:
    """Rows whose final LML (column 5) differs by more than MOVED_RTOL."""
    rel = np.abs(a[:, 5] - b[:, 5]) / np.maximum(np.abs(b[:, 5]), 1e-12)
    return [int(i) for i in np.flatnonzero(rel > MOVED_RTOL)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--perturb", choices=("y", "x"), default="y", help="which data to move by one ulp")
    args = ap.parse_args()
    from gogp_tpu.tutorial import anynoise
    from gogp_tpu.tutorial import io as tio

    x, y = tio.load_csv(anynoise.selfcheck_data())
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    fixture = np.loadtxt(FIXTURE, delimiter=",")
    t0 = time.perf_counter()
    base = jax_rows(x, y)
    if args.perturb == "y":
        ulp = jax_rows(x, np.nextafter(y, np.inf))
    else:
        ulp = jax_rows(np.nextafter(x, np.inf), y)
    port = port_rows(x, y)
    jax_moved, other = moved(ulp, base), moved(port, fixture)
    print(json.dumps({
        "rows": int(base.shape[0]), "perturb": args.perturb, "moved_rtol": MOVED_RTOL,
        "jax_matches_fixture": moved(base, fixture) == [],
        "jax_moved_by_one_ulp": jax_moved, "port_other_optima": other,
        "other_optima_that_move_in_jax": sorted(set(jax_moved) & set(other)),
        "counts": {"jax_moved": len(jax_moved), "port_other": len(other),
                   "both": len(set(jax_moved) & set(other))},
        "largest_jax_move_rel": float(np.max(np.abs(ulp[:, 5] - base[:, 5]) / np.abs(base[:, 5]))),
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
