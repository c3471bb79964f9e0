"""Every case study end to end on its embedded dataset.

The port's counterpart of the JAX package's ``make selfcheck`` (Makefile:
the five MLE studies with ``--seed 0``, events with the events
``1.0:1.0:0.5,4.2:6.7:0.25``, and the classify study with ``--seed 0
--iters 60``).  Each study's CSV goes to stdout after a ``# <study>`` line;
the run fails unless every forecast study gives one row per data point of
the reference's width (x, y, mu, sigma, lml0, lml and the thetas) with
finite mu, sigma >= 0 and finite log-densities, and classify one row per
point (x, y, p_hat, lml0, lml and the thetas) with p_hat in [0, 1] and
finite log-densities.

Run:  python -m gogp_torch.tutorial.selfcheck [--platform cpu] [other flags]
      (the flags go to every forecast study, e.g. ``--iters 200`` or
      ``-a adam``; classify takes only ``--platform``)
"""

from __future__ import annotations

import importlib
import sys

import numpy as np

from gogp_torch.tutorial import io as tio

RUNS = (
    ("barebones", []),
    ("hyperpriors", []),
    ("warpedtime", []),
    ("anynoise", []),
    ("events", ["--events", "1.0:1.0:0.5,4.2:6.7:0.25"]),
)
CLASSIFY = ["--seed", "0", "--iters", "60"]


def _platform(flags: list[str]) -> list[str]:
    """The ``--platform`` flag of ``flags`` (either spelling), if any."""
    for i, flag in enumerate(flags):
        if flag.startswith("--platform="):
            return [flag]
        if flag == "--platform" and i + 1 < len(flags):
            return flags[i : i + 2]
    return []


def check_classify(flags: list[str]) -> None:
    """The classify study on its embedded data, its rows checked."""
    from gogp_torch.tutorial import classify

    print("# classify", flush=True)
    rows = np.asarray(classify.main([*CLASSIFY, *_platform(flags), "selfcheck"]), dtype=np.float64)
    x, _ = tio.load_csv(classify.selfcheck_data())
    n, width = x.shape[0], x.shape[1] + 4 + classify.make_gp().n_theta
    p = rows[:, x.shape[1] + 1] if rows.ndim == 2 and rows.shape == (n, width) else None
    if p is None or not (np.isfinite(rows).all() and ((p >= 0) & (p <= 1)).all()):
        raise SystemExit(f"selfcheck classify: rows of shape {rows.shape} are not {n} finite classification rows")
    tio.progress(f"classify: {n} rows")


def main(argv=None) -> int:
    flags = list(sys.argv[1:] if argv is None else argv)
    for name, extra in RUNS:
        mod = importlib.import_module(f"gogp_torch.tutorial.{name}")
        print(f"# {name}", flush=True)
        _, _, study, result = mod.main(["--seed", "0", *extra, *flags, "selfcheck"])
        rows = np.asarray(result.rows, dtype=np.float64)
        n, n_theta = result.x.shape[0], study.gp.n_theta
        ok = (rows.shape == (n, result.x.shape[1] + 5 + n_theta) and np.isfinite(rows[:, 2]).all()
              and (rows[:, 3] >= 0).all() and np.isfinite(rows[:, 4:6]).all())
        if not ok:
            raise SystemExit(f"selfcheck {name}: rows of shape {rows.shape} are not {n} finite forecast rows")
        tio.progress(f"{name}: {n} rows, iterations {int(result.iters.max())} at most, "
                     f"{int(result.stalled.sum())} stalled")
    check_classify(flags)
    tio.progress("selfchecks ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
