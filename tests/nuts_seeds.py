"""NUTS at the Bayesian command line's defaults on the hyperpriors study, in
the JAX package and in the port, on the CPU: each chain's adapted step size
and posterior mean, and the diagnostics over the chains.

The command line's NUTS (``tutorial/bayes.py``: 4 chains from v0 + 0.1
N(0, 1), 400 warmup transitions, 512 samples over the chains, trees up to
depth 10) adapts one step size per chain.  This shows, seed by seed, which
chains adapt a small step and where they sit in the posterior, in the JAX
package's sampler and in the port's.  The port runs on the K7 route (K7's
plain version on the CPU) or, with ``--route plain``, under
``force_plain``, on the CPU or on a card.  The two packages draw different
random numbers, so their runs at one seed are two samples of the same
sampler, not one run twice.

    python tests/nuts_seeds.py --package jax --dtype float32 --seeds 0,1,2
    python tests/nuts_seeds.py --package torch --route plain --dtype float64 --seeds 0
    python tests/nuts_seeds.py --package torch --route plain --device cuda --seeds 0

One JSON line per seed; a run takes minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def run_jax(seed: int, dtype: str, warmup: int, samples: int, chains: int):
    """(chains, draws, dim) positions and each chain's step size."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import numpy as np

    from gogp_tpu import infer
    from gogp_tpu.tutorial import bayes, io as tio

    _, study, data = bayes.get_study("hyperpriors")
    x, y = tio.load_csv(data)
    logp, _, v0, free = bayes.build_logjoint(study, x, tio.normalize(y)[0])
    # the command line's keys and start (gogp_tpu/tutorial/bayes.py)
    keys = jax.random.split(jax.random.PRNGKey(seed), chains)
    x0 = v0[None, :] + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), (chains, v0.shape[0])) * free[None, :]
    res = jax.jit(jax.vmap(lambda q, k: infer.run_nuts(logp, q, k, num_warmup=warmup,
                                                         num_samples=samples // chains, free=free)))(x0, keys)
    return np.asarray(res.positions, dtype=np.float64), np.asarray(res.state.step_size, dtype=np.float64)


def run_torch(seed: int, dtype: str, warmup: int, samples: int, chains: int, route: str, device: str):
    """(chains, draws, dim) positions and each chain's step size, from the
    command line's own sampling call with ``nuts.run_nuts`` wrapped to keep
    its result."""
    import unittest.mock

    import torch

    from gogp_torch.infer import nuts
    from gogp_torch.ops import linalg
    from gogp_torch.tutorial import bayes, io as tio

    _, study, data = bayes.get_study("hyperpriors")
    x, y = tio.load_csv(data)
    with linalg.force_plain() if route == "plain" else contextlib.nullcontext():
        logp, _, v0, free = bayes.build_logjoint(study, x, tio.normalize(y)[0], device, getattr(torch, dtype))
    real, results = nuts.run_nuts, []

    def run_nuts(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    with unittest.mock.patch.object(nuts, "run_nuts", run_nuts):
        bayes.sample_posterior(logp, v0, free, "nuts", seed, samples, warmup, chains)
    res = results[0]
    return res.positions.transpose(0, 1).double().cpu().numpy(), res.state.step_size.double().cpu().numpy()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"], required=True)
    ap.add_argument("--route", choices=["k7", "plain"], default="k7", help="the port's log-joint route")
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--device", default="cpu", help="the port's device (the JAX package runs on the CPU)")
    args = ap.parse_args()
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.package == "jax":
            pos, step = run_jax(seed, args.dtype, args.warmup, args.samples, args.chains)
        else:
            pos, step = run_torch(seed, args.dtype, args.warmup, args.samples, args.chains, args.route,
                                  args.device)
        import torch

        from gogp_torch.infer import diagnostics

        min_ess, max_rhat, _ = diagnostics.gated_min_ess(torch.as_tensor(pos))
        torch_run = args.package == "torch"
        print(json.dumps({"package": args.package, "route": args.route if torch_run else None,
                          "device": args.device if torch_run else "cpu", "dtype": args.dtype, "seed": seed,
                          "warmup": args.warmup,
                          "wall_s": time.perf_counter() - t0, "step_size": step.tolist(),
                          "chain_mean": pos.mean(1).tolist(), "min_bulk_ess": min_ess,
                          "max_bulk_rhat": max_rhat}), flush=True)


if __name__ == "__main__":
    main()
