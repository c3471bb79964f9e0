"""Bayesian forecast driver: full-posterior inference on a case study.

PyTorch-package twin of ``gogp_tpu/tutorial/bayes.py``.  A sampler runs over
the study's log-joint (GP log marginal likelihood plus the study's priors on
the log-scale hyperparameters), then the forecast is the moment-matched
posterior-predictive mixture over the draws (``gp.core.predict_mixture``).

Output CSV rows: ``z, nan, mu, sigma`` (the reference's out-of-sample schema,
tutorial/tutorial.go:200-225) on a grid reaching one span past the data,
then a comment line with the posterior means of the hyperparameters.

Ported so far: the theta-only studies (barebones, hyperpriors, events) and
the ChEES-HMC engine.  The latent-input studies (warpedtime, anynoise) and
the other engines (NUTS, the JAX default, HMC, PT-ChEES, GHMC, ADVI, SMC;
``--pops`` and ``--race``) stop with a message naming ROADMAP.md.

The log-joint of a theta-only study runs on the K7 route: its forward is
``ops.fused_gp.make_fused_value_and_grad``'s value for the whole chain
batch, and its backward hands back the gradient that evaluation computed
(GPML 5.9), so the sampler differentiates it like any other log-density.
Built under ``ops.linalg.force_plain()`` it is the JAX package's own route
instead: ``gp_observe`` plus the priors, differentiated by autograd.

Usage:
    python -m gogp_torch.tutorial.bayes hyperpriors --engine chees selfcheck
    python -m gogp_torch.tutorial.bayes hyperpriors --engine chees --platform cpu selfcheck
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import NamedTuple

import numpy as np
import torch

from gogp_torch.gp.core import predict_mixture
from gogp_torch.infer import chees
from gogp_torch.models.params import gp_observe
from gogp_torch.ops import fused_gp, linalg
from gogp_torch.tutorial import io as tio

STUDIES = ("barebones", "hyperpriors", "warpedtime", "anynoise", "events")
ENGINES = ("nuts", "hmc", "chees", "pt-chees", "ghmc", "advi", "advi-full", "smc")
_PORTED_STUDIES = ("barebones", "hyperpriors", "events")


def get_study(name: str):
    if name not in _PORTED_STUDIES:
        raise SystemExit(f"study {name!r} is not ported yet (ROADMAP.md, queue 1); ported: {_PORTED_STUDIES}")
    mod = importlib.import_module(f"gogp_torch.tutorial.{name}")
    return mod, mod.make_study(), mod.selfcheck_data()


class Observed(NamedTuple):
    """The data every draw conditions on (where the JAX twin returns
    ``posterior_of``, one draw's posterior, the port returns the data, and
    ``predict_mixture`` conditions all draws at once)."""

    x: torch.Tensor  # (n, ndim)
    y: torch.Tensor  # (n,)
    mask: torch.Tensor  # (n,)


class _SavedGradLogp(torch.autograd.Function):
    """``vg(V)``'s value, with the gradient ``vg`` computed beside it as the
    backward (times the cotangent)."""

    @staticmethod
    def forward(ctx, V, vg):
        val, grad = vg(V)
        ctx.save_for_backward(grad)
        return val

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[..., None] * grad, None


def build_logjoint(study, x: np.ndarray, y: np.ndarray, device=None, dtype: torch.dtype = torch.float32):
    """``(logp, observed, v0, free)`` for a theta-only study: ``logp`` maps
    (chains, n_theta) log-thetas to (chains,) log-joints, on the K7 route or,
    built under ``linalg.force_plain()``, on the plain one."""
    if study.optinp:
        raise SystemExit(f"study {study.name!r} samples its inputs too: not ported yet (ROADMAP.md, queue 1)")
    gp = study.gp
    n = x.shape[0]
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    yt = torch.as_tensor(y, dtype=dtype, device=device)
    mask = torch.ones(n, dtype=dtype, device=device)
    priors = study.make_priors(x, y) if study.make_priors else None
    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    free = np.ones(gp.n_theta)
    if study.free_fn is not None:
        free = free * study.free_fn(gp.n_theta, n, n)[: gp.n_theta]
    free = torch.as_tensor(free, dtype=dtype, device=device)

    if linalg._FORCE_PLAIN:

        def one(v):
            ll = gp_observe(gp, v, x=xt, y=yt, mask=mask)
            return ll if priors is None else ll + priors(v, mask)

        logp = torch.func.vmap(one)
    else:
        vg = fused_gp.make_fused_value_and_grad(
            gp, xt, yt, mask, None if priors is None else (lambda V: priors(V, mask)))

        def logp(V):
            return _SavedGradLogp.apply(V, vg)

    return logp, Observed(xt, yt, mask), v0, free


def sample_posterior(logp, v0, free, engine: str, seed: int, num_samples: int,
                     num_warmup: int, chains: int, pops: int = 1,
                     replicas: int = 8, race: int = 0) -> torch.Tensor:
    """(draws, n_theta) posterior draws on ``v0``'s device.  ChEES keeps
    ``num_samples // chains`` draws per chain, as the JAX twin does."""
    if engine != "chees":
        raise SystemExit(f"engine {engine!r} is not ported yet (ROADMAP.md, queue 1); --engine chees is")
    if pops > 1 or race > 0:
        raise SystemExit("--pops and --race are not ported yet (ROADMAP.md, queue 1)")
    del replicas  # a PT-ChEES flag
    dim = v0.shape[0]
    init = torch.Generator(device=v0.device).manual_seed(seed + 1)
    x0 = v0[None, :] + 0.1 * torch.randn((chains, dim), generator=init, dtype=v0.dtype,
                                         device=v0.device) * free[None, :]
    rng = torch.Generator(device=v0.device).manual_seed(seed)
    res = chees.run_chees(logp, x0, rng, num_warmup=num_warmup,
                          num_samples=max(1, num_samples // chains), free=free)
    return res.positions.reshape(-1, dim)


def mixture_forecast(gp, observed: Observed, draws, z: np.ndarray, max_draws: int = 256):
    """Mixture mean and std (numpy) at ``z`` over at most ``max_draws``
    evenly spaced draws."""
    draws = torch.as_tensor(draws, device=observed.x.device)
    if draws.shape[0] > max_draws:
        idx = np.linspace(0, draws.shape[0] - 1, max_draws).astype(int)
        draws = draws[torch.as_tensor(idx, device=draws.device)]
    mu, sigma = predict_mixture(gp, draws, observed.x, observed.y, z, observed.mask)
    return mu.cpu().numpy(), sigma.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("study", choices=STUDIES)
    ap.add_argument("--engine", default="nuts", choices=ENGINES,
                    help="sampler (default nuts, as in the JAX package; chees is the one ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=8, help="with --engine pt-chees: rungs per ladder")
    ap.add_argument("--pops", type=int, default=1,
                    help="with --engine chees: independent populations (not ported yet)")
    ap.add_argument("--race", type=int, default=0,
                    help="with --engine chees: post-warmup trajectory race (not ported yet)")
    ap.add_argument("-n", action="store_true", help="do not normalize outputs")
    ap.add_argument("--grid", type=int, default=50, help="forecast grid points")
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("mode", nargs="?", default=None, help="'selfcheck' for embedded data")
    # intermixed: the optional positional ``mode`` may follow the options on
    # every Python 3 release (plain parse_args loses it on some)
    args = ap.parse_intermixed_args(argv)

    device = tio.device_for(args.platform or "cuda")
    _, study, data = get_study(args.study)
    x, y = tio.load_csv(data if args.mode == "selfcheck" else sys.stdin)
    if args.n:
        y_norm, mean_y, std_y = y, 0.0, 1.0
    else:
        y_norm, mean_y, std_y = tio.normalize(y)

    logp, observed, v0, free = build_logjoint(study, x, y_norm, device)
    tio.progress(f"sampling ({args.engine})...")
    draws = sample_posterior(logp, v0, free, args.engine, args.seed, args.samples, args.warmup,
                             args.chains, args.pops, args.replicas, args.race)
    tio.progress("forecasting...")
    lo, hi = x[:, 0].min(), x[:, 0].max()
    z = np.linspace(lo, hi + (hi - lo), args.grid)[:, None]
    mu, sigma = mixture_forecast(study.gp, observed, draws, z)

    rows = [[z[i, 0], float("nan"), mu[i] * std_y + mean_y, sigma[i] * std_y] for i in range(z.shape[0])]
    tio.write_forecast_rows(sys.stdout, rows)
    theta_mean = torch.exp(draws[:, : study.gp.n_theta]).mean(0)
    print("# posterior theta mean: " + ",".join(f"{t:.6f}" for t in theta_mean.tolist()))
    tio.progress("done")


if __name__ == "__main__":
    main()
