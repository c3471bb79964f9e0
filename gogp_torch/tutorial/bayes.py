"""Bayesian forecast driver: full-posterior inference on a case study.

PyTorch-package twin of ``gogp_tpu/tutorial/bayes.py``.  A sampler runs over
the study's log-joint (GP log marginal likelihood plus the study's priors on
the log-scale hyperparameters), then the forecast is the moment-matched
posterior-predictive mixture over the draws (``gp.core.predict_mixture``).

Output CSV rows: ``z, nan, mu, sigma`` (the reference's out-of-sample schema,
tutorial/tutorial.go:200-225) on a grid reaching one span past the data,
then a comment line with the posterior means of the hyperparameters.

Engines: every one of the JAX twin's, on all five studies: NUTS (the
default), HMC, ChEES-HMC (with ``--pops`` independent populations or a
``--race`` of trajectory lengths), PT-ChEES (``--chains`` ladders of
``--replicas`` rungs), GHMC, ADVI (mean-field and full-rank) and SMC.

The log-joint of a theta-only study runs on the K7 route: its forward is
``ops.fused_gp.make_fused_value_and_grad``'s value for the whole chain
batch, and its backward hands back the gradient that evaluation computed
(GPML 5.9), so the sampler differentiates it like any other log-density.
Built under ``ops.linalg.force_plain()`` it is the JAX package's own route
instead: ``gp_observe`` plus the priors, differentiated by autograd.  A
latent-input study (warpedtime, anynoise) samples its inputs and outputs
too, over the full parameter vector, always on that route (``torch.func.vmap``
over the chains), and its forecast conditions each draw on its own inputs.

Usage:
    python -m gogp_torch.tutorial.bayes hyperpriors selfcheck
    python -m gogp_torch.tutorial.bayes hyperpriors --engine pt-chees selfcheck
    python -m gogp_torch.tutorial.bayes anynoise --engine advi --platform cpu selfcheck
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import NamedTuple

import numpy as np
import torch

from gogp_torch.gp.core import predict_from_posterior, predict_mixture
from gogp_torch.infer import advi, chees, ghmc, hmc, nuts, pt_chees, smc
from gogp_torch.models.params import gp_observe, gp_posterior, join_params
from gogp_torch.ops import fused_gp, linalg
from gogp_torch.tutorial import io as tio

STUDIES = ("barebones", "hyperpriors", "warpedtime", "anynoise", "events")
ENGINES = ("nuts", "hmc", "chees", "pt-chees", "ghmc", "advi", "advi-full", "smc")


def get_study(name: str):
    mod = importlib.import_module(f"gogp_torch.tutorial.{name}")
    return mod, mod.make_study(), mod.selfcheck_data()


class Observed(NamedTuple):
    """The data every draw conditions on (where the JAX twin returns
    ``posterior_of``, one draw's posterior, the port returns the data, and
    ``predict_mixture`` conditions all draws at once).  ``latent``: each
    draw carries its own inputs and outputs (a latent-input study)."""

    x: torch.Tensor  # (n, ndim)
    y: torch.Tensor  # (n,)
    mask: torch.Tensor  # (n,)
    latent: bool = False


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
    """``(logp, observed, v0, free)``: ``logp`` maps (chains, p) parameter
    vectors to (chains,) log-joints.  A theta-only study's vector is its
    log-thetas, on the K7 route or, built under ``linalg.force_plain()``, on
    the plain one; a latent-input study's is the full vector (log-thetas,
    inputs, outputs) on the plain route."""
    gp = study.gp
    n = x.shape[0]
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    yt = torch.as_tensor(y, dtype=dtype, device=device)
    mask = torch.ones(n, dtype=dtype, device=device)
    priors = study.make_priors(x, y) if study.make_priors else None
    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    if study.optinp:
        v0 = join_params(gp, v0, xt, yt)
    free = np.ones(v0.shape[0])
    if study.free_fn is not None:
        free = free * study.free_fn(gp.n_theta, n, n)[: v0.shape[0]]
    free = torch.as_tensor(free, dtype=dtype, device=device)
    observed = Observed(xt, yt, mask, study.optinp)

    if study.optinp or linalg._FORCE_PLAIN:

        def one(v):
            ll = gp_observe(gp, v, mask=mask) if study.optinp else gp_observe(gp, v, x=xt, y=yt, mask=mask)
            return ll if priors is None else ll + priors(v, mask)

        return torch.func.vmap(one), observed, v0, free
    vg = fused_gp.make_fused_value_and_grad(
        gp, xt, yt, mask, None if priors is None else (lambda V: priors(V, mask)))

    def logp(V):
        return _SavedGradLogp.apply(V, vg)

    return logp, observed, v0, free


def sample_posterior(logp, v0, free, engine: str, seed: int, num_samples: int,
                     num_warmup: int, chains: int, pops: int = 1,
                     replicas: int = 8, race: int = 0) -> torch.Tensor:
    """(draws, p) posterior draws on ``v0``'s device, with the JAX twin's
    sizes: ChEES keeps ``num_samples // chains`` draws per chain (at least
    one; ``pops > 1`` splits the chains into independent populations, ``race
    > 0`` races that many trajectory lengths for ``min(128, max(32,
    num_warmup // 4))`` transitions), PT-ChEES as many per ladder of
    ``replicas`` rungs, ``chains`` ladders, pooled; GHMC warms up for
    ``max(4 num_warmup, 512)`` transitions and keeps every 16th of ``16
    max(1, num_samples // chains)``; NUTS and HMC ``num_samples // chains``
    (chain after chain, as JAX's vmap stacks them), ADVI runs ``4
    num_warmup`` steps and draws ``num_samples``, SMC anneals
    ``max(num_samples, 128)`` particles."""
    dim = v0.shape[0]

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=v0.device).manual_seed(seed + offset)

    if engine in ("advi", "advi-full"):
        run, sample = ((advi.run_advi, advi.sample_posterior) if engine == "advi"
                       else (advi.run_advi_fullrank, advi.sample_posterior_fullrank))
        res = run(logp, v0, generator(0), num_steps=num_warmup * 4, free=free)
        return sample(res, generator(2), num_samples, free)
    if engine == "smc":
        return smc.run_smc(logp, v0, generator(0), num_particles=max(num_samples, 128), free=free).particles
    x0 = v0[None, :] + 0.1 * torch.randn((chains, dim), generator=generator(1), dtype=v0.dtype,
                                         device=v0.device) * free[None, :]
    per = max(1, num_samples // chains)
    if engine == "chees" and pops > 1:
        res = chees.run_chees_pops(logp, x0, generator(0), n_pops=pops, num_warmup=num_warmup, num_samples=per,
                                   free=free)
        return res.positions.reshape(-1, dim)
    if engine == "chees":
        res = chees.run_chees(logp, x0, generator(0), num_warmup=num_warmup, num_samples=per, free=free,
                              race=race, race_probe=min(128, max(32, num_warmup // 4)))
        return res.positions.reshape(-1, dim)
    if engine == "pt-chees":
        res = pt_chees.run_pt_chees(logp, x0, generator(0), n_ladders=chains, n_replicas=replicas,
                                    num_warmup=num_warmup, num_samples=per, free=free)
        return res.positions.reshape(-1, dim)
    if engine == "ghmc":
        thin = 16  # transitions per kept draw: one leapfrog step each
        res = ghmc.run_ghmc(logp, x0, generator(0), num_warmup=max(num_warmup * 4, 512), num_samples=per * thin,
                            free=free)
        return res.positions[::thin].reshape(-1, dim)
    if engine == "hmc":
        res = hmc.run_hmc(logp, x0, generator(0), num_warmup=num_warmup, num_samples=num_samples // chains, free=free)
        return res.positions.transpose(0, 1).reshape(-1, dim)
    # NUTS keeps its tree state on the host (:func:`on_host`): its per-leaf
    # bookkeeping is some fifty small operations, which cost less there than
    # as launches on a card (PERF.md)
    host = torch.device("cpu")
    res = nuts.run_nuts(on_host(logp, v0.device), x0.to(host), torch.Generator(device=host).manual_seed(seed),
                        num_warmup=num_warmup, num_samples=num_samples // chains, free=free.to(host))
    return res.positions.transpose(0, 1).reshape(-1, dim).to(v0.device)


def on_host(logp, device):
    """``logp`` for a sampler whose state lives on the host: each batch goes
    to ``device``, where ``logp``'s value and gradient are taken, and both
    come back in one copy; the backward hands back that gradient."""
    vg = hmc.value_and_grad(logp, None)

    def host_vg(V):
        val, grad = vg(V.to(device))
        both = torch.cat([val[:, None], grad], 1).cpu()
        return both[:, 0], both[:, 1:]

    return lambda V: _SavedGradLogp.apply(V, host_vg)


def mixture_forecast(gp, observed: Observed, draws, z: np.ndarray, max_draws: int = 256):
    """Mixture mean and std (numpy) at ``z`` over at most ``max_draws``
    evenly spaced draws."""
    draws = torch.as_tensor(draws, device=observed.x.device)
    if draws.shape[0] > max_draws:
        idx = np.linspace(0, draws.shape[0] - 1, max_draws).astype(int)
        draws = draws[torch.as_tensor(idx, device=draws.device)]
    if not observed.latent:
        mu, sigma = predict_mixture(gp, draws, observed.x, observed.y, z, observed.mask)
        return mu.cpu().numpy(), sigma.cpu().numpy()
    zt = torch.as_tensor(z, dtype=draws.dtype, device=draws.device)

    def one(v):
        return predict_from_posterior(gp, gp_posterior(gp, v, mask=observed.mask), zt)

    with torch.no_grad():
        mus, sigmas = torch.func.vmap(one)(draws)
    mu = mus.mean(0)
    var = (sigmas * sigmas + mus * mus).mean(0) - mu * mu
    return mu.cpu().numpy(), torch.sqrt(torch.clamp(var, min=0.0)).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("study", choices=STUDIES)
    ap.add_argument("--engine", default="nuts", choices=ENGINES, help="sampler (default nuts, as in the JAX package)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=8, help="with --engine pt-chees: rungs per ladder")
    ap.add_argument("--pops", type=int, default=1,
                    help="with --engine chees: independent populations of chains/pops chains, each adapting its "
                         "own kernel")
    ap.add_argument("--race", type=int, default=0,
                    help="with --engine chees (pops=1): K-candidate post-warmup trajectory race (0 = off)")
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
