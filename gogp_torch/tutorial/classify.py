"""Case study: GP binary classification.

PyTorch-package twin of ``gogp_tpu/tutorial/classify.py``: the classification
counterpart of the rolling forecast.  For every prefix length ``end``, the
hyperparameters start from seeded jitter, are fitted by Adam ascent of an
approximate log marginal likelihood (Laplace or EP, ``-e``), and the study
emits the one-step-ahead class probability p(y=1 | x_end).  The whole rolling
loop is one batch over prefix masks: every fit, every Newton or EP loop and
every ESS chain of all prefixes runs in lockstep.  Prefixes at or below
MINOPT are not fitted; only the others enter ``mle.adam_batched``, as the
JAX twin's per-row ``iters`` of 0 leaves them.

Engines: ``laplace`` and ``ep`` predict from their Gaussian approximations;
``ess`` fits by the Laplace marginal and predicts from elliptical-slice
draws of the exact latent posterior (``infer.elliptical``).

Output CSV row: x..., y_true, p_hat, lml0, lml, exp(theta)..., where
lml0 and lml are the approximate log marginal likelihood before and after
the fit.

Run:  python -m gogp_torch.tutorial.classify [-e laplace|ep|ess] [--probit] --seed 0 selfcheck
      (cuda in float32 by default; --platform cpu runs float64 on the CPU)
"""

from __future__ import annotations

import sys
from importlib import resources
from typing import IO

import numpy as np
import torch

from gogp_torch.gp import ep as ep_mod
from gogp_torch.gp import laplace as lap_mod
from gogp_torch.gp import likelihoods
from gogp_torch.gp.core import GP
from gogp_torch.infer import elliptical as ess_mod
from gogp_torch.infer import mle
from gogp_torch.kernels import rbf
from gogp_torch.tutorial import io as tio

MINOPT = 8  # the rolling forecast's MINOPT: no fit at or below it

ENGINES = ("laplace", "ep", "ess")


def make_gp() -> GP:
    # amplitude + lengthscale RBF on the latent; jitter-only noise (the
    # observation model is the likelihood)
    return GP(ndim=1, simil=rbf.scaled())


def evaluate_classify(gp: GP, lik, x, y, engine: str = "laplace", seed: int = 0, iters: int = 200,
                      rate: float = 0.05, minopt: int = MINOPT, theta0: np.ndarray | None = None,
                      ess_chains: int = 4, ess_warmup: int = 200, ess_samples: int = 200,
                      device: str | torch.device = "cuda", dtype: torch.dtype | None = None, ess_draws=None):
    """Rolling one-step-ahead class-probability evaluation, batched over the
    prefixes.  Returns CSV rows [x..., y_true, p_hat, lml0, lml,
    exp(theta)...].  ``device``: the CUDA card by default, where ``dtype``
    defaults to float32; on the CPU to float64.  The jitter of the starting
    thetas comes from numpy's ``default_rng(seed)``, as in the JAX twin;
    ``ess_draws`` is the ESS draws hook (``infer.elliptical``), by default a
    generator seeded ``seed`` on ``device``."""
    device = torch.device(device)
    dtype = dtype or (torch.float32 if device.type == "cuda" else torch.float64)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (laplace|ep|ess)")
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    if x.shape[0] == 1 and x.shape[1] > 1 and gp.ndim == 1:
        x = x.T
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n = x.shape[0]
    n_params = gp.n_theta + lik.n_theta
    rng = np.random.default_rng(seed)
    v00 = np.zeros(n_params) if theta0 is None else np.log(np.asarray(theta0))
    v0s = v00[None, :] + 0.1 * rng.normal(size=(n, n_params))
    masks_np = (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(np.float64)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    X, Y, V0, masks = t(x), t(y), t(v0s), t(masks_np)
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise
    lml_fn = ep_mod.ep_lml if engine == "ep" else lap_mod.laplace_lml

    def split(V):
        theta = torch.exp(V)
        return theta[:, :nts], theta[:, nts : nts + ntn], theta[:, nts + ntn :]

    def logp(V, M):
        ts, tn, tl = split(V)
        return lml_fn(gp, lik, ts, tl, X, Y, theta_noise=tn, mask=M)

    fit = torch.as_tensor(np.arange(n) > minopt, device=device)
    M_fit = masks[fit]

    def value_and_grad(V):
        V = V.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp(V, M_fit)
            (grad,) = torch.autograd.grad(val.sum(), V)
        return val.detach(), grad

    with torch.no_grad():
        lml0s = logp(V0, masks)
    vs = V0.clone()
    if bool(fit.any()) and iters > 0:
        vs[fit] = mle.adam_batched(value_and_grad, V0[fit], iters=iters, rate=rate).x
    with torch.no_grad():
        lmls = logp(vs, masks)
        ts, tn, tl = split(vs)
        z = X[:, None, :]  # each prefix predicts at its own next input
        if engine == "ess":
            if ess_draws is None:
                gen = torch.Generator(device=device).manual_seed(seed)
                ess_draws = ess_mod.generator_draws(gen)
            res = ess_mod.run_ess_gp(gp, lik, ts, tl, X, Y, ess_draws, theta_noise=tn, mask=masks,
                                     num_chains=ess_chains, num_warmup=ess_warmup, num_samples=ess_samples)
            probs = ess_mod.ess_predict_prob(gp, lik, res, z)[:, 0]
        elif engine == "ep":
            post = ep_mod.ep_fit(gp, lik, ts, tl, X, Y, theta_noise=tn, mask=masks)
            probs = ep_mod.ep_predict_prob(gp, lik, post, z)[:, 0]
        else:
            post = lap_mod.laplace_fit(gp, lik, ts, tl, X, Y, theta_noise=tn, mask=masks)
            probs = lap_mod.laplace_predict_prob(gp, lik, post, z)[:, 0]

    def host(a):
        return a.detach().cpu().double().numpy()

    vs_np, p_np, l0_np, l_np = host(vs), host(probs), host(lml0s), host(lmls)
    return [[*x[end], y[end], p_np[end], l0_np[end], l_np[end], *np.exp(vs_np[end])] for end in range(n)]


def selfcheck_data() -> str:
    return resources.files("gogp_torch.tutorial").joinpath("data/classify.csv").read_text()


def main(argv=None, wtr: IO[str] | None = None):
    import argparse

    ap = argparse.ArgumentParser(description="GP binary classification (Laplace/EP/ESS) rolling evaluation.")
    ap.add_argument("-e", "--engine", default="laplace", choices=list(ENGINES))
    ap.add_argument("-a", default="adam", choices=["adam"], help="(reference CLI shape; classification uses adam)")
    ap.add_argument("--probit", action="store_true", help="probit link instead of logit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (float32, the default) or cpu (float64)")
    ap.add_argument("mode", nargs="?", default=None)
    args = ap.parse_intermixed_args(argv)
    device = tio.device_for(args.platform)

    tio.progress("loading...", end="")
    if args.mode == "selfcheck":
        x, y = tio.load_csv(selfcheck_data())
    elif args.mode is None:
        x, y = tio.load_csv(sys.stdin)
    else:
        raise SystemExit(f"usage: unknown mode {args.mode!r}")
    tio.progress("done")

    lik = likelihoods.bernoulli_probit if args.probit else likelihoods.bernoulli_logit
    tio.progress("Classifying...")
    rows = evaluate_classify(make_gp(), lik, x, y, engine=args.engine, seed=args.seed, iters=args.iters,
                             rate=args.rate, device=device)
    tio.write_forecast_rows(wtr or sys.stdout, rows)
    tio.progress("done")
    return rows


if __name__ == "__main__":
    main()
