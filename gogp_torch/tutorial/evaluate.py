"""Rolling one-step-out-of-sample forecast driver.

PyTorch-package twin of ``gogp_tpu/tutorial/evaluate.py``, the reference's
``Evaluate`` (tutorial/tutorial.go:56-230) with its protocol:

- Y normalized to zero mean / unit sample-std unless disabled (:78-86);
- for each prefix length ``end`` in 0..N-1: theta re-initialized to
  ``theta0 + 0.1*N(0,1)`` jitter (:119-121), the initial log-density
  recorded, the fit on ``X[:end]`` (skipped while ``end <= minopt``, :127),
  the final log-density recorded, ``X[end]`` forecast;
- output CSV row: ``x..., y_true*std+mean, mu*std+mean, sigma*std, lml0,
  lml, exp(theta)...`` (:185-197);
- optionally a whole-horizon out-of-sample forecast at ``X shifted by
  X[-1]`` from the last fit (:200-225).

Every prefix is the same n x n problem under its own 0/1 mask, so the fits
run as one batch (the JAX twin's ``vmap``): one batched value and gradient of
every prefix per optimizer step (``mle.adam_batched``,
``mle.lbfgs_batched``).  For a theta-only study whose covariances K7 takes
(``ops.fused_gp.takes_kernel``: CUDA, float32, n <= 128) that batch is the K7
route, ``fused_gp.make_fused_value_and_grad`` with one mask per row: every
prefix's L^-1 in one launch.  Otherwise, and always under
``ops.linalg.force_plain()``, it is ``torch.func.vmap`` of ``gp_observe``
plus the priors, differentiated by autograd.  ``batched=False`` fits the
prefixes one by one with ``mle.adam`` / ``mle.lbfgs``.

The jitter comes from a ``torch.Generator`` seeded with ``--seed``, drawn on
the CPU in float64, so a seed gives the same rows on either device (the
JAX twin draws from ``jax.random``; tests hand its draws in through
``draws``).  ``device`` defaults to the CUDA card (float32); the CPU runs in
float64.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import IO, Callable

import numpy as np
import torch

from gogp_torch.gp.core import GP, predict_from_posterior
from gogp_torch.infer import mle
from gogp_torch.models.model import masked_value_and_grad
from gogp_torch.models.params import gp_observe, gp_posterior
from gogp_torch.ops import fused_gp
from gogp_torch.tutorial import io as tio

# Log-density of priors given the parameter vector (chain axis leading) and
# the 0/1 observation mask.
PriorsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class EvalConfig:
    """The reference's flag set (tutorial/tutorial.go:21-45)."""

    alg: str = "lbfgs"  # -a: "lbfgs" | "adam"
    iters: int = 1000  # ITERS (major iterations)
    # MINITERS: an LBFGS stall is tolerated silently unless it happens
    # before this many iterations; then it is logged and the run continues
    # (reference tutorial.go:144-155).
    min_iters: int = 10
    threshold: float = 1e-6  # THRESHOLD (gradient)
    rate: float = 0.01  # RATE (adam)
    minopt: int = 0  # MINOPT: optimize only when n > minopt
    normalize: bool = True  # !NONORMALIZE (-n)
    out_of_sample: bool = False  # OUTOFSAMPLE (-o)
    seed: int = 0
    batched: bool = True  # every prefix fit in one batch, or one by one


@dataclasses.dataclass
class Study:
    """A case study: GP spec, optional priors, optional constraints.

    ``make_priors(X0, Y0)`` closes over the initial (normalized) data.
    ``free_fn(n_theta, n, end)`` returns the study's 0/1 free mask over the
    full parameter vector for prefix length ``end``.  ``optinp``: the inputs
    and outputs are parameters too (the latent-input studies).
    """

    name: str
    gp: GP
    optinp: bool = False
    make_priors: Callable[[np.ndarray, np.ndarray], PriorsFn] | None = None
    free_fn: Callable[[int, int, int], np.ndarray] | None = None


@dataclasses.dataclass
class EvalResult:
    rows: list  # forecast CSV rows (floats)
    v_all: np.ndarray  # (N, P) optimized parameter vectors per prefix
    masks: np.ndarray  # (N, N) observation masks per prefix
    mean_y: float
    std_y: float
    x: np.ndarray  # original inputs (N, d)
    y_norm: np.ndarray  # normalized outputs (N,)
    iters: np.ndarray  # (N,) optimizer iterations per prefix (0: not fitted)
    stalled: np.ndarray  # (N,) whether the prefix's optimizer stalled
    device: torch.device = torch.device("cpu")  # where the fits ran
    dtype: torch.dtype = torch.float64
    v0: np.ndarray | None = None  # (N, P) each prefix's starting parameter vector


def _padding_free(study: Study, n_theta: int, n: int, ndim: int, end: int) -> np.ndarray:
    """Free mask for one prefix: padding beyond ``end`` is always pinned;
    the study's own constraint composes on top."""
    p = n_theta + n * (ndim + 1)
    free = np.ones(p)
    xs, ys = n_theta, n_theta + n * ndim
    free[xs + end * ndim : ys] = 0.0
    free[ys + end :] = 0.0
    if study.free_fn is not None:
        free = free * study.free_fn(n_theta, n, end)
    return free


def prefix_logp(study: Study, x: torch.Tensor, y: torch.Tensor, priors: PriorsFn | None):
    """``logp(v, mask)`` of one prefix: the LML of the observations ``mask``
    keeps (from ``v`` itself for a latent-input study), plus the priors."""
    gp = study.gp

    def logp(v, mask):
        ll = gp_observe(gp, v, mask=mask) if study.optinp else gp_observe(gp, v, x=x, y=y, mask=mask)
        return ll if priors is None else ll + priors(v, mask)

    return logp


def takes_k7(study: Study, x: torch.Tensor) -> bool:
    """Whether the prefix batch takes the K7 route: a theta-only study whose
    n x n covariances ``fused_gp.takes_kernel`` sends to K7."""
    n = x.shape[0]
    return not study.optinp and fused_gp.takes_kernel(x.new_empty(0, n, n))


def batched_value_and_grad(study: Study, x: torch.Tensor, y: torch.Tensor, masks: torch.Tensor,
                           priors: PriorsFn | None):
    """``vg(V) -> (logp, grad)`` of every prefix at once: V (rows, p), one
    mask a row (rows, n).  The K7 route where :func:`takes_k7` says so (one
    K7 launch a call), else the plain route: ``torch.func.vmap`` of
    :func:`prefix_logp`, differentiated by autograd."""
    if takes_k7(study, x):
        return fused_gp.make_fused_value_and_grad(
            study.gp, x, y, masks, None if priors is None else (lambda V: priors(V, masks)))
    logp_rows = torch.func.vmap(prefix_logp(study, x, y, priors))

    def vg(V):
        V = V.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp_rows(V, masks)
            (grad,) = torch.autograd.grad(val.sum(), V, allow_unused=True)
        return val.detach(), torch.zeros_like(V) if grad is None else grad

    return vg


def _forecast_fn(study: Study, x: torch.Tensor, y: torch.Tensor):
    """``forecast(v, mask, z) -> (mu, sigma)`` of one prefix's fit at one
    input ``z`` (ndim,)."""
    gp = study.gp

    def forecast(v, mask, z):
        post = gp_posterior(gp, v, mask=mask) if study.optinp else gp_posterior(gp, v, x=x, y=y, mask=mask)
        mu, sigma = predict_from_posterior(gp, post, z[None, :])
        return mu[0], sigma[0]

    return forecast


def _fit_rows(study: Study, cfg: EvalConfig, x, y, priors, V0, masks, frees) -> mle.OptResult:
    """Every row of V0 fitted under its mask, in one batch."""
    vg = batched_value_and_grad(study, x, y, masks, priors)
    if cfg.alg == "adam":
        def vg_free(V):
            val, grad = vg(V)
            return val, grad * frees

        return mle.adam_batched(vg_free, V0, iters=cfg.iters, rate=cfg.rate, threshold=cfg.threshold)
    return mle.lbfgs_batched(vg, V0, iters=cfg.iters, threshold=cfg.threshold, free=frees)


def _fit_one(study: Study, cfg: EvalConfig, logp, v0, mask, free) -> mle.OptResult:
    """One prefix fitted alone (``--sequential``)."""
    lp = lambda v: logp(v, mask)  # noqa: E731
    if cfg.alg == "adam":
        return mle.adam(masked_value_and_grad(lp, free), v0, iters=cfg.iters, rate=cfg.rate,
                        threshold=cfg.threshold)
    return mle.lbfgs(lp, v0, iters=cfg.iters, threshold=cfg.threshold, free=free)


def jitter_draws(n: int, n_theta: int, seed: int) -> np.ndarray:
    """The (n, n_theta) standard normal draws of the theta jitter: a
    ``torch.Generator`` seeded with ``seed``, on the CPU in float64."""
    return torch.randn((n, n_theta), generator=torch.Generator().manual_seed(seed), dtype=torch.float64).numpy()


def evaluate(
    study: Study,
    x: np.ndarray,
    y: np.ndarray,
    theta0: np.ndarray | None = None,
    config: EvalConfig | None = None,
    wtr: IO[str] | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype | None = None,
    draws: np.ndarray | None = None,
) -> EvalResult:
    """Run the rolling-forecast protocol; optionally stream rows to ``wtr``.

    ``device``: the CUDA card by default, where ``dtype`` defaults to
    float32; on the CPU to float64.  ``draws``: the (N, n_theta) standard
    normal draws of the jitter (default: a ``torch.Generator`` seeded with
    ``config.seed``, on the CPU in float64)."""
    cfg = config or EvalConfig()
    gp = study.gp
    device = torch.device(device)
    dtype = dtype or (torch.float32 if device.type == "cuda" else torch.float64)
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    y = np.asarray(y, dtype=np.float64)
    if x.shape[0] == 0:
        return EvalResult([], np.zeros((0, 0)), np.zeros((0, 0)), 0.0, 1.0, x, y,
                          np.zeros(0, np.int64), np.zeros(0, bool), device, dtype)
    if x.shape[1] != gp.ndim:
        x = x.reshape(-1, gp.ndim)
    n, ndim = x.shape
    n_theta = gp.n_theta
    theta0 = np.zeros(n_theta) if theta0 is None else np.asarray(theta0, dtype=np.float64)

    if cfg.normalize:
        y_norm, mean_y, std_y = tio.normalize(y)
    else:
        y_norm, mean_y, std_y = y, 0.0, 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    xt, yt = t(x), t(y_norm)

    # theta jitter per prefix (tutorial.go:119-121), explicit seed
    if draws is None:
        draws = jitter_draws(n, n_theta, cfg.seed)
    theta_init = theta0[None, :] + 0.1 * np.asarray(draws, dtype=np.float64)

    # prefix masks: row e has ones at 0..e-1
    masks_np = (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(np.float64)
    masks = t(masks_np)

    priors = study.make_priors(x, y_norm) if study.make_priors else None

    if study.optinp:
        data = np.concatenate([x.reshape(-1), y_norm])
        V0 = t(np.concatenate([theta_init, np.broadcast_to(data, (n, data.shape[0]))], axis=1))
        frees = t(np.stack([_padding_free(study, n_theta, n, ndim, e) for e in range(n)]))
    else:
        V0 = t(theta_init)
        frees = torch.ones((n, n_theta), dtype=dtype, device=device)
        if study.free_fn is not None:
            frees = t(np.stack([study.free_fn(n_theta, n, e)[:n_theta] for e in range(n)]))

    logp = prefix_logp(study, xt, yt, priors)
    forecast = _forecast_fn(study, xt, yt)
    # MINOPT rows (reference tutorial.go:127): no optimization at all,
    # partitioned out of the batched fit rather than masked inside it
    opt_idx = np.flatnonzero(np.arange(n) > cfg.minopt)

    tio.progress("Forecasting...")
    V = V0.clone()
    iters = np.zeros(n, np.int64)
    stalled = np.zeros(n, bool)
    if cfg.batched:
        if opt_idx.size:
            rows = torch.as_tensor(opt_idx, device=device)
            res = _fit_rows(study, cfg, xt, yt, priors, V0[rows], masks[rows], frees[rows])
            V[rows] = res.x
            iters[opt_idx] = res.iters.cpu().numpy()
            stalled[opt_idx] = res.stalled.cpu().numpy()
        with torch.no_grad():
            lml0_all = torch.func.vmap(logp)(V0, masks)
            lml_all = torch.func.vmap(logp)(V, masks)
            mu_all, sigma_all = torch.func.vmap(forecast)(V, masks, xt)
    else:
        out = []
        for e in range(n):
            if e in opt_idx:
                res = _fit_one(study, cfg, logp, V0[e], masks[e], frees[e])
                V[e], iters[e], stalled[e] = res.x, res.iters, res.stalled
            with torch.no_grad():
                out.append((logp(V0[e], masks[e]), logp(V[e], masks[e]), *forecast(V[e], masks[e], xt[e])))
        lml0_all, lml_all, mu_all, sigma_all = (torch.stack(col) for col in zip(*out))

    # MINITERS stall reporting (reference tutorial.go:144-155): a stalled
    # optimizer is tolerated, but a stall before min_iters is logged; the
    # run always continues with whatever point the optimizer reached.
    for e in np.flatnonzero(stalled & (iters < cfg.min_iters)):
        tio.progress(f"{e}: optimization stuck after {int(iters[e])} iterations (< {cfg.min_iters})")

    v0_all, v_all, lml0_all, lml_all, mu_all, sigma_all = (
        a.detach().cpu().double().numpy() for a in (V0, V, lml0_all, lml_all, mu_all, sigma_all))

    rows = []
    for e in range(n):
        row = list(x[e])
        row += [y_norm[e] * std_y + mean_y, mu_all[e] * std_y + mean_y, sigma_all[e] * std_y, lml0_all[e], lml_all[e]]
        row += list(np.exp(v_all[e, :n_theta]))
        rows.append(row)

    if wtr is not None:
        tio.write_forecast_rows(wtr, rows)

    result = EvalResult(rows, v_all, masks_np, mean_y, std_y, x, y_norm, iters, stalled, device, dtype, v0_all)

    if cfg.out_of_sample and n > 1:
        oos_rows = out_of_sample_rows(study, result)
        result.rows.extend(oos_rows)
        if wtr is not None:
            tio.write_forecast_rows(wtr, oos_rows)

    tio.progress("done")
    return result


def last_posterior(study: Study, result: EvalResult):
    """The posterior of the last prefix's fit, on the device it ran on."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=result.dtype, device=result.device)

    v, mask = t(result.v_all[-1]), t(result.masks[-1])
    if study.optinp:
        return gp_posterior(study.gp, v, mask=mask)
    return gp_posterior(study.gp, v, x=t(result.x), y=t(result.y_norm), mask=mask)


def out_of_sample_rows(study: Study, result: EvalResult) -> list:
    """Whole-horizon forecast at X shifted by X[-1], from the last prefix fit
    (reference tutorial.go:200-225).  Row: ``z..., nan, mu, sigma``."""
    x = result.x
    z = (x + x[-1])[1:]
    post = last_posterior(study, result)
    with torch.no_grad():
        mu, sigma = predict_from_posterior(study.gp, post, torch.as_tensor(z, dtype=result.dtype, device=result.device))
    mu = mu.cpu().double().numpy() * result.std_y + result.mean_y
    sigma = sigma.cpu().double().numpy() * result.std_y
    return [list(z[i]) + [float("nan"), mu[i], sigma[i]] for i in range(z.shape[0])]


def run_cli(
    study_factory: Callable[..., Study],
    selfcheck_data: str,
    description: str,
    extra_flags: Callable | None = None,
    argv: list[str] | None = None,
    wtr: IO[str] | None = None,
):
    """Shared CLI for the case studies: the reference's flags
    (tutorial.go:35-45) plus ``--seed``, ``--iters``, ``--rate``,
    ``--sequential`` and ``--platform`` (cuda, the default, in float32; cpu
    in float64)."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-a", default="lbfgs", choices=["lbfgs", "adam"], help="optimization algorithm")
    ap.add_argument("-p", action="store_true",
                    help="(accepted for reference CLI parity; batching is always on, see --sequential)")
    ap.add_argument("-n", action="store_true", help="do not normalize outputs")
    ap.add_argument("-o", action="store_true", help="forecast out of sample")
    ap.add_argument("--seed", type=int, default=0, help="seed of the theta jitter")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=0.01)
    ap.add_argument("--sequential", action="store_true", help="fit the prefixes one by one instead of in one batch")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (float32, the default) or cpu (float64)")
    if extra_flags is not None:
        extra_flags(ap)
    ap.add_argument("mode", nargs="?", default=None, help="'selfcheck' to use embedded data")
    # intermixed: the optional positional ``mode`` may follow the options on
    # every Python 3 release (plain parse_args loses it on some)
    args = ap.parse_intermixed_args(argv)
    device = tio.device_for(args.platform)

    tio.progress("loading...", end="")
    if args.mode == "selfcheck":
        x, y = tio.load_csv(selfcheck_data)
    elif args.mode is None:
        x, y = tio.load_csv(sys.stdin)
    else:
        raise SystemExit(f"usage: unknown mode {args.mode!r}")
    tio.progress("done")

    cfg = EvalConfig(
        alg=args.a,
        iters=args.iters,
        rate=args.rate,
        normalize=not args.n,
        out_of_sample=args.o,
        seed=args.seed,
        batched=not args.sequential,
    )
    study = study_factory(args) if extra_flags is not None else study_factory()
    result = evaluate(study, x, y, config=cfg, wtr=sys.stdout if wtr is None else wtr, device=device)
    return args, cfg, study, result
