"""Maximum-likelihood / MAP optimization of log-densities.

PyTorch twin of ``gogp_tpu/infer/mle.py``: Adam and LBFGS *maximizing*
``logp``, stopping when every |grad_i| < threshold or after ``iters`` major
iterations.

The JAX twin runs each optimization as one ``lax.while_loop``.  Here each
runs as a Python loop on the host, with one host read of the largest
gradient entry per step: that read is the counterpart of the while_loop's
``cond``.  Capturing the loop in a CUDA graph is later work.  Batched fits
(the JAX twin's vmap over prefix fits) are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor

DEFAULT_ITERS = 1000
DEFAULT_THRESHOLD = 1e-6
DEFAULT_RATE = 0.01
_MAX_LINE_SEARCH = 25  # function evaluations per LBFGS line search


class OptResult(NamedTuple):
    x: Tensor  # optimized parameter vector
    value: Tensor  # logp at the last point whose gradient was taken
    iters: int  # iterations actually taken
    converged: bool  # True if the gradient threshold was hit
    # True if the run stopped without converging: Adam met a non-finite value
    # or gradient, or an LBFGS step was exactly zero (a failed line search)
    stalled: bool


def adam(
    value_and_grad_logp: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    rate: float = DEFAULT_RATE,
    threshold: float = DEFAULT_THRESHOLD,
) -> OptResult:
    """Adam ascent on ``logp``, in optax's arithmetic: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected moments.

    ``value_and_grad_logp`` may carry a gradient mask
    (``gogp_torch.models.masked_value_and_grad``) to pin coordinates.  As in
    the JAX twin's driver: the step whose gradient falls below the threshold
    still applies its update; a non-finite value or gradient zeroes that
    step's update, keeps the last finite value, ends the run (unless the
    threshold is 0) and sets ``stalled``."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    x = torch.as_tensor(x0).detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    value = torch.zeros((), dtype=x.dtype, device=x.device)  # -logp, last finite
    bad = torch.zeros((), dtype=torch.bool, device=x.device)
    step, gmax = 0, math.inf
    while step < iters and gmax >= threshold:
        v, g = value_and_grad_logp(x)
        v, g = -v, -g  # minimize -logp
        finite = torch.isfinite(v) & torch.isfinite(g).all()
        g = torch.where(finite, g, 0.0)
        value = torch.where(finite, v, value)
        step += 1
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        mu_hat, nu_hat = mu / (1 - b1**step), nu / (1 - b2**step)
        update = -rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
        x = x + torch.where(finite, update, 0.0)
        bad = bad | ~finite
        gmax = float(torch.where(finite, g.abs().max(), 0.0)) if g.numel() else 0.0
    failed = bool(bad)
    return OptResult(x, -value, step, gmax < threshold and not failed, failed)


def lbfgs(
    logp: Callable[[Tensor], Tensor],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    threshold: float = DEFAULT_THRESHOLD,
    memory_size: int = 15,
    free: Tensor | None = None,
) -> OptResult:
    """LBFGS ascent on ``logp`` with a strong-Wolfe line search.

    ``torch.optim.LBFGS(history_size=memory_size, line_search_fn=
    "strong_wolfe")`` driven one major iteration per step (``max_iter=1``,
    up to 25 line-search evaluations, its own stopping tolerances off).
    The JAX twin takes optax's LBFGS with a zoom line search, so the two
    reach the same optimum by different trajectories.  ``free`` is an optional 0/1 mask applied to the gradient
    before the update, so pinned coordinates keep their initialization.  A
    step of exactly zero while the gradient is above the threshold is a
    stall (a failed line search) and ends the run.  Besides the one read of
    the gradient per step, the line search reads each trial value on the
    host."""
    x = torch.as_tensor(x0).detach().clone().requires_grad_(True)
    mask = None if free is None else torch.as_tensor(free, dtype=x.dtype, device=x.device)
    opt = torch.optim.LBFGS(
        [x], lr=1.0, max_iter=1, history_size=memory_size,
        # the line search may take max_eval minus the step's first evaluation:
        # 25, _strong_wolfe's own default (max_iter=1 alone would leave it 0)
        max_eval=1 + _MAX_LINE_SEARCH,
        tolerance_grad=0.0, tolerance_change=0.0, line_search_fn="strong_wolfe",
    )
    evals = []

    def closure():
        neg = -logp(x)
        (g,) = torch.autograd.grad(neg, x) if neg.requires_grad else (torch.zeros_like(x),)
        if mask is not None:
            g = g * mask
        x.grad = g
        evals.append((neg.detach(), g))
        return neg.detach()

    value = torch.zeros((), dtype=x.dtype, device=x.device)
    step, gmax, stalled = 0, math.inf, False
    while step < iters and gmax >= threshold and not stalled:
        before = x.detach().clone()
        del evals[:]
        opt.step(closure)
        value, g = evals[0]  # at the step's starting point
        step += 1
        if x.numel():
            gmax, moved = torch.stack([g.abs().max(), (x.detach() - before).abs().max()]).tolist()
            stalled = moved <= 0.0
        else:
            gmax = 0.0
    converged = gmax < threshold
    return OptResult(x.detach(), -value, step, converged, stalled and not converged)
