"""Bayesian optimization on the GP stack: serve + stream, zero refits.

PyTorch twin of ``gogp_tpu/bo.py``.  BO composes from pieces the port
already has, with no refit anywhere:

- acquisition over a candidate grid is one batched predict
  (``gp.core.predict_from_posterior``: one blocked TRSM, K5 for its tile
  inverses, on the card in f32 at a capacity n >= 1024);
- exact Thompson sampling is one joint draw over the grid (the m x m
  posterior covariance factored by ``torch.linalg``, as the JAX twin's
  ``jnp.linalg.cholesky``); pathwise Thompson is a random-feature +
  Matheron function (``gp.pathwise``, O(m (F + n)));
- absorbing an observation is ``gp.streaming.absorb_append``, O(n^2 b);
- the optimize loop is a Python loop over a fixed-capacity posterior and a
  fixed candidate grid (the JAX twin's ``lax.scan``).

Hyperparameters stay fixed during a run (the streaming contract).  Random
numbers come from a ``gp.pathwise.PathDraws`` (or a ``torch.Generator``) in
the JAX twin's key's place, split as the key is split.

Convention: MAXIMIZATION (flip the sign of a loss to minimize).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.gp import pathwise
from gogp_torch.gp.core import GP, Posterior, _like, _points, predict_from_posterior
from gogp_torch.gp.streaming import absorb_append, streaming_posterior
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def _norm_pdf(z):
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


def expected_improvement(mu: Tensor, sigma: Tensor, best, xi: float = 0.0) -> Tensor:
    """EI for maximization: E[max(f - best - xi, 0)] under N(mu, sigma^2).
    Zero-variance points (already-observed candidates) get EI = 0; the guard
    also keeps the gradient finite there."""
    pos = sigma > 0.0
    safe = torch.where(pos, sigma, torch.ones_like(sigma))
    z = (mu - best - xi) / safe
    ei = (mu - best - xi) * _norm_cdf(z) + safe * _norm_pdf(z)
    return torch.where(pos, torch.clamp(ei, min=0.0), torch.zeros_like(ei))


def upper_confidence_bound(mu: Tensor, sigma: Tensor, beta: float = 2.0) -> Tensor:
    """UCB for maximization: mu + beta * sigma."""
    return mu + beta * sigma


class BOState(NamedTuple):
    """Everything a BO run carries: the streaming posterior + incumbents."""

    post: Posterior
    best_x: Tensor  # (ndim,)
    best_y: Tensor  # ()


def bo_init(gp: GP, theta_simil, theta_noise, capacity: int, dtype=torch.float32, device=None) -> BOState:
    """An empty state of ``capacity`` slots.  ``device``: that of
    ``theta_simil`` when it is a tensor, else the CUDA card."""
    post = streaming_posterior(gp, theta_simil, theta_noise, capacity, dtype, device)
    return BOState(post, post.x.new_zeros(gp.ndim), torch.tensor(-torch.inf, dtype=dtype, device=post.x.device))


def acquire(gp: GP, state: BOState, candidates, kind: str = "ei", key=None, xi: float = 0.0,
            beta: float = 2.0) -> tuple[Tensor, Tensor]:
    """Score the candidate grid and return (argmax index, scores); the
    first maximum on ties.

    ``kind``: "ei" | "ucb" | "thompson" | "thompson-path".  "thompson"
    draws ONE joint sample over the candidates from ``key`` (a
    ``PathDraws`` or ``torch.Generator``; O(m^3), the m x m factor by
    ``torch.linalg``, NaN scores where it fails, as in the JAX twin);
    "thompson-path" draws it as a pathwise function, O(m (F + n)).  With no
    observations EI/UCB score the prior and Thompson draws from it."""
    post = state.post
    candidates = _points(_like(candidates, post.x))
    mu, sigma = predict_from_posterior(gp, post, candidates)
    if kind == "ei":
        scores = expected_improvement(mu, sigma, state.best_y, xi)
    elif kind == "ucb":
        scores = upper_confidence_bound(mu, sigma, beta)
    elif kind == "thompson":
        if key is None:
            raise ValueError("thompson acquisition needs a PRNG key")
        kzz = gp.simil.matrix(post.theta_simil, candidates, candidates)
        kstar = gp.simil.matrix(post.theta_simil, post.x, candidates) * post.mask[:, None]
        v = linalg.trsm_lower(post.chol, kstar)
        cov = kzz - v.T @ v
        m = candidates.shape[0]
        scale = torch.diagonal(cov).mean() + 1.0
        chol = cb.plain_cholesky(cov + (1e-8 * scale) * torch.eye(m, dtype=cov.dtype, device=cov.device))
        scores = mu + chol @ pathwise.as_draws(key, mu).normal((m,), mu)
    elif kind == "thompson-path":
        if key is None:
            raise ValueError("thompson-path acquisition needs a PRNG key")
        scores = thompson_path_scores(gp, state, candidates, key)
    else:
        raise ValueError(f"unknown acquisition {kind!r}")
    return torch.argmax(scores), scores


def thompson_path_scores(gp: GP, state: BOState, candidates, key, num_features: int = 512) -> Tensor:
    """One pathwise posterior draw evaluated on the candidates: Thompson
    scores in O(m (F + n)).  The draw is a coherent function, so the same
    draws score ANY candidate set consistently."""
    ps = pathwise.sample_paths(gp, state.post, key, 1, num_features)
    return pathwise.eval_paths(gp, ps, candidates)[0]


def thompson_path_optimize(gp: GP, state: BOState, key, bounds: tuple, num_restarts: int = 8, steps: int = 100,
                           lr: float = 0.05, num_features: int = 512) -> tuple[Tensor, Tensor]:
    """CONTINUOUS-domain Thompson: draw one pathwise posterior sample and
    maximize it by multi-start gradient ascent, every restart in lockstep as
    one (restarts, ndim) tensor differentiated by autograd, each step
    clipped to the box ``bounds`` = (lo, hi) of shape (ndim,).  Returns
    (x (ndim,), value)."""
    ref = state.post.x
    lo = torch.broadcast_to(_like(bounds[0], ref), (gp.ndim,))
    hi = torch.broadcast_to(_like(bounds[1], ref), (gp.ndim,))
    kp, k0 = pathwise.as_draws(key, ref).split(2)
    ps = pathwise.sample_paths(gp, state.post, kp, 1, num_features)

    def f(X):  # (restarts, ndim) -> (restarts,): each row's own value
        return pathwise.eval_paths(gp, ps, X)[0]

    X = lo + (hi - lo) * k0.uniform((num_restarts, gp.ndim), ref)
    scale = lr * (hi - lo)
    for _ in range(steps):
        Xg = X.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(f(Xg).sum(), Xg)
        X = torch.clamp(X + scale * g, lo, hi)
    vals = f(X)
    i = torch.argmax(vals)
    return X[i], vals[i]


def acquire_batch_thompson(gp: GP, state: BOState, candidates, key, q: int,
                           num_features: int = 512) -> tuple[Tensor, Tensor]:
    """Pick ``q`` candidates to evaluate IN PARALLEL by batch Thompson
    sampling: q independent pathwise posterior draws, each proposing its own
    argmax, a candidate already taken by an earlier draw falling through to
    that draw's best unclaimed one.  Returns (indices (q,), scores (q, m))."""
    candidates = _points(_like(candidates, state.post.x))
    ps = pathwise.sample_paths(gp, state.post, key, q, num_features)
    scores = pathwise.eval_paths(gp, ps, candidates)  # (q, m)
    taken = torch.zeros(candidates.shape[0], dtype=torch.bool, device=scores.device)
    idx = []
    for s in scores:
        i = torch.argmax(torch.where(taken, -torch.inf, s))
        taken.index_fill_(0, i.reshape(1), True)
        idx.append(i)
    return torch.stack(idx), scores


def bo_update(gp: GP, state: BOState, x_new, y_new) -> BOState:
    """Absorb one (or a batch of) new observation(s); track the incumbent.
    A 1-D ``x_new`` is a batch of 1-D points when the GP is 1-D and its
    length is not 1, else one point, as in the JAX twin."""
    post = state.post
    x_new = _like(x_new, post.x)
    if x_new.dim() == 1:
        x_new = x_new[:, None] if gp.ndim == 1 and x_new.shape[0] != gp.ndim else x_new[None, :]
    y_new = torch.atleast_1d(_like(y_new, post.y))
    post = absorb_append(gp, post, x_new, y_new)
    i = torch.argmax(y_new)
    better = y_new[i] > state.best_y
    return BOState(post, torch.where(better, x_new[i], state.best_x), torch.where(better, y_new[i], state.best_y))


def bo_run(gp: GP, theta_simil, theta_noise, objective: Callable[[Tensor], Tensor], candidates, num_iters: int,
           key, kind: str = "ei", n_init: int = 2, xi: float = 0.0, beta: float = 2.0) -> tuple[BOState, Tensor]:
    """Run BO against an objective ``objective(x (ndim,)) -> scalar``
    (maximized; the ``n_init`` start points go through
    ``torch.func.vmap(objective)``) over a fixed candidate grid, in the
    grid's dtype and on its device.  ``n_init`` random grid points seed the
    posterior.  Returns (final state, (num_iters,) chosen ys)."""
    candidates = _points(torch.as_tensor(candidates))
    state = bo_init(gp, theta_simil, theta_noise, n_init + num_iters, candidates.dtype, candidates.device)
    key, sub = pathwise.as_draws(key, candidates).split(2)
    x0 = candidates[sub.choice(candidates.shape[0], n_init, candidates)]
    state = bo_update(gp, state, x0, torch.func.vmap(objective)(x0))
    ys = []
    for k in key.split(num_iters):
        idx, _ = acquire(gp, state, candidates, kind, k, xi, beta)
        x = candidates[idx]
        y = objective(x)
        state = bo_update(gp, state, x[None, :], y[None])
        ys.append(y)
    return state, torch.stack(ys) if ys else candidates.new_zeros(0)


__all__ = [
    "BOState",
    "acquire",
    "acquire_batch_thompson",
    "bo_init",
    "bo_run",
    "bo_update",
    "expected_improvement",
    "thompson_path_optimize",
    "thompson_path_scores",
    "upper_confidence_bound",
]
