"""Laplace approximation for latent-GP models with non-Gaussian likelihoods.

PyTorch twin of ``gogp_tpu/gp/laplace.py``: f ~ GP(0, K_theta),
y_i ~ p(y_i | f_i, theta_lik) with a :class:`~gogp_torch.gp.likelihoods.Likelihood`
(classification, counts, heavy-tailed regression).  The math is GPML ch. 3:
the latent posterior is approximated at its mode f_hat by a Gaussian of
precision K^{-1} + W, W = -(d^2/df^2) log p(y|f) >= 0 (clipped for
non-log-concave likelihoods), and every solve goes through the
well-conditioned B = I + W^0.5 K W^0.5 (GPML Alg. 3.1/3.2), whose Cholesky
runs through ``linalg.cholesky`` (K1 at 1024 <= n <= 4096 on the card).

- The Newton mode search runs on the host, one read per iteration (whether
  any row is still moving), with the JAX twin's 11-point step grid and its
  tolerance on the change of the objective psi; the posterior reports the
  iterations taken.  psi is of order n, so in f32 its change meets
  ``tol = 1e-9`` only by reaching 0, once the iterate stops moving: 7
  iterations at n = 4096 on the card against 6 in f64 (PERF.md).
- Hyperparameter gradients use the exact-Newton implicit trick: the Newton
  map has zero Jacobian in f at the mode, so one differentiable Newton step
  from ``f_hat.detach()`` gives the exact implicit derivative (the JAX
  twin's ``stop_gradient``), through ``linalg.cholesky``'s pullback.
- Batches: every function takes theta vectors with a leading rows axis
  (rows, n_theta) and masks (rows, n) beside shared x and y, and then runs
  every row in lockstep, a row that has met its tolerance frozen while the
  others go on, as ``jax.vmap`` of the twin's ``while_loop`` runs it.  The
  classify study batches its prefixes so; one-vs-rest batches its classes.
  A batch of covariances factors with ``torch.linalg`` (the kernels take
  one matrix).
- Padding as in ``gp.core``: padded rows have W = 0, f = 0 and identity rows
  in K and B.

``precision`` (default ``linalg.ACCURATE_PRECISION``) sets the K matvecs,
B's blocked Cholesky and the serving inversion.  Predictive bands are for
the noise-free latent f.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from gogp_torch.gp.core import GP, _like, _points, masked_cov
from gogp_torch.gp.likelihoods import Likelihood, bernoulli_probit
from gogp_torch.gp.serve import ServingPosterior, serve_predict
from gogp_torch.ops import linalg

Tensor = torch.Tensor

# The Newton line search's step grid (the JAX twin's).
_STEPS = (1.0, 0.7, 0.5, 0.35, 0.25, 0.125, 0.0625, 0.03125, 0.01, 0.003, 0.001)


def _safe_sqrt(w: Tensor) -> Tensor:
    """sqrt with a zero (not NaN) gradient at w == 0 (padded rows)."""
    pos = w > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, w, torch.ones_like(w))), torch.zeros_like(w))


class LaplacePosterior(NamedTuple):
    """Fitted Laplace state: everything prediction needs.  Leading rows
    axes on every field where the fit was batched."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    theta_lik: Tensor  # (lik.n_theta,) natural scale
    x: Tensor  # (n, ndim)
    y: Tensor  # (n,) observations
    f_hat: Tensor  # (n,) latent posterior mode
    grad_ll: Tensor  # (n,) d log p(y|f)/df at f_hat == K^{-1} f_hat
    sqrt_w: Tensor  # (n,) W^0.5 at f_hat
    chol_b: Tensor  # (n, n) lower Cholesky of B = I + W^0.5 K W^0.5
    mask: Tensor  # (n,) 1.0 real / 0.0 padding
    iters: Tensor | None = None  # () Newton iterations taken (not in the JAX twin's state)


def _rows(t: Tensor, k: int) -> Tensor:
    """A theta vector (k,) or a rows batch of them (..., k)."""
    return t.reshape(k) if t.dim() <= 1 else t


def _prep(gp: GP, lik: Likelihood, theta_simil, theta_noise, theta_lik, x, y, mask):
    x = _points(x)
    y = _like(y, x)
    ts = _rows(_like(theta_simil, x), gp.n_theta_simil)
    tn = _rows(_like(theta_noise, x), gp.n_theta_noise)
    tl = _rows(_like(theta_lik, x), lik.n_theta)
    mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if mask is None else _like(mask, x)
    return x, y, ts, tn, tl, mask


def _zeros_noise(gp: GP, theta_noise):
    """The default theta_noise: zeros (the noise kernel's jitter alone)."""
    return [0.0] * gp.n_theta_noise if theta_noise is None else theta_noise


def _cov(gp: GP, ts: Tensor, tn: Tensor, x: Tensor, mask: Tensor) -> Tensor:
    """masked_cov of one problem, or of each row where a theta or the mask
    has a rows axis."""
    if ts.dim() == 1 and tn.dim() == 1 and mask.dim() == 1:
        return masked_cov(gp, ts, tn, x, mask)
    rows = torch.broadcast_shapes(ts.shape[:-1], tn.shape[:-1], mask.shape[:-1])
    r = math.prod(rows)
    ts, tn, mask = (t.expand(rows + t.shape[-1:]).reshape((r,) + t.shape[-1:]) for t in (ts, tn, mask))
    K = torch.func.vmap(lambda a, b, m: masked_cov(gp, a, b, x, m))(ts, tn, mask)
    return K.reshape(rows + K.shape[-2:])


def _cross(gp: GP, ts: Tensor, x: Tensor, z: Tensor) -> Tensor:
    """k(x, z) (n, m), per row where ts (rows, k) or z (rows, m, ndim) has
    a rows axis."""
    if ts.dim() == 1 and z.dim() == 2:
        return gp.simil.matrix(ts, x, z)
    return torch.func.vmap(gp.simil.matrix, in_dims=(0 if ts.dim() > 1 else None, None, 0 if z.dim() > 2 else None))(
        ts, x, z)


def _prior(gp: GP, ts: Tensor, z: Tensor) -> Tensor:
    """k(z, z) diagonal, per row as in :func:`_cross`."""
    if ts.dim() == 1 and z.dim() == 2:
        return gp.simil.diag_matrix(ts, z)
    return torch.func.vmap(gp.simil.diag_matrix, in_dims=(0 if ts.dim() > 1 else None, 0 if z.dim() > 2 else None))(
        ts, z)


def _test_points(gp: GP, z, ref: Tensor) -> Tensor:
    """Test inputs as (m, ndim), or (rows, m, ndim) as given."""
    z = _like(z, ref)
    if z.dim() <= 1 or z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    return z


def _mv(K: Tensor, b: Tensor) -> Tensor:
    """K @ b over any batch axes."""
    return (K @ b[..., None])[..., 0]


def _b_matrix(K: Tensor, sw: Tensor) -> Tensor:
    """B = I + sW K sW: 1 + sw^2 diag(K) on the diagonal."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=K.device)
    diag = 1.0 + sw * sw * torch.diagonal(K, dim1=-2, dim2=-1)
    return torch.where(eye, torch.diag_embed(diag), sw[..., :, None] * K * sw[..., None, :])


def _newton_step(lik: Likelihood, tl, K: Tensor, f: Tensor, y: Tensor, mask: Tensor,
                 precision: str | None = None):
    """One exact Newton step of the mode search (GPML Alg. 3.1 body):
    (f_new, a, chol_b, sqrt_w at f, grad_ll at f) with f_new = K a."""
    gll, w = lik.grads(tl, f, y, mask)
    w = torch.maximum(w, torch.zeros_like(w))  # a no-op for log-concave likelihoods
    sw = _safe_sqrt(w)
    L = linalg.cholesky(_b_matrix(K, sw), precision)
    b = w * f + gll
    with linalg.matmul_precision(precision):
        Kb = _mv(K, b)
    a = b - sw * linalg.cho_solve_vec(L, sw * Kb)
    with linalg.matmul_precision(precision):
        f_new = _mv(K, a)
    return f_new, a, L, sw, gll


def _objective(lik: Likelihood, tl, f, a, y, mask):
    # psi(f) = log p(y|f) - 1/2 f^T K^{-1} f with a = K^{-1} f
    return lik.sum_logp(tl, f, y, mask) - 0.5 * (a * f).sum(-1)


def _newton_solve(lik: Likelihood, tl, K, y, mask, max_iters: int, tol: float,
                  precision: str | None = None) -> tuple[Tensor, Tensor]:
    """Guarded Newton to an objective change of ``tol`` or ``max_iters``:
    (f_hat, iterations per row).

    Each iteration takes the Newton direction and keeps the best of the
    fixed step grid (K^{-1} f moves linearly along it, so psi is free at
    every trial).  Every row runs in lockstep; a row that has met ``tol``
    (or whose psi turned NaN) keeps its state.  Not differentiable: the
    callers pass detached operands and take one differentiable step."""
    n = K.shape[-1]
    batch = torch.broadcast_shapes(K.shape[:-2], y.shape[:-1], mask.shape[:-1], tl.shape[:-1])
    f = torch.zeros(batch + (n,), dtype=K.dtype, device=K.device)
    a = torch.zeros_like(f)
    steps = torch.tensor(_STEPS, dtype=K.dtype, device=K.device)
    psi = _objective(lik, tl, f, a, y, mask).expand(batch)
    delta = torch.full(batch, float("inf"), dtype=K.dtype, device=K.device)
    iters = torch.zeros(batch, dtype=torch.int64, device=K.device)
    for _ in range(max_iters):
        active = delta > tol
        if not bool(active.any()):
            break
        f_full, a_full = _newton_step(lik, tl, K, f, y, mask, precision)[:2]
        df, da = f_full - f, a_full - a
        f_tr = f[..., None, :] + steps[:, None] * df[..., None, :]  # (*batch, steps, n)
        a_tr = a[..., None, :] + steps[:, None] * da[..., None, :]
        psis = _objective(lik, tl, f_tr, a_tr, y[..., None, :], mask[..., None, :])
        best = torch.argmax(psis, dim=-1)
        s = steps[best][..., None]
        psi_new = psis.gather(-1, best[..., None])[..., 0]
        on = active[..., None]
        f = torch.where(on, f + s * df, f)
        a = torch.where(on, a + s * da, a)
        delta = torch.where(active, torch.abs(psi_new - psi), delta)
        psi = torch.where(active, psi_new, psi)
        iters = iters + active
    return f, iters


def laplace_fit(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, y, theta_noise=None, mask=None,
                max_iters: int = 40, tol: float = 1e-9,
                precision: str | None = linalg.ACCURATE_PRECISION) -> LaplacePosterior:
    """Find the latent mode and package the Laplace posterior.  ``gp.noise``
    is only diagonal jitter on K here (observation noise belongs to the
    likelihood)."""
    theta_noise = _zeros_noise(gp, theta_noise)
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = _cov(gp, ts, tn, x, mask)
    with torch.no_grad():
        f_hat, iters = _newton_solve(lik, tl, K, y, mask, max_iters, tol, precision)
        # one more step from the mode: the mode again, with B's factor there
        f, a, L, sw, gll = _newton_step(lik, tl, K, f_hat, y, mask, precision)
    return LaplacePosterior(ts, tn, tl, x, y, f, gll, sw, L, mask, iters)


def laplace_lml(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, y, theta_noise=None, mask=None,
                max_iters: int = 40, tol: float = 1e-9,
                precision: str | None = linalg.ACCURATE_PRECISION) -> Tensor:
    """Laplace-approximate log marginal likelihood, GPML eq. 3.32:

        log q(y|X, theta) = log p(y|f_hat) - 1/2 f_hat^T K^{-1} f_hat - 1/2 log|B|

    differentiable in every theta by the one-Newton-step trick (module
    docstring); with the Gaussian likelihood it equals ``gp.lml`` with noise
    variance sigma^2.  One value per row of a batch."""
    theta_noise = _zeros_noise(gp, theta_noise)
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = _cov(gp, ts, tn, x, mask)
    with torch.no_grad():
        f_hat, _ = _newton_solve(lik, tl.detach(), K.detach(), y, mask, max_iters, tol, precision)
    # the differentiable step from the (constant) mode
    f, a = _newton_step(lik, tl, K, f_hat, y, mask, precision)[:2]
    # W (hence B) again at the differentiable f, so that log|B|'s implicit
    # dependence on theta flows (GPML eq. 5.23's third-derivative terms)
    _, w = lik.grads(tl, f, y, mask)
    sw = _safe_sqrt(torch.maximum(w, torch.zeros_like(w)))
    L = linalg.cholesky(_b_matrix(K, sw), precision)
    half_logdet_b = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)  # padded rows: log 1
    return lik.sum_logp(tl, f, y, mask) - 0.5 * (a * f).sum(-1) - half_logdet_b


def _latent_bands(gp: GP, ts, x, mask, weights, chol_b, sqrt_w, z) -> tuple[Tensor, Tensor]:
    """mu* = K*^T weights, sigma*^2 = k(z, z) - ||L_B^{-1} (sW K*)||^2 per
    column (GPML Alg. 3.2 and 3.6)."""
    kstar = _cross(gp, ts, x, z) * mask[..., :, None]  # (..., n, m)
    mu = (kstar.mT @ weights[..., None])[..., 0]
    v = linalg.trsm_lower(chol_b, sqrt_w[..., :, None] * kstar)
    var = _prior(gp, ts, z) - (v * v).sum(-2)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def laplace_predict(gp: GP, post: LaplacePosterior, z) -> tuple[Tensor, Tensor]:
    """Latent predictive mean and std at ``z`` (GPML Alg. 3.2); ``z``
    (rows, m, ndim) gives each row of a batched posterior its own inputs."""
    z = _test_points(gp, z, post.x)
    return _latent_bands(gp, post.theta_simil, post.x, post.mask, post.grad_ll, post.chol_b, post.sqrt_w, z)


def predict_expect(fn: Callable[[Tensor], Tensor], mu: Tensor, var: Tensor, order: int = 32) -> Tensor:
    """E[fn(f*)] for f* ~ N(mu, var), elementwise, by Gauss-Hermite
    quadrature (numpy's ``hermgauss`` nodes).  ``fn`` maps a tensor
    elementwise: it sees mu's shape plus a trailing nodes axis."""
    xs, ws = np.polynomial.hermite.hermgauss(order)
    xs = torch.as_tensor(xs, dtype=mu.dtype, device=mu.device)
    ws = torch.as_tensor(ws / np.sqrt(np.pi), dtype=mu.dtype, device=mu.device)
    f = mu[..., None] + torch.sqrt(2.0 * torch.clamp(var, min=0.0))[..., None] * xs
    return (fn(f) * ws).sum(-1)


def class_prob(lik: Likelihood, theta_lik: Tensor, mu: Tensor, sd: Tensor, order: int = 32) -> Tensor:
    """p(y = 1) under a Gaussian latent N(mu, sd^2): probit analytically,
    Phi(mu / sqrt(1 + sd^2)) (GPML eq. 3.80), other links by Gauss-Hermite
    quadrature of exp(logp(f, y = 1))."""
    if lik is bernoulli_probit:
        return torch.special.ndtr(mu / torch.sqrt(1.0 + sd * sd))
    return predict_expect(lambda f: torch.exp(lik.pointwise(theta_lik, f, 1.0)), mu, sd * sd, order)


def laplace_predict_prob(gp: GP, lik: Likelihood, post: LaplacePosterior, z, order: int = 32) -> Tensor:
    """Predictive p(y=1 | z) for binary-classification likelihoods."""
    mu, sd = laplace_predict(gp, post, z)
    return class_prob(lik, post.theta_lik, mu, sd, order)


def compile_laplace_serving(gp: GP, post: LaplacePosterior,
                            precision: str | None = linalg.ACCURATE_PRECISION) -> ServingPosterior:
    """LaplacePosterior -> ServingPosterior: the GP serving algebra with
    alpha -> grad_ll and W_serve = L_B^{-1} diag(sqrt_w), so every
    ``gp.serve`` entry point serves the classification posterior.  One
    ``linalg.tril_inv`` of chol_b."""
    w = linalg.tril_inv(post.chol_b, precision) * post.sqrt_w[None, :]
    return ServingPosterior(post.theta_simil, post.theta_noise, post.x, post.grad_ll, w, post.mask)


def serve_predict_prob(gp: GP, lik: Likelihood, sp: ServingPosterior, theta_lik, z, order: int = 32,
                       precision: str | None = linalg.ACCURATE_PRECISION) -> Tensor:
    """Predictive p(y=1 | z) from a compiled Laplace (or EP) serving cache."""
    mu, sd = serve_predict(gp, sp, z, precision)
    return class_prob(lik, _like(theta_lik, mu), mu, sd, order)


def laplace_fit_ovr(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, labels, n_classes: int, mask=None,
                    max_iters: int = 40, tol: float = 1e-9) -> LaplacePosterior:
    """One-vs-rest multiclass: C binary Laplace fits as one batch (class c
    sees y = 1[labels == c]), in lockstep until the slowest class
    converges.  Thetas shared, (n_theta,), or per class, (C, n_theta).
    The posterior's fields carry a leading class axis (x too, broadcast)."""
    x = _points(x)
    labels = torch.as_tensor(labels, device=x.device)
    ys = (labels[None, :] == torch.arange(n_classes, device=x.device)[:, None]).to(x.dtype)
    post = laplace_fit(gp, lik, theta_simil, theta_lik, x, ys, mask=mask, max_iters=max_iters, tol=tol)
    c = (n_classes,)
    return post._replace(
        theta_simil=post.theta_simil.expand(c + post.theta_simil.shape[-1:]),
        theta_noise=post.theta_noise.expand(c + post.theta_noise.shape[-1:]),
        theta_lik=post.theta_lik.expand(c + post.theta_lik.shape[-1:]),
        x=post.x.expand(c + post.x.shape), mask=post.mask.expand(c + post.mask.shape[-1:]),
    )


def laplace_predict_ovr(gp: GP, lik: Likelihood, posts: LaplacePosterior, z, order: int = 32) -> Tensor:
    """(m, C) class probabilities from a one-vs-rest posterior: each class's
    Bernoulli probability, rescaled to sum to one across classes."""
    z = _test_points(gp, z, posts.x)
    mu, sd = _latent_bands(gp, posts.theta_simil, posts.x[0], posts.mask, posts.grad_ll, posts.chol_b,
                           posts.sqrt_w, z)
    probs = class_prob(lik, posts.theta_lik, mu, sd, order).T  # (m, C)
    return probs / probs.sum(1, keepdim=True)


def make_laplace_logp(gp: GP, lik: Likelihood, x, y, mask=None, max_iters: int = 40, tol: float = 1e-9,
                      precision: str | None = linalg.ACCURATE_PRECISION):
    """Flat-vector hyperparameter log-density, layout v = [log theta_simil,
    log theta_noise, log theta_lik]; v may carry leading rows axes.
    Returns (logp, n_params)."""
    nts, ntn, ntl = gp.n_theta_simil, gp.n_theta_noise, lik.n_theta

    def logp(v):
        theta = torch.exp(torch.as_tensor(v))
        return laplace_lml(gp, lik, theta[..., :nts], theta[..., nts + ntn :], x, y,
                           theta_noise=theta[..., nts : nts + ntn], mask=mask, max_iters=max_iters, tol=tol,
                           precision=precision)

    return logp, nts + ntn + ntl


__all__ = [
    "LaplacePosterior",
    "class_prob",
    "compile_laplace_serving",
    "laplace_fit",
    "laplace_fit_ovr",
    "laplace_lml",
    "laplace_predict",
    "laplace_predict_ovr",
    "laplace_predict_prob",
    "make_laplace_logp",
    "predict_expect",
    "serve_predict_prob",
]
