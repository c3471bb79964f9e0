"""Expectation propagation for latent-GP models: parallel-update EP.

PyTorch twin of ``gogp_tpu/gp/ep.py`` (GPML §3.6).  Each likelihood factor
p(y_i|f_i) is replaced by an unnormalized Gaussian site
t_i(f) = exp(nu_i f - tau_i f^2 / 2) whose parameters are iterated to match
the tilted moments.  As in the JAX twin this is *parallel* EP: every sweep
recomputes all n cavities from one factorization of B = I + S^0.5 K S^0.5
(``linalg.cholesky``: K1 at 1024 <= n <= 4096 on the card) and one
``linalg.trsm_lower(L, S^0.5 K)`` (K5 and GEMMs there), updates every site
at once and damps the natural parameters.  The sweeps run on the host, one
read per sweep (whether any row's sites still move more than ``tol``).  In
f32 the damped sites keep moving by more than ``tol = 1e-8``: the n = 4096
problem of ``chip_smoke.py`` takes all 60 sweeps on the card, 25 in f64
(PERF.md).

Tilted moments come from the :class:`~gogp_torch.gp.likelihoods.Likelihood`
by Gauss-Hermite quadrature (numpy's ``hermgauss`` nodes), with closed forms
for the probit (GPML eq. 3.58) and the Gaussian likelihoods.

Hyperparameter gradients: log Z_EP is stationary in the site parameters at
an EP fixed point (Seeger 2005), so :func:`ep_lml` detaches the converged
sites and re-evaluates log Z_EP with a differentiable K.  With the Gaussian
likelihood EP is exact after one sweep and ep_lml equals ``gp.lml``.

Batches and padding as in ``gp.laplace``: thetas (rows, n_theta) and masks
(rows, n) run every row in lockstep, a converged row frozen.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gogp_torch.gp.core import GP
from gogp_torch.gp.laplace import (
    _b_matrix,
    _cov,
    _latent_bands,
    _mv,
    _prep,
    _safe_sqrt,
    _test_points,
    _zeros_noise,
    class_prob,
)
from gogp_torch.gp.likelihoods import Likelihood, bernoulli_probit, gaussian
from gogp_torch.gp.serve import ServingPosterior
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_TAU_MIN = 1e-10  # cavity and site precision floor
_LOG_2PI = 1.8378770664093453


class EPPosterior(NamedTuple):
    """Converged EP state: sites and the B-factorization at those sites."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    theta_lik: Tensor  # (lik.n_theta,) natural scale
    x: Tensor  # (n, ndim)
    y: Tensor  # (n,)
    tau_site: Tensor  # (n,) site precisions (>= 0)
    nu_site: Tensor  # (n,) site precision-means
    chol_b: Tensor  # (n, n) lower Cholesky of B = I + S^0.5 K S^0.5
    alpha: Tensor  # (n,) posterior-mean weights: K*^T alpha is the predictive mean
    mask: Tensor  # (n,) 1.0 real / 0.0 padding
    sweeps: Tensor | None = None  # () sweeps taken (not in the JAX twin's state)


def _gh_nodes(order: int, dtype, device):
    xs, ws = np.polynomial.hermite.hermgauss(order)
    return (torch.as_tensor(xs, dtype=dtype, device=device),
            torch.as_tensor(ws / np.sqrt(np.pi), dtype=dtype, device=device))


def _tilted_moments(lik: Likelihood, tl, y, mu_c, s2_c, order: int):
    """(log Zhat, mu_hat, sigma2_hat) of Z^-1 p(y|f) N(f; mu_c, s2_c), every
    site at once: closed forms for the Gaussian and probit likelihoods,
    Gauss-Hermite otherwise."""
    if lik is gaussian:
        s2_l = tl[..., 0, None] * tl[..., 0, None]
        tot = s2_l + s2_c
        r = y - mu_c
        logZ = -0.5 * (r * r / tot + torch.log(2.0 * math.pi * tot))
        return logZ, mu_c + s2_c * r / tot, s2_c * s2_l / tot
    if lik is bernoulli_probit:
        sgn = 2.0 * y - 1.0
        denom = torch.sqrt(1.0 + s2_c)
        z = sgn * mu_c / denom
        logZ = torch.special.log_ndtr(z)
        ratio = torch.exp(-0.5 * (z * z + _LOG_2PI) - logZ)  # N(z)/Phi(z), stable
        mu_hat = mu_c + sgn * s2_c * ratio / denom
        s2_hat = s2_c - s2_c * s2_c * ratio * (z + ratio) / (1.0 + s2_c)
        return logZ, mu_hat, s2_hat
    xs, ws = _gh_nodes(order, mu_c.dtype, mu_c.device)
    sd = torch.sqrt(2.0 * s2_c)
    f = mu_c[..., None] + sd[..., None] * xs  # (..., n, order)
    ll = lik.pointwise(tl, f, torch.broadcast_to(y, mu_c.shape)[..., None])
    # log-sum-exp against the weights for Zhat, then the moment ratios
    mx = ll.amax(-1, keepdim=True)
    p = torch.exp(ll - mx) * ws
    Z = p.sum(-1)
    logZ = torch.log(Z) + mx[..., 0]
    mu_hat = (p * f).sum(-1) / Z
    ex2 = (p * f * f).sum(-1) / Z
    return logZ, mu_hat, torch.clamp(ex2 - mu_hat * mu_hat, min=_TAU_MIN)


def _posterior_marginals(K, tau, nu, precision):
    """diag(Sigma), mu, chol(B), alpha for Sigma = (K^{-1} + S)^{-1}:
    Sigma = K - K sW B^{-1} sW K with sW = sqrt(tau), mu = Sigma nu, and
    alpha the weights with K*^T alpha the predictive mean."""
    sw = _safe_sqrt(tau)
    L = linalg.cholesky(_b_matrix(K, sw), precision)
    V = linalg.trsm_lower(L, sw[..., :, None] * K)  # L^{-1} sW K
    sigma_diag = torch.diagonal(K, dim1=-2, dim2=-1) - (V * V).sum(-2)
    with linalg.matmul_precision(precision):
        Knu = _mv(K, nu)
    alpha = nu - sw * linalg.cho_solve_vec(L, sw * Knu)
    with linalg.matmul_precision(precision):
        mu = _mv(K, alpha)
    return sigma_diag, mu, L, alpha


def _cavities(sigma_diag, mu, tau, nu):
    """(mu_c, s2_c, tau_c, nu_c) of every site's cavity."""
    s = torch.clamp(sigma_diag, min=_TAU_MIN)
    tau_c = torch.clamp(1.0 / s - tau, min=_TAU_MIN)
    nu_c = mu / s - nu
    s2_c = 1.0 / tau_c
    return nu_c * s2_c, s2_c, tau_c, nu_c


def _ep_sweeps(lik, tl, K, y, mask, max_sweeps, tol, damping, order, precision):
    """Damped parallel-EP fixed-point iteration, every row in lockstep:
    (tau, nu, sweeps per row).  Not differentiable."""
    n = K.shape[-1]
    batch = torch.broadcast_shapes(K.shape[:-2], y.shape[:-1], mask.shape[:-1], tl.shape[:-1])
    tau = torch.zeros(batch + (n,), dtype=K.dtype, device=K.device)
    nu = torch.zeros_like(tau)
    delta = torch.full(batch, float("inf"), dtype=K.dtype, device=K.device)
    sweeps = torch.zeros(batch, dtype=torch.int64, device=K.device)
    for _ in range(max_sweeps):
        active = delta > tol
        if not bool(active.any()):
            break
        sigma_diag, mu, _, _ = _posterior_marginals(K, tau, nu, precision)
        mu_c, s2_c, tau_c, nu_c = _cavities(sigma_diag, mu, tau, nu)
        _, mu_hat, s2_hat = _tilted_moments(lik, tl, y, mu_c, s2_c, order)
        s_hat = torch.clamp(s2_hat, min=_TAU_MIN)
        tau_new = torch.clamp(1.0 / s_hat - tau_c, min=0.0)
        nu_new = mu_hat / s_hat - nu_c
        tau_d = ((1.0 - damping) * tau + damping * tau_new) * mask
        nu_d = ((1.0 - damping) * nu + damping * nu_new) * mask
        change = (torch.abs(tau_d - tau) + torch.abs(nu_d - nu)).amax(-1)
        on = active[..., None]
        tau = torch.where(on, tau_d, tau)
        nu = torch.where(on, nu_d, nu)
        delta = torch.where(active, change, delta)
        sweeps = sweeps + active
    return tau, nu, sweeps


def ep_fit(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, y, theta_noise=None, mask=None,
           max_sweeps: int = 60, tol: float = 1e-8, damping: float = 0.7, order: int = 32,
           precision: str | None = linalg.ACCURATE_PRECISION) -> EPPosterior:
    """Damped parallel EP to convergence, packaged.  ``gp.noise`` is only
    diagonal jitter on K, as in ``laplace_fit``."""
    theta_noise = _zeros_noise(gp, theta_noise)
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = _cov(gp, ts, tn, x, mask)
    with torch.no_grad():
        tau, nu, sweeps = _ep_sweeps(lik, tl, K, y, mask, max_sweeps, tol, damping, order, precision)
        _, _, L, alpha = _posterior_marginals(K, tau, nu, precision)
    return EPPosterior(ts, tn, tl, x, y, tau, nu, L, alpha, mask, sweeps)


def ep_lml(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, y, theta_noise=None, mask=None,
           max_sweeps: int = 60, tol: float = 1e-8, damping: float = 0.7, order: int = 32,
           precision: str | None = linalg.ACCURATE_PRECISION) -> Tensor:
    """EP approximation of the log marginal likelihood, in the padding-safe
    unnormalized-site form (equivalent to GPML eq. 3.65):

        log Z_EP = -sum log L_ii + 1/2 nu^T Sigma nu
                   + sum_i [log Zhat_i - log ∫ N(f; mu_c, s2_c) t_i(f) df]

    The converged sites (and only they) are detached, so autograd gives the
    exact hyperparameter gradient.  One value per row of a batch."""
    theta_noise = _zeros_noise(gp, theta_noise)
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = _cov(gp, ts, tn, x, mask)
    with torch.no_grad():
        tau, nu, _ = _ep_sweeps(lik, tl.detach(), K.detach(), y, mask, max_sweeps, tol, damping, order,
                                precision)
    sigma_diag, mu, L, _ = _posterior_marginals(K, tau, nu, precision)
    mu_c, s2_c, tau_c, nu_c = _cavities(sigma_diag, mu, tau, nu)
    logZhat, _, _ = _tilted_moments(lik, tl, y, mu_c, s2_c, order)
    # log ∫ N(f; mu_c, s2_c) exp(nu f - tau f^2 / 2) df, per site
    log_site_int = (-0.5 * torch.log1p(tau * s2_c) + 0.5 * (nu_c + nu) ** 2 / (tau_c + tau)
                    - 0.5 * nu_c * nu_c * s2_c)
    corr = (logZhat - log_site_int) * mask
    half_quad = 0.5 * (nu * mu).sum(-1)  # nu^T Sigma nu / 2
    logdet_half = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)  # padded rows: log 1
    return -logdet_half + half_quad + corr.sum(-1)


def ep_predict(gp: GP, post: EPPosterior, z) -> tuple[Tensor, Tensor]:
    """Latent predictive mean and std at ``z`` (GPML Alg. 3.6):
    mu* = K*^T alpha, sigma*^2 = k(z, z) - ||L^{-1} (S^0.5 K*)||^2."""
    z = _test_points(gp, z, post.x)
    return _latent_bands(gp, post.theta_simil, post.x, post.mask, post.alpha, post.chol_b,
                         _safe_sqrt(post.tau_site), z)


def ep_predict_prob(gp: GP, lik: Likelihood, post: EPPosterior, z, order: int = 32) -> Tensor:
    """Predictive p(y=1 | z); probit analytic, Gauss-Hermite otherwise."""
    mu, sd = ep_predict(gp, post, z)
    return class_prob(lik, post.theta_lik, mu, sd, order)


def compile_ep_serving(gp: GP, post: EPPosterior,
                       precision: str | None = linalg.ACCURATE_PRECISION) -> ServingPosterior:
    """EPPosterior -> ServingPosterior (the Laplace bridge's algebra: alpha
    stays alpha, W_serve = L_B^{-1} diag(S^0.5)); one ``linalg.tril_inv``."""
    w = linalg.tril_inv(post.chol_b, precision) * _safe_sqrt(post.tau_site)[None, :]
    return ServingPosterior(post.theta_simil, post.theta_noise, post.x, post.alpha, w, post.mask)


def make_ep_logp(gp: GP, lik: Likelihood, x, y, mask=None, max_sweeps: int = 60, tol: float = 1e-8,
                 damping: float = 0.7, order: int = 32, precision: str | None = linalg.ACCURATE_PRECISION):
    """Flat-vector hyperparameter log-density (layout [log theta_simil,
    log theta_noise, log theta_lik]; v may carry leading rows axes).
    Returns (logp, n_params)."""
    nts, ntn, ntl = gp.n_theta_simil, gp.n_theta_noise, lik.n_theta

    def logp(v):
        theta = torch.exp(torch.as_tensor(v))
        return ep_lml(gp, lik, theta[..., :nts], theta[..., nts + ntn :], x, y,
                      theta_noise=theta[..., nts : nts + ntn], mask=mask, max_sweeps=max_sweeps, tol=tol,
                      damping=damping, order=order, precision=precision)

    return logp, nts + ntn + ntl


__all__ = [
    "EPPosterior",
    "compile_ep_serving",
    "ep_fit",
    "ep_lml",
    "ep_predict",
    "ep_predict_prob",
    "make_ep_logp",
]
