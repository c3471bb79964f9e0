"""Serving: precompiled posterior caches for batch prediction.

PyTorch twin of ``gogp_tpu/gp/serve.py``.  Every prediction from a
:class:`~gogp_torch.gp.core.Posterior` runs a triangular solve against the
cached factor.  This module spends one O(n^3/3) triangular inversion at fit
time instead, so that each prediction is matmuls:

    ServingPosterior = Posterior with W = inv(L) precomputed
    mu    = Kstar^T alpha                       (one (m, n) @ (n,) matvec)
    sigma = sqrt(kzz - colnorms^2(W @ Kstar))   (one (n, n) @ (n, m) matmul)

The semantics are those of ``gp.core.predict_from_posterior``: noise-free
latent bands, padded training rows contribute nothing.  On an NVIDIA H100
80GB HBM3 (700 W) the serve phase of ``chip_smoke.py`` measured a request
batch of m = 1024 at n = 4096 in 0.99 ms from the cache, against 2.82 ms
for ``predict_from_posterior``'s blocked TRSM (K5 and GEMMs) and 2.28 ms
for the plain path's ``solve_triangular`` (median of 5, PERF.md); the
inversion costs about 2 ms once, at fit time.

Bayesian serving: S hyperparameter draws compile into a
:class:`ServingMixture`, the S caches stacked, which serves the
moment-matched predictive mixture as S-batched matmuls.

``precision`` (every entry point, default ``linalg.ACCURATE_PRECISION``)
sets the matmuls and the blocked inversion: TF32 or full f32 on the card
(``linalg.matmul_precision``).  sigma^2 = prior - explained is a
cancellation wherever the data explain the test point, so sigma inherits
the matmuls' rounding; mu is a well-conditioned inner product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gogp_torch.gp.core import GP, Posterior, _like, _points, absorb
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

Tensor = torch.Tensor


class ServingPosterior(NamedTuple):
    """Fitted-GP serving cache: a Posterior with the factor inverted."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    x: Tensor  # (n, ndim)
    alpha: Tensor  # (n,) K^{-1} y
    w: Tensor  # (n, n) inv(L), lower triangular
    mask: Tensor  # (n,) 1.0 real / 0.0 padding


def compile_posterior(gp: GP, post: Posterior,
                      precision: str | None = linalg.ACCURATE_PRECISION) -> ServingPosterior:
    """Posterior -> ServingPosterior: invert the cached factor once
    (``linalg.tril_inv``: K5 and GEMMs at n >= 1024 on the card)."""
    del gp  # symmetry with the other entry points
    w = linalg.tril_inv(post.chol, precision)
    return ServingPosterior(post.theta_simil, post.theta_noise, post.x, post.alpha, w, post.mask)


def fit_serving(gp: GP, theta_simil, theta_noise, x, y, mask=None,
                precision: str | None = linalg.ACCURATE_PRECISION) -> ServingPosterior:
    """absorb + compile in one call: the fit-time entry point."""
    return compile_posterior(gp, absorb(gp, theta_simil, theta_noise, x, y, mask), precision)


def _half_solve(gp: GP, sp: ServingPosterior, z: Tensor, precision):
    """(mu, v = W Kstar) at test inputs z."""
    kstar = gp.simil.matrix(sp.theta_simil, sp.x, z) * sp.mask[:, None]  # (n, m)
    with linalg.matmul_precision(precision):
        mu = kstar.T @ sp.alpha
        v = sp.w @ kstar
    return mu, v


def serve_predict(gp: GP, sp: ServingPosterior, z,
                  precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Predictive mean and std of the noise-free latent f at ``z`` from the
    compiled cache: the half-solve is ``w @ kstar``, one matmul."""
    z = _points(_like(z, sp.x))
    mu, v = _half_solve(gp, sp, z, precision)
    var = gp.simil.diag_matrix(sp.theta_simil, z) - (v * v).sum(0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def serve_predict_y(gp: GP, sp: ServingPosterior, z,
                    precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Noise-inclusive bands: sigma_y^2 = sigma_f^2 + noise_var(z)."""
    z = _points(_like(z, sp.x))
    mu, sigma = serve_predict(gp, sp, z, precision)
    return mu, torch.sqrt(sigma * sigma + gp.noise.vector(sp.theta_noise, z))


def serve_predict_cov(gp: GP, sp: ServingPosterior, z,
                      precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Predictive mean and the full (m, m) latent covariance
    Kzz - v^T v, v = W Kstar."""
    z = _points(_like(z, sp.x))
    kzz = gp.simil.matrix(sp.theta_simil, z, z)
    mu, v = _half_solve(gp, sp, z, precision)
    with linalg.matmul_precision(precision):
        cov = kzz - v.T @ v
    return mu, cov


def serve_sample(gp: GP, sp: ServingPosterior, z, num_samples: int = 1, jitter: float = 1e-8,
                 precision: str | None = linalg.ACCURATE_PRECISION, eps=None,
                 generator: torch.Generator | None = None) -> Tensor:
    """Joint posterior function draws f(z) ~ N(mu, cov), (num_samples, m).

    ``eps``: the (num_samples, m) standard normals (the JAX twin's draws,
    handed in); by default drawn from ``generator`` (torch's default one
    when None).  O(m^3) for the m x m factorization, which
    gives NaN draws (as in the JAX twin) where ``cov`` plus ``jitter`` times
    (mean variance + 1) is not positive definite: the joint covariance of
    close points is singular to f32's precision."""
    mu, cov = serve_predict_cov(gp, sp, z, precision)
    m = mu.shape[0]
    scale = torch.diagonal(cov).mean() + 1.0
    chol = cb.plain_cholesky(cov + (jitter * scale) * torch.eye(m, dtype=cov.dtype, device=cov.device))
    if eps is None:
        eps = torch.randn((num_samples, m), generator=generator, dtype=mu.dtype, device=mu.device)
    eps = _like(eps, mu)
    with linalg.matmul_precision(precision):
        return mu[None, :] + eps @ chol.T


class ServingMixture(NamedTuple):
    """S stacked serving posteriors: the compiled form of a sampler's
    hyperparameter draws (a leading draw axis on every field but x, mask)."""

    theta_simil: Tensor  # (S, n_theta_simil)
    theta_noise: Tensor  # (S, n_theta_noise)
    x: Tensor  # (n, ndim), shared
    alpha: Tensor  # (S, n)
    w: Tensor  # (S, n, n)
    mask: Tensor  # (n,)

    @property
    def n_draws(self) -> int:
        return self.alpha.shape[0]


def compile_mixture(gp: GP, vs, x, y, mask=None,
                    precision: str | None = linalg.ACCURATE_PRECISION) -> ServingMixture:
    """Compile S log-scale draws (S, n_theta) into a batched serving cache.

    Each draw is absorbed and inverted through the front door, one after
    another (``absorb``: K1 at n >= 1024 on the card; ``tril_inv``: one K5
    launch over the draw's diagonal tiles and its GEMMs), where the JAX twin
    vmaps one absorb and one inversion.  K5 would take all S * nb tiles in
    one launch, but the S factors come from S K1 launches anyway and the
    GEMMs dominate.  O(S n^2) storage."""
    x = _points(x)
    vs = _like(vs, x)
    nts = gp.n_theta_simil
    posts, ws = [], []
    for v in vs:
        theta = torch.exp(v)
        post = absorb(gp, theta[:nts], theta[nts:], x, y, mask)
        posts.append(post)
        ws.append(linalg.tril_inv(post.chol, precision))
    return ServingMixture(
        torch.stack([p.theta_simil for p in posts]), torch.stack([p.theta_noise for p in posts]), x,
        torch.stack([p.alpha for p in posts]), torch.stack(ws), posts[0].mask,
    )


def mixture_draw_moments(gp: GP, sm: ServingMixture, z,
                         precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Each draw's predictive mean and latent variance at ``z``: (mus,
    vars_), each (S, m), as S-batched matmuls over the compiled caches (of
    all the draws, or of one rank's slab of them)."""
    z = _points(_like(z, sm.x))
    prior_var = torch.func.vmap(lambda ts: gp.simil.diag_matrix(ts, z))(sm.theta_simil)  # (S, m)
    kstar = torch.func.vmap(lambda ts: gp.simil.matrix(ts, sm.x, z))(sm.theta_simil)  # (S, n, m)
    kstar = kstar * sm.mask[None, :, None]
    with linalg.matmul_precision(precision):
        mus = (kstar.mT @ sm.alpha[..., None])[..., 0]  # (S, m)
        v = sm.w @ kstar  # (S, n, m)
    return mus, torch.clamp(prior_var - (v * v).sum(1), min=0.0)


def serve_predict_mixture(gp: GP, sm: ServingMixture, z,
                          precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Moment-matched posterior predictive from the compiled mixture:
    mu = E_s[mu_s], var = E_s[sigma_s^2 + mu_s^2] - mu^2 (the moments of
    ``gp.core.predict_mixture``), as S-batched matmuls."""
    mus, vars_ = mixture_draw_moments(gp, sm, z, precision)
    mu = mus.mean(0)
    var = (vars_ + mus * mus).mean(0) - mu * mu
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def serve_predict_mixture_y(gp: GP, sm: ServingMixture, z,
                            precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Noise-inclusive moment match, var_y = E_s[sigma_s^2 + noise_s(z) +
    mu_s^2] - mu^2: each draw's own noise inside the average."""
    z = _points(_like(z, sm.x))
    mu, sigma_f = serve_predict_mixture(gp, sm, z, precision)
    nv = torch.func.vmap(lambda tn: gp.noise.vector(tn, z))(sm.theta_noise).mean(0)
    return mu, torch.sqrt(sigma_f * sigma_f + nv)


__all__ = [
    "ServingMixture",
    "ServingPosterior",
    "compile_mixture",
    "compile_posterior",
    "fit_serving",
    "serve_predict",
    "serve_predict_cov",
    "serve_predict_mixture",
    "serve_predict_mixture_y",
    "serve_predict_y",
    "serve_sample",
]
