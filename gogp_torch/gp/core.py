"""GP core: covariance assembly, log marginal likelihood, prediction.

PyTorch twin of the exact subset of ``gogp_tpu/gp/core.py``: an immutable
:class:`GP` spec, an immutable :class:`Posterior` of tensors, and pure
functions on them.  Gradients come from autograd.

Padding: a 0/1 ``mask`` marks which of the n rows are real observations.
Padded rows become identity rows of K and zeros of y, so the log marginal
likelihood and the predictions are exactly those of the unpadded problem.

Devices: everything runs on the device of the inputs ``x`` (or of the
posterior).  Python numbers and lists are created there; a tensor on another
device is an error, never a silent copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gogp_torch.kernels.base import Kernel, NoiseKernel
from gogp_torch.kernels.noise import constant_noise
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453

# Default noise std, present for numerical stability (variance 1e-10); zero
# it by passing constant_noise(0.) explicitly.
DEFAULT_NOISE_STD = 1e-5


@dataclasses.dataclass(frozen=True)
class GP:
    """GP spec: input dimensionality plus similarity and noise kernels."""

    ndim: int
    simil: Kernel
    noise: NoiseKernel | None = None

    def __post_init__(self):
        if self.noise is None:
            object.__setattr__(self, "noise", constant_noise(DEFAULT_NOISE_STD))

    @property
    def n_theta_simil(self) -> int:
        return self.simil.n_theta

    @property
    def n_theta_noise(self) -> int:
        return self.noise.n_theta

    @property
    def n_theta(self) -> int:
        return self.simil.n_theta + self.noise.n_theta


class Posterior(NamedTuple):
    """Immutable fitted-GP state: everything ``predict`` needs."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    x: Tensor  # (n, ndim)
    y: Tensor  # (n,)
    chol: Tensor  # (n, n) lower Cholesky factor of K
    alpha: Tensor  # (n,) K^{-1} y
    mask: Tensor  # (n,) 1.0 for real observations, 0.0 for padding


def _like(v, ref: Tensor) -> Tensor:
    """``v`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    if isinstance(v, Tensor):
        if v.device != ref.device:
            raise ValueError(f"tensor on {v.device}, expected {ref.device}")
        return v.to(ref.dtype)
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _points(x) -> Tensor:
    x = torch.as_tensor(x)
    return x[:, None] if x.dim() == 1 else x


def _prepare(gp: GP, theta_simil, theta_noise, x, y, mask):
    x = _points(x)
    n = x.shape[0]
    theta_simil = _like(theta_simil, x).reshape(gp.n_theta_simil)
    theta_noise = _like(theta_noise, x).reshape(gp.n_theta_noise)
    if mask is None:
        mask = torch.ones(n, dtype=x.dtype, device=x.device)
    else:
        mask = _like(mask, x)
    y = _like(y, x) * mask
    return theta_simil, theta_noise, x, y, mask


def masked_cov(gp: GP, theta_simil, theta_noise, x: Tensor, mask: Tensor | None) -> Tensor:
    """Covariance with noise on the diagonal,
    K[i, j] = simil(x_i, x_j) + delta_ij noise(x_j); padded rows and columns
    are replaced by identity rows."""
    k = gp.simil.matrix(theta_simil, x, x)
    k = k + torch.diag_embed(gp.noise.vector(theta_noise, x))
    if mask is not None:
        m = mask.to(k.dtype)
        k = k * (m[:, None] * m[None, :]) + torch.diag_embed(1.0 - m)
    return k


def absorb(gp: GP, theta_simil, theta_noise, x, y, mask=None, robust: bool = False) -> Posterior:
    """Factorize K and solve for alpha.  ``robust=True`` retries a failed
    factorization with escalating diagonal jitter instead of returning
    NaNs."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    L = linalg.cholesky_with_jitter(K)[0] if robust else linalg.cholesky(K)
    alpha = linalg.cho_solve_vec(L, y)
    return Posterior(theta_simil, theta_noise, x, y, L, alpha, mask)


def lml_from_posterior(post: Posterior) -> Tensor:
    """GPML eq. 5.8: -(n/2) log 2pi - 1/2 log|K| - 1/2 y^T alpha; 0 with no
    data."""
    n_eff = post.mask.sum()
    logdet = linalg.logdet_from_chol(post.chol, post.mask)
    return -0.5 * (n_eff * _LOG_2PI + logdet + post.y @ post.alpha)


def lml(gp: GP, theta_simil, theta_noise, x, y, mask=None, precision: str | None = None) -> Tensor:
    """Log marginal likelihood at natural-scale hyperparameters, through
    ``linalg.lml_core`` (the blocked kernels on CUDA f32 at n >= 1024).
    ``precision``: the blocked drivers' matmul precision (``ops.linalg``)."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    return -0.5 * mask.sum() * _LOG_2PI + linalg.lml_core(K, y, precision)


def predict_from_posterior(gp: GP, post: Posterior, z) -> tuple[Tensor, Tensor]:
    """Posterior mean and std of the noise-free latent f at test inputs z.

    mu = Kstar^T alpha; sigma_i^2 = k(z_i, z_i) - |L^{-1} Kstar[:, i]|^2,
    clamped at 0, so sigma at an observed point of a noise-free GP is 0.
    """
    z = _points(_like(z, post.x))
    prior_var = gp.simil.diag_matrix(post.theta_simil, z)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z) * post.mask[:, None]  # (n, m)
    mu = kstar.T @ post.alpha
    v = linalg.trsm_lower(post.chol, kstar)
    var = prior_var - (v * v).sum(0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def predict_y_from_posterior(gp: GP, post: Posterior, z) -> tuple[Tensor, Tensor]:
    """Predictive mean and std of an observation y*: the latent bands plus
    the noise kernel's variance at the test inputs."""
    z = _points(_like(z, post.x))
    mu, sigma = predict_from_posterior(gp, post, z)
    nv = gp.noise.vector(post.theta_noise, z)
    return mu, torch.sqrt(sigma * sigma + nv)


def predict(gp: GP, theta_simil, theta_noise, x, y, z, mask=None) -> tuple[Tensor, Tensor]:
    """Fit and predict: absorb, then predict_from_posterior."""
    post = absorb(gp, theta_simil, theta_noise, x, y, mask)
    return predict_from_posterior(gp, post, z)


def predict_prior(gp: GP, theta_simil, z) -> tuple[Tensor, Tensor]:
    """Prediction with no observations: mu = 0, sigma = prior std."""
    z = _points(z)
    prior_var = gp.simil.diag_matrix(_like(theta_simil, z), z)
    return torch.zeros_like(prior_var), torch.sqrt(prior_var)
