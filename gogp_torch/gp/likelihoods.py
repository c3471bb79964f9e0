"""Observation likelihoods for latent-GP models.

PyTorch twin of ``gogp_tpu/gp/likelihoods.py``.  A :class:`Likelihood` is an
immutable spec around a pure *scalar* log-density

    logp(theta, f, y) -> log p(y | f, theta)

with ``theta`` a 1-D tensor of ``n_theta`` positive parameters (natural
scale) and ``f``, ``y`` 0-d tensors.  The first and second derivatives in f
come from ``torch.func.grad`` under ``torch.func.vmap``, as the JAX twin
takes ``jax.grad`` under ``jax.vmap``; they stay differentiable once more by
autograd, which ``laplace.laplace_lml`` needs (it differentiates W).

Batches: :meth:`Likelihood.pointwise`, :meth:`sum_logp` and :meth:`grads`
evaluate ``logp`` at every entry of ``f`` (any shape), with ``y`` broadcast
against ``f`` and ``theta`` either shared (1-D) or one vector per leading
index of ``f`` (shape ``f.shape[:k] + (n_theta,)``): the rows of a batch of
problems, each with its own parameters.

Consumers: ``gp.laplace``, ``gp.ep``, ``infer.elliptical`` and, through
:meth:`Likelihood.for_svgp`, ``gp.sparse``'s Gauss-Hermite ELBO.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453
_SQRT_HALF = 0.7071067811865476


def _flat(fn, theta: Tensor, f: Tensor, y: Tensor) -> Tensor:
    """``fn(theta, f_i, y_i)`` at every entry of ``f`` under one vmap."""
    y = torch.broadcast_to(y, f.shape).reshape(-1)
    if theta.dim() == 1:
        out = torch.func.vmap(fn, in_dims=(None, 0, 0))(theta, f.reshape(-1), y)
    else:
        lead, nt = theta.shape[:-1], theta.shape[-1]
        th = theta.reshape(lead + (1,) * (f.dim() - len(lead)) + (nt,)).expand(f.shape + (nt,))
        out = torch.func.vmap(fn, in_dims=(0, 0, 0))(th.reshape(f.numel(), nt), f.reshape(-1), y)
    return out.reshape(f.shape)


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """Pointwise observation model ``logp(theta, f, y) -> scalar``.

    ``log_concave`` declares concavity of logp in f: the Laplace Newton
    solve is exact there, and so is its implicit hyperparameter gradient.
    Non-log-concave models (student_t) clip the negative curvature, which
    makes that gradient approximate."""

    n_theta: int
    logp: Callable[[Tensor, Tensor, Tensor], Tensor]
    name: str = "likelihood"
    log_concave: bool = True

    def __call__(self, theta, f, y):
        return self.logp(theta, f, y)

    def pointwise(self, theta: Tensor, f: Tensor, y) -> Tensor:
        """log p(y_i | f_i) at every entry of ``f``."""
        return _flat(self.logp, theta, f, torch.as_tensor(y, dtype=f.dtype, device=f.device))

    def sum_logp(self, theta: Tensor, f: Tensor, y, mask=None) -> Tensor:
        """Masked total log-likelihood over the last axis of ``f``."""
        ll = self.pointwise(theta, f, y)
        if mask is not None:
            ll = ll * mask
        return ll.sum(-1)

    def grads(self, theta: Tensor, f: Tensor, y, mask=None) -> tuple[Tensor, Tensor]:
        """(d logp/df, -d^2 logp/df^2) at every entry of ``f``, masked.
        -logp'' is the Laplace weight W (GPML §3.4)."""
        g1 = torch.func.grad(self.logp, argnums=1)
        g2 = torch.func.grad(g1, argnums=1)
        y = torch.as_tensor(y, dtype=f.dtype, device=f.device)
        gll = _flat(g1, theta, f, y)
        w = -_flat(g2, theta, f, y)
        if mask is not None:
            gll = gll * mask
            w = w * mask
        return gll, w

    def for_svgp(self, theta) -> Callable[[Tensor, Tensor], Tensor]:
        """``svgp_elbo``'s ``likelihood(y, f)`` with theta bound: log p at
        every entry of ``f`` (any shape, ``y`` broadcast against it), by
        :meth:`pointwise`.  ``theta`` takes ``f``'s dtype at each call."""

        def logp(y, f):
            th = theta.to(f.dtype) if isinstance(theta, Tensor) else torch.as_tensor(
                theta, dtype=f.dtype, device=f.device)
            return self.pointwise(th.reshape(-1), f, y)

        return logp


# -- built-in families -----------------------------------------------------


def _gaussian_logp(theta, f, y):
    sigma = theta[0]
    z = (y - f) / sigma
    return -0.5 * (z * z + _LOG_2PI) - torch.log(sigma)


#: Gaussian observation noise, theta = [sigma]: the Laplace approximation
#: is exact there, and laplace_lml equals gp.lml with noise sigma^2.
gaussian = Likelihood(1, _gaussian_logp, "gaussian")


def _bernoulli_logit_logp(theta, f, y):
    # y in {0, 1}, p(y=1|f) = sigmoid(f): log p = y f - log(1 + e^f)
    return y * f - torch.logaddexp(torch.zeros_like(f), f)


#: Logistic binary classification, y in {0, 1}, no theta.
bernoulli_logit = Likelihood(0, _bernoulli_logit_logp, "bernoulli_logit")


def log_ndtr(z: Tensor) -> Tensor:
    """log Phi(z) from erfcx and erfc, which have batching rules under
    ``torch.func.vmap`` (``torch.special.log_ndtr`` has none): for z < 0,
    log(erfcx(-z/sqrt2)/2) - z^2/2; for z >= 0, log1p(-erfc(z/sqrt2)/2).
    Each branch sees only its own side, so neither puts a NaN into the
    other's gradient."""
    zn = torch.clamp(z, max=0.0)
    zp = torch.clamp(z, min=0.0)
    neg = torch.log(0.5 * torch.special.erfcx(-zn * _SQRT_HALF)) - 0.5 * zn * zn
    pos = torch.log1p(-0.5 * torch.special.erfc(zp * _SQRT_HALF))
    return torch.where(z < 0.0, neg, pos)


def _bernoulli_probit_logp(theta, f, y):
    # y in {0, 1} mapped to signs: log Phi((2y - 1) f)
    return log_ndtr((2.0 * y - 1.0) * f)


#: Probit binary classification, y in {0, 1}, no theta.
bernoulli_probit = Likelihood(0, _bernoulli_probit_logp, "bernoulli_probit")


def _poisson_logp(theta, f, y):
    # log link: rate = exp(f)
    return y * f - torch.exp(f) - torch.lgamma(y + 1.0)


#: Poisson counts with log link, no theta.
poisson = Likelihood(0, _poisson_logp, "poisson")


def _laplace_logp(theta, f, y):
    b = theta[0]
    return -torch.abs(y - f) / b - torch.log(2.0 * b)


#: Laplace (double-exponential) noise, theta = [scale b]: the anynoise
#: study's observation model.  Log-concave, not smooth at y == f.
laplace_noise = Likelihood(1, _laplace_logp, "laplace")


def _student_t_logp(theta, f, y):
    sigma, nu = theta[0], theta[1]
    z = (y - f) / sigma
    return (
        torch.lgamma(0.5 * (nu + 1.0))
        - torch.lgamma(0.5 * nu)
        - 0.5 * torch.log(nu * math.pi)
        - torch.log(sigma)
        - 0.5 * (nu + 1.0) * torch.log1p(z * z / nu)
    )


#: Student-t noise, theta = [sigma, nu].  Not log-concave in f: the Laplace
#: path clips W >= 0 and its gradients are approximate there.
student_t = Likelihood(2, _student_t_logp, "student_t", log_concave=False)

__all__ = [
    "Likelihood",
    "bernoulli_logit",
    "bernoulli_probit",
    "gaussian",
    "laplace_noise",
    "log_ndtr",
    "poisson",
    "student_t",
]
