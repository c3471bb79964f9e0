"""Elementary log-densities for priors.

PyTorch twin of ``gogp_tpu/dists/__init__.py`` (Infergo's ``dist`` package as
the tutorials use it).  Every function broadcasts and differentiates under
autograd.  Arguments may mix tensors and Python numbers; numbers take the
dtype and device of the first tensor argument (torch's default dtype if
there is none); a tuple of numbers is a vector.  A number or tuple becomes
a tensor once per dtype and device: on a card each new one is a copy from
the host that waits for the card, and a sampler calls its priors once per
leapfrog step.
"""

from __future__ import annotations

import functools
import math

import torch

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def _tensors(*args) -> list[Tensor]:
    ref = next((a for a in args if isinstance(a, Tensor)), None)
    dtype = torch.get_default_dtype() if ref is None else ref.dtype
    device = None if ref is None else ref.device
    return [_constant(a, dtype, device) if isinstance(a, (int, float, tuple))
            else torch.as_tensor(a, dtype=dtype, device=device) for a in args]


@functools.lru_cache(maxsize=256)
def _constant(value, dtype: torch.dtype, device) -> Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device)


def normal_logp(mu, sigma, x):
    """log N(x | mu, sigma).  Infergo dist.Normal.Logp(mu, sigma, x)."""
    mu, sigma, x = _tensors(mu, sigma, x)
    z = (x - mu) / sigma
    return -0.5 * (z * z + _LOG_2PI) - torch.log(sigma)


def expon_logp(lam, x):
    """log Expon(x | rate lam).  Infergo dist.Expon.Logp(lambda, x)."""
    lam, x = _tensors(lam, x)
    return torch.log(lam) - lam * x


def laplace_logp(mu, b, x):
    """log Laplace(x | mu, scale b).  The anynoise tutorial's Exponential on
    the absolute residual is this plus log 2."""
    mu, b, x = _tensors(mu, b, x)
    return -torch.abs(x - mu) / b - torch.log(2.0 * b)


def lognormal_logp(mu, sigma, x):
    """log LogNormal(x | mu, sigma)."""
    mu, sigma, x = _tensors(mu, sigma, x)
    lx = torch.log(x)
    z = (lx - mu) / sigma
    return -0.5 * (z * z + _LOG_2PI) - torch.log(sigma) - lx


def halfnormal_logp(sigma, x):
    """log HalfNormal(x | sigma) for x >= 0."""
    sigma, x = _tensors(sigma, x)
    z = x / sigma
    return 0.5 * math.log(2.0 / math.pi) - torch.log(sigma) - 0.5 * z * z


def gamma_logp(alpha, beta, x):
    """log Gamma(x | shape alpha, rate beta)."""
    alpha, beta, x = _tensors(alpha, beta, x)
    return alpha * torch.log(beta) + (alpha - 1) * torch.log(x) - beta * x - torch.special.gammaln(alpha)
