"""Primitive stationary kernels.

PyTorch twin of ``gogp_tpu/kernels/stationary.py``.  Each pair function
reduces over the last axis of its broadcast inputs (see ``base.py``), through
the Euclidean distance where the JAX twin does.  Hyperparameters arrive in
natural scale; the exp-transform happens at the parameter boundary
(``gogp_torch/models/params.py``).
"""

from __future__ import annotations

import math

import torch

from gogp_torch.kernels.base import Kernel

SQRT3 = 1.7320508075688772
SQRT5 = 2.2360679774997900


def _dist(xa, xb):
    """Euclidean distance over the last axis, safe to differentiate at zero.

    sqrt has an infinite derivative at 0 and every stationary kernel is
    evaluated at xa == xb on the covariance diagonal, so zero-distance pairs
    take a zero gradient instead of NaN.
    """
    diff = xa - xb
    sq = torch.sum(diff * diff, dim=-1)
    zero = sq == 0.0
    safe = torch.where(zero, torch.ones_like(sq), sq)
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(safe))


def _normal_pair(theta, xa, xb):
    # exp(-d^2/2), d = |xa-xb|/l; no output scale (compose one with .scaled())
    diff = (xa - xb) / theta[0]
    return torch.exp(-torch.sum(diff * diff, dim=-1) / 2)


normal = Kernel(1, _normal_pair, "normal", ("rbf",))
rbf = normal


def _periodic_pair(theta, xa, xb):
    # exp(-2 sum_d (sin(pi tau_d / p) / l)^2), tau = xa - xb: the
    # per-dimension product form, PSD in every dimension
    l, p = theta[0], theta[1]
    s = torch.sin(math.pi * (xa - xb) / p) / l
    return torch.exp(-2 * torch.sum(s * s, dim=-1))


periodic = Kernel(2, _periodic_pair, "periodic", ("periodic",))


def _matern32_pair(theta, xa, xb):
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT3 * d) * torch.exp(-SQRT3 * d)


matern32 = Kernel(1, _matern32_pair, "matern32", ("matern", 3))


def _matern52_pair(theta, xa, xb):
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + (5.0 / 3.0) * d * d) * torch.exp(-SQRT5 * d)


matern52 = Kernel(1, _matern52_pair, "matern52", ("matern", 5))


def _rq_pair(theta, xa, xb):
    # rational quadratic: (1 + d^2 / (2 alpha l^2))^-alpha
    l, alpha = theta[0], theta[1]
    diff = xa - xb
    d2 = torch.sum(diff * diff, dim=-1)
    return (1.0 + d2 / (2.0 * alpha * l * l)) ** (-alpha)


rational_quadratic = Kernel(2, _rq_pair, "rational_quadratic", ("rq",))


def _linear_pair(theta, xa, xb):
    # dot product about an offset c, <xa - c, xb - c>; under the exp-transform
    # of the parameter protocol c is positive
    c = theta[0]
    return torch.sum((xa - c) * (xb - c), dim=-1)


linear = Kernel(1, _linear_pair, "linear")


def _white_pair(theta, xa, xb):
    # white noise as a similarity kernel: variance theta^2 only where xa == xb
    same = torch.all(xa - xb == 0.0, dim=-1)
    return torch.where(same, theta[0] * theta[0], torch.zeros((), dtype=theta.dtype, device=theta.device))


white = Kernel(1, _white_pair, "white")


def _matern52_ref_pair(theta, xa, xb):
    # The reference Matern-5/2 as it really computes: its ``5/3*d*d`` is Go
    # integer constant division, which makes the coefficient 1.
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + d * d) * torch.exp(-SQRT5 * d)


matern52_ref = Kernel(1, _matern52_ref_pair, "matern52_ref", ("matern52_ref",))


def _matern12_pair(theta, xa, xb):
    # Ornstein-Uhlenbeck / exponential: exp(-d), d = |xa-xb|/l
    d = _dist(xa, xb) / theta[0]
    return torch.exp(-d)


matern12 = Kernel(1, _matern12_pair, "matern12", ("matern", 1))
exponential = matern12

_TWO_PI_SQ = 2.0 * math.pi * math.pi
_TWO_PI = 2.0 * math.pi


def spectral_mixture(q: int, ndim: int = 1) -> Kernel:
    """Spectral mixture kernel (Wilson & Adams 2013), Q components:

        k(tau) = sum_q w_q prod_d exp(-2 pi^2 tau_d^2 v_qd) cos(2 pi mu_qd tau_d),

    tau = xa - xb, theta (natural scale) = [w_1..w_Q | mu (Q*ndim) | v (Q*ndim)].
    One component with mu = 0 is the RBF kernel scaled by w."""
    if q < 1:
        raise ValueError(f"spectral_mixture needs q >= 1, got {q}")

    def pair(theta, xa, xb):
        w = theta[:q]
        mu = theta[q : q + q * ndim].reshape(q, ndim)
        v = theta[q + q * ndim :].reshape(q, ndim)
        tau = (xa - xb)[..., None, :]  # (..., 1, ndim)
        envelope = torch.exp(-_TWO_PI_SQ * (tau * tau) * v)  # (..., q, ndim)
        phase = torch.cos(_TWO_PI * mu * tau)
        return torch.sum(w * torch.prod(envelope * phase, dim=-1), dim=-1)

    return Kernel(q * (1 + 2 * ndim), pair, f"spectral_mixture(q={q})", ("sm", q, ndim))
