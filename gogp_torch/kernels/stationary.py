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


normal = Kernel(1, _normal_pair, "normal")
rbf = normal


def _periodic_pair(theta, xa, xb):
    # exp(-2 sum_d (sin(pi tau_d / p) / l)^2), tau = xa - xb: the
    # per-dimension product form, PSD in every dimension
    l, p = theta[0], theta[1]
    s = torch.sin(math.pi * (xa - xb) / p) / l
    return torch.exp(-2 * torch.sum(s * s, dim=-1))


periodic = Kernel(2, _periodic_pair, "periodic")


def _matern32_pair(theta, xa, xb):
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT3 * d) * torch.exp(-SQRT3 * d)


matern32 = Kernel(1, _matern32_pair, "matern32")


def _matern52_pair(theta, xa, xb):
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + (5.0 / 3.0) * d * d) * torch.exp(-SQRT5 * d)


matern52 = Kernel(1, _matern52_pair, "matern52")


def _rq_pair(theta, xa, xb):
    # rational quadratic: (1 + d^2 / (2 alpha l^2))^-alpha
    l, alpha = theta[0], theta[1]
    diff = xa - xb
    d2 = torch.sum(diff * diff, dim=-1)
    return (1.0 + d2 / (2.0 * alpha * l * l)) ** (-alpha)


rational_quadratic = Kernel(2, _rq_pair, "rational_quadratic")


def _matern52_ref_pair(theta, xa, xb):
    # The reference Matern-5/2 as it really computes: its ``5/3*d*d`` is Go
    # integer constant division, which makes the coefficient 1.
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + d * d) * torch.exp(-SQRT5 * d)


matern52_ref = Kernel(1, _matern52_ref_pair, "matern52_ref")
