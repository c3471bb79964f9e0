"""The flat parameter-vector protocol of the reference ``GP.Observe``.

PyTorch twin of ``gogp_tpu/models/params.py``.  Layout:

    v = [log theta_simil..., log theta_noise...,
         (optional) x_1...x_n each ndim, y_1...y_n]

Hyperparameters are exp-transformed at this boundary, so autograd gradients
with respect to ``v`` are on log scale.  If anything follows the thetas,
inputs and outputs are read from ``v`` too ("withObs" mode); a tail whose
length is not a multiple of ndim + 1 is an error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gogp_torch.gp.core import GP, Posterior, absorb, lml

Tensor = torch.Tensor


class GPParams(NamedTuple):
    """Destructured parameter vector (natural-scale thetas)."""

    theta_simil: Tensor
    theta_noise: Tensor
    x: Tensor | None  # (n, ndim) or None in hyperparameters-only mode
    y: Tensor | None  # (n,) or None


def split_params(gp: GP, v: Tensor) -> GPParams:
    """Destructure ``v`` per the reference layout, exp-transforming thetas."""
    v = torch.as_tensor(v)
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise
    theta = torch.exp(v[: nts + ntn])
    theta_simil, theta_noise = theta[:nts], theta[nts:]
    rest = v[nts + ntn :]
    if rest.shape[0] == 0:
        return GPParams(theta_simil, theta_noise, None, None)
    n, rem = divmod(rest.shape[0], gp.ndim + 1)
    if rem != 0:
        raise ValueError(
            f"parameter vector tail of length {rest.shape[0]} is not a "
            f"multiple of ndim+1={gp.ndim + 1}"
        )
    x = rest[: n * gp.ndim].reshape(n, gp.ndim)
    y = rest[n * gp.ndim :]
    return GPParams(theta_simil, theta_noise, x, y)


def join_params(gp: GP, log_theta: Tensor, x: Tensor | None = None, y: Tensor | None = None) -> Tensor:
    """Inverse of :func:`split_params` (thetas supplied in log scale)."""
    parts = [torch.as_tensor(log_theta).reshape(-1)]
    if x is not None:
        parts.append(torch.as_tensor(x).reshape(-1))
        parts.append(torch.as_tensor(y).reshape(-1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def gp_posterior(gp: GP, v: Tensor, x=None, y=None, mask=None) -> Posterior:
    """Absorb under the parameter-vector protocol; ``x``/``y`` are the stored
    observations, used when ``v`` carries only hyperparameters."""
    p = split_params(gp, v)
    if p.x is not None:
        x, y = p.x, p.y
    if x is None:
        raise ValueError("no observations: pass x/y or a withObs parameter vector")
    return absorb(gp, p.theta_simil, p.theta_noise, x, y, mask)


def gp_observe(gp: GP, v: Tensor, x=None, y=None, mask=None, precision: str | None = None) -> Tensor:
    """Log marginal likelihood at a flat parameter vector (the reference
    ``GP.Observe``); 0 with no observations.  Autograd of it gives the
    reference ``GP.Gradient`` on both paths: on the kernel path through
    ``cholesky_blocked.lml_core``'s analytic GPML-5.9 backward."""
    v = torch.as_tensor(v)
    p = split_params(gp, v)
    if p.x is not None:
        x, y = p.x, p.y
    if x is None or torch.as_tensor(x).shape[0] == 0:
        return torch.zeros((), dtype=v.dtype, device=v.device)
    return lml(gp, p.theta_simil, p.theta_noise, x, y, mask, precision=precision)


def make_gp_logp(gp: GP, x=None, y=None, mask=None, precision: str | None = None):
    """Close over static data: returns ``logp(v) -> scalar``."""

    def logp(v):
        return gp_observe(gp, v, x=x, y=y, mask=mask, precision=precision)

    return logp
