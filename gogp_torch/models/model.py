"""Log-density composition and gradient masking.

PyTorch twin of ``gogp_tpu/models/model.py``.  Models are plain functions
``logp(v) -> scalar``; composition is addition, and constraints are a 0/1
``free`` mask applied to the gradient (the reference tutorials' Gradient()
overrides), so pinned coordinates never move from their initialization.
"""

from __future__ import annotations

from typing import Callable

import torch

from gogp_torch.utils.profiling import count, span

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]


def add_logps(*logps: LogDensity) -> LogDensity:
    """Sum of log-densities."""

    def logp(v):
        total = logps[0](v)
        for f in logps[1:]:
            total = total + f(v)
        return total

    return logp


def masked_value_and_grad(logp: LogDensity, free: Tensor | None = None):
    """``v -> (value, grad)`` of ``logp`` by ``torch.autograd.grad``, with
    the gradients of pinned coordinates (``free`` 0.0) zeroed.  Both come
    back detached; a ``logp`` that does not depend on ``v`` has gradient 0."""

    def value_and_grad(v):
        with span("vg", device=True):
            count("vg_calls")
            v = torch.as_tensor(v).detach().requires_grad_(True)
            with torch.enable_grad():
                value = logp(v)
                if value.requires_grad:
                    with span("vg.backward", device=True):
                        (grad,) = torch.autograd.grad(value, v)
                else:
                    grad = torch.zeros_like(v)
            if free is not None:
                grad = grad * torch.as_tensor(free, dtype=grad.dtype, device=grad.device)
            return value.detach(), grad

    return value_and_grad


def free_mask_warpedtime(n_theta: int, n: int, ndim: int = 1, dtype=None, device=None) -> Tensor:
    """warpedtime constraint: all thetas and interior inputs free; first and
    last input and all outputs pinned."""
    m = torch.ones(n_theta + n * ndim + n, dtype=dtype, device=device)
    if n > 0:
        m[n_theta : n_theta + ndim] = 0.0  # first input
        m[n_theta + (n - 1) * ndim :] = 0.0  # last input + all outputs
    return m


def free_mask_anynoise(n_theta: int, n: int, ndim: int = 1, dtype=None, device=None) -> Tensor:
    """anynoise constraint: thetas and outputs free, all inputs pinned."""
    m = torch.ones(n_theta + n * ndim + n, dtype=dtype, device=device)
    if n > 0:
        m[n_theta : n_theta + n * ndim] = 0.0
    return m
