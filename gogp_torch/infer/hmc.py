"""Hamiltonian Monte Carlo building blocks: the leapfrog integrator.

PyTorch twin of the part of ``gogp_tpu/infer/hmc.py`` that ChEES-HMC
(``infer/chees.py``) uses: :class:`IntegratorState`, :class:`Samples`,
:func:`kinetic` and :func:`leapfrog`.  The per-chain HMC engine
(``HMCState``, ``hmc_transition``, ``warmup_step``, ``run_hmc``) waits in
ROADMAP.md with NUTS.

Positions carry the chain axis leading: (chains, dim).  A value-and-gradient
function maps such a batch to ((chains,), (chains, dim)).  The number of
leapfrog steps is a host integer, and the integrator a host loop (the JAX
twin's ``fori_loop``).

An optional 0/1 ``free`` mask pins coordinates: they get zero momentum and
zero gradient, so they never move.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tensor = torch.Tensor
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]


class IntegratorState(NamedTuple):
    position: Tensor
    momentum: Tensor
    logp: Tensor
    grad: Tensor


class Samples(NamedTuple):
    positions: Tensor  # (num_samples, chains, dim)
    logps: Tensor  # (num_samples, chains)
    accept_probs: Tensor  # (num_samples, chains)
    state: Any  # the final sampler state (tuned step size, mass, ...)


def leapfrog(
    value_and_grad: ValueAndGrad,
    state: IntegratorState,
    step_size: Tensor,
    inv_mass: Tensor,
    n_steps: int,
    free: Tensor | None = None,
) -> IntegratorState:
    """``n_steps`` velocity-Verlet steps."""
    for _ in range(n_steps):
        r = state.momentum + 0.5 * step_size * state.grad
        q = state.position + step_size * inv_mass * r
        if free is not None:
            q = torch.where(free > 0, q, state.position)
        logp, grad = value_and_grad(q)
        if free is not None:
            grad = grad * free
        r = r + 0.5 * step_size * grad
        state = IntegratorState(q, r, logp, grad)
    return state


def kinetic(momentum: Tensor, inv_mass: Tensor) -> Tensor:
    """0.5 r^T M^-1 r over the last axis (one value per chain)."""
    return 0.5 * (momentum * (inv_mass * momentum)).sum(-1)
