"""Hamiltonian Monte Carlo: the leapfrog integrator and windowed warmup.

PyTorch twin of ``gogp_tpu/infer/hmc.py``.  The JAX twin runs one chain and
vmaps it; here every function carries the chain axis in front and runs all
chains in lockstep: positions are (chains, dim), and the step size, the
dual-averaging state, the diagonal inverse mass and the Welford accumulator
are per chain ((chains,) and (chains, dim)), so each chain adapts alone, as
under vmap.  A value-and-gradient function maps a (chains, dim) batch to
((chains,), (chains, dim)): one batched evaluation per leapfrog step, which
on a theta-only GP study is one K7 launch (``tutorial/bayes.py``).

Differences from the JAX twin, each forced by PyTorch:

- The step count ``ceil(L / step)`` differs from chain to chain (the JAX
  ``fori_loop`` with a traced bound, batched by vmap).  Here every chain
  integrates to the largest count in one host loop, and a chain past its
  own count is frozen by ``torch.where``: its position, momentum, value and
  gradient stay as they were, as vmap's loop keeps them.
- The warmup schedule's flags (``update_mass``, ``window_end``) are host
  booleans shared by all chains, as the JAX twin's scan feeds every chain
  the same ones.
- Randomness: the JAX twin draws from ``split(rng, 3)`` per chain, which
  torch cannot reproduce.  Each transition takes its draws ``(r0_raw
  (chains, dim), u_acc (chains,))`` from one place, ``draws(state)``: by
  default :func:`generator_draws`, from the state's ``torch.Generator``;
  tests hand in JAX's own draws.

An optional 0/1 ``free`` mask pins coordinates: they get zero momentum and
zero gradient, so they never move.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gogp_torch.infer import adapt
from gogp_torch.utils.profiling import count, span

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]


class HMCState(NamedTuple):
    """The state of a chain batch: every field has the chain axis first."""

    position: Tensor  # (chains, dim)
    logp: Tensor  # (chains,)
    grad: Tensor  # (chains, dim)
    step_size: Tensor  # (chains,)
    inv_mass: Tensor  # (chains, dim) diagonal inverse mass matrix
    da: adapt.DualAveragingState  # per chain: (chains,) fields, t shared
    welford: adapt.WelfordState  # per chain: (chains, dim) moments, count shared
    accept_prob: Tensor  # (chains,) last transition's acceptance probability
    rng: torch.Generator  # on the positions' device


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


Draws = Callable[[HMCState], tuple[Tensor, Tensor]]


def generator_draws(state: HMCState) -> tuple[Tensor, Tensor]:
    """One transition's draws from the state's generator: standard normal
    momenta (chains, dim) and acceptance uniforms (chains,)."""
    chains, dim = state.position.shape
    like = dict(dtype=state.position.dtype, device=state.position.device, generator=state.rng)
    return torch.randn((chains, dim), **like), torch.rand((chains,), **like)


def value_and_grad(logp: LogDensity, free: Tensor | None) -> ValueAndGrad:
    """``q -> (logp(q), d logp / dq)`` for a (chains, dim) batch, by
    autograd (the counterpart of ``jax.vmap(jax.value_and_grad(logp))``);
    the gradient masked by ``free``.  A log-density whose backward returns
    a gradient it saved in its forward (``tutorial/bayes.py``'s K7 route)
    runs through the same code."""

    def vg(q: Tensor) -> tuple[Tensor, Tensor]:
        with span("vg", device=True):
            count("vg_calls")
            q = q.detach().requires_grad_(True)
            with torch.enable_grad():
                lp = logp(q)
                with span("vg.backward", device=True):
                    (g,) = torch.autograd.grad(lp.sum(), q)
            if free is not None:
                g = g * free
            return lp.detach(), g

    return vg


def as_free(free, like: Tensor) -> Tensor | None:
    """``free`` as a tensor of ``like``'s dtype and device (None stays None)."""
    return None if free is None else torch.as_tensor(free, dtype=like.dtype, device=like.device)


def where_chains(mask: Tensor, new, old):
    """Per-chain select, ``new`` where ``mask`` (chains,) holds, over a
    tensor with the chain axis first or a NamedTuple of them."""
    if isinstance(new, tuple):
        return type(new)(*(where_chains(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(-1, *[1] * (new.dim() - 1)), new, old)


def leapfrog_step(value_and_grad: ValueAndGrad, s: IntegratorState, step: Tensor, inv_mass: Tensor,
                  free: Tensor | None = None, active: Tensor | None = None) -> IntegratorState:
    """One velocity-Verlet step.  ``step`` broadcasts against the positions
    (a number, or (chains, 1) per chain).  Chains where ``active`` (chains,)
    is False keep their state, and are evaluated at their own position."""
    r = s.momentum + 0.5 * step * s.grad
    q = s.position + step * inv_mass * r
    if free is not None:
        q = torch.where(free > 0, q, s.position)
    if active is not None:
        q = torch.where(active[:, None], q, s.position)
    logp, grad = value_and_grad(q)
    if free is not None:
        grad = grad * free
    r = r + 0.5 * step * grad
    new = IntegratorState(q, r, logp, grad)
    return new if active is None else where_chains(active, new, s)


def leapfrog(
    value_and_grad: ValueAndGrad,
    state: IntegratorState,
    step_size: Tensor,
    inv_mass: Tensor,
    n_steps: int | Tensor,
    free: Tensor | None = None,
) -> IntegratorState:
    """``n_steps`` velocity-Verlet steps: a host integer, or (chains,) per
    chain, in which case every chain runs to the largest and a chain past
    its own count keeps its state."""
    if isinstance(n_steps, int):
        for _ in range(n_steps):
            state = leapfrog_step(value_and_grad, state, step_size, inv_mass, free)
        return state
    for k in range(int(n_steps.max())):
        state = leapfrog_step(value_and_grad, state, step_size, inv_mass, free, active=n_steps > k)
    return state


def kinetic(momentum: Tensor, inv_mass: Tensor) -> Tensor:
    """0.5 r^T M^-1 r over the last axis (one value per chain)."""
    return 0.5 * (momentum * (inv_mass * momentum)).sum(-1)


def sample_momentum(r0_raw: Tensor, inv_mass: Tensor, free: Tensor | None = None) -> Tensor:
    """Momenta r ~ N(0, M) from standard normal draws."""
    r = r0_raw / torch.sqrt(inv_mass)
    return r if free is None else r * free


def _welford_init(chains: int, dim: int, like: Tensor) -> adapt.WelfordState:
    """One accumulator per chain: (chains, dim) moments, one shared count
    (every chain is fed at the same transitions)."""
    w = adapt.welford_init(dim, like.dtype, like.device)
    return w._replace(mean=like.new_zeros((chains, dim)), m2=like.new_zeros((chains, dim)))


def init_state(
    logp: LogDensity,
    position: Tensor,
    rng: torch.Generator,
    step_size: float = 0.1,
    free: Tensor | None = None,
) -> HMCState:
    position = torch.atleast_2d(torch.as_tensor(position))
    val, grad = value_and_grad(logp, as_free(free, position))(position)
    chains, dim = position.shape
    like = dict(dtype=position.dtype, device=position.device)
    return HMCState(
        position=position,
        logp=val,
        grad=grad,
        step_size=torch.full((chains,), step_size, **like),
        inv_mass=torch.ones((chains, dim), **like),
        da=adapt.da_init(torch.full((chains,), step_size, **like)),
        welford=_welford_init(chains, dim, position),
        accept_prob=torch.zeros((chains,), **like),
        rng=rng,
    )


def hmc_transition(
    logp: LogDensity,
    state: HMCState,
    trajectory_length: float = 1.0,
    max_num_steps: int = 1024,
    free: Tensor | None = None,
    divergence_threshold: float = 1000.0,
    draws: Draws = generator_draws,
) -> HMCState:
    """One HMC transition of every chain: momentum, about
    ``trajectory_length`` of leapfrog (each chain ``ceil(length / its
    step)`` steps, at most ``max_num_steps``), Metropolis accept."""
    freea = as_free(free, state.position)
    vg = value_and_grad(logp, freea)
    r0_raw, u_acc = draws(state)
    r0 = sample_momentum(r0_raw, state.inv_mass, freea)
    energy0 = -state.logp + kinetic(r0, state.inv_mass)

    n_steps = torch.clamp(torch.ceil(trajectory_length / state.step_size).to(torch.int32), 1, max_num_steps)
    integ = IntegratorState(state.position, r0, state.logp, state.grad)
    integ = leapfrog(vg, integ, state.step_size[:, None], state.inv_mass, n_steps, freea)

    energy1 = -integ.logp + kinetic(integ.momentum, state.inv_mass)
    delta = energy1 - energy0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    accept_prob = torch.where(delta > divergence_threshold, 0.0, torch.clamp(torch.exp(-delta), max=1.0))
    accept = u_acc < accept_prob
    return state._replace(
        position=torch.where(accept[:, None], integ.position, state.position),
        logp=torch.where(accept, integ.logp, state.logp),
        grad=torch.where(accept[:, None], integ.grad, state.grad),
        accept_prob=accept_prob,
    )


def warmup_step(state: HMCState, update_mass: bool, window_end: bool, target_accept: float = 0.8) -> HMCState:
    """Adaptation bookkeeping after one transition (shared by HMC and NUTS),
    each chain on its own statistics:

    - always: the dual-averaging step-size update from its accept statistic;
    - if ``update_mass``: its position into its Welford accumulator;
    - if ``window_end``: its inv_mass from the window's variance, the
      accumulator reset, and dual averaging restarted at its step size.
    """
    da = adapt.da_update(state.da, state.accept_prob, target=target_accept)
    step_size = torch.exp(da.log_step)
    welford = adapt.welford_update(state.welford, state.position) if update_mass else state.welford
    inv_mass = state.inv_mass
    if window_end:
        new_inv_mass = adapt.welford_variance(welford)
        # keep the mass if the window was empty
        inv_mass = torch.where(welford.count > 1, new_inv_mass, inv_mass)
        welford = _welford_init(*inv_mass.shape, inv_mass)
        da = adapt.da_init(torch.exp(da.log_step))
    return state._replace(step_size=step_size, da=da, welford=welford, inv_mass=inv_mass)


def finalize_warmup(state: HMCState) -> HMCState:
    """Freeze each chain's step size at its dual-averaging iterate average."""
    return state._replace(step_size=torch.exp(state.da.log_step_avg))


def run_sampler(transition: Callable[[HMCState], HMCState], state: HMCState, num_warmup: int,
                num_samples: int, target_accept: float = 0.8) -> Samples:
    """Windowed warmup then sampling with ``transition``, the loop of
    :func:`run_hmc` and ``nuts.run_nuts``."""
    if num_warmup > 0:
        for um, we in zip(*adapt.build_schedule(num_warmup)):
            state = warmup_step(transition(state), bool(um), bool(we), target_accept)
        state = finalize_warmup(state)
    pos, lps, accs = [], [], []
    for _ in range(num_samples):
        state = transition(state)
        pos.append(state.position)
        lps.append(state.logp)
        accs.append(state.accept_prob)
    dim = state.position.shape
    if not pos:
        empty = state.position.new_zeros((0, *dim))
        return Samples(empty, empty[..., 0], empty[..., 0], state)
    return Samples(torch.stack(pos), torch.stack(lps), torch.stack(accs), state)


def run_hmc(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    trajectory_length: float = 1.0,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Tensor | None = None,
    max_num_steps: int = 1024,
    draws: Draws = generator_draws,
) -> Samples:
    """Warmup then sampling of every chain of ``position0`` (chains, dim);
    the returned positions are (num_samples, chains, dim)."""
    state = init_state(logp, position0, rng, init_step_size, free)

    def transition(s):
        return hmc_transition(logp, s, trajectory_length, max_num_steps, free, draws=draws)

    return run_sampler(transition, state, num_warmup, num_samples, target_accept)
