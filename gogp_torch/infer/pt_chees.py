"""Parallel tempering with ChEES-HMC rung populations.

PyTorch twin of ``gogp_tpu/infer/pt_chees.py``.  L independent ladders of
K rungs: the L chains at rung k all target ``beta_k * logp``, a ChEES
population, so each rung owns a step size, trajectory length and mass
matrix adapted from its cross-ladder population.  DEO swaps act within each
ladder, exchanging states between adjacent rungs; the beta ladder, shared
by all ladders, is re-placed at each warmup window end at equal increments
of the communication barrier (Syed et al. 2019), endpoints pinned.

Layout: the rungs are the groups of ``chees.ChEESState`` (positions (K, L,
dim), every adaptation leaf with a leading K), and the L ladders are their
chains.  The tempered log-density of the whole (K * L, dim) batch is
``beta_row * logp(V)``, one beta per row, so each lockstep leapfrog step is
one value and gradient (one K7 launch) for every rung of every ladder; the
rungs run to the longest rung's trajectory, the others frozen, as the JAX
twin's vmap lowers its rung loop to a masked while.

Swaps move positions, raw log-densities and raw gradients between rungs;
tempered caches are rescaled by the destination beta; the adaptation state
stays with the temperature slot.  Randomness: the ChEES draws come from
``draws(state)`` (``chees.generator_draws`` by default), each sweep's swap
uniforms, (L, K), from ``swap_draws(state)`` (by default the state's
generator); tests hand in JAX's.

``axis_name``/``ladder_offset``: the ladders may be sharded over mesh axes
(``gogp_torch.parallel.sample.run_pt_chees_sharded``).  Each rank then holds
a slab of ladders from global index ``ladder_offset``; every rung's
cross-ladder adaptation statistic and the swap's pair statistics are
taken over every rank's ladders (``chees._cross_mean``), so every rank holds
the same ladder, and each
slab's ChEES and swap draws are its rows of the whole population's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import adapt
from gogp_torch.infer.chees import (
    ChEESState,
    _axis_size,
    _cross_mean,
    Draws,
    chees_init,
    chees_transition,
    chees_warmup_step,
    finalize_chees_warmup,
    generator_draws,
)
from gogp_torch.infer.tempering import (
    PTFlow,
    adapt_ladder_betas,
    flow_update,
    geometric_ladder,
    init_flow,
    swap_decision,
    tempered,
)

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]
SwapDraws = Callable[[ChEESState], Tensor]


class PTChEESResult(NamedTuple):
    positions: Tensor  # (num_samples, L, dim) cold-chain draws, all ladders
    logps: Tensor  # (num_samples, L) raw log-density at beta = 1
    swap_rate: Tensor  # () mean DEO acceptance over sampling
    state: ChEESState  # final rung-stacked state (leading axis K)
    betas: Tensor  # (K,) final ladder
    round_trips: Tensor  # () completed beta_min -> 1 trips, summed over ladders
    barrier: Tensor  # () estimated total communication barrier Lambda
    pair_rej: Tensor  # (K-1,) per-pair mean rejection over sampling


def generator_swap_draws(state: ChEESState) -> Tensor:
    """One sweep's uniforms (L, K), ladder by ladder, from the state's
    generator."""
    return torch.rand(state.logps.shape[::-1], dtype=state.logps.dtype, device=state.logps.device,
                      generator=state.rng)


def _rung_logp(logp: LogDensity, betas: Tensor, n_ladders: int) -> LogDensity:
    """The tempered log-density of the flattened (K * L, dim) batch."""
    return tempered(logp, betas.repeat_interleave(n_ladders))


def pt_chees_init(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    betas: Tensor,
    n_ladders: int,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    free: Tensor | None = None,
) -> ChEESState:
    """Rung-stacked ChEES state: positions (K, L, dim).  ``position0``:
    (dim,) shared init or (L, dim) per ladder; every rung starts from the
    same ladder positions."""
    position0 = torch.atleast_2d(torch.as_tensor(position0))
    position0 = position0.expand(n_ladders, position0.shape[-1])
    pos = position0.expand(betas.shape[0], *position0.shape).clone()
    return chees_init(_rung_logp(logp, betas, n_ladders), pos, rng, init_step_size, init_traj_length, free)


def _rung_transition(logp, state: ChEESState, betas: Tensor, adapt_traj: bool, max_num_steps: int,
                     traj_lr: float, free, draws: Draws, axis_name=None, ladder_offset: int = 0) -> ChEESState:
    """One ChEES transition of every rung (the groups), each on its own
    tempered target."""
    return chees_transition(_rung_logp(logp, betas, state.positions.shape[1]), state, adapt_traj=adapt_traj,
                            max_num_steps=max_num_steps, traj_lr=traj_lr, free=free, draws=draws,
                            axis_name=axis_name, chain_offset=ladder_offset)


def _swap_uniforms(swap_draws: SwapDraws, states: ChEESState, axis_name, ladder_offset: int) -> Tensor:
    """One sweep's (L, K) uniforms: with ``axis_name``, this slab's rows of
    the whole population's."""
    if axis_name is None:
        return swap_draws(states)
    K, L = states.logps.shape
    u = swap_draws(states._replace(logps=states.logps.new_empty((K, L * _axis_size(axis_name)))))
    return u[ladder_offset:ladder_offset + L]


def _pt_chees_swap(states: ChEESState, betas: Tensor, u: Tensor, parity: int, axis_name=None):
    """One DEO sweep across every ladder (``u``: (L, K) uniforms).  Returns
    the swapped states, the sources (K, L), the pair rejections averaged
    over the ladders, the pairs proposed and the mean accepted fraction
    (the averages over every rank's ladders with ``axis_name``)."""
    K, L = states.logps.shape
    raw = states.logps / betas[:, None]
    src, pair_probs, proposed, frac = swap_decision(betas, raw.T, u, parity)
    src = src.T  # (K, L): the source rung of each ladder's slot k
    ladder = torch.arange(L, device=src.device)[None, :]
    new_raw = raw[src, ladder]
    raw_grad = states.grads / betas[:, None, None]
    states = states._replace(positions=states.positions[src, ladder], logps=new_raw * betas[:, None],
                             grads=raw_grad[src, ladder] * betas[:, None, None])
    pair_rej = _cross_mean(torch.where(proposed, 1.0 - pair_probs, 0.0), axis_name, 0)
    return states, src, pair_rej, proposed.to(raw.dtype), _cross_mean(frac, axis_name, 0)


def _retemper(states: ChEESState, betas: Tensor, new_betas: Tensor) -> ChEESState:
    """Tempered caches moved from ``betas`` to ``new_betas``."""
    raw = states.logps / betas[:, None]
    raw_grad = states.grads / betas[:, None, None]
    return states._replace(logps=raw * new_betas[:, None], grads=raw_grad * new_betas[:, None, None])


def pt_chees_warm_chunk(
    logp, states: ChEESState, betas: Tensor, um, we, t0: int = 0,
    max_num_steps: int = 256, target_accept: float = 0.75, traj_lr: float = 0.025, free=None,
    adapt_ladder: bool = True, draws: Draws = generator_draws, swap_draws: SwapDraws = generator_swap_draws,
    axis_name=None, ladder_offset: int = 0,
) -> tuple[ChEESState, Tensor]:
    """len(um) warmup sweeps; returns the states and the (re-placed)
    ladder."""
    rej_sum = prop_count = betas.new_zeros(betas.shape[0] - 1)
    for t, (m, w) in enumerate(zip(um, we), start=t0):
        states = _rung_transition(logp, states, betas, True, max_num_steps, traj_lr, free, draws, axis_name,
                                  ladder_offset)
        states = chees_warmup_step(states, bool(m), bool(w), target_accept, axis_name)
        u = _swap_uniforms(swap_draws, states, axis_name, ladder_offset)
        states, _, pair_rej, prop, _ = _pt_chees_swap(states, betas, u, t % 2, axis_name)
        rej_sum, prop_count = rej_sum + pair_rej, prop_count + prop
        if adapt_ladder and w:
            new_betas = adapt_ladder_betas(betas, rej_sum, prop_count)
            states, betas = _retemper(states, betas, new_betas), new_betas
            rej_sum, prop_count = torch.zeros_like(rej_sum), torch.zeros_like(prop_count)
    return states, betas


def pt_chees_sample_chunk(
    logp, states: ChEESState, betas: Tensor, num: int, t0: int = 0,
    max_num_steps: int = 256, free=None, flow: PTFlow | None = None,
    draws: Draws = generator_draws, swap_draws: SwapDraws = generator_swap_draws,
    axis_name=None, ladder_offset: int = 0,
):
    """``num`` sampling sweeps; returns ``(states, positions (num, L, dim),
    raws (num, L), swap_fracs (num,), flow)`` of every (local) ladder's cold
    chain; ``flow``'s labels and trips are per ladder."""
    if flow is None:
        flow = init_flow(betas.shape[0], betas.dtype, betas.device, n_ladders=states.logps.shape[1])
    pos, raws, fracs = [], [], []
    for t in range(t0, t0 + num):
        states = _rung_transition(logp, states, betas, False, max_num_steps, 0.025, free, draws, axis_name,
                                  ladder_offset)
        u = _swap_uniforms(swap_draws, states, axis_name, ladder_offset)
        states, src, pair_rej, prop, frac = _pt_chees_swap(states, betas, u, t % 2, axis_name)
        flow = flow_update(flow, src.T, pair_rej, prop)
        pos.append(states.positions[0])
        raws.append(states.logps[0] / betas[0])
        fracs.append(frac)
    return states, torch.stack(pos), torch.stack(raws), torch.stack(fracs), flow


def run_pt_chees(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    n_ladders: int = 16,
    n_replicas: int = 8,
    beta_min: float = 0.1,
    betas: Tensor | None = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    adapt_ladder: bool = True,
    draws: Draws = generator_draws,
    swap_draws: SwapDraws = generator_swap_draws,
) -> PTChEESResult:
    """Parallel-tempered ChEES-HMC over L ladders x K rungs.  Returns the
    cold-chain draws of every ladder: positions (num_samples, n_ladders,
    dim)."""
    position0 = torch.as_tensor(position0)
    like = dict(dtype=position0.dtype, device=position0.device)
    betas = geometric_ladder(n_replicas, beta_min, **like) if betas is None else torch.as_tensor(betas, **like)
    states = pt_chees_init(logp, position0, rng, betas, n_ladders, init_step_size, init_traj_length, free)
    if num_warmup > 0:
        sched = adapt.build_schedule(num_warmup)
        states, betas = pt_chees_warm_chunk(logp, states, betas, sched.update_mass, sched.window_end, 0,
                                            max_num_steps, target_accept, traj_lr, free, adapt_ladder, draws,
                                            swap_draws)
        states = finalize_chees_warmup(states)
    states, positions, raws, fracs, flow = pt_chees_sample_chunk(logp, states, betas, num_samples, num_warmup,
                                                                 max_num_steps, free, None, draws, swap_draws)
    pair_rej = flow.rej_sum / torch.clamp(flow.prop_count, min=1.0)
    return PTChEESResult(positions, raws, fracs.mean(), states, betas, flow.trips.sum(), pair_rej.sum(), pair_rej)
