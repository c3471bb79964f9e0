"""Parallel tempering: a replica ladder with non-reversible (DEO) swaps.

PyTorch twin of ``gogp_tpu/infer/tempering.py``.  A ladder of K replicas
targets ``beta_k * logp`` (``betas[0] = 1 > ... > betas[K-1] = beta_min``)
and states flow between adjacent temperatures, so the hot replicas carry
mode-hopping moves down to beta = 1:

- swaps follow the deterministic even-odd scheme (Okabe et al.; Syed et al.
  2019): even sweeps propose pairs (0,1)(2,3)..., odd sweeps (1,2)(3,4)...;
- a swap exchanges positions; the cached log-density and gradient are
  tempered values, so they move with a rescale by the destination beta;
- acceptance: log A = (beta_i - beta_j) (raw_j - raw_i), raw = tempered /
  beta, one uniform per pair, drawn for its left member;
- during warmup, at each adaptation-window end, the rungs are re-placed at
  equal increments of the communication barrier estimated from the pairs'
  Rao-Blackwellized rejections, the endpoints pinned.

:func:`run_pt_nuts` runs its K replicas as one lockstep NUTS batch of K
chains (``nuts.nuts_transition``): the tempered log-density of the batch is
``betas * logp(V)``, one beta per row, so one value and gradient serves the
whole ladder, and each replica keeps its own
step-size and mass adaptation as under the JAX twin's vmap.

Randomness: the NUTS draws come from ``draws(state)`` as in ``nuts``; each
sweep's swap uniforms from ``swap_draws(state)`` (by default the state's
generator), where the JAX twin splits its loop key.  Tests hand in JAX's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import adapt
from gogp_torch.infer.hmc import HMCState, finalize_warmup, init_state, warmup_step
from gogp_torch.infer.nuts import NUTSDraws, generator_draws, nuts_transition

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]
SwapDraws = Callable[[HMCState], Tensor]


def geometric_ladder(n_replicas: int, beta_min: float = 0.1, dtype=torch.float32, device=None) -> Tensor:
    """betas[0] = 1 down to betas[-1] = beta_min, geometric spacing."""
    if n_replicas == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    return beta_min ** (torch.arange(n_replicas, dtype=dtype, device=device) / (n_replicas - 1))


def tempered(logp: LogDensity, betas: Tensor) -> LogDensity:
    """``V -> betas * logp(V)`` for a batch whose rows follow ``betas``
    (one beta per row)."""
    return lambda V: betas * logp(V)


def swap_decision(betas: Tensor, raw_logp: Tensor, u: Tensor, parity: int):
    """DEO swap decisions for one sweep of the ladder (of each ladder, over
    leading axes of ``raw_logp`` (..., K) and ``u`` (..., K), the sweep's
    uniforms; pair (i, i+1) uses its left member's).

    Returns ``(src, pair_probs, proposed, swap_frac)``: ``src[..., k]`` the
    replica whose position slot k receives, ``pair_probs[..., i]`` the
    acceptance probability min(1, e^delta) of pair (i, i+1) (zero where not
    proposed), ``proposed[i]`` the pairs proposed under this parity, and
    the sweep's accepted fraction.
    """
    K = betas.shape[0]
    idx = torch.arange(K, device=betas.device)
    is_left = (idx % 2) == parity % 2
    partner = torch.clamp(torch.where(is_left, idx + 1, idx - 1), 0, K - 1)
    valid = partner != idx
    delta = (betas - betas[partner]) * (raw_logp[..., partner] - raw_logp)
    left_idx = torch.minimum(idx, partner)
    accept = valid & (torch.log(u[..., left_idx]) < delta)
    src = torch.where(accept, partner, idx)
    swap_frac = accept.to(raw_logp.dtype).sum(-1) / torch.clamp(valid.sum(), min=1).to(raw_logp.dtype)

    proposed = (idx[:-1] % 2) == parity % 2
    pair_delta = (betas[:-1] - betas[1:]) * (raw_logp[..., 1:] - raw_logp[..., :-1])
    pair_probs = torch.where(proposed, torch.clamp(torch.exp(pair_delta), max=1.0), 0.0)
    return src, pair_probs, proposed, swap_frac


def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, xp increasing, held
    constant beyond the ends (``numpy.interp``; the arithmetic of
    ``jnp.interp``)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    flat = dx.abs() <= torch.finfo(xp.dtype).eps ** 2  # numpy's spacing(eps)
    f = torch.where(flat, fp[i - 1], fp[i - 1] + (delta / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def place_rungs(betas: Tensor, rej_mean: Tensor, n_new: int) -> Tensor:
    """Place ``n_new`` rungs at equal increments of the cumulative
    communication barrier estimated on the grid ``betas`` (Syed et al. 2019,
    §5.2).  ``rej_mean``: (K-1,) mean rejection of each adjacent pair.  The
    endpoints stay pinned."""
    K = betas.shape[0]
    lam = torch.cat([betas.new_zeros(1), torch.cumsum(rej_mean, 0)])
    lam = lam + torch.arange(K, dtype=betas.dtype, device=betas.device) * 1e-6
    if n_new > 1:  # jnp.linspace's arithmetic: start (1 - s) + stop s, the end exact
        s = torch.arange(n_new - 1, dtype=betas.dtype, device=betas.device) / (n_new - 1)
        targets = torch.cat([lam[0] * (1 - s) + lam[-1] * s, lam[-1:]])
    else:
        targets = lam[:1]
    new = _interp(targets, lam, betas)
    new[0] = betas[0]
    new[-1] = betas[-1]
    return new


def adapt_ladder_betas(betas: Tensor, rej_sum: Tensor, prop_count: Tensor) -> Tensor:
    """Round-trip-optimal ladder update (Syed et al. 2019, §5.2): the K
    rungs at equal increments of the barrier estimated from each pair's
    mean rejection; endpoints pinned."""
    return place_rungs(betas, rej_sum / torch.clamp(prop_count, min=1.0), betas.shape[0])


def _swap_sweep(states: HMCState, betas: Tensor, raw_logp: Tensor, u: Tensor, parity: int):
    """One DEO sweep over the ladder's adjacent pairs: positions, raw values
    and raw gradients travel, tempered caches rescale.  Returns the swapped
    states and raws, the sweep's accepted fraction, the pair statistics and
    the sources."""
    src, pair_probs, proposed, swap_frac = swap_decision(betas, raw_logp, u, parity)
    new_raw = raw_logp[src]
    raw_grad = states.grad / betas[:, None]
    new_states = states._replace(position=states.position[src], logp=new_raw * betas,
                                 grad=raw_grad[src] * betas[:, None])
    return new_states, new_raw, swap_frac, pair_probs, proposed, src


class PTFlow(NamedTuple):
    """Replica-flow and pair statistics threaded across sampling chunks."""

    labels: Tensor  # ([L,] K) int32: +1 travelling up (hot->cold), -1 down
    trips: Tensor  # ([L]) int32: completed beta_min -> 1 round trips
    rej_sum: Tensor  # (K-1,) summed expected rejection of adjacent pairs
    prop_count: Tensor  # (K-1,) number of times each pair was proposed


def init_flow(n_replicas: int, dtype=torch.float32, device=None, n_ladders: int | None = None) -> PTFlow:
    """A fresh flow; with ``n_ladders``, labels and trips per ladder."""
    lead = () if n_ladders is None else (n_ladders,)
    return PTFlow(
        labels=torch.zeros(lead + (n_replicas,), dtype=torch.int32, device=device),
        trips=torch.zeros(lead, dtype=torch.int32, device=device),
        rej_sum=torch.zeros((n_replicas - 1,), dtype=dtype, device=device),
        prop_count=torch.zeros((n_replicas - 1,), dtype=dtype, device=device),
    )


def flow_update(flow: PTFlow, src: Tensor, pair_rej: Tensor, prop: Tensor) -> PTFlow:
    """Labels travel with the states (``src`` ([L,] K)): +1 after visiting
    the hottest rung, -1 after the coldest; an up-labelled state reaching
    the cold end completes a round trip.  Adds the sweep's pair rejections
    and proposals."""
    labels = torch.gather(flow.labels, -1, src)
    trips = flow.trips + (labels[..., 0] > 0).to(flow.trips.dtype)
    labels = labels.clone()
    labels[..., 0] = -1
    labels[..., -1] = 1
    return PTFlow(labels, trips, flow.rej_sum + pair_rej, flow.prop_count + prop)


class PTResult(NamedTuple):
    positions: Tensor  # (num_samples, dim): the beta = 1 replica
    logps: Tensor  # (num_samples,) raw log-density at beta = 1
    swap_rate: Tensor  # () mean DEO acceptance over sampling
    state: HMCState  # final replica-stacked state
    betas: Tensor
    # round trips completed during sampling (cold-chain ESS cannot exceed
    # about twice this: whether mixing is ladder-limited)
    round_trips: Tensor | None = None
    # estimated total communication barrier Lambda (sum of the pairs' mean
    # rejections over sampling); K ~ 2 Lambda is the efficient depth
    barrier: Tensor | None = None
    pair_rej: Tensor | None = None  # (K-1,) per-pair mean rejection over sampling


def generator_swap_draws(state: HMCState) -> Tensor:
    """One sweep's uniforms (K,) from the state's generator."""
    return torch.rand(state.logp.shape, dtype=state.logp.dtype, device=state.logp.device, generator=state.rng)


def pt_init(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    betas: Tensor,
    init_step_size: float = 0.1,
    free: Tensor | None = None,
) -> HMCState:
    """The replica-stacked state: ``position0`` (dim,) shared by every
    replica, or (K, dim)."""
    position0 = torch.as_tensor(position0)
    if position0.dim() == 1:
        position0 = position0.expand(betas.shape[0], -1).clone()
    return init_state(tempered(logp, betas), position0, rng, init_step_size, free)


def pt_warm_chunk(logp, states: HMCState, betas: Tensor, um, we, t0: int = 0, max_tree_depth: int = 6,
                  target_accept: float = 0.8, free=None, adapt_ladder: bool = True,
                  draws: Callable[[HMCState], NUTSDraws] = generator_draws,
                  swap_draws: SwapDraws = generator_swap_draws) -> tuple[HMCState, Tensor]:
    """len(um) warmup sweeps (transition, adaptation, swap, and at each
    window end the ladder re-placed); returns the states and the ladder."""
    rej_sum = prop_count = betas.new_zeros(betas.shape[0] - 1)
    for t, (m, w) in enumerate(zip(um, we), start=t0):
        states = nuts_transition(tempered(logp, betas), states, max_tree_depth, free, draws)
        states = warmup_step(states, bool(m), bool(w), target_accept)
        raw = states.logp / betas
        states, raw, _, pair_probs, proposed, _ = _swap_sweep(states, betas, raw, swap_draws(states), t % 2)
        rej_sum = rej_sum + torch.where(proposed, 1.0 - pair_probs, 0.0)
        prop_count = prop_count + proposed.to(rej_sum.dtype)
        if adapt_ladder and w:
            # raw values are beta-free; step size and mass stay with the slot
            new_betas = adapt_ladder_betas(betas, rej_sum, prop_count)
            states = states._replace(logp=raw * new_betas, grad=states.grad / betas[:, None] * new_betas[:, None])
            betas, rej_sum, prop_count = new_betas, torch.zeros_like(rej_sum), torch.zeros_like(prop_count)
    return states, betas


def pt_sample_chunk(logp, states: HMCState, betas: Tensor, num: int, t0: int = 0, max_tree_depth: int = 6,
                    free=None, flow: PTFlow | None = None,
                    draws: Callable[[HMCState], NUTSDraws] = generator_draws,
                    swap_draws: SwapDraws = generator_swap_draws):
    """``num`` sampling sweeps; returns ``(states, positions (num, dim),
    raws (num,), swap_fracs (num,), flow)`` of the cold chain, ``flow``
    threading the round trips and pair statistics across chunks."""
    if flow is None:
        flow = init_flow(betas.shape[0], betas.dtype, betas.device)
    pos, raws, fracs = [], [], []
    for t in range(t0, t0 + num):
        states = nuts_transition(tempered(logp, betas), states, max_tree_depth, free, draws)
        raw = states.logp / betas
        states, raw, frac, pair_probs, proposed, src = _swap_sweep(states, betas, raw, swap_draws(states), t % 2)
        flow = flow_update(flow, src, torch.where(proposed, 1.0 - pair_probs, 0.0), proposed.to(flow.rej_sum.dtype))
        pos.append(states.position[0])
        raws.append(raw[0])
        fracs.append(frac)
    return states, torch.stack(pos), torch.stack(raws), torch.stack(fracs), flow


def run_pt_nuts(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    n_replicas: int = 8,
    beta_min: float = 0.1,
    betas: Tensor | None = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Tensor | None = None,
    adapt_ladder: bool = True,
    draws: Callable[[HMCState], NUTSDraws] = generator_draws,
    swap_draws: SwapDraws = generator_swap_draws,
) -> PTResult:
    """Parallel-tempered NUTS; returns the cold-chain (beta = 1) draws.

    ``position0``: (dim,) shared init, or (n_replicas, dim) per replica.
    ``adapt_ladder``: re-place the rungs at every warmup window end; the
    final ladder is ``PTResult.betas``.
    """
    position0 = torch.as_tensor(position0)
    like = dict(dtype=position0.dtype, device=position0.device)
    betas = geometric_ladder(n_replicas, beta_min, **like) if betas is None else torch.as_tensor(betas, **like)
    states = pt_init(logp, position0, rng, betas, init_step_size, free)
    if num_warmup > 0:
        sched = adapt.build_schedule(num_warmup)
        states, betas = pt_warm_chunk(logp, states, betas, sched.update_mass, sched.window_end, 0, max_tree_depth,
                                      target_accept, free, adapt_ladder, draws, swap_draws)
        states = finalize_warmup(states)
    states, positions, raws, fracs, flow = pt_sample_chunk(logp, states, betas, num_samples, num_warmup,
                                                           max_tree_depth, free, None, draws, swap_draws)
    pair_rej = flow.rej_sum / torch.clamp(flow.prop_count, min=1.0)
    return PTResult(positions, raws, fracs.mean(), states, betas, flow.trips, pair_rej.sum(), pair_rej)


def tune_ladder(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    beta_min: float = 0.1,
    pilot_replicas: int = 8,
    pilot_warmup: int = 256,
    pilot_samples: int = 128,
    growth: float = 2.0,
    max_replicas: int = 64,
    max_tree_depth: int = 6,
    free: Tensor | None = None,
) -> tuple[Tensor, PTResult]:
    """The ladder's depth from a pilot run (Syed et al. 2019): the pilot's
    barrier Lambda sets K* = clip(ceil(1 + growth Lambda), 2,
    max_replicas), placed at equal barrier increments on the pilot's grid.
    Returns ``(betas_star, pilot_result)``."""
    pilot = run_pt_nuts(logp, position0, rng, n_replicas=pilot_replicas, beta_min=beta_min,
                        num_warmup=pilot_warmup, num_samples=pilot_samples, max_tree_depth=max_tree_depth,
                        free=free, adapt_ladder=True)
    n_star = min(max(math.ceil(1.0 + growth * float(pilot.barrier)), 2), max_replicas)
    return place_rungs(pilot.betas, pilot.pair_rej, n_star), pilot
