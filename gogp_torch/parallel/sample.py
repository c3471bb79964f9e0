"""Multi-rank MCMC: chains sharded over the process mesh, adaptation
shared through collectives.

PyTorch twin of ``gogp_tpu/parallel/sample.py``.  Every runner is SPMD:
every rank of the mesh calls it with the same global inputs (``position0``
and a generator seeded alike on every rank), runs its slab of chains, and
returns the global result, gathered, on every rank.  Chains split over the
flattened (chain, data) mesh in row-major order.

Shared adaptation: every warmup step the whole population's mean
acceptance drives one dual-averaging step size, and the whole population's
positions feed one Welford accumulator for one mass matrix.  The twin
psum-averages the acceptance and psum-combines the devices' accumulators at
each window end (n = psum(n_d), mu = psum(n_d mu_d) / n, m2 = psum(m2_d +
n_d (mu_d - mu)^2)); here each statistic's slabs are all-gathered (O(chains
dim) floats) and reduced in one order on every rank
(``infer.chees._cross_mean``), the same arithmetic as a run on one rank, so
a run on R ranks adapts bit for bit like a run on one wherever a chain's
log-density does not depend on its batch.  Randomness: a rank's draws are its rows of the whole
population's, through each sampler's draws hook.  The hook is called on a
state widened to every chain; the default draws come from the replicated
generator (HMC, ChEES, GHMC: a fixed shape per transition, so 1 and R ranks
sample the same chains), and for NUTS, whose leaf draws follow each rank's
own trees, from generators keyed by (transition, draw, depth, leaf) counters
instead of one stream (:class:`CounterDraws`).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from gogp_torch.infer import adapt, chees, ghmc, hmc, nuts, pt_chees, tempering
from gogp_torch.infer.hmc import Samples
from gogp_torch.parallel import mesh as pmesh
from gogp_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]

AXES = (CHAIN_AXIS, DATA_AXIS)


def _slab(mesh: pmesh.Mesh, n: int, what: str = "chains") -> tuple[int, int]:
    """(local count, global offset) of this rank's slab of ``n``."""
    if n % mesh.size != 0:
        raise ValueError(f"{n} {what} not divisible by {mesh.size} devices")
    local = n // mesh.size
    return local, mesh.axis_index(AXES) * local


def _gather(x: Tensor, dim: int, axes=AXES) -> Tensor:
    """The global tensor from every rank's slab along ``dim``."""
    return pmesh.all_gather(x.movedim(dim, 0), axes).movedim(0, dim)


def _gather_fields(state, fields: dict, axes=AXES):
    """``state`` with ``fields`` (name -> chain dim) gathered over ``axes``."""
    return state._replace(**{f: _gather(getattr(state, f), d, axes) for f, d in fields.items()})


# --- draws -------------------------------------------------------------------


def _key_generator(seed: int, device, *key) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(hash((seed,) + key) & (2**63 - 1))


class CounterDraws:
    """NUTS draws for a whole population that do not depend on how it is
    split: every draw comes from a generator seeded by (seed, transition,
    draw, depth, leaf), so a rank that stops building leaves when its own
    trees end leaves the others' draws as they are.  ``kind="hmc"`` gives
    the (momenta, uniforms) pair of an HMC transition the same way."""

    def __init__(self, seed: int, kind: str = "nuts"):
        self.seed, self.kind, self.t = seed, kind, 0

    def __call__(self, state: hmc.HMCState):
        t, self.t = self.t, self.t + 1
        total, dim = state.position.shape
        like = dict(dtype=state.position.dtype, device=state.position.device)
        dev = state.position.device

        def uniforms(*key):
            return torch.rand((total,), generator=_key_generator(self.seed, dev, t, *key), **like)

        momentum = torch.randn((total, dim), generator=_key_generator(self.seed, dev, t, 0), **like)
        if self.kind == "hmc":
            return momentum, uniforms(1)
        return nuts.NUTSDraws(momentum, lambda depth: uniforms(1, depth) < 0.5, lambda depth: uniforms(2, depth),
                              lambda depth, n: uniforms(3, depth, n))


def _rows_of_hmc_draws(kind: str, draws, total: int, offset: int, local: int):
    """An HMC or NUTS draws hook for this slab: ``draws`` on the state
    widened to ``total`` chains, rows ``offset`` on kept."""
    sl = slice(offset, offset + local)

    def rows(state: hmc.HMCState):
        whole = state._replace(position=state.position.new_empty((total, state.position.shape[1])))
        d = draws(whole)
        if kind == "hmc":
            return d[0][sl], d[1][sl]
        return nuts.NUTSDraws(d.momentum[sl], lambda depth: d.direction(depth)[sl], lambda depth: d.merge(depth)[sl],
                              lambda depth, n: d.leaf(depth, n)[sl])

    return rows


def _seed_of(rng: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=rng, device=rng.device))


# --- NUTS / HMC with shared adaptation ---------------------------------------------------


def _make_transition(kind: str, logp, free, draws, **kw):
    if kind == "nuts":
        return lambda s: nuts.nuts_transition(logp, s, max_tree_depth=kw.get("max_tree_depth", 10), free=free,
                                              draws=draws)
    if kind == "hmc":
        return lambda s: hmc.hmc_transition(logp, s, trajectory_length=kw.get("trajectory_length", 1.0),
                                            max_num_steps=kw.get("max_num_steps", 1024), free=free, draws=draws)
    raise ValueError(f"unknown sampler kind {kind!r}")


def run_mcmc_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    kind: str = "nuts",
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Tensor | None = None,
    draws=None,
    **kw,
) -> Samples:
    """Run ``position0.shape[0]`` chains sharded over the mesh, one shared
    step size and mass.

    Returns Samples with leading axes (chains, num_samples), as the twin.
    ``draws``: the HMC or NUTS hook of the whole population (default: the
    counter-keyed draws of :class:`CounterDraws`, seeded from
    ``rng``)."""
    position0 = torch.as_tensor(position0)
    n_chains, dim = position0.shape
    if kind not in ("nuts", "hmc"):
        raise ValueError(f"unknown sampler kind {kind!r}")
    local, offset = _slab(mesh, n_chains)
    if draws is None:
        draws = CounterDraws(_seed_of(rng), kind)
    sched = adapt.build_schedule(num_warmup)
    like = dict(dtype=position0.dtype, device=position0.device)
    with mesh:
        transition = _make_transition(kind, logp, free, _rows_of_hmc_draws(kind, draws, n_chains, offset, local),
                                      **kw)
        states = hmc.init_state(logp, position0[offset:offset + local], rng, init_step_size, free)
        da = adapt.da_init(torch.as_tensor(init_step_size, **like))
        welford = adapt.welford_init(dim, **like)
        inv_mass = torch.ones((dim,), **like)

        def shared(states, step_size, inv_mass):
            return states._replace(step_size=step_size.expand(local).clone(),
                                   inv_mass=inv_mass.expand(local, dim).clone())

        for um, we in zip(sched.update_mass, sched.window_end):
            states = transition(shared(states, torch.exp(da.log_step), inv_mass))
            # ONE step size from the whole population's mean accept
            da = adapt.da_update(da, chees._cross_mean(states.accept_prob, AXES, 0), target=target_accept)
            if um:
                for q in chees._gathered(states.position, AXES, 0):
                    welford = adapt.welford_update(welford, q)
            if we:
                var = adapt.welford_variance(welford)
                inv_mass = torch.where(welford.count > 1, var, inv_mass)
                welford = adapt.welford_init(dim, **like)
                da = adapt.da_init(torch.exp(da.log_step))
        if num_warmup > 0:
            states = shared(states, torch.exp(da.log_step_avg), inv_mass)
        pos, lps, acc = [], [], []
        for _ in range(num_samples):
            states = transition(states)
            pos.append(states.position)
            lps.append(states.logp)
            acc.append(states.accept_prob)
        pos, lps, acc = (_gather(torch.stack(a, 1), 0) for a in (pos, lps, acc))
        states = _gather_fields(states, {"position": 0, "logp": 0, "grad": 0, "step_size": 0, "inv_mass": 0,
                                         "accept_prob": 0})
    return Samples(pos, lps, acc, states)


run_nuts_sharded = functools.partial(run_mcmc_sharded, kind="nuts")
run_hmc_sharded = functools.partial(run_mcmc_sharded, kind="hmc")


# --- ChEES and GHMC: every adaptation signal a cross-chain mean ----------------------

def _gather_chees(state: chees.ChEESState, axes=AXES) -> chees.ChEESState:
    """A ChEES state's per-chain leaves gathered (the chain axis behind the
    group axis, where there is one)."""
    d = state.positions.dim() - 2
    return _gather_fields(state, {"positions": d, "logps": d, "grads": d, "accept_probs": d}, axes)


def run_chees_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    draws: chees.Draws = chees.generator_draws,
) -> Samples:
    """ChEES-HMC with the chain population sharded over the mesh.

    Every adaptation signal of ChEES (mean accept, the criterion's
    centring and gradient, the Welford moments) is a cross-chain mean, so
    the sharded form is the one-rank form with each mean taken over the
    gathered population (``infer.chees`` takes the axis names).  Each rank
    draws the whole population's momenta and uniforms from the replicated
    generator and keeps its rows, so results are rank-count invariant.  Returns positions (num_samples, chains, dim)."""
    position0 = torch.as_tensor(position0)
    local, offset = _slab(mesh, position0.shape[0])
    with mesh:
        res = chees.run_chees(logp, position0[offset:offset + local], rng, num_warmup, num_samples, init_step_size,
                              init_traj_length, target_accept, max_num_steps, traj_lr, free, draws=draws,
                              axis_name=AXES, chain_offset=offset)
        return Samples(_gather(res.positions, 1), _gather(res.logps, 1), _gather(res.accept_probs, 1),
                       _gather_chees(res.state))


def run_ghmc_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    free: Tensor | None = None,
    draws: ghmc.Draws = ghmc.generator_draws,
    momenta: Tensor | None = None,
) -> Samples:
    """Persistent-momentum GHMC with the chain population sharded.

    The mean accept and the cross-fold moments are taken over the gathered
    population.
    Chains split into folds by global index parity, so each rank's slab
    must hold an even number of chains.  ``momenta``: the whole
    population's initial persistent momenta (default: drawn from ``rng``,
    each rank keeping its rows)."""
    position0 = torch.as_tensor(position0)
    n_chains = position0.shape[0]
    local, offset = _slab(mesh, n_chains)
    if n_chains < 4:
        raise ValueError(f"ghmc needs >= 4 chains globally (got {n_chains}): with fewer, each parity fold has a "
                         "single chain and the cross-fold std degenerates to its floor")
    if local % 2 != 0:
        raise ValueError(f"ghmc sharding needs an even per-device chain count (got {local}): folds split by "
                         "global index parity")
    sl = slice(offset, offset + local)
    with mesh:
        state = ghmc.ghmc_init(logp, position0[sl], rng, init_step_size,
                               None if momenta is None else torch.as_tensor(momenta)[sl], AXES, offset)
        if num_warmup > 0:
            state = ghmc.finalize_ghmc_warmup(ghmc.ghmc_warm_chunk(logp, state, num_warmup, free, draws, AXES, offset))
        state, (pos, lps, acc) = ghmc.ghmc_sample_chunk(logp, state, num_samples, free, draws, AXES, offset)
        state = _gather_fields(state, {"positions": 0, "momenta": 0, "logps": 0, "grads": 0, "accept_probs": 0})
        return Samples(_gather(pos, 1), _gather(lps, 1), _gather(acc, 1), state)


def run_chees_pops_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    n_pops: int,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    draws: Callable[[range], chees.Draws] | None = None,
) -> Samples:
    """Independent ChEES populations sharded over the mesh: the
    zero-collective layout (``infer.chees.run_chees_pops`` semantics).

    Each rank runs ``n_pops // ranks`` whole populations as the groups of
    one state; no statistic crosses ranks until the final gather.  Each
    population draws from generator ``spawn_generators(rng, n_pops)[p]``,
    so the draws match the one-rank run.  ``draws``: given the range of
    this rank's global population indices, the grouped state's hook.
    Returns positions (num_samples, chains, dim), chains grouped by
    population."""
    position0 = torch.as_tensor(position0)
    n_chains, dim = position0.shape
    if n_chains % n_pops != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_pops} populations")
    pops_local, pop0 = _slab(mesh, n_pops, "populations")
    per = n_chains // n_pops
    gens = chees.spawn_generators(rng, n_pops)[pop0:pop0 + pops_local]
    hook = chees.generator_draws if draws is None else draws(range(pop0, pop0 + pops_local))
    pos0 = position0[pop0 * per:(pop0 + pops_local) * per].reshape(pops_local, per, dim)
    with mesh:
        state = chees.chees_init(logp, pos0, gens, init_step_size, init_traj_length, free)
        state = chees._run(logp, state, num_warmup, max_num_steps, target_accept, traj_lr, free, hook)
        state, (pos, lps, acc) = chees.chees_sample_chunk(logp, state, num_samples, max_num_steps, free, hook)
        pos = _gather(pos.reshape(num_samples, pops_local * per, dim), 1)
        lps = _gather(lps.reshape(num_samples, pops_local * per), 1)
        acc = _gather(acc.reshape(num_samples, pops_local * per), 1)
        return Samples(pos, lps, acc, state)


# --- parallel tempering ------------------------------------------------------------


def run_pt_chees_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
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
    draws: chees.Draws = chees.generator_draws,
    swap_draws: pt_chees.SwapDraws = pt_chees.generator_swap_draws,
) -> pt_chees.PTChEESResult:
    """PT-ChEES with the LADDERS sharded over the mesh.

    Each rank runs its ladders' K-rung stacks; every rung's cross-ladder
    adaptation statistic and the pair statistics behind the shared ladder
    are taken over every rank's ladders, so every rank holds the same
    ladder; swaps act within a
    ladder and stay rank-local.  ``position0``: (n_ladders, dim).  Returns
    the all-ladder draws (num_samples, n_ladders, dim)."""
    position0 = torch.as_tensor(position0)
    n_ladders = position0.shape[0]
    like = dict(dtype=position0.dtype, device=position0.device)
    betas = (tempering.geometric_ladder(n_replicas, beta_min, **like) if betas is None
             else torch.as_tensor(betas, **like))
    local, offset = _slab(mesh, n_ladders, "ladders")
    with mesh:
        states = pt_chees.pt_chees_init(logp, position0[offset:offset + local], rng, betas, local, init_step_size,
                                        init_traj_length, free)
        if num_warmup > 0:
            sched = adapt.build_schedule(num_warmup)
            states, betas = pt_chees.pt_chees_warm_chunk(logp, states, betas, sched.update_mass, sched.window_end, 0,
                                                         max_num_steps, target_accept, traj_lr, free, adapt_ladder,
                                                         draws, swap_draws, AXES, offset)
            states = chees.finalize_chees_warmup(states)
        states, pos, raws, fracs, flow = pt_chees.pt_chees_sample_chunk(
            logp, states, betas, num_samples, num_warmup, max_num_steps, free, None, draws, swap_draws, AXES, offset)
        # pair stats are identical on every rank (gathered at the swap);
        # trips are per local ladder: psum for the global count
        trips = pmesh.psum(flow.trips.sum(), AXES)
        pair_rej = flow.rej_sum / torch.clamp(flow.prop_count, min=1.0)
        states = _gather_chees(states)
        return pt_chees.PTChEESResult(_gather(pos, 1), _gather(raws, 1), fracs.mean(), states, betas, trips,
                                      pair_rej.sum(), pair_rej)


def run_pt_distributed(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    n_replicas: int = 8,
    beta_min: float = 0.05,
    betas: Tensor | None = None,
    num_warmup: int = 400,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Tensor | None = None,
    adapt_ladder: bool = True,
    draws=None,
    swap_draws: tempering.SwapDraws = tempering.generator_swap_draws,
) -> tempering.PTResult:
    """ONE parallel-tempering NUTS ladder spanning the whole mesh.

    Each rank owns ``n_replicas / ranks`` adjacent temperature slots and
    runs their NUTS transitions and per-temperature adaptation locally.  A
    DEO sweep all-gathers (position, raw logp, raw gradient) of every
    replica, O(K dim) floats, computes the same swap decision on every
    rank from replicated uniforms (``swap_draws`` on the whole ladder), and
    each rank keeps its slots' incoming states; step size and mass stay
    with the temperature.  ``draws``: the NUTS hook of the whole ladder
    (default: counter-keyed, :class:`CounterDraws`).  Returns the
    cold-chain draws and the gathered replica states."""
    position0 = torch.as_tensor(position0)
    like = dict(dtype=position0.dtype, device=position0.device)
    betas0 = (tempering.geometric_ladder(n_replicas, beta_min, **like) if betas is None
              else torch.as_tensor(betas, **like))
    K = betas0.shape[0]
    r_local, r0 = _slab(mesh, K, "replicas")
    if position0.dim() == 1:
        position0 = position0.expand(K, -1)
    if draws is None:
        draws = CounterDraws(_seed_of(rng))
    rows = _rows_of_hmc_draws("nuts", draws, K, r0, r_local)
    sl = slice(r0, r0 + r_local)
    sched = adapt.build_schedule(num_warmup)

    with mesh:
        states = hmc.init_state(tempering.tempered(logp, betas0[sl]), position0[sl].clone(), rng, init_step_size,
                                free)

        def swap(states, betas_full, t):
            betas_loc = betas_full[sl]
            raw_f = pmesh.all_gather(states.logp / betas_loc, AXES)
            pos_f = pmesh.all_gather(states.position, AXES)
            rawg_f = pmesh.all_gather(states.grad / betas_loc[:, None], AXES)
            whole = states._replace(logp=raw_f)
            src, pair_probs, proposed, frac = tempering.swap_decision(betas_full, raw_f, swap_draws(whole), t % 2)
            my_src = src[sl]
            new_raw, new_rawg = raw_f[my_src], rawg_f[my_src]
            states = states._replace(position=pos_f[my_src], logp=new_raw * betas_loc,
                                     grad=new_rawg * betas_loc[:, None])
            return states, new_raw, new_rawg, pair_probs, proposed, frac, pos_f[src[0]], raw_f[src[0]], src

        betas_f = betas0
        if num_warmup > 0:
            rej_sum = prop_count = betas0.new_zeros(K - 1)
            for t, (um, we) in enumerate(zip(sched.update_mass, sched.window_end)):
                states = nuts.nuts_transition(tempering.tempered(logp, betas_f[sl]), states, max_tree_depth, free,
                                              rows)
                states = hmc.warmup_step(states, bool(um), bool(we), target_accept)
                states, new_raw, new_rawg, pair_probs, proposed, *_ = swap(states, betas_f, t)
                rej_sum = rej_sum + torch.where(proposed, 1.0 - pair_probs, 0.0)
                prop_count = prop_count + proposed.to(rej_sum.dtype)
                if adapt_ladder and we:
                    betas_f = tempering.adapt_ladder_betas(betas_f, rej_sum, prop_count)
                    nb = betas_f[sl]
                    states = states._replace(logp=new_raw * nb, grad=new_rawg * nb[:, None])
                    rej_sum, prop_count = torch.zeros_like(rej_sum), torch.zeros_like(prop_count)
            states = hmc.finalize_warmup(states)
        flow = tempering.init_flow(K, betas0.dtype, betas0.device)
        pos, raws, fracs = [], [], []
        for t in range(num_warmup, num_warmup + num_samples):
            states = nuts.nuts_transition(tempering.tempered(logp, betas_f[sl]), states, max_tree_depth, free, rows)
            states, _, _, pair_probs, proposed, frac, cold_pos, cold_raw, src = swap(states, betas_f, t)
            # src and the pair statistics are replicated: every rank makes
            # the same O(K) flow update
            flow = tempering.flow_update(flow, src, torch.where(proposed, 1.0 - pair_probs, 0.0),
                                         proposed.to(flow.rej_sum.dtype))
            pos.append(cold_pos)
            raws.append(cold_raw)
            fracs.append(frac)
        states = _gather_fields(states, {"position": 0, "logp": 0, "grad": 0, "step_size": 0, "inv_mass": 0,
                                         "accept_prob": 0})
    pair_rej = flow.rej_sum / torch.clamp(flow.prop_count, min=1.0)
    return tempering.PTResult(torch.stack(pos), torch.stack(raws), torch.stack(fracs).mean(), states, betas_f,
                              flow.trips, pair_rej.sum(), pair_rej)


def run_pt_chees_distributed(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
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
    draws: chees.Draws = chees.generator_draws,
    swap_draws: pt_chees.SwapDraws = pt_chees.generator_swap_draws,
) -> pt_chees.PTChEESResult:
    """PT-ChEES with the RUNGS spanning the mesh, the ChEES analogue of
    :func:`run_pt_distributed`.

    Each rank owns ``n_replicas / ranks`` adjacent temperature slots, each
    slot the whole cross-ladder population (L chains), so every rung's
    ChEES adaptation is rank-local: no collective in the mutation.  A DEO
    sweep gathers (position, raw logp, raw grad) of every rung, O(K L dim)
    floats, makes the same per-ladder swap decisions on every rank from
    replicated uniforms, and each rank keeps its slots' incoming states.
    ``draws`` is the rung-stacked (K, L) state's hook, called on the whole
    ladder and cut to this rank's rungs.  Returns the cold draws of every
    ladder (num_samples, n_ladders, dim) and the gathered rung states."""
    position0 = torch.atleast_2d(torch.as_tensor(position0))
    if position0.shape[0] == 1 and n_ladders > 1:
        position0 = position0.expand(n_ladders, position0.shape[-1])
    L = position0.shape[0]
    like = dict(dtype=position0.dtype, device=position0.device)
    betas0 = (tempering.geometric_ladder(n_replicas, beta_min, **like) if betas is None
              else torch.as_tensor(betas, **like))
    K = betas0.shape[0]
    r_local, r0 = _slab(mesh, K, "replicas")
    sl = slice(r0, r0 + r_local)

    def rung_draws(state):
        """This rank's rungs of the whole (K, L) stack's draws."""
        whole = state._replace(positions=state.positions.new_empty((K,) + state.positions.shape[1:]),
                               logps=state.logps.new_empty((K, L)), accept_probs=state.accept_probs.new_empty((K, L)))
        r, u = draws(whole)
        return r[sl], u[sl]

    sched = adapt.build_schedule(num_warmup)
    with mesh:
        pos0 = position0.expand(r_local, L, position0.shape[-1]).clone()
        states = chees.chees_init(pt_chees._rung_logp(logp, betas0[sl], L), pos0, rng, init_step_size,
                                  init_traj_length, free)

        def swap(states, betas_full, parity):
            betas_loc = betas_full[sl]
            raw_f = pmesh.all_gather(states.logps / betas_loc[:, None], AXES)  # (K, L)
            pos_f = pmesh.all_gather(states.positions, AXES)  # (K, L, dim)
            rawg_f = pmesh.all_gather(states.grads / betas_loc[:, None, None], AXES)
            u = swap_draws(states._replace(logps=raw_f))  # (L, K)
            src, pair_probs, proposed, frac = tempering.swap_decision(betas_full, raw_f.T, u, parity)
            src = src.T  # (K, L)
            ladder = torch.arange(L, device=src.device)[None, :]
            my_src = src[sl]
            new_raw, new_rawg = raw_f[my_src, ladder], rawg_f[my_src, ladder]
            states = states._replace(positions=pos_f[my_src, ladder], logps=new_raw * betas_loc[:, None],
                                     grads=new_rawg * betas_loc[:, None, None])
            pair_rej = torch.where(proposed, 1.0 - pair_probs, 0.0).mean(0)
            cold = torch.arange(L, device=src.device)
            return (states, new_raw, new_rawg, src, pair_rej, proposed.to(raw_f.dtype), frac.mean(),
                    pos_f[src[0], cold], raw_f[src[0], cold])

        betas_f = betas0
        if num_warmup > 0:
            rej_sum = prop_count = betas0.new_zeros(K - 1)
            for t, (um, we) in enumerate(zip(sched.update_mass, sched.window_end)):
                states = chees.chees_transition(pt_chees._rung_logp(logp, betas_f[sl], L), states, adapt_traj=True,
                                                max_num_steps=max_num_steps, traj_lr=traj_lr, free=free,
                                                draws=rung_draws)
                states = chees.chees_warmup_step(states, bool(um), bool(we), target_accept)
                states, new_raw, new_rawg, _, pair_rej, prop, *_ = swap(states, betas_f, t % 2)
                rej_sum, prop_count = rej_sum + pair_rej, prop_count + prop
                if adapt_ladder and we:
                    betas_f = tempering.adapt_ladder_betas(betas_f, rej_sum, prop_count)
                    nb = betas_f[sl][:, None]
                    states = states._replace(logps=new_raw * nb, grads=new_rawg * nb[..., None])
                    rej_sum, prop_count = torch.zeros_like(rej_sum), torch.zeros_like(prop_count)
            states = chees.finalize_chees_warmup(states)
        flow = tempering.init_flow(K, betas0.dtype, betas0.device, n_ladders=L)
        pos, raws, fracs = [], [], []
        for t in range(num_warmup, num_warmup + num_samples):
            states = chees.chees_transition(pt_chees._rung_logp(logp, betas_f[sl], L), states, adapt_traj=False,
                                            max_num_steps=max_num_steps, traj_lr=traj_lr, free=free,
                                            draws=rung_draws)
            states, _, _, src, pair_rej, prop, frac, cold_pos, cold_raw = swap(states, betas_f, t % 2)
            flow = tempering.flow_update(flow, src.T, pair_rej, prop)
            pos.append(cold_pos)
            raws.append(cold_raw)
            fracs.append(frac)
        states = _gather_fields(states, {"positions": 0, "logps": 0, "grads": 0, "step_size": 0, "inv_mass": 0,
                                         "log_traj": 0, "accept_probs": 0})
    pair_rej = flow.rej_sum / torch.clamp(flow.prop_count, min=1.0)
    return pt_chees.PTChEESResult(torch.stack(pos), torch.stack(raws), torch.stack(fracs).mean(), states, betas_f,
                                  flow.trips.sum(), pair_rej.sum(), pair_rej)


def run_pt_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    n_replicas: int = 4,
    beta_min: float = 0.05,
    num_warmup: int = 400,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    free: Tensor | None = None,
    draws: Callable[[int], tuple] | None = None,
) -> tempering.PTResult:
    """Parallel-tempered NUTS with independent ladders sharded over the
    mesh: ``position0`` (n_chains, dim), each chain a whole ladder on one
    rank.  Chain c draws from generator ``spawn_generators(rng,
    n_chains)[c]`` (or, with ``draws``, from ``draws(c)``, a (NUTS hook,
    swap hook) pair).  Returns a PTResult whose fields have the leading
    axis n_chains, as the twin's vmap."""
    position0 = torch.as_tensor(position0)
    n_chains = position0.shape[0]
    local, offset = _slab(mesh, n_chains)
    gens = chees.spawn_generators(rng, n_chains)
    outs = []
    for c in range(offset, offset + local):
        hooks = {} if draws is None else dict(zip(("draws", "swap_draws"), draws(c)))
        outs.append(tempering.run_pt_nuts(logp, position0[c], gens[c], n_replicas=n_replicas, beta_min=beta_min,
                                          num_warmup=num_warmup, num_samples=num_samples,
                                          max_tree_depth=max_tree_depth, free=free, **hooks))
    with mesh:
        fields = {}
        for name in ("positions", "logps", "swap_rate", "betas", "round_trips", "barrier", "pair_rej"):
            fields[name] = pmesh.all_gather(torch.stack([getattr(o, name) for o in outs]), AXES)
        state = hmc.HMCState(*(pmesh.all_gather(torch.stack([getattr(o.state, f) for o in outs]), AXES)
                               if f in ("position", "logp", "grad", "step_size", "inv_mass", "accept_prob")
                               else None for f in hmc.HMCState._fields))
    return tempering.PTResult(fields["positions"], fields["logps"], fields["swap_rate"], state, fields["betas"],
                              fields["round_trips"], fields["barrier"], fields["pair_rej"])


def run_ess_sharded(
    loglik_fn: Callable,
    chol: Tensor,
    f0: Tensor,
    draws,
    mesh: pmesh.Mesh,
    num_warmup: int = 256,
    num_samples: int = 256,
    thin: int = 1,
):
    """Elliptical slice sampling with chains sharded over the mesh.

    ESS chains share no adaptation, so there is no collective until the
    final gather.  ``draws``: the ``infer.elliptical`` hook of the whole
    population ((chains, n) shapes), called with the whole shape and cut
    to this rank's rows; a ``torch.Generator`` replicated on every rank
    works as ``elliptical.generator_draws(rng)``.  ``chol`` is replicated.
    Returns (f (C, S, n), loglik (C, S), and the third output of
    ``elliptical.run_ess``), gathered."""
    from gogp_torch.infer import elliptical

    f0 = torch.as_tensor(f0)
    c = f0.shape[0]
    local, offset = _slab(mesh, c)
    if isinstance(draws, torch.Generator):
        draws = elliptical.generator_draws(draws)

    def rows(shape, dtype, device):
        d = draws((c,) + tuple(shape[1:]), dtype, device)
        return type(d)(*(a[offset:offset + local] for a in d))

    out = elliptical.run_ess(loglik_fn, chol, f0[offset:offset + local], rows, num_warmup, num_samples, thin)
    with mesh:
        return tuple(pmesh.all_gather(a, AXES) for a in out)
