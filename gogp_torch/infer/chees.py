"""ChEES-HMC: one adaptive trajectory length shared by a chain population.

PyTorch twin of ``gogp_tpu/infer/chees.py`` (Hoffman, Radul & Sountsov,
AISTATS 2021).  All chains integrate the same number of leapfrog steps, so
every step is one batched value-and-gradient over (chains, dim), which is
the shape K7 (``ops/fused_gp.py``) serves.  The trajectory length is adapted
by Adam ascent on the ChEES criterion, the step size by dual averaging on
the population-mean acceptance, the diagonal mass by Welford over the whole
population; every adaptation statistic is a cross-chain mean.

``logp`` maps a (chains, dim) batch to (chains,) and is differentiated by
autograd: the counterpart of ``jax.vmap(jax.value_and_grad(logp))``.  A
log-density whose backward returns a gradient it saved in its forward
(``tutorial/bayes.py``'s K7 route) runs through the same code.

Groups.  A state may hold G independent populations that run in lockstep:
positions (G, chains, dim), and every adaptation leaf (step size, dual
averaging, log-trajectory, Adam, Welford, mass) with a leading G axis; the
iteration counters are shared, since every group takes every transition.
The JAX twin gets this by vmapping its transition; here each group's step
count is read to the host in one copy, the leapfrog runs to the largest,
and a group past its own count is frozen by ``torch.where``.  Every
leapfrog step is one value and gradient of the flattened (G * chains, dim)
batch, and every statistic a mean within its group.  The groups are the
arms of :func:`chees_race`, the populations of :func:`run_chees_pops` and
the rungs of ``pt_chees.run_pt_chees``.  A state without the G axis runs
as it always has.

Differences from the JAX twin, each forced by PyTorch:

- The step count of a transition is data dependent (the JAX ``fori_loop``):
  here it is read to the host once per transition and the leapfrog is a
  host loop.  The warmup and sampling scans are host loops too.
- Randomness: the JAX twin draws each chain's momentum and acceptance
  uniform from ``fold_in(key_iter, chain)``, which torch cannot reproduce.
  Each transition takes its draws ``(r0_raw, u_acc)``, shaped like the
  positions and the acceptance probabilities, from one place,
  ``draws(state)``: by default :func:`generator_draws`, from the state's
  ``torch.Generator`` (or from one generator per group, where the state
  holds a list of them); tests hand in JAX's own draws.
- ``axis_name``/``chain_offset``: the population may be sharded over mesh
  axes (``gogp_torch.parallel``).  Each rank then holds a slab of chains
  starting at global index ``chain_offset``; every cross-chain mean is taken
  over the whole population, its slabs gathered over ``axis_name``
  (``ops.collectives``, on the active mesh) and reduced in one order
  (:func:`_cross_mean`), so every rank adapts identically, and as one rank
  would.  A rank's draws are its rows of the whole
  population's: ``draws`` is called on a state shaped like the whole
  population and the transition keeps the slab's rows, so a replicated
  generator (or JAX's draws in the tests) gives every chain the draws a
  one-rank run gives it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import adapt, diagnostics
from gogp_torch.infer.hmc import IntegratorState, Samples, as_free, kinetic, leapfrog_step, value_and_grad
from gogp_torch.ops import collectives as coll
from gogp_torch.utils.profiling import host_read, span

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]


class AdamState(NamedTuple):
    """Adam for the log-trajectory-length ascent, one per group."""

    m: Tensor  # () or (G,)
    v: Tensor  # () or (G,)
    t: Tensor  # () int32, shared


def _adam_init(dtype, device=None, shape: tuple = ()) -> AdamState:
    return AdamState(
        m=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def _adam_update(s: AdamState, grad: Tensor, lr: float) -> tuple[Tensor, AdamState]:
    """The (ascent) update step and the new state."""
    t = s.t + 1
    m = 0.9 * s.m + 0.1 * grad
    v = 0.999 * s.v + 0.001 * grad * grad
    tf = t.to(m.dtype)
    mhat = m / (1.0 - 0.9**tf)
    vhat = v / (1.0 - 0.999**tf)
    return lr * mhat / (torch.sqrt(vhat) + 1e-8), AdamState(m, v, t)


class ChEESState(NamedTuple):
    """Whole-population state: ``positions`` holds the chain axis, behind
    the group axis G where there is one."""

    positions: Tensor  # ([G,] chains, dim)
    logps: Tensor  # ([G,] chains)
    grads: Tensor  # ([G,] chains, dim)
    step_size: Tensor  # ([G]) shared across a group's chains
    inv_mass: Tensor  # ([G,] dim) shared diagonal inverse mass
    log_traj: Tensor  # ([G]) log of the max trajectory length T
    accept_probs: Tensor  # ([G,] chains)
    da: adapt.DualAveragingState  # step-size dual averaging, ([G]) fields, t shared
    adam: AdamState  # trajectory-length Adam
    welford: adapt.WelfordState  # cross-chain mass accumulator, ([G,] dim) moments, count shared
    step: int  # iteration counter (drives the halton jitter), shared
    rng: torch.Generator | list  # on the positions' device; or one per group


Draws = Callable[[ChEESState], tuple[Tensor, Tensor]]


def generator_draws(state: ChEESState) -> tuple[Tensor, Tensor]:
    """One transition's draws from the state's generator: standard normal
    momenta shaped like the positions and acceptance uniforms shaped like
    the acceptance probabilities; where ``state.rng`` is a list of
    generators, group g's from the g-th."""
    like = dict(dtype=state.positions.dtype, device=state.positions.device)
    if isinstance(state.rng, torch.Generator):
        return (torch.randn(state.positions.shape, generator=state.rng, **like),
                torch.rand(state.accept_probs.shape, generator=state.rng, **like))
    pairs = [(torch.randn(state.positions.shape[1:], generator=g, **like),
              torch.rand(state.accept_probs.shape[1:], generator=g, **like)) for g in state.rng]
    return torch.stack([r for r, _ in pairs]), torch.stack([u for _, u in pairs])


def spawn_generators(rng: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``rng``'s device, seeded from ``rng`` (the
    counterpart of ``fold_in(rng, i)``)."""
    seeds = torch.randint(0, 2**62, (n,), generator=rng, device=rng.device).tolist()
    return [torch.Generator(device=rng.device).manual_seed(s) for s in seeds]


def _gathered(x: Tensor, axis_name, dim: int) -> Tensor:
    """``x`` with its chain axis ``dim`` widened to the whole population:
    with ``axis_name``, every rank's slab all-gathered in axis-index (chain
    offset) order."""
    if axis_name is None:
        return x
    return coll.all_gather(x.movedim(dim, 0), axis_name).movedim(0, dim)


def _cross_mean(x: Tensor, axis_name, dim: int) -> Tensor:
    """The mean over the chain axis ``dim`` of the whole population.  With
    ``axis_name`` the slabs are gathered (O(chains) floats a statistic) and
    reduced where they meet, not pmean'd as in the JAX twin: every rank, and
    a run on one rank, then sums the same numbers in the same order, so the
    ranks' runs agree with the one-rank run to the bit wherever each
    chain's log-density does not depend on the batch it is in."""
    return _gathered(x, axis_name, dim).mean(dim)


def _axis_size(axis_name) -> int:
    return coll.axis_size(axis_name)


def population_draws(draws, state, axis_name=None, chain_offset: int = 0):
    """``draws(state)``, or where the population is sharded over
    ``axis_name``, this slab's rows of the draws of the whole population:
    ``draws`` sees the state with its chain axis (``positions``' second to
    last, ``logps``' and ``accept_probs``' last) widened to every rank's
    chains, and the two draws keep rows ``chain_offset`` on (the first on
    its second-to-last axis, the second on its last)."""
    if axis_name is None:
        return draws(state)
    c = state.positions.shape[-2]
    total = c * _axis_size(axis_name)

    def widen(t, d):
        shape = list(t.shape)
        shape[d] = total
        return t.new_empty(shape)

    whole = state._replace(positions=widen(state.positions, -2), logps=widen(state.logps, -1),
                           accept_probs=widen(state.accept_probs, -1))
    first, second = draws(whole)
    return first.narrow(-2, chain_offset, c), second.narrow(-1, chain_offset, c)


def _halton2(i: int | Tensor) -> Tensor:
    """van der Corput base-2 radical inverse of ``i`` (float32, elementwise):
    the low-discrepancy jitter of the trajectory length, one shared draw per
    iteration.  Accumulated in float32 as in the JAX twin, whatever the
    positions' dtype (24 bits, each sum of them exact)."""
    i = torch.as_tensor(i, dtype=torch.int64)
    val = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    for k in range(24):
        bit = ((i >> k) & 1).to(torch.float32)
        val = val + bit * (0.5 ** (k + 1.0))
    return val


def _batched(logp: LogDensity, free: Tensor | None):
    """``value_and_grad`` over ([G,] chains, dim): one call of the
    flattened batch."""
    vg = value_and_grad(logp, free)

    def f(q: Tensor) -> tuple[Tensor, Tensor]:
        lp, g = vg(q.reshape(-1, q.shape[-1]))
        return lp.reshape(q.shape[:-1]), g.reshape(q.shape)

    return f


def chees_init(
    logp: LogDensity,
    positions: Tensor,
    rng: torch.Generator | list,
    step_size: float = 0.1,
    traj_length: float = 1.0,
    free: Tensor | None = None,
) -> ChEESState:
    """The state of one population, positions (chains, dim), or of G in
    lockstep, positions (G, chains, dim)."""
    positions = torch.atleast_2d(torch.as_tensor(positions))
    vals, grads = _batched(logp, as_free(free, positions))(positions)
    *groups, chains, dim = positions.shape
    groups = tuple(groups)
    like = dict(dtype=positions.dtype, device=positions.device)
    step = torch.full(groups, step_size, **like)
    return ChEESState(
        positions=positions,
        logps=vals,
        grads=grads,
        step_size=step,
        inv_mass=torch.ones(groups + (dim,), **like),
        log_traj=torch.log(torch.full(groups, traj_length, **like)),
        accept_probs=torch.zeros(groups + (chains,), **like),
        da=adapt.da_init(step),
        adam=_adam_init(shape=groups, **like),
        welford=_welford_init(groups + (dim,), **like),
        step=0,
        rng=rng,
    )


def _welford_init(shape: tuple, dtype, device=None) -> adapt.WelfordState:
    """Moments of ``shape`` ([G,] dim), one shared count."""
    w = adapt.welford_init(shape[-1], dtype, device)
    return w._replace(mean=torch.zeros(shape, dtype=dtype, device=device),
                      m2=torch.zeros(shape, dtype=dtype, device=device))


def n_leapfrog_steps(state: ChEESState, max_num_steps: int = 256) -> tuple[int | list[int], Tensor]:
    """The transition's step count (an int; with groups, a list of G, read
    to the host in one copy) and its jittered integration time t = max(u T,
    step), u = halton(step)."""
    # the jitter's copy to the card waits for the stream, as the read does
    with host_read("chees_steps"):
        u = _halton2(state.step).to(device=state.step_size.device, dtype=state.step_size.dtype)
        t_real = torch.maximum(u * torch.exp(state.log_traj), state.step_size)
        n = torch.ceil(t_real / state.step_size).reshape(-1).tolist()
    counts = [min(max(int(k), 1), max_num_steps) for k in n]
    return (counts if state.step_size.dim() else counts[0]), t_real


def _integrate(vg, state: ChEESState, r0: Tensor, n_steps: int | list[int], free: Tensor | None) -> IntegratorState:
    """Each group's ``n_steps`` velocity-Verlet steps, all groups in one
    batch: every step one value and gradient of every chain, a group past
    its own count frozen."""
    shape = state.positions.shape
    rows = lambda a: a.reshape(-1, shape[-1])  # noqa: E731
    step = state.step_size[..., None].expand(shape[:-1]).reshape(-1, 1)
    inv_mass = rows(state.inv_mass.unsqueeze(-2).expand(shape))
    counts = n_steps if isinstance(n_steps, list) else [n_steps]
    row_counts = None
    s = IntegratorState(rows(state.positions), rows(r0), state.logps.reshape(-1), rows(state.grads))
    for k in range(max(counts)):
        active = None
        if k >= min(counts):
            if row_counts is None:
                row_counts = torch.tensor(counts, device=step.device).repeat_interleave(shape[-2])
            active = row_counts > k
        s = leapfrog_step(vg, s, step, inv_mass, free, active)
    return IntegratorState(s.position.reshape(shape), s.momentum.reshape(shape), s.logp.reshape(shape[:-1]),
                           s.grad.reshape(shape))


def chees_transition(
    logp: LogDensity,
    state: ChEESState,
    adapt_traj: bool = False,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    divergence_threshold: float = 1000.0,
    draws: Draws = generator_draws,
    axis_name=None,
    chain_offset: int = 0,
) -> ChEESState:
    """One population transition (of every group): shared jittered
    trajectory, batched leapfrog, per-chain Metropolis, and with
    ``adapt_traj`` one ChEES gradient step on log T.  ``axis_name``: mesh
    axes holding more chains of the population (this slab's first at
    global index ``chain_offset``)."""
    with span("chees.transition"):
        freea = as_free(free, state.positions)
        vg = value_and_grad(logp, freea)
        r0_raw, u_acc = population_draws(draws, state, axis_name, chain_offset)

        n_steps, t_real = n_leapfrog_steps(state, max_num_steps)
        inv_mass = state.inv_mass.unsqueeze(-2)
        r0 = r0_raw / torch.sqrt(inv_mass)
        if freea is not None:
            r0 = r0 * freea
        energy0 = -state.logps + kinetic(r0, inv_mass)
        integ = _integrate(vg, state, r0, n_steps, freea)

        energy1 = -integ.logp + kinetic(integ.momentum, inv_mass)
        delta = energy1 - energy0
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        accept_probs = torch.where(delta > divergence_threshold, 0.0, torch.clamp(torch.exp(-delta), max=1.0))
        accept = u_acc < accept_probs
        acc = accept[..., None]
        positions = torch.where(acc, integ.position, state.positions)
        logps = torch.where(accept, integ.logp, state.logps)
        grads = torch.where(acc, integ.grad, state.grads)

        # ChEES gradient on log T (Hoffman et al. 2021, eq. 8-9): the centred
        # squared-radius change, differentiated through the endpoint velocity.
        # Divergent chains (non-finite endpoints) enter with their start point at
        # weight 0, so an inf cannot poison the cross-chain means.
        fin = (torch.isfinite(integ.position).all(-1) & torch.isfinite(integ.momentum).all(-1)
               & torch.isfinite(delta))
        q1 = torch.where(fin[..., None], integ.position, state.positions)
        vel1 = torch.where(fin[..., None], inv_mass * integ.momentum, 0.0)
        c0 = state.positions - _cross_mean(state.positions, axis_name, -2).unsqueeze(-2)
        c1 = q1 - _cross_mean(q1, axis_name, -2).unsqueeze(-2)
        delta_sq = (c1 * c1).sum(-1) - (c0 * c0).sum(-1)
        ddelta_dt = 2.0 * (c1 * vel1).sum(-1)
        w = accept_probs * fin
        wsum = _cross_mean(w, axis_name, -1) + 1e-12
        g_t = _cross_mean(w * delta_sq * ddelta_dt, axis_name, -1) / wsum
        g_logt = g_t * t_real
        g_logt = torch.where(torch.isfinite(g_logt), g_logt, 0.0)
        log_traj, adam = state.log_traj, state.adam
        if adapt_traj:
            upd, adam = _adam_update(state.adam, g_logt, traj_lr)
            log_traj = state.log_traj + upd
        # keep T in [step, max_num_steps * step]: outside it the jittered step
        # count saturates and the gradient decouples from T
        log_traj = torch.minimum(torch.maximum(log_traj, torch.log(state.step_size)),
                                 torch.log(state.step_size * max_num_steps))

        return state._replace(
            positions=positions,
            logps=logps,
            grads=grads,
            accept_probs=accept_probs,
            log_traj=log_traj,
            adam=adam,
            step=state.step + 1,
        )


def _welford_update_population(w: adapt.WelfordState, X: Tensor, axis_name=None) -> adapt.WelfordState:
    """Fold a whole ([G,] chains, dim) batch into the accumulator (Chan
    merge), each group into its own moments; with ``axis_name`` the whole
    population's batch."""
    X = _gathered(X, axis_name, -2)
    n = torch.as_tensor(X.shape[-2], dtype=X.dtype, device=X.device)
    mean = X.mean(-2)
    m2 = ((X - mean.unsqueeze(-2)) ** 2).mean(-2) * n
    return adapt.welford_combine(w, adapt.WelfordState(n, mean, m2))


def chees_warmup_step(
    state: ChEESState,
    update_mass: bool,
    window_end: bool,
    target_accept: float = 0.75,
    axis_name=None,
) -> ChEESState:
    """Shared-statistics warmup bookkeeping: one dual-averaging update from
    the population-mean accept, one batched Welford feed, window refresh
    (each group on its own statistics)."""
    da = adapt.da_update(state.da, _cross_mean(state.accept_probs, axis_name, -1), target=target_accept)
    step_size = torch.exp(da.log_step)
    welford = (_welford_update_population(state.welford, state.positions, axis_name) if update_mass
               else state.welford)
    inv_mass = state.inv_mass
    if window_end:
        new_inv_mass = adapt.welford_variance(welford)
        inv_mass = torch.where(welford.count > 1, new_inv_mass, inv_mass)
        welford = _welford_init(inv_mass.shape, inv_mass.dtype, inv_mass.device)
        da = adapt.da_init(torch.exp(da.log_step))
    return state._replace(step_size=step_size, da=da, welford=welford, inv_mass=inv_mass)


def chees_warm_chunk(
    logp: LogDensity,
    state: ChEESState,
    update_mass,
    window_end,
    max_num_steps: int = 256,
    target_accept: float = 0.75,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    draws: Draws = generator_draws,
    axis_name=None,
    chain_offset: int = 0,
) -> ChEESState:
    """Warmup transitions, one per pair of schedule flags."""
    for um, we in zip(update_mass, window_end):
        state = chees_transition(logp, state, adapt_traj=True, max_num_steps=max_num_steps,
                                 traj_lr=traj_lr, free=free, draws=draws, axis_name=axis_name,
                                 chain_offset=chain_offset)
        state = chees_warmup_step(state, bool(um), bool(we), target_accept, axis_name)
    return state


def chees_sample_chunk(
    logp: LogDensity,
    state: ChEESState,
    num: int,
    max_num_steps: int = 256,
    free: Tensor | None = None,
    draws: Draws = generator_draws,
    axis_name=None,
    chain_offset: int = 0,
) -> tuple[ChEESState, tuple[Tensor, Tensor, Tensor]]:
    """``num`` frozen-hyperparameter transitions; returns the state and
    (positions (num, [G,] chains, dim), logps, accept_probs)."""
    pos, lps, accs = [], [], []
    for _ in range(num):
        state = chees_transition(logp, state, adapt_traj=False, max_num_steps=max_num_steps,
                                 free=free, draws=draws, axis_name=axis_name, chain_offset=chain_offset)
        pos.append(state.positions)
        lps.append(state.logps)
        accs.append(state.accept_probs)
    return state, (torch.stack(pos), torch.stack(lps), torch.stack(accs))


def finalize_chees_warmup(state: ChEESState) -> ChEESState:
    """Freeze the step size at the dual-averaging average iterate (the
    halton jitter keeps running: it is part of the kernel)."""
    return state._replace(step_size=torch.exp(state.da.log_step_avg))


def _map_groups(fn, state: ChEESState) -> ChEESState:
    """``fn`` applied to every leaf that carries the group axis (the shared
    counters and the generator left as they are)."""
    return state._replace(
        positions=fn(state.positions), logps=fn(state.logps), grads=fn(state.grads),
        step_size=fn(state.step_size), inv_mass=fn(state.inv_mass), log_traj=fn(state.log_traj),
        accept_probs=fn(state.accept_probs),
        da=state.da._replace(log_step=fn(state.da.log_step), log_step_avg=fn(state.da.log_step_avg),
                             gradient_avg=fn(state.da.gradient_avg), mu=fn(state.da.mu)),
        adam=state.adam._replace(m=fn(state.adam.m), v=fn(state.adam.v)),
        welford=state.welford._replace(mean=fn(state.welford.mean), m2=fn(state.welford.m2)),
    )


def take_group(state: ChEESState, g: int) -> ChEESState:
    """Group ``g`` of a grouped state, as a state of one population (with
    group g's generator where each group has its own)."""
    rng = state.rng if isinstance(state.rng, torch.Generator) else state.rng[g]
    return _map_groups(lambda a: a[g], state)._replace(rng=rng)


def _run(logp, state: ChEESState, num_warmup: int, max_num_steps: int, target_accept: float, traj_lr: float,
         free, draws: Draws, axis_name=None, chain_offset: int = 0) -> ChEESState:
    """Windowed warmup of ``num_warmup`` transitions, then the frozen step."""
    if num_warmup > 0:
        sched = adapt.build_schedule(num_warmup)
        state = chees_warm_chunk(logp, state, sched.update_mass, sched.window_end, max_num_steps,
                                 target_accept, traj_lr, free, draws, axis_name, chain_offset)
        state = finalize_chees_warmup(state)
    return state


def race_candidates(state: ChEESState, n: int, max_num_steps: int, lo_steps: float = 4.0) -> Tensor:
    """(n,) candidate log-trajectory lengths: the adapted draw plus n-1
    log-spaced points spanning [lo_steps, max_num_steps] leapfrog steps at
    the frozen step size, an absolute bracket, not centred on the adapted
    draw (the draw itself is the noisy quantity being hedged)."""
    if n < 2:
        raise ValueError(f"racing needs >= 2 candidates (got {n})")
    eps = state.step_size
    lo = torch.log(lo_steps * eps)
    hi = torch.log(max_num_steps * eps)
    frac = torch.arange(n - 1, dtype=eps.dtype, device=eps.device) / max(n - 2, 1)
    grid = lo + (hi - lo) * frac
    return torch.cat([state.log_traj[None], grid])


def chees_race(
    logp: LogDensity,
    state: ChEESState,
    n_candidates: int = 4,
    probe: int = 128,
    max_num_steps: int = 256,
    free: Tensor | None = None,
    lo_steps: float = 4.0,
    candidates: Tensor | None = None,
    draws: Draws = generator_draws,
) -> tuple[ChEESState, dict]:
    """Post-warmup trajectory-length racing: selection instead of smoothing.

    The warmed population is replicated once per candidate trajectory
    length; the k arms are the groups of one lockstep batch and run
    ``probe`` frozen-kernel transitions with identical halton indices, so
    each arm's leapfrog cost is computed exactly from the shared jitter
    sequence.  Each arm's draws are its group's in ``draws`` (by default
    from a generator of its own, spawned from the state's).  Score: the
    slowest free dimension's accept-realized ESJD over its posterior
    variance (pooled over all arms), per leapfrog step; pinned dimensions
    score +inf.  The winner's probe-end state seeds sampling.

    Returns (winner state, info) with info carrying the candidate
    log-trajectories, per-candidate normalized ESJD, probe min-ESS (for
    diagnostics only), leapfrog costs, scores and the winner's index.
    """
    if candidates is None:
        candidates = race_candidates(state, n_candidates, max_num_steps, lo_steps)
    candidates = torch.as_tensor(candidates, dtype=state.log_traj.dtype, device=state.log_traj.device)
    k = candidates.shape[0]
    rng = spawn_generators(state.rng, k) if isinstance(state.rng, torch.Generator) else state.rng
    arms = _map_groups(lambda a: a.expand(k, *a.shape).clone(), state)._replace(log_traj=candidates, rng=rng)
    raced, (pos, _, _) = chees_sample_chunk(logp, arms, probe, max_num_steps, free, draws)
    pos = pos.transpose(0, 1)  # (k, probe, chains, dim)

    # exact per-candidate leapfrog cost from the shared halton sequence
    # (every arm runs iteration indices state.step + 0..probe-1)
    u = _halton2(state.step + torch.arange(probe)).to(dtype=pos.dtype, device=pos.device)
    t_real = torch.maximum(u[None, :] * torch.exp(candidates)[:, None], state.step_size)
    n_steps = torch.clamp(torch.ceil(t_real / state.step_size).to(torch.int32), 1, max_num_steps)
    cost = n_steps.sum(1).to(pos.dtype)

    # realized ESJD per dim (rejections contribute zero jumps), normalized by
    # each dim's variance over the probe draws of all arms
    jumps = torch.diff(pos, dim=1)
    esjd = (jumps * jumps).mean(dim=(1, 2))
    var_d = pos.reshape(-1, pos.shape[-1]).var(0, correction=0) + 1e-12
    ratio = esjd / var_d[None, :]
    freea = as_free(free, ratio)
    if freea is not None:
        ratio = torch.where(freea[None, :] > 0, ratio, torch.inf)
    norm_esjd = ratio.min(1).values
    score = norm_esjd / cost
    probe_ess = torch.stack([diagnostics.ess(p.transpose(0, 1)).min() for p in pos])
    win = int(torch.argmax(score))
    info = {"candidates_log_traj": candidates, "norm_esjd": norm_esjd, "probe_min_ess": probe_ess,
            "leapfrog_cost": cost, "score": score, "winner": win}
    return take_group(raced, win), info


def run_chees_pops(
    logp: LogDensity,
    positions0: Tensor,
    rng: torch.Generator,
    n_pops: int,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    draws: Draws = generator_draws,
) -> Samples:
    """Independent ChEES populations in one lockstep batch.

    ``positions0`` (chains, dim) splits into ``n_pops`` populations of
    chains // n_pops, each adapting its own step size, trajectory and mass
    from its own cross-chain means: the groups of one state.  Each
    population draws from a generator of its own, ``spawn_generators(rng,
    n_pops)``, so each takes exactly the transitions that ``n_pops``
    separate :func:`run_chees` calls on those generators would.

    Returns Samples with positions (num_samples, chains, dim), chains
    grouped by population, and the grouped final state.
    """
    positions0 = torch.atleast_2d(torch.as_tensor(positions0))
    chains, dim = positions0.shape
    if chains % n_pops != 0:
        raise ValueError(f"{chains} chains not divisible by {n_pops} populations")
    pos = positions0.reshape(n_pops, chains // n_pops, dim)
    state = chees_init(logp, pos, spawn_generators(rng, n_pops), init_step_size, init_traj_length, free)
    state = _run(logp, state, num_warmup, max_num_steps, target_accept, traj_lr, free, draws)
    state, (positions, logps, accepts) = chees_sample_chunk(logp, state, num_samples, max_num_steps, free, draws)
    return Samples(positions.reshape(num_samples, chains, dim), logps.reshape(num_samples, chains),
                   accepts.reshape(num_samples, chains), state)


def run_chees(
    logp: LogDensity,
    positions0: Tensor,
    rng: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    race: int = 0,
    race_probe: int = 128,
    draws: Draws = generator_draws,
    axis_name=None,
    chain_offset: int = 0,
) -> Samples:
    """Warmup then sampling for the whole population.  ``positions0`` is
    (chains, dim); the returned positions are (num_samples, chains, dim).

    ``race > 0`` inserts a :func:`chees_race` selection between warmup and
    sampling: ``race`` candidate trajectory lengths probed for
    ``race_probe`` transitions each, the sampling budget to the winner
    (``draws`` then also serves the race's grouped state); on one rank
    only, as in the JAX twin."""
    if race > 0 and axis_name is not None:
        raise ValueError("race is a single-device feature; shard the race axis explicitly")
    state = chees_init(logp, positions0, rng, init_step_size, init_traj_length, free)
    state = _run(logp, state, num_warmup, max_num_steps, target_accept, traj_lr, free, draws, axis_name,
                 chain_offset)
    if race > 0:
        state, _ = chees_race(logp, state, race, race_probe, max_num_steps, free, draws=draws)
    state, (positions, logps, accepts) = chees_sample_chunk(logp, state, num_samples, max_num_steps, free, draws,
                                                            axis_name, chain_offset)
    return Samples(positions, logps, accepts, state)
