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

Differences from the JAX twin, each forced by PyTorch:

- The step count of a transition is data dependent (the JAX ``fori_loop``):
  here it is read to the host once per transition and the leapfrog is a
  host loop.  The warmup and sampling scans are host loops too.
- Randomness: the JAX twin draws each chain's momentum and acceptance
  uniform from ``fold_in(key_iter, chain)``, which torch cannot reproduce.
  Each transition takes its draws ``(r0_raw (chains, dim), u_acc (chains,))``
  from one place, ``draws(state)``: by default :func:`generator_draws`, from
  the state's ``torch.Generator``; tests hand in JAX's own draws.
- No ``axis_name``/``chain_offset``: the sharded population waits for the
  multi-device layer.  Racing (``chees_race``, ``race_candidates``) and
  independent populations (``run_chees_pops``) wait in ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import adapt
from gogp_torch.infer.hmc import IntegratorState, Samples, as_free, kinetic, leapfrog, value_and_grad

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]


class AdamState(NamedTuple):
    """Scalar Adam for the log-trajectory-length ascent."""

    m: Tensor  # ()
    v: Tensor  # ()
    t: Tensor  # () int32


def _adam_init(dtype, device=None) -> AdamState:
    return AdamState(
        m=torch.zeros((), dtype=dtype, device=device),
        v=torch.zeros((), dtype=dtype, device=device),
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
    """Whole-population state: ``positions`` holds the chain axis."""

    positions: Tensor  # (chains, dim)
    logps: Tensor  # (chains,)
    grads: Tensor  # (chains, dim)
    step_size: Tensor  # () shared across chains
    inv_mass: Tensor  # (dim,) shared diagonal inverse mass
    log_traj: Tensor  # () log of the max trajectory length T
    accept_probs: Tensor  # (chains,)
    da: adapt.DualAveragingState  # shared step-size dual averaging
    adam: AdamState  # trajectory-length Adam
    welford: adapt.WelfordState  # cross-chain mass accumulator
    step: int  # iteration counter (drives the halton jitter)
    rng: torch.Generator  # on the positions' device


Draws = Callable[[ChEESState], tuple[Tensor, Tensor]]


def generator_draws(state: ChEESState) -> tuple[Tensor, Tensor]:
    """One transition's draws from the state's generator: standard normal
    momenta (chains, dim) and acceptance uniforms (chains,)."""
    chains, dim = state.positions.shape
    like = dict(dtype=state.positions.dtype, device=state.positions.device, generator=state.rng)
    return torch.randn((chains, dim), **like), torch.rand((chains,), **like)


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


def chees_init(
    logp: LogDensity,
    positions: Tensor,
    rng: torch.Generator,
    step_size: float = 0.1,
    traj_length: float = 1.0,
    free: Tensor | None = None,
) -> ChEESState:
    positions = torch.atleast_2d(torch.as_tensor(positions))
    vals, grads = value_and_grad(logp, as_free(free, positions))(positions)
    chains, dim = positions.shape
    like = dict(dtype=positions.dtype, device=positions.device)
    return ChEESState(
        positions=positions,
        logps=vals,
        grads=grads,
        step_size=torch.as_tensor(step_size, **like),
        inv_mass=torch.ones((dim,), **like),
        log_traj=torch.log(torch.as_tensor(traj_length, **like)),
        accept_probs=torch.zeros((chains,), **like),
        da=adapt.da_init(step_size, **like),
        adam=_adam_init(**like),
        welford=adapt.welford_init(dim, **like),
        step=0,
        rng=rng,
    )


def n_leapfrog_steps(state: ChEESState, max_num_steps: int = 256) -> tuple[int, Tensor]:
    """The transition's shared step count (one host read) and its jittered
    integration time t = max(u T, step), u = halton(step)."""
    u = _halton2(state.step).to(device=state.step_size.device, dtype=state.step_size.dtype)
    t_real = torch.maximum(u * torch.exp(state.log_traj), state.step_size)
    n_steps = int(torch.ceil(t_real / state.step_size))
    return min(max(n_steps, 1), max_num_steps), t_real


def chees_transition(
    logp: LogDensity,
    state: ChEESState,
    adapt_traj: bool = False,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Tensor | None = None,
    divergence_threshold: float = 1000.0,
    draws: Draws = generator_draws,
) -> ChEESState:
    """One population transition: shared jittered trajectory, batched
    leapfrog, per-chain Metropolis, and with ``adapt_traj`` one ChEES
    gradient step on log T."""
    freea = as_free(free, state.positions)
    vg = value_and_grad(logp, freea)
    r0_raw, u_acc = draws(state)

    n_steps, t_real = n_leapfrog_steps(state, max_num_steps)
    r0 = r0_raw / torch.sqrt(state.inv_mass)
    if freea is not None:
        r0 = r0 * freea
    energy0 = -state.logps + kinetic(r0, state.inv_mass)

    integ = IntegratorState(state.positions, r0, state.logps, state.grads)
    integ = leapfrog(vg, integ, state.step_size, state.inv_mass, n_steps, freea)

    energy1 = -integ.logp + kinetic(integ.momentum, state.inv_mass)
    delta = energy1 - energy0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    accept_probs = torch.where(delta > divergence_threshold, 0.0, torch.clamp(torch.exp(-delta), max=1.0))
    accept = u_acc < accept_probs
    acc = accept[:, None]
    positions = torch.where(acc, integ.position, state.positions)
    logps = torch.where(accept, integ.logp, state.logps)
    grads = torch.where(acc, integ.grad, state.grads)

    # ChEES gradient on log T (Hoffman et al. 2021, eq. 8-9): the centred
    # squared-radius change, differentiated through the endpoint velocity.
    # Divergent chains (non-finite endpoints) enter with their start point at
    # weight 0, so an inf cannot poison the cross-chain means.
    fin = (torch.isfinite(integ.position).all(1) & torch.isfinite(integ.momentum).all(1)
           & torch.isfinite(delta))
    q1 = torch.where(fin[:, None], integ.position, state.positions)
    vel1 = torch.where(fin[:, None], state.inv_mass * integ.momentum, 0.0)
    c0 = state.positions - state.positions.mean(0)
    c1 = q1 - q1.mean(0)
    delta_sq = (c1 * c1).sum(1) - (c0 * c0).sum(1)
    ddelta_dt = 2.0 * (c1 * vel1).sum(1)
    w = accept_probs * fin
    wsum = w.mean() + 1e-12
    g_t = (w * delta_sq * ddelta_dt).mean() / wsum
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


def _welford_update_population(w: adapt.WelfordState, X: Tensor) -> adapt.WelfordState:
    """Fold a whole (chains, dim) batch into the accumulator (Chan merge)."""
    n = torch.as_tensor(X.shape[0], dtype=X.dtype, device=X.device)
    mean = X.mean(0)
    m2 = ((X - mean) ** 2).mean(0) * n
    return adapt.welford_combine(w, adapt.WelfordState(n, mean, m2))


def chees_warmup_step(
    state: ChEESState,
    update_mass: bool,
    window_end: bool,
    target_accept: float = 0.75,
) -> ChEESState:
    """Shared-statistics warmup bookkeeping: one dual-averaging update from
    the population-mean accept, one batched Welford feed, window refresh."""
    da = adapt.da_update(state.da, state.accept_probs.mean(), target=target_accept)
    step_size = torch.exp(da.log_step)
    welford = _welford_update_population(state.welford, state.positions) if update_mass else state.welford
    inv_mass = state.inv_mass
    if window_end:
        new_inv_mass = adapt.welford_variance(welford)
        inv_mass = torch.where(welford.count > 1, new_inv_mass, inv_mass)
        welford = adapt.welford_init(inv_mass.shape[0], inv_mass.dtype, inv_mass.device)
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
) -> ChEESState:
    """Warmup transitions, one per pair of schedule flags."""
    for um, we in zip(update_mass, window_end):
        state = chees_transition(logp, state, adapt_traj=True, max_num_steps=max_num_steps,
                                 traj_lr=traj_lr, free=free, draws=draws)
        state = chees_warmup_step(state, bool(um), bool(we), target_accept)
    return state


def chees_sample_chunk(
    logp: LogDensity,
    state: ChEESState,
    num: int,
    max_num_steps: int = 256,
    free: Tensor | None = None,
    draws: Draws = generator_draws,
) -> tuple[ChEESState, tuple[Tensor, Tensor, Tensor]]:
    """``num`` frozen-hyperparameter transitions; returns the state and
    (positions (num, chains, dim), logps, accept_probs)."""
    pos, lps, accs = [], [], []
    for _ in range(num):
        state = chees_transition(logp, state, adapt_traj=False, max_num_steps=max_num_steps,
                                 free=free, draws=draws)
        pos.append(state.positions)
        lps.append(state.logps)
        accs.append(state.accept_probs)
    return state, (torch.stack(pos), torch.stack(lps), torch.stack(accs))


def finalize_chees_warmup(state: ChEESState) -> ChEESState:
    """Freeze the step size at the dual-averaging average iterate (the
    halton jitter keeps running: it is part of the kernel)."""
    return state._replace(step_size=torch.exp(state.da.log_step_avg))


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
    draws: Draws = generator_draws,
) -> Samples:
    """Warmup then sampling for the whole population.  ``positions0`` is
    (chains, dim); the returned positions are (num_samples, chains, dim)."""
    if race:
        raise NotImplementedError("chees_race is not ported yet (ROADMAP.md, queue 1)")
    state = chees_init(logp, positions0, rng, init_step_size, init_traj_length, free)
    if num_warmup > 0:
        sched = adapt.build_schedule(num_warmup)
        state = chees_warm_chunk(logp, state, sched.update_mass, sched.window_end, max_num_steps,
                                 target_accept, traj_lr, free, draws)
        state = finalize_chees_warmup(state)
    state, (positions, logps, accepts) = chees_sample_chunk(logp, state, num_samples, max_num_steps, free, draws)
    return Samples(positions, logps, accepts, state)

