"""Sequential Monte Carlo sampler: adaptive tempering and HMC mutation.

PyTorch twin of ``gogp_tpu/infer/smc.py`` (Del Moral et al. 2006, the
likelihood-tempering path):

- particles start from a Gaussian reference q0 = N(mu0, sigma0^2 I);
- the bridge is logp_beta(v) = (1 - beta) log q0(v) + beta logp(v), beta
  from 0 to 1;
- each stage picks the next beta by bisection (a fixed number of halvings)
  so that the effective sample size of the incremental weights stays near
  ``ess_target`` of the particles;
- systematic resampling, then ``num_mcmc_steps`` HMC (or random-walk
  Metropolis) transitions targeting logp_beta, with the mass from the
  resampled population's spread;
- the log evidence is the sum of the stages' logsumexp increments.

Every particle moves at once: each value and gradient is one batched call
of ``logp`` on (particles, dim), which on a theta-only GP study is one K7
launch (``tutorial/bayes.py``).  The stage loop is a host loop with one
host read of beta per stage (the JAX while loop's ``cond``).  The loop,
:func:`smc_loop`, also runs on a slab of a population sharded over mesh
axes (``parallel.smc_sharded``, ``parallel.large_n``).

Randomness: the JAX twin draws from a key chain (``split(rng)`` once, then
``split(key, 3)`` per stage, ``fold_in(k_mut, i)`` and a key per particle
per mutation), which torch cannot reproduce.  The sampler takes its draws
from an :class:`SMCDraws`: the initial eps, each stage's resampling uniform
and each mutation's normals and uniforms.  By default
:func:`generator_draws` takes them from a ``torch.Generator``; tests hand in
JAX's own.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from gogp_torch.infer.hmc import IntegratorState, LogDensity, as_free, kinetic, value_and_grad
from gogp_torch.ops import collectives as coll

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453


class SMCResult(NamedTuple):
    particles: Tensor  # (num_particles, dim) final (beta = 1) particles
    log_evidence: Tensor  # () log E_q0[exp(logp - log q0)]
    num_stages: int  # tempering stages used
    betas_hit_one: bool  # annealing completed within max_stages
    accept_rate: Tensor  # () mean accept rate of the final stage's last mutation


class SMCDraws(NamedTuple):
    """Where the sampler's random numbers come from."""

    init: Callable[[], Tensor]  # () -> (particles, dim) standard normal
    resample: Callable[[int], Tensor]  # stage -> () uniform
    mutation: Callable[[int, int], tuple[Tensor, Tensor]]  # (stage, i) -> (particles, dim) normal, (particles,) uniform


def generator_draws(rng: torch.Generator, num_particles: int, like: Tensor) -> SMCDraws:
    """Draws from ``rng``, each made when first asked for."""
    dim = like.shape[-1]
    kw = dict(dtype=like.dtype, device=like.device, generator=rng)
    return SMCDraws(
        init=lambda: torch.randn((num_particles, dim), **kw),
        resample=lambda stage: torch.rand((), **kw),
        mutation=lambda stage, i: (torch.randn((num_particles, dim), **kw), torch.rand((num_particles,), **kw)),
    )


def _systematic_resample(u: Tensor, log_weights: Tensor) -> Tensor:
    """Indices of the resampled particles (systematic, one uniform ``u``)."""
    p = log_weights.shape[0]
    cum = torch.cumsum(torch.softmax(log_weights, 0), 0)
    pts = (torch.arange(p, dtype=cum.dtype, device=cum.device) + u) / p
    return torch.clamp(torch.searchsorted(cum, pts), 0, p - 1)


def _ess(log_weights: Tensor) -> Tensor:
    lw = log_weights - torch.logsumexp(log_weights, -1, keepdim=True)
    return torch.exp(-torch.logsumexp(2.0 * lw, -1))


def _rwm_mutate(logp_beta, positions: Tensor, normals: Tensor, uniforms: Tensor, step_scale: Tensor, free):
    """One random-walk Metropolis transition of every particle (gradient
    free)."""
    step = step_scale * normals
    if free is not None:
        step = step * free
    q_new = positions + step
    delta = logp_beta(q_new) - logp_beta(positions)
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    accept = uniforms < accept_prob
    return torch.where(accept[:, None], q_new, positions), accept_prob


def _mutation_steps(vg_beta, s: IntegratorState, step_size: float, inv_mass: Tensor, n_leapfrog: int,
                    free) -> IntegratorState:
    """The mutation's integrator, the JAX twin's ``leap`` (smc.py:101-109):
    each step kicks the momentum by half a step's gradient, drifts, and
    evaluates the gradient at the new position, but the next step kicks by
    half a step again.  So every interior kick is half of velocity
    Verlet's (``hmc.leapfrog`` kicks by ``step * grad`` between drifts) and
    the last half kick is never taken: the integrator is not the leapfrog,
    is not reversible under a momentum flip, and the energy that the
    acceptance compares is not the leapfrog's.  Mirrored for parity with
    the JAX package; ROADMAP.md lists it as the reference's fault."""
    for _ in range(n_leapfrog):
        r = s.momentum + 0.5 * step_size * s.grad
        q = s.position + step_size * inv_mass * r
        if free is not None:
            q = torch.where(free > 0, q, s.position)
        s = IntegratorState(q, r, *vg_beta(q))
    return s


def _hmc_mutate(vg_beta, positions: Tensor, normals: Tensor, uniforms: Tensor, step_size: float,
                inv_mass: Tensor, n_leapfrog: int, free):
    """One HMC-like transition of every particle on the tempered density
    (``vg_beta`` masks its gradient by ``free``), integrated by
    :func:`_mutation_steps` as the JAX twin integrates it."""
    logp_q, grad_q = vg_beta(positions)
    r0 = normals / torch.sqrt(inv_mass)
    if free is not None:
        r0 = r0 * free
    e0 = -logp_q + kinetic(r0, inv_mass)
    s = _mutation_steps(vg_beta, IntegratorState(positions, r0, logp_q, grad_q), step_size, inv_mass, n_leapfrog,
                        free)
    e1 = -s.logp + kinetic(s.momentum, inv_mass)
    delta = torch.where(torch.isnan(e1 - e0), torch.inf, e1 - e0)
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    accept = uniforms < accept_prob
    return torch.where(accept[:, None], s.position, positions), accept_prob


def _fold_rank(axes: Sequence[str]) -> int:
    """Rank in the flattened (row-major) order of the mesh ``axes``: how the
    particle axis splits over them (0 with no axes)."""
    return coll.axis_index(tuple(axes)) if axes else 0


def _gather_axes(x: Tensor, axes: Sequence[str]) -> Tensor:
    """``x`` all-gathered over ``axes``, ordered axes[0]-major (``x`` itself
    with no axes)."""
    return coll.all_gather(x, tuple(axes)) if axes else x


def initial_particles(position0: Tensor, sigma0: float, draws: SMCDraws, free: Tensor | None = None) -> Tensor:
    """The whole population's starting particles from ``draws.init()``."""
    eps = draws.init()
    freea = as_free(free, position0)
    if freea is not None:
        eps = eps * freea[None, :]
    return position0[None, :] + sigma0 * eps


def smc_loop(
    logp: LogDensity,
    particles_local: Tensor,
    position0: Tensor,
    draws: SMCDraws,
    particle_axes: Sequence[str],
    num_particles: int,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    n_leapfrog: int = 10,
    ess_target: float = 0.5,
    max_stages: int = 100,
    bisection_iters: int = 20,
    free: Tensor | None = None,
    mutation: str = "hmc",
):
    """The tempering loop on this rank's particle slab; :func:`run_smc` is
    the loop with no axes, ``parallel.smc_sharded`` runs it under ``with
    mesh:`` with the population sharded over ``particle_axes``.  Every
    population-wide quantity (the log-ratios, the resampled particles, the
    mass from their spread, the acceptance) is taken from the gathered
    population, so any split of the particles gives the serial sampler's
    numbers; any other mesh axis is free for the log-density's own
    collectives.  Returns (particles_local, log_z, stages, done, accept)."""
    if mutation not in ("hmc", "rwm"):
        raise ValueError(f"unknown mutation {mutation!r}")
    dim = position0.shape[0]
    p_local = particles_local.shape[0]
    freea = as_free(free, position0)
    n_free = freea.sum() if freea is not None else dim
    rank = _fold_rank(particle_axes)
    mine = slice(rank * p_local, (rank + 1) * p_local)

    def log_q0(V):
        z = (V - position0) / sigma0
        if freea is not None:
            z = z * freea
        return -0.5 * (z * z).sum(-1) - n_free * (0.5 * _LOG_2PI + math.log(sigma0))

    def next_beta(beta: Tensor, log_ratios: Tensor) -> Tensor:
        """The largest beta' in (beta, 1] keeping the ESS at least
        ``ess_target`` of the particles."""
        target = ess_target * num_particles
        lo, hi = beta, torch.ones_like(beta)
        ok_full = _ess((hi - beta) * log_ratios) >= target
        for _ in range(bisection_iters):
            mid = 0.5 * (lo + hi)
            ok = _ess((mid - beta) * log_ratios) >= target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return torch.where(ok_full, 1.0, lo)

    parts = particles_local
    beta = position0.new_zeros(())
    log_z, accept_probs = position0.new_zeros(()), None
    stage = 0
    while stage < max_stages and float(beta) < 1.0:
        lr_local = logp(parts) - log_q0(parts)
        lr_local = torch.where(torch.isnan(lr_local), -torch.inf, lr_local)
        log_ratios = _gather_axes(lr_local, particle_axes)  # (P,)
        beta_new = next_beta(beta, log_ratios)
        lw = (beta_new - beta) * log_ratios
        log_z = log_z + torch.logsumexp(lw, 0) - math.log(float(num_particles))
        idx = _systematic_resample(draws.resample(stage), lw)  # identical on every rank
        full = _gather_axes(parts, particle_axes)[idx]  # (P, dim)
        parts = full[mine]

        # the mutation's mass from the resampled population's spread
        std = full.std(0, correction=0)
        if freea is not None:
            std = torch.where(freea > 0, std, 1.0)
        inv_mass = torch.clamp(std * std, min=1e-10)

        def logp_beta(V, b=beta_new):
            return (1.0 - b) * log_q0(V) + b * logp(V)

        for i in range(num_mcmc_steps):
            normals, uniforms = draws.mutation(stage, i)
            normals, uniforms = normals[mine], uniforms[mine]
            if mutation == "hmc":
                parts, accept_probs = _hmc_mutate(value_and_grad(logp_beta, freea), parts, normals, uniforms,
                                                  0.5 / math.sqrt(dim), inv_mass, n_leapfrog, freea)
            else:  # Roberts and Rosenthal's optimal RWM scale from the population std
                parts, accept_probs = _rwm_mutate(logp_beta, parts, normals, uniforms,
                                                  (2.38 / math.sqrt(dim)) * std, freea)
        beta, stage = beta_new, stage + 1
    # the last mutation's mean acceptance over the whole population (the JAX
    # sharded twin reports its first device's slab's)
    acc = position0.new_zeros(()) if accept_probs is None else _gather_axes(accept_probs, particle_axes).mean()
    return parts, log_z, stage, bool(beta >= 1.0), acc


def run_smc(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    num_particles: int = 512,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    n_leapfrog: int = 10,
    ess_target: float = 0.5,
    max_stages: int = 100,
    bisection_iters: int = 20,
    free: Tensor | None = None,
    mutation: str = "hmc",
    draws: SMCDraws | None = None,
) -> SMCResult:
    """Anneal from N(position0, sigma0^2 I) to ``logp`` (a batched
    log-density, (particles, dim) to (particles,)); returns the particles.

    ``log_evidence`` estimates log E_q0[exp(logp - log q0)].  ``mutation``:
    "hmc" (default) or "rwm", random-walk Metropolis for targets whose
    gradient is unavailable."""
    position0 = torch.as_tensor(position0)
    draws = draws or generator_draws(rng, num_particles, position0)
    particles, log_z, stage, done, acc = smc_loop(
        logp, initial_particles(position0, sigma0, draws, free), position0, draws, (), num_particles,
        sigma0=sigma0, num_mcmc_steps=num_mcmc_steps, n_leapfrog=n_leapfrog, ess_target=ess_target,
        max_stages=max_stages, bisection_iters=bisection_iters, free=free, mutation=mutation)
    return SMCResult(particles, log_z, stage, done, acc)
