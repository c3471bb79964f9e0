"""Generalized (persistent-momentum) HMC with cross-fold ensemble adaptation.

PyTorch twin of ``gogp_tpu/infer/ghmc.py``, in the spirit of MEADS (Hoffman
& Sountsov, AISTATS 2022).  Every transition is ONE leapfrog step with a
partially refreshed persistent momentum,

    u' = damping * u + sqrt(1 - damping^2) * xi,   xi ~ N(0, I),

then a Metropolis test that negates the momentum on rejection (the flip
makes persistent momentum a valid MCMC kernel).  The whole population
advances in one batched value and gradient per transition (one K7 launch on
a theta-only GP study): no trajectory length, no data-dependent loop.

Cross-fold adaptation: the chains split into two folds by index parity; the
diagonal preconditioner each fold uses is the other fold's per-dimension
std, so no chain's kernel depends on its own state.  The step size adapts
by dual averaging on the population-mean acceptance towards 0.9 and freezes
at the averaged iterate; the damping is exp(-step / sigma_max_ratio) from
the running preconditioner; pinned coordinates (``free`` 0) get a neutral
sigma of 1 and are left out of the damping's ratio.

Randomness: the JAX twin draws each chain's xi and acceptance uniform from
``fold_in(key_iter, chain)``; here each transition takes them, (chains, dim)
and (chains,), from ``draws(state)``: by default :func:`generator_draws`,
from the state's ``torch.Generator``; tests hand in JAX's.

``axis_name``/``chain_offset``: the population may be sharded over mesh
axes (``gogp_torch.parallel.sample.run_ghmc_sharded``).  The fold moments
and the mean acceptance are then taken over the whole population, its
slabs gathered over ``axis_name`` (``chees._cross_mean``); each slab holds an
even number of chains, so local parity is global parity.  A slab's draws (and initial momenta) are its
rows of the whole population's (``chees.population_draws``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import adapt
from gogp_torch.infer.chees import _axis_size, _cross_mean, _gathered, population_draws
from gogp_torch.infer.hmc import Samples, as_free, value_and_grad

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]

TARGET_ACCEPT = 0.9


class GHMCState(NamedTuple):
    """Whole-population state; chains split into two folds by index parity.
    ``sigma[f]`` is the scale each chain of fold f uses, computed from fold
    1 - f's positions."""

    positions: Tensor  # (chains, dim)
    momenta: Tensor  # (chains, dim) standardized persistent momentum u
    logps: Tensor  # (chains,)
    grads: Tensor  # (chains, dim)
    step_size: Tensor  # () shared
    sigma: Tensor  # (2, dim) per-fold preconditioner (the other fold's std)
    accept_probs: Tensor  # (chains,)
    da: adapt.DualAveragingState
    step: int
    rng: torch.Generator  # on the positions' device


Draws = Callable[[GHMCState], tuple[Tensor, Tensor]]


def generator_draws(state: GHMCState) -> tuple[Tensor, Tensor]:
    """One transition's draws from the state's generator: the momentum
    refresh xi (chains, dim) and the acceptance uniforms (chains,)."""
    like = dict(dtype=state.positions.dtype, device=state.positions.device, generator=state.rng)
    return torch.randn(state.positions.shape, **like), torch.rand(state.logps.shape, **like)


def _fold_ids(chains: int, device=None) -> Tensor:
    return torch.arange(chains, device=device) % 2


def _fold_stats(positions: Tensor, free: Tensor | None = None, axis_name=None) -> Tensor:
    """(2, dim): for each fold, the std of the OTHER fold's positions
    (pinned coordinates: 1), over the whole population (with ``axis_name``
    its slabs gathered)."""
    positions = _gathered(positions, axis_name, 0)
    ids = _fold_ids(positions.shape[0], positions.device)

    def other_std(f):
        m = (ids != f).to(positions.dtype)[:, None]
        cnt = m.sum()
        mean = (positions * m).sum(0) / cnt
        var = (m * (positions - mean) ** 2).sum(0) / cnt
        std = torch.sqrt(torch.clamp(var, min=1e-12))
        return std if free is None else torch.where(free > 0, std, 1.0)

    return torch.stack([other_std(0), other_std(1)])


def ghmc_init(logp: LogDensity, positions: Tensor, rng: torch.Generator, step_size: float = 0.1,
              momenta: Tensor | None = None, axis_name=None, chain_offset: int = 0) -> GHMCState:
    """The population's state, its persistent momenta ``momenta`` or, if
    None, standard normal draws from ``rng`` (with ``axis_name``, this
    slab's rows of the whole population's, from ``chain_offset`` on)."""
    positions = torch.atleast_2d(torch.as_tensor(positions))
    chains, dim = positions.shape
    if chains < 2 or chains % 2 != 0:
        raise ValueError(f"ghmc needs an even population (got {chains}): cross-fold "
                         "adaptation splits chains by index parity")
    vals, grads = value_and_grad(logp, None)(positions)
    like = dict(dtype=positions.dtype, device=positions.device)
    step = torch.as_tensor(step_size, **like)
    if momenta is None:
        total = chains if axis_name is None else chains * _axis_size(axis_name)
        momenta = torch.randn((total, dim), generator=rng, **like)[chain_offset:chain_offset + chains]
    return GHMCState(
        positions=positions,
        momenta=momenta,
        logps=vals,
        grads=grads,
        step_size=step,
        sigma=torch.ones((2, dim), **like),
        accept_probs=torch.zeros((chains,), **like),
        da=adapt.da_init(step),
        step=0,
        rng=rng,
    )


def _damping(state: GHMCState, free: Tensor | None = None) -> Tensor:
    """exp(-step / max scale ratio): the ratio of the largest to the
    smallest fold scale (free coordinates only) bounds the steps the
    slowest direction needs; damping over that horizon keeps the momentum
    coherent across it."""
    sig = state.sigma
    if free is not None:
        keep = (free[None, :] > 0).expand(sig.shape)
        hi = torch.where(keep, sig, -torch.inf).max()
        lo = torch.where(keep, sig, torch.inf).min()
    else:
        hi, lo = sig.max(), sig.min()
    ratio = hi / torch.clamp(lo, min=1e-12)
    ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
    return torch.exp(-state.step_size / torch.clamp(ratio, min=1.0))


def ghmc_transition(
    logp: LogDensity,
    state: GHMCState,
    adapt_sigma: bool = False,
    free: Tensor | None = None,
    divergence_threshold: float = 1000.0,
    draws: Draws = generator_draws,
    axis_name=None,
    chain_offset: int = 0,
) -> GHMCState:
    """One population transition: partial momentum refresh, ONE leapfrog
    step in preconditioned coordinates, per-chain Metropolis with a
    momentum flip on rejection; with ``adapt_sigma`` the folds' scales
    from the new positions."""
    freea = as_free(free, state.positions)
    vg = value_and_grad(logp, freea)
    sig = state.sigma[_fold_ids(state.positions.shape[0], state.positions.device)]
    if freea is not None:
        sig = torch.where(freea[None, :] > 0, sig, 0.0)
    xi, u_acc = population_draws(draws, state, axis_name, chain_offset)

    gamma = _damping(state, freea)
    u = gamma * state.momenta + torch.sqrt(1.0 - gamma * gamma) * xi
    if freea is not None:
        u = u * freea[None, :]

    # one leapfrog step: q' = q + eps sig (u + eps/2 sig g)
    eps = state.step_size
    energy0 = -state.logps + 0.5 * (u * u).sum(1)
    u_half = u + 0.5 * eps * sig * state.grads
    q_new = state.positions + eps * sig * u_half
    if freea is not None:
        q_new = torch.where(freea[None, :] > 0, q_new, state.positions)
    lp_new, g_new = vg(q_new)
    u_new = u_half + 0.5 * eps * sig * g_new

    delta = -lp_new + 0.5 * (u_new * u_new).sum(1) - energy0
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    accept_probs = torch.where(delta > divergence_threshold, 0.0, torch.clamp(torch.exp(-delta), max=1.0))
    accept = u_acc < accept_probs
    acc = accept[:, None]
    positions = torch.where(acc, q_new, state.positions)
    return state._replace(
        positions=positions,
        momenta=torch.where(acc, u_new, -u),  # the flip on rejection
        logps=torch.where(accept, lp_new, state.logps),
        grads=torch.where(acc, g_new, state.grads),
        accept_probs=accept_probs,
        sigma=_fold_stats(positions, freea, axis_name) if adapt_sigma else state.sigma,
        step=state.step + 1,
    )


def ghmc_warmup_step(state: GHMCState, axis_name=None) -> GHMCState:
    da = adapt.da_update(state.da, _cross_mean(state.accept_probs, axis_name, -1), target=TARGET_ACCEPT)
    return state._replace(step_size=torch.exp(da.log_step), da=da)


def ghmc_warm_chunk(logp: LogDensity, state: GHMCState, num: int, free: Tensor | None = None,
                    draws: Draws = generator_draws, axis_name=None, chain_offset: int = 0) -> GHMCState:
    """``num`` warmup transitions."""
    for _ in range(num):
        state = ghmc_transition(logp, state, adapt_sigma=True, free=free, draws=draws, axis_name=axis_name,
                                chain_offset=chain_offset)
        state = ghmc_warmup_step(state, axis_name)
    return state


def finalize_ghmc_warmup(state: GHMCState) -> GHMCState:
    """Freeze the kernel: the step size at the dual-averaging average
    iterate (sigma and the damping freeze by no longer being updated)."""
    return state._replace(step_size=torch.exp(state.da.log_step_avg))


def ghmc_sample_chunk(logp: LogDensity, state: GHMCState, num: int, free: Tensor | None = None,
                      draws: Draws = generator_draws, axis_name=None,
                      chain_offset: int = 0) -> tuple[GHMCState, tuple[Tensor, Tensor, Tensor]]:
    """``num`` frozen-kernel transitions; returns (state, (positions (num,
    chains, dim), logps, accept_probs))."""
    pos, lps, accs = [], [], []
    for _ in range(num):
        state = ghmc_transition(logp, state, adapt_sigma=False, free=free, draws=draws, axis_name=axis_name,
                                chain_offset=chain_offset)
        pos.append(state.positions)
        lps.append(state.logps)
        accs.append(state.accept_probs)
    return state, (torch.stack(pos), torch.stack(lps), torch.stack(accs))


def run_ghmc(
    logp: LogDensity,
    positions0: Tensor,
    rng: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    free: Tensor | None = None,
    draws: Draws = generator_draws,
    momenta: Tensor | None = None,
) -> Samples:
    """Warmup then sampling, every transition one value and gradient;
    positions (num_samples, chains, dim).  ``momenta``: the initial
    persistent momenta (drawn from ``rng`` if None)."""
    positions0 = torch.atleast_2d(torch.as_tensor(positions0))
    if positions0.shape[0] < 4:
        raise ValueError(f"ghmc needs an even population of >= 4 chains (got {positions0.shape[0]}): "
                         "each fold's preconditioner is the other fold's std")
    state = ghmc_init(logp, positions0, rng, init_step_size, momenta)
    if num_warmup > 0:
        state = finalize_ghmc_warmup(ghmc_warm_chunk(logp, state, num_warmup, free, draws))
    state, (pos, lps, acc) = ghmc_sample_chunk(logp, state, num_samples, free, draws)
    return Samples(pos, lps, acc, state)
