"""Multi-rank SMC: particles sharded over the mesh, resampling by
all-gather.

PyTorch twin of ``gogp_tpu/parallel/smc_sharded.py``.  Each rank owns a
slab of particles; per stage:

- the incremental log-weights are computed locally (one GP LML per
  particle, the expensive part) and all-gathered: O(P) floats;
- the adaptive-tempering bisection and the systematic-resampling indices
  are computed identically on every rank from the gathered weights and the
  replicated resampling uniform;
- each rank gathers the whole population once and keeps its slab of the
  resampled particles; the HMC (or random-walk) mutation runs locally.

The loop is the serial sampler's own, ``infer.smc.smc_loop``, SPMD code
parameterised by the mesh axes that shard the population (re-exported
here, as the twin defines it here), so it composes with row-sharded
log-densities: :func:`run_smc_sharded` shards particles over every rank
(chain x data), while ``parallel.large_n.run_smc_large_n`` shards them over
the chain axis and lets each particle's row-sharded LML collectives ride
the data axis.  Randomness: an ``infer.smc.SMCDraws`` of the whole
population; each rank keeps its rows of the initial eps and of each
mutation's draws, so results do not depend on how the population is split.
"""

from __future__ import annotations

from typing import Callable

import torch

from gogp_torch.infer import smc as serial_smc
from gogp_torch.infer.smc import (
    SMCDraws,
    SMCResult,
    _fold_rank,
    _gather_axes,
    initial_particles,
    smc_loop,
)
from gogp_torch.parallel import mesh as pmesh
from gogp_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]


def run_smc_sharded(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
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
    """Sharded counterpart of ``infer.smc.run_smc`` (same semantics), the
    particles sharded over every rank of the mesh (chain x data).
    ``draws``: the whole population's (default: from ``rng``, replicated
    on every rank).  Returns the gathered particles on every rank."""
    position0 = torch.as_tensor(position0)
    n_dev = mesh.size
    if num_particles % n_dev != 0:
        raise ValueError(f"{num_particles} particles not divisible by {n_dev} devices")
    draws = draws or serial_smc.generator_draws(rng, num_particles, position0)
    axes = (CHAIN_AXIS, DATA_AXIS)
    with mesh:
        particles0 = initial_particles(position0, sigma0, draws, free)
        p_local = num_particles // n_dev
        rank = _fold_rank(axes)
        parts, log_z, stage, done, acc = smc_loop(
            logp, particles0[rank * p_local:(rank + 1) * p_local], position0, draws, axes, num_particles,
            sigma0=sigma0, num_mcmc_steps=num_mcmc_steps, n_leapfrog=n_leapfrog, ess_target=ess_target,
            max_stages=max_stages, bisection_iters=bisection_iters, free=free, mutation=mutation)
        return SMCResult(_gather_axes(parts, axes), log_z, stage, done, acc)


# the serial sampler, for callers that want it alongside
run_smc = serial_smc.run_smc
