"""Large-N GP inference: SMC and ChEES over hyperparameters with the
covariance row-sharded over the mesh and the Cholesky distributed
(BASELINE.json's "Large-N forecast: N=16k points, sharded covariance +
distributed Cholesky, SMC over hyperparameters").

PyTorch twin of ``gogp_tpu/parallel/large_n.py``.  The whole sampler is SPMD
over the mesh: the particle (or chain) population is sharded over the
non-data axes (weights and resampling gather over them, draws are each
rank's rows of the population's), and each particle's log-density does
distributed work over the data axis: each rank builds its block-rows of
K(theta) from its slab of X (the covariance is never materialised whole)
and the distributed blocked Cholesky and solves (``ops.distributed``)
reduce them to the replicated LML with collectives.  Control flow is
replicated everywhere.

Gradients: the distributed LML is a ``torch.autograd.Function`` with the
analytic backward (``ops.distributed.lml_rowsharded``), which gives each
rank its rows' share of the theta gradient; :func:`psum_grads` completes it
with one psum in its own backward.  No autograd runs through a collective.

Log-densities here take one log-theta vector (dim,) or a batch (B, dim),
the batch a host loop of single evaluations (each a distributed
factorization), the shape the port's samplers call.
"""

from __future__ import annotations

import math

import torch

from gogp_torch.gp.core import GP
from gogp_torch.infer import smc as serial_smc
from gogp_torch.infer.hmc import Samples
from gogp_torch.infer.smc import SMCResult, _fold_rank, _gather_axes, initial_particles, smc_loop
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import distributed as dops
from gogp_torch.ops import iterative
from gogp_torch.ops.draws import GeneratorDraws
from gogp_torch.parallel import mesh as pmesh
from gogp_torch.parallel.mesh import DATA_AXIS

Tensor = torch.Tensor


def _batched(logp_one):
    """A log-density of (dim,) or (B, dim): the batch row by row."""

    def logp(v: Tensor) -> Tensor:
        if v.dim() == 1:
            return logp_one(v)
        return torch.stack([logp_one(r) for r in v])

    return logp


def _fixed_draws(draws):
    """A callable giving the same probe draws at every call: a
    ``torch.Generator`` is replaced by a seed drawn from it once, each call
    a fresh generator on that seed; a ``PathDraws`` is returned as it is."""
    if not isinstance(draws, torch.Generator):
        return lambda: draws
    seed, device = int(torch.randint(0, 2**62, (1,), generator=draws, device=draws.device)), draws.device
    return lambda: GeneratorDraws(torch.Generator(device=device).manual_seed(seed))


def make_rowsharded_logp(gp: GP, x_local, x_full, y_local, mask_local, axis, block: int = cb.DEFAULT_BLOCK,
                         method: str = "exact", draws=None, num_probes: int = 16, cg_iters: int = 100,
                         lanczos_iters: int = 32, precond_rank: int = 0):
    """This rank's log-density: log-thetas (replicated) -> the replicated
    LML, under ``with mesh:``.

    Builds this rank's block-rows of K(theta) from its X slab (noise and the
    padding mask on the diagonal only) and runs the distributed
    factorization, or with ``method="iterative"`` the matrix-free CG/SLQ
    estimator (``ops.iterative.lml_rowsharded_iterative``: one all_gather
    per covariance matvec).  ``draws``: the probes' ``PathDraws``, the same
    on every rank and for every call (a ``torch.Generator`` is re-seeded
    from one draw of it before each call, so the probes stay fixed);
    required for "iterative".  ``precond_rank > 0`` (iterative only): the
    pivoted-Cholesky preconditioner from all-gathered column slices."""
    if method == "iterative" and draws is None:
        raise ValueError("method='iterative' needs probe `draws`")
    fixed = _fixed_draws(draws)
    n_local = x_local.shape[0]
    n = x_full.shape[0]

    def logp_one(v: Tensor) -> Tensor:
        theta = torch.exp(v)
        th_s, th_n = theta[: gp.n_theta_simil], theta[gp.n_theta_simil:]
        row0 = pmesh.axis_index(axis) * n_local
        rows = gp.simil.matrix(th_s, x_local, x_full)  # (n_local, n)
        eye = torch.arange(n, device=rows.device)[None, :] == (torch.arange(n_local, device=rows.device)
                                                              + row0)[:, None]
        noise = gp.noise.vector(th_n, x_local)
        rows = torch.where(eye, rows + noise[:, None], rows)
        # padding: identity rows and columns for masked-out points
        m_local = mask_local.to(rows.dtype)
        m_full = pmesh.all_gather(m_local, axis)
        rows = rows * (m_local[:, None] * m_full[None, :])
        rows = torch.where(eye, rows + (1.0 - m_local[:, None]), rows)
        yv = y_local * m_local
        if method == "iterative":
            y_full = pmesh.all_gather(yv, axis)
            noise_diag = None
            if precond_rank > 0:
                noise_diag = pmesh.all_gather((noise * m_local + (1.0 - m_local)).detach(), axis)
            core = iterative.lml_rowsharded_iterative(rows, y_full, fixed(), axis, num_probes, cg_iters,
                                                      lanczos_iters, precond_rank, noise_diag)
            n_eff = pmesh.psum(m_local.sum(), axis)
            return core - 0.5 * n_eff * math.log(2.0 * math.pi)
        lml = dops.lml_rowsharded(rows, yv, axis, block)
        # the constant term for the padding: lml_rowsharded counted all n
        n_pad = n - pmesh.psum(m_local.sum(), axis)
        return lml + 0.5 * n_pad * math.log(2.0 * math.pi)

    return _batched(logp_one)


def make_rowsharded_value_and_grad(logp, axis=DATA_AXIS):
    """value_and_grad of a row-sharded log-density of one (dim,) vector:
    the LML's backward gives each rank its partial theta gradient (the
    terms of tr(W dK) whose K rows it owns); one psum completes it."""

    def f(v: Tensor) -> tuple[Tensor, Tensor]:
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp(v)
            (g,) = torch.autograd.grad(val, v)
        return val.detach(), pmesh.psum(g, axis)

    return f


class _PsumGrads(torch.autograd.Function):
    """logp(v) whose backward is the whole-mesh gradient: the row-sharded
    partial gradient, psum'd over ``axis`` under the forward's mesh."""

    @staticmethod
    def forward(ctx, v, logp, axis):
        ctx.v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            ctx.val = logp(ctx.v)
        ctx.axis, ctx.mesh = axis, pmesh.current()
        return ctx.val.detach()

    @staticmethod
    def backward(ctx, cot):
        (g,) = torch.autograd.grad(ctx.val, ctx.v, cot)
        return ctx.mesh.psum(g, ctx.axis), None, None


def psum_grads(logp, axis=DATA_AXIS):
    """Wrap a row-sharded log-density so that autograd of the wrapper gives
    the COMPLETE parameter gradient (the cross-rank psum in its backward):
    the samplers' value-and-gradient consume the sharded density unchanged.
    A (B, dim) batch runs row by row, one psum a row."""
    return _batched(lambda v: _PsumGrads.apply(v, logp, axis))


def _data_slabs(x, y, mask, mesh: pmesh.Mesh):
    sh = pmesh.data_sharding(mesh)
    return sh.slab(x), sh.slab(y), sh.slab(mask)


def _prepare(gp: GP, x, y, mesh: pmesh.Mesh, mask, position0, check_rows: bool = True):
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[:, None]
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    n_data = mesh.shape[DATA_AXIS]
    if check_rows and n % n_data != 0:
        raise ValueError(f"n={n} must divide over {n_data} data-axis devices")
    if mask is None:
        mask = torch.ones(n, dtype=x.dtype, device=x.device)
    if position0 is None:
        position0 = torch.zeros(gp.n_theta, dtype=x.dtype, device=x.device)
    return x, y, torch.as_tensor(mask, dtype=x.dtype, device=x.device), torch.as_tensor(position0)


def _population_axes(mesh: pmesh.Mesh, with_data: bool) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if (with_data or a != DATA_AXIS) and mesh.shape[a] > 1)


def run_chees_large_n(
    gp: GP,
    x,
    y,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    num_chains: int = 8,
    num_warmup: int = 200,
    num_samples: int = 200,
    block: int = cb.DEFAULT_BLOCK,
    mask=None,
    position0=None,
    sigma0: float = 0.1,
    init_step_size: float = 0.01,
    init_traj_length: float = 0.1,
    target_accept: float = 0.75,
    max_num_steps: int = 64,
    traj_lr: float = 0.025,
    method: str = "exact",
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    grid_size: int | tuple = 2048,
    draws=None,
    init_eps: Tensor | None = None,
    probes=None,
) -> Samples:
    """Full-posterior ChEES-HMC over log-thetas with the covariance
    row-sharded over the data axis.

    Chains shard over the non-data mesh axes (every cross-chain adaptation
    statistic pmean'd over them, each rank's draws its rows of the
    population's); each chain's log-density and gradient do distributed
    work over the data axis, completed by :func:`psum_grads`.

    ``method="iterative"`` samples the CG/SLQ surrogate with fixed probes
    (``probes``, default a generator seeded from ``rng``: a smooth
    deterministic target whose bias is the estimator error).
    ``method="ski"`` samples the SKI surrogate (``gp.ski.lml_ski``,
    ``grid_size`` per axis): per-chain work is cheap enough on one rank
    that the chains shard over EVERY mesh axis with (x, y) replicated; no
    padding mask.  ``draws``: the ChEES hook of the whole population;
    ``init_eps``: the (num_chains, dim) standard normals of the start
    (default: from ``rng``).  Returns positions (num_samples, num_chains,
    dim), gathered."""
    from gogp_torch.infer import chees
    from gogp_torch.parallel.sample import _gather, _gather_chees

    if method == "ski":
        if mask is not None:
            raise ValueError("method='ski' does not support a padding mask")
    x, y, mask, position0 = _prepare(gp, x, y, mesh, mask, position0, check_rows=method != "ski")
    dim = position0.shape[0]
    chain_axes = _population_axes(mesh, with_data=method == "ski")
    n_chain_dev = mesh.axis_size(chain_axes) if chain_axes else 1
    if num_chains % n_chain_dev != 0:
        raise ValueError(f"{num_chains} chains not divisible over {n_chain_dev} chain-axis devices {chain_axes}")
    local = num_chains // n_chain_dev
    if init_eps is None:
        init_eps = torch.randn((num_chains, dim), generator=rng, dtype=position0.dtype, device=rng.device)
    if probes is None and method in ("iterative", "ski"):
        probes = torch.Generator(device=rng.device).manual_seed(
            int(torch.randint(0, 2**62, (1,), generator=rng, device=rng.device)))
    draws = draws or chees.generator_draws
    axis_name = chain_axes if chain_axes else None

    with mesh:
        if method == "ski":
            from gogp_torch.gp.ski import lml_ski

            probe_draws = _fixed_draws(probes)

            def logp_one(v):
                theta = torch.exp(v)
                return lml_ski(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil:], x, y, probe_draws(),
                               grid_size, num_probes, cg_iters, lanczos_iters)

            logp = _batched(logp_one)
        else:
            x_local, y_local, m_local = _data_slabs(x, y, mask, mesh)
            logp = psum_grads(make_rowsharded_logp(gp, x_local, pmesh.all_gather(x_local, DATA_AXIS), y_local,
                                                   m_local, DATA_AXIS, block, method=method, draws=probes,
                                                   num_probes=num_probes, cg_iters=cg_iters,
                                                   lanczos_iters=lanczos_iters, precond_rank=precond_rank),
                              DATA_AXIS)
        offset = _fold_rank(chain_axes) * local
        pos0 = (position0[None, :] + sigma0 * init_eps)[offset:offset + local]
        res = chees.run_chees(logp, pos0, rng, num_warmup, num_samples, init_step_size, init_traj_length,
                              target_accept, max_num_steps, traj_lr, None, draws=draws, axis_name=axis_name,
                              chain_offset=offset)
        if not chain_axes:
            return res
        return Samples(_gather(res.positions, 1, chain_axes), _gather(res.logps, 1, chain_axes),
                       _gather(res.accept_probs, 1, chain_axes), _gather_chees(res.state, chain_axes))


def run_smc_large_n(
    gp: GP,
    x,
    y,
    rng: torch.Generator,
    mesh: pmesh.Mesh,
    num_particles: int = 32,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    block: int = cb.DEFAULT_BLOCK,
    mask=None,
    position0=None,
    max_stages: int = 50,
    mutation: str = "hmc",
    method: str = "exact",
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    draws: serial_smc.SMCDraws | None = None,
    probes=None,
    n_leapfrog: int = 10,
) -> SMCResult:
    """SMC posterior over log-thetas with N-sharded covariance work AND the
    particle population sharded over the remaining mesh axes.

    ``x`` (n, d), ``y`` (n,), n divisible by the data-axis size.  Every
    non-data mesh axis of size > 1 shards particles: a (chain=C, data=D)
    mesh gives each rank P/C particles and n/D rows of each particle's
    covariance.  ``mutation``: "hmc" (gradient-guided, through
    :func:`psum_grads`) or "rwm".  ``method="iterative"``: the CG/SLQ
    core with fixed probes (``probes``, default a generator seeded from
    ``rng``).  ``draws``: the SMC hook of the whole population (default:
    from ``rng``).  Returns the gathered particles on every rank."""
    x, y, mask, position0 = _prepare(gp, x, y, mesh, mask, position0)
    particle_axes = _population_axes(mesh, with_data=False)
    n_part_dev = mesh.axis_size(particle_axes) if particle_axes else 1
    if num_particles % n_part_dev != 0:
        raise ValueError(f"{num_particles} particles not divisible over {n_part_dev} particle-axis devices "
                         f"{particle_axes}")
    p_local = num_particles // n_part_dev
    draws = draws or serial_smc.generator_draws(rng, num_particles, position0)
    if probes is None and method == "iterative":
        probes = torch.Generator(device=rng.device).manual_seed(
            int(torch.randint(0, 2**62, (1,), generator=rng, device=rng.device)))
    with mesh:
        x_local, y_local, m_local = _data_slabs(x, y, mask, mesh)
        logp = make_rowsharded_logp(gp, x_local, pmesh.all_gather(x_local, DATA_AXIS), y_local, m_local, DATA_AXIS,
                                    block, method=method, draws=probes, num_probes=num_probes, cg_iters=cg_iters,
                                    lanczos_iters=lanczos_iters, precond_rank=precond_rank)
        if mutation == "hmc":
            logp = psum_grads(logp, DATA_AXIS)
        particles0 = initial_particles(position0, sigma0, draws)
        rank = _fold_rank(particle_axes)
        parts, log_z, stage, done, acc = smc_loop(logp, particles0[rank * p_local:(rank + 1) * p_local], position0,
                                                  draws, particle_axes, num_particles, sigma0=sigma0,
                                                  num_mcmc_steps=num_mcmc_steps, n_leapfrog=n_leapfrog,
                                                  max_stages=max_stages, mutation=mutation)
        return SMCResult(_gather_axes(parts, particle_axes), log_z, stage, done, acc)


__all__ = [
    "make_rowsharded_logp",
    "make_rowsharded_value_and_grad",
    "psum_grads",
    "run_chees_large_n",
    "run_smc_large_n",
]
