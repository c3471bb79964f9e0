"""Driver entry points: the single-card forward step and the multi-device
dry run.

PyTorch twin of the JAX package's root ``__graft_entry__.py``:

- :func:`entry` -> ``(fn, example_args)``: the forward step on the flagship
  model (the hyperpriors study's log-joint, GP LML plus Normal hyperpriors,
  and its gradient) at n = 256 in float32;
- :func:`dryrun_multichip` builds a (chain, data) mesh over the first
  ``n_devices`` ranks of the ``torch.distributed`` world and runs the twin's
  steps on it, in its order, at its tiny shapes, seeds and arguments.

Fourteen of the steps call the multi-device layer's runners
(``parallel.sample``, ``parallel.large_n``, ``parallel.serving``,
``ops.distributed``).  Seven are plain ``jit``s with sharded inputs in the
JAX twin, which GSPMD partitions; the port has no GSPMD, so each is written
here as an explicit SPMD function over the mesh's process groups
(``_chain_adam_step``, ``_data_sharded_value_and_grad``, ``_svgp_step``,
``_laplace_rowsharded``, ``_thompson_step``, ``_ski_value_and_grad``,
``_advi_sharded``): every rank of the mesh calls it on its shard, the data
stays on its rank where the twin's comment says the step partitions, and
the collectives are the mesh's psum and all_gather.

The samplers' batched log-joint is ``tutorial.bayes.build_logjoint`` on the
hyperpriors study (the twin vmaps the same ``gp_observe`` plus priors): on
the card its K7 route, one ``csrc/fused_gp.cu`` launch a call.  Every step
that draws takes its draws from ``draws[step]`` (keyword arguments of the
step's runner or SPMD form), so tests can hand in the twin's; by default
each draws from a ``torch.Generator`` seeded with the twin's key number.

Run on the card:  ``python -m gogp_torch.graft_entry`` (a world of one), or
``torchrun --nproc-per-node 4 -m gogp_torch.graft_entry`` for four ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Collection

import numpy as np
import torch
import torch.distributed as dist

from gogp_torch.gp import core, laplace, pathwise, serve, sparse
from gogp_torch.gp.likelihoods import bernoulli_logit
from gogp_torch.gp.ski import _axis_grid, _grid_cov
from gogp_torch.gp.streaming import absorb_append
from gogp_torch.infer import advi, hmc, mle
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import distributed, iterative, linalg, ski
from gogp_torch.ops.toeplitz import toeplitz_matvec_fn
from gogp_torch.parallel import large_n, sample, serving
from gogp_torch.parallel import mesh as pmesh
from gogp_torch.parallel.mesh import CHAIN_AXIS, DATA_AXIS

Tensor = torch.Tensor
AXES = (CHAIN_AXIS, DATA_AXIS)

# Each step of dryrun_multichip and its outputs, in the twin's
# ``jax.block_until_ready`` order; "sharded_lml" runs only where n_data > 1.
STEPS = (
    ("chain_adam", ("v_new", "mean_ll")),
    ("data_lml", ("value", "grad")),
    ("nuts", ("positions",)),
    ("chees", ("positions",)),
    ("chees_pops", ("positions",)),
    ("ghmc", ("positions",)),
    ("ess", ("f",)),
    ("sharded_lml", ("lml",)),
    ("pt_chees", ("positions",)),
    ("pt_distributed", ("positions",)),
    ("pt_chees_distributed", ("positions",)),
    ("smc_large_n", ("particles",)),
    ("chees_large_n", ("positions",)),
    ("chees_large_n_iterative", ("positions",)),
    ("svgp", ("log_theta", "z", "q_mu", "q_sqrt", "elbo")),
    ("serve", ("mu",)),
    ("mixture", ("mu",)),
    ("laplace", ("f_hat", "lml")),
    ("thompson", ("scores", "chol")),
    ("ski", ("value", "grad")),
    ("advi", ("mu",)),
)


def steps_for(n_devices: int) -> tuple:
    """The steps :func:`dryrun_multichip` runs on ``n_devices``."""
    return tuple(s for s in STEPS if s[0] != "sharded_lml" or n_devices % 2 == 0)


def _device(device) -> torch.device:
    """``device``, or the current CUDA card; no quiet CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def _flagship():
    """The hyperpriors study: composite Matern52 + periodic kernel, 6
    thetas, Normal hyperpriors."""
    from gogp_torch.tutorial.hyperpriors import make_priors, make_study

    study = make_study()
    return study, study.gp, make_priors


def _series(n: int, seed: int, noise: float):
    """The twin's sorted uniform inputs on [0, 10] and sine outputs."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + (noise * rng.normal(size=n) if noise else 0.0)
    return x, y


def entry(device=None):
    """Forward step: log-joint (GP LML + hyperpriors) and its gradient.

    ``fn(v, x, y, mask) -> (value, gradient)``; ``example_args`` in float32
    on ``device`` (default the card).  At n = 256 every kernel gate of the
    port sends the factorization to ``torch.linalg``, as the twin's reaches
    no Pallas kernel."""
    from gogp_torch.models.params import gp_observe

    dev = _device(device)
    _, gp, make_priors = _flagship()
    n = 256
    x, y = _series(n, 0, 0.1)
    priors = make_priors(x, y)
    mask = np.ones(n)

    def fn(v, xj, yj, maskj):
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = gp_observe(gp, v, x=xj, y=yj, mask=maskj) + priors(v, maskj)
            (g,) = torch.autograd.grad(lp, v)
        return lp.detach(), g

    example_args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                         for a in (np.zeros(gp.n_theta), x, y, mask))
    return fn, example_args


# --- the explicit SPMD forms of the twin's GSPMD steps ---------------------------


def _chain_adam_step(logp, v0: Tensor, mesh: pmesh.Mesh) -> tuple[Tensor, Tensor]:
    """The chain-parallel training step (``__graft_entry__.py:92-111``): the
    C chains of ``v0`` (C, p) split over both mesh axes flattened, one
    ``mle.adam`` step each on this rank's slab (``adam_batched``), then the
    cross-chain mean of the values.  The values are gathered and averaged in
    one order, so every mesh shape gives the same mean."""
    res = mle.adam_batched(hmc.value_and_grad(logp, None), pmesh.Sharding(mesh, AXES).slab(v0), iters=1)
    return mesh.all_gather(res.x, AXES), mesh.all_gather(res.value, AXES).mean()


def _data_sharded_value_and_grad(gp, x: Tensor, y: Tensor, mask: Tensor, v: Tensor, mesh: pmesh.Mesh,
                                 block: int) -> tuple[Tensor, Tensor]:
    """``gp_observe``'s value and gradient with the rows of K split over the
    data axis (``__graft_entry__.py:113-126``): each rank builds its block
    rows from its slab of x, the distributed factorization reduces them,
    and ``psum_grads`` completes the gradient; every chain line computes the
    same (replicated over the chain axis)."""
    sh = pmesh.data_sharding(mesh)
    xs, ys, ms = sh.slab(x), sh.slab(y), sh.slab(mask)
    with mesh:
        logp = large_n.psum_grads(large_n.make_rowsharded_logp(
            gp, xs, mesh.all_gather(xs, DATA_AXIS), ys, ms, DATA_AXIS, block))
        vv = v.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp(vv)
            (g,) = torch.autograd.grad(val, vv)
    return val.detach(), g


def _svgp_step(gp, params: sparse.SVGPParams, opt: mle.AdamState, x: Tensor, y: Tensor, n_total: int,
               mesh: pmesh.Mesh, rate: float = 1e-2, jitter: float = sparse.DEFAULT_JITTER):
    """The data-parallel SVGP minibatch step (``__graft_entry__.py:328-365``,
    ``gogp_tpu/gp/sparse.py:302-305``): the batch rows split over the data
    axis; each rank's masked data sum and its gradients are psum'd and
    rescaled to ``n_total``, the KL and its gradients added once, then one
    Adam step on -ELBO.  Each leaf keeps its dtype (the twin's state is
    float32 by ``svgp_init``'s default) and is promoted to x's in the ELBO,
    as JAX promotes.  Returns (params, Adam state, ELBO)."""
    sh = pmesh.data_sharding(mesh)
    xb, yb = sh.slab(x), sh.slab(y)
    dt = xb.dtype
    leaves = [params.log_theta, *params.state]

    def data_sum(log_theta, z, q_mu, q_sqrt):
        ts, tn = sparse._split_theta(gp, log_theta)
        ts, tn, xs, ys, mask = sparse._prepare(gp, ts, tn, xb, yb, None)
        state = sparse.SVGPState(z, q_mu, q_sqrt)
        mean, var = sparse._latent_moments(gp, ts, state, xs, jitter)
        return sparse._data_term(gp, tn, xs, ys, mask, mean, var, None, None, 20), mask.sum()

    # the data term in x's dtype, each gradient cast back to its leaf's (the
    # cotangent of a promotion); the KL in the state's own dtype, as the twin
    # takes it.  The twin's kernels take a float32 Z's distances in float32
    # before promoting (a 0-d tensor does not promote in torch, so the port
    # promotes Z first): with a float32 state the two part by float32
    # rounding
    promoted = [p.detach().to(dt).requires_grad_(True) for p in leaves]
    q = [p.detach().requires_grad_(True) for p in leaves[2:]]
    with torch.enable_grad():
        local, count = data_sum(*promoted)
        g_data = torch.autograd.grad(local, promoted)
        kl = sparse.kl_whitened(*q)
        g_kl = torch.autograd.grad(kl, q)
    with mesh:
        sums = mesh.psum(torch.stack([local.detach(), count.detach()]), DATA_AXIS)
        scale = torch.as_tensor(n_total, dtype=dt, device=xb.device) / torch.clamp(sums[1], min=1.0)
        grads = [(scale * mesh.psum(g, DATA_AXIS)).to(p.dtype) for g, p in zip(g_data, leaves)]
    grads[2:] = [g - k for g, k in zip(grads[2:], g_kl)]
    new, opt = sparse._adam_ascent(leaves, grads, opt, rate)
    return sparse.SVGPParams(new[0], sparse.SVGPState(*new[1:])), opt, sums[0] * scale - kl.detach().to(dt)


def _laplace_rowsharded(gp, lik, theta_simil, theta_lik, theta_noise, x: Tensor, y: Tensor, mesh: pmesh.Mesh,
                        max_iters: int = 40, tol: float = 1e-9, block: int = distributed.DEFAULT_BLOCK):
    """The Laplace fit and LML with the data rows split over the data axis
    (``__graft_entry__.py:390-409``): ``gp.laplace``'s guarded Newton with
    each rank holding its rows of K and W.  A K-vector product gathers the
    vector and is local; B = I + W^1/2 K W^1/2 is factored by
    ``ops.distributed.cholesky_rowsharded`` and solved by its row-sharded
    solves; the objective's sums are psum'd, so the step choice is the same
    on every rank.  Returns (f_hat (n,), LML), gathered: ``laplace_fit``'s
    f_hat and ``laplace_lml``'s value, which share one Newton solve."""
    sh = pmesh.data_sharding(mesh)
    x = core._points(x)
    xl, yl = sh.slab(x), sh.slab(core._like(y, x))
    ts, tn, tl = (core._like(t, x) for t in (theta_simil, theta_noise, theta_lik))
    nl = xl.shape[0]
    row0 = mesh.axis_index(DATA_AXIS) * nl
    idx = torch.arange(nl, device=x.device)
    steps = torch.tensor(laplace._STEPS, dtype=x.dtype, device=x.device)

    def gather(v):
        return mesh.all_gather(v, DATA_AXIS)

    def objective(f, a):
        """psi = log p(y|f) - 1/2 f^T a, summed over every rank's rows."""
        return mesh.psum(lik.sum_logp(tl, f, yl) - 0.5 * (a * f).sum(-1), DATA_AXIS)

    def factor_b(K, f):
        gll, w = lik.grads(tl, f, yl)
        sw = laplace._safe_sqrt(torch.maximum(w, torch.zeros_like(w)))
        B = sw[:, None] * K * gather(sw)[None, :]
        B[idx, row0 + idx] = 1.0 + sw * sw * K[idx, row0 + idx]
        return distributed.cholesky_rowsharded(B, DATA_AXIS, block), w, sw, gll

    def newton_step(K, f):
        L, w, sw, gll = factor_b(K, f)
        b = w * f + gll
        t = sw * (K @ gather(b))
        t = distributed.solve_upper_rowsharded(L, distributed.solve_lower_rowsharded(L, t, DATA_AXIS, block),
                                               DATA_AXIS, block)
        a = b - sw * t
        return K @ gather(a), a

    with torch.no_grad(), mesh:
        K = large_n._cov_rows(gp, ts, tn, xl, x, torch.ones_like(yl), DATA_AXIS)[0]
        f = torch.zeros(nl, dtype=x.dtype, device=x.device)
        a = torch.zeros_like(f)
        psi = objective(f, a)
        delta = math.inf
        for _ in range(max_iters):
            if not delta > tol:
                break
            f_full, a_full = newton_step(K, f)
            df, da = f_full - f, a_full - a
            psis = objective(f[None, :] + steps[:, None] * df[None, :], a[None, :] + steps[:, None] * da[None, :])
            best = int(torch.argmax(psis))
            f, a = f + steps[best] * df, a + steps[best] * da
            delta = float(torch.abs(psis[best] - psi))
            psi = psis[best]
        # one more step from the mode: laplace_fit's f_hat, and laplace_lml's
        # f and a, with B's factor at that f
        f, a = newton_step(K, f)
        L = factor_b(K, f)[0]
        half_logdet = mesh.psum(torch.log(L[idx, row0 + idx]).sum(), DATA_AXIS)
        lml = objective(f, a) - half_logdet
        return gather(f), lml


def _absorb_append_as_jit(gp, post: core.Posterior, x_new: Tensor, y_new: Tensor) -> core.Posterior:
    """``gp.streaming.absorb_append`` as the JAX twin's runs under jit, where
    appending past the capacity is not checked: every write's start clamps
    to the last ``b`` slots (``jax.lax.dynamic_update_slice``), so the new
    block row overwrites the last live row of the factor, with the
    cross-covariance taken against every live row.  Within the capacity it
    is ``absorb_append``."""
    x_new = core._points(core._like(x_new, post.x))
    b, n = x_new.shape[0], post.x.shape[0]
    if int(post.mask.sum()) + b <= n:
        return absorb_append(gp, post, x_new, y_new)
    y_new = core._like(y_new, post.y).reshape(b)
    knew = gp.simil.matrix(post.theta_simil, post.x, x_new) * post.mask[:, None]
    w = linalg.trsm_lower(post.chol, knew)
    kbb = gp.simil.matrix(post.theta_simil, x_new, x_new) + torch.diag_embed(gp.noise.vector(post.theta_noise, x_new))
    row_block = w.T.clone()
    s = n - b
    row_block[:, s:] = cb.plain_cholesky(kbb - w.T @ w)
    chol, x, y, mask = post.chol.clone(), post.x.clone(), post.y.clone(), post.mask.clone()
    chol[s:] = row_block
    x[s:], y[s:], mask[s:] = x_new, y_new, 1.0
    return core.Posterior(post.theta_simil, post.theta_noise, x, y, chol, linalg.cho_solve_vec(chol, y * mask), mask)


def _thompson_step(gp, post: core.Posterior, ps: pathwise.PathState, z: Tensor, mesh: pmesh.Mesh):
    """The pathwise Thompson step (``__graft_entry__.py:411-447``): the
    candidate rows split over both mesh axes flattened, each rank scoring
    its rows on every path; the scores gathered, the first path's argmax
    taken, and the chosen point absorbed (replicated).  Returns (x_new,
    scores (q, m), the new posterior)."""
    sh = pmesh.Sharding(mesh, AXES)
    scores = mesh.all_gather(pathwise.eval_paths(gp, ps, sh.slab(z)).T.contiguous(), AXES).T
    x_new = z[torch.argmax(scores[0])]
    return x_new, scores, _absorb_append_as_jit(gp, post, x_new[None, :], torch.ones(1, dtype=z.dtype,
                                                                                      device=z.device))


class _SkiRows(torch.autograd.Function):
    """The row-sharded SKI LML core: the value by CG and SLQ over the
    row-sharded operator, and the Hutchinson backward with (alpha, Z, S)
    frozen, whose W^T products and theta gradients are psum'd over the
    forward's mesh."""

    @staticmethod
    def forward(ctx, ts, tn, gp, geom, x_local, y, probes_slq, probes_tr, cg_iters, lanczos_iters):
        mesh = pmesh.current()
        mv = _ski_rows_matvec(gp, ts, tn, geom, x_local, mesh)
        X, _ = iterative.cg_solve(mv, iterative._solve_block(y, probes_tr), cg_iters)
        alpha, S = X[:, 0], X[:, 1:]
        logdet = iterative.slq_logdet(mv, probes_slq, lanczos_iters)
        ctx.save_for_backward(ts, tn, alpha, probes_tr, S)
        ctx.gp, ctx.geom, ctx.x_local, ctx.mesh = gp, geom, x_local, mesh
        return -0.5 * (logdet + (y * alpha).sum())

    @staticmethod
    def backward(ctx, g):
        ts, tn, alpha, Z, S = ctx.saved_tensors
        gp, (g0, h, dims, idx, w), x_local, mesh = ctx.gp, ctx.geom, ctx.x_local, ctx.mesh
        p, nl = Z.shape[1], x_local.shape[0]
        mine = slice(mesh.axis_index(DATA_AXIS) * nl, (mesh.axis_index(DATA_AXIS) + 1) * nl)
        V = torch.cat([alpha[:, None], S, Z], -1)[mine]
        WtV = mesh.psum(ski.interp_t_matmul(idx, w, dims[0], V), DATA_AXIS)
        with torch.enable_grad():
            a, b = ts.detach().requires_grad_(True), tn.detach().requires_grad_(True)
            c = _grid_cov(gp, a, g0, h, dims)
            prod = ski.interp(idx, w, toeplitz_matvec_fn(c)(WtV)) + gp.noise.vector(b, x_local)[:, None] * V
            # this rank's rows of alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K)
            h_loc = ((alpha[mine] * prod[:, 0]).sum()
                     - 0.5 * ((Z[mine] * prod[:, 1:1 + p]).sum() + (S[mine] * prod[:, 1 + p:]).sum()) / p)
            ga, gb = torch.autograd.grad(h_loc, (a, b))
        half = 0.5 * g
        return (half * mesh.psum(ga, DATA_AXIS), half * mesh.psum(gb, DATA_AXIS), None, None, None,
                -g * alpha, None, None, None, None)


def _ski_rows_matvec(gp, ts, tn, geom, x_local, mesh):
    """V (n, k), replicated -> K V, replicated: this rank's rows of V
    interpolated onto the grid (W^T V, psum'd over the data axis), the grid
    operator applied on every rank, W U local, the noise diagonal added,
    and the rows gathered (as ``ops.iterative``'s row-sharded matvec
    gathers), so CG and SLQ run replicated on the gathered vectors."""
    g0, h, dims, idx, w = geom
    tmv = toeplitz_matvec_fn(_grid_cov(gp, ts, g0, h, dims))
    noise = gp.noise.vector(tn, x_local)
    nl = x_local.shape[0]
    row0 = mesh.axis_index(DATA_AXIS) * nl

    def mv(V):
        squeeze = V.dim() == 1
        V = V[:, None] if squeeze else V
        Vl = V[row0:row0 + nl]
        out = ski.interp(idx, w, tmv(mesh.psum(ski.interp_t_matmul(idx, w, dims[0], Vl), DATA_AXIS)))
        out = mesh.all_gather(out + noise[:, None] * Vl, DATA_AXIS)
        return out[:, 0] if squeeze else out

    return mv


def _ski_value_and_grad(gp, theta_simil, theta_noise, x: Tensor, y: Tensor, draws, mesh: pmesh.Mesh,
                        grid_size: int = 2048, num_probes: int = 16, cg_iters: int = 100,
                        lanczos_iters: int = 32) -> tuple[Tensor, Tensor]:
    """``gp.ski.lml_ski``'s value and its gradient in ``theta_simil`` with
    the data rows split over the data axis (``__graft_entry__.py:449-473``):
    each rank's interpolation taps stay local; the grid comes from the
    global x range (the gathered extremes); the probes are every rank's
    rows of the same draws.  1-D inputs, sorted (``lml_ski`` sorts them
    first; the twin's are)."""
    sh = pmesh.data_sharding(mesh)
    x = core._points(x)
    xl = sh.slab(x)
    y = core._like(y, x)
    n = x.shape[0]
    ts, tn = core._like(theta_simil, x), core._like(theta_noise, x)
    dims = (grid_size,)
    with mesh:
        ends = mesh.all_gather(torch.stack([xl[:, 0].min(), xl[:, 0].max()]), DATA_AXIS)
        g0, h = _axis_grid(ends, grid_size)
        g0, h = g0[None], h[None]
        idx, w = ski.cubic_interp_nd(xl, g0, h, dims)
        k1, k2 = pathwise.as_draws(draws, y).split(2)
        probes_slq = iterative.rademacher(k1, (num_probes, n), y)
        probes_tr = iterative.rademacher(k2, (n, num_probes), y)
        a = ts.detach().requires_grad_(True)
        with torch.enable_grad():
            val = -0.5 * n * core._LOG_2PI + _SkiRows.apply(a, tn, gp, (g0, h, dims, idx, w), xl, y, probes_slq,
                                                            probes_tr, cg_iters, lanczos_iters)
            (g,) = torch.autograd.grad(val, a)
    return val.detach(), g


def _advi_sharded(logp, v0: Tensor, mesh: pmesh.Mesh, eps_draws: Callable[[int], Callable] | None = None,
                  num_steps: int = 2000, num_draws: int = 8, seed: int = 15) -> Tensor:
    """The batch of full-rank ADVI fits (``__graft_entry__.py:475-499``):
    the fits of ``v0`` (b, p) split over both mesh axes flattened, each rank
    running ``infer.advi.run_advi_fullrank`` on its slab, fit by fit, with
    no collective; fit i draws from ``eps_draws(i)`` (default a generator
    seeded ``seed``, then i).  Returns the gathered mu's (b, p)."""
    local, offset = sample._slab(mesh, v0.shape[0], "fits")
    mus = []
    for i in range(offset, offset + local):
        rng = torch.Generator(device=v0.device).manual_seed(seed * 2**20 + i)
        eps = None if eps_draws is None else eps_draws(i)
        mus.append(advi.run_advi_fullrank(logp, v0[i], rng, num_steps=num_steps, num_draws=num_draws,
                                          eps_draws=eps).mu)
    return mesh.all_gather(torch.stack(mus), AXES)


# --- the dry run ------------------------------------------------------------------


def _normal(seed: int, shape, dtype, dev, scale: float) -> Tensor:
    """``scale`` times standard normals from a CPU generator seeded
    ``seed``, drawn in float64 (the same draws at either dtype)."""
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, dtype=torch.float64)).to(dev, dtype)


def dryrun_multichip(n_devices: int, device=None, dtype: torch.dtype | None = None, draws: dict | None = None,
                     after_step: Callable[[str, list], None] | None = None, mesh: pmesh.Mesh | None = None,
                     only: Collection[str] | None = None) -> list[Tensor] | None:
    """Every step of the twin's dry run on an n-device (chain, data) mesh:
    ``n_data = 2`` where ``n_devices`` is even, else 1; the mesh takes the
    world's first ``n_devices`` ranks (ValueError where the world is
    smaller), and the ranks outside it return None at once.  Every rank of
    the world calls it; a world not yet initialised is
    ``parallel.mesh.init_multihost``'s.

    Returns each step's outputs (``steps_for(n_devices)``), gathered on
    every rank of the mesh, as one list in the twin's order.
    ``device``: default the card; ``dtype``: default float32.  ``draws``:
    per step name, keyword arguments for that step's runner or SPMD form
    (the draws hooks, and "v0" / "vs" for the chain, ADVI and mixture
    starts).  ``after_step(name, outputs)`` is called after each step.
    ``mesh``: run the steps of ``n_devices``, at their shapes, on this mesh
    instead (a 1x1 mesh: one rank's reference for the 4-rank run);
    ``only``: run only the steps of these names."""
    from gogp_torch.tutorial.bayes import build_logjoint

    dev = _device(device)
    dt = dtype or torch.float32
    draws = draws or {}
    if not dist.is_initialized():
        pmesh.init_multihost(backend="gloo" if dev.type == "cpu" else None)
    n_data = 2 if n_devices % 2 == 0 else 1
    if mesh is None:
        mesh = pmesh.make_mesh(n_chain=n_devices // n_data, n_data=n_data, ranks=list(range(dist.get_world_size())))
    if not mesh.member:
        return None
    n_chain, c = n_devices // n_data, 2 * n_devices

    def T(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    def rng(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def kw(name):
        return dict(draws.get(name, {}))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    study, gp, _ = _flagship()
    p, n = gp.n_theta, 16
    x, y = _series(n, 0, 0.1)
    xj, yj, maskj = T(x), T(y), torch.ones(n, dtype=dt, device=dev)
    logp = build_logjoint(study, x, y, device=dev, dtype=dt)[0]
    ones_s, ones_n = torch.ones(gp.n_theta_simil, dtype=dt, device=dev), torch.ones(gp.n_theta_noise, dtype=dt,
                                                                                      device=dev)
    yb = (yj > 0).to(dt)
    no_theta = zeros(0)
    xs, ys = (T(a) for a in _series(16 * n_data, 2, 0.0))
    z_req = torch.linspace(0.0, 10.0, 8 * n_devices, dtype=dt, device=dev)[:, None]

    def chain_adam():
        # chain-parallel training step: C chains, one Adam step each
        return _chain_adam_step(logp, T(kw("chain_adam").get("v0", _normal(0, (c, p), dt, dev, 0.1))), mesh)

    def data_lml():
        # data-sharded LML + grad: rows of K split over the data axis
        return _data_sharded_value_and_grad(gp, xj, yj, maskj, zeros(p), mesh, 8)

    def ghmc():
        # the twin's 2 n chains, but at least the 4 that run_ghmc_sharded
        # needs: at n_devices = 1 the twin's step raises there (ROADMAP
        # Queue 3)
        return (sample.run_ghmc_sharded(logp, zeros(max(c, 4), p), rng(11), mesh, num_warmup=4, num_samples=4,
                                        **kw("ghmc")).positions,)

    def ess():
        # sharded elliptical slice sampling on a Bernoulli-logit likelihood
        chol = linalg.cholesky(core.masked_cov(gp, ones_s, ones_n, xj, maskj))
        ess_kw = kw("ess")
        return sample.run_ess_sharded(lambda fv: bernoulli_logit.sum_logp(no_theta, fv, yb), chol, zeros(c, n),
                                      ess_kw.pop("draws", rng(9)), mesh, num_warmup=4, num_samples=2, **ess_kw)[:1]

    def sharded_lml():
        # the distributed blocked Cholesky LML, over the data axis
        n_big = 16 * n_data
        rng2 = np.random.default_rng(1)
        a = rng2.normal(size=(n_big, n_big))
        K, yv = T(a @ a.T + n_big * np.eye(n_big)), T(rng2.normal(size=n_big))
        sh = pmesh.data_sharding(mesh)
        return (distributed.make_sharded_lml(mesh, DATA_AXIS, block=8)(sh.slab(K), sh.slab(yv)),)

    def svgp():
        # data-parallel SVGP minibatch step
        n_sv = 8 * n_data
        x_sv, y_sv = _series(n_sv, 4, 0.0)
        params = sparse.SVGPParams(zeros(p), sparse.svgp_init(gp, x_sv[::2], dtype=torch.float32, device=dev))
        params, _, elbo = _svgp_step(gp, params, mle.adam_init([params.log_theta, *params.state]), T(x_sv),
                                     T(y_sv), n_sv, mesh)
        return (params.log_theta, *params.state, elbo)

    def mixture():
        # the draws-sharded mixture
        vs = T(kw("mixture").get("vs", _normal(10, (2 * n_chain, p), dt, dev, 0.05)))
        sm = serving.compile_mixture_sharded(gp, vs, xj, yj, mesh)
        return serving.serve_predict_mixture_sharded(gp, sm, z_req, mesh)[:1]

    def thompson():
        # pathwise Thompson over a row-sharded candidate grid, then the append
        from gogp_torch.kernels import matern52_ref, periodic, uniform_noise

        gp_bo = core.GP(ndim=1, simil=matern52_ref.scaled() + periodic, noise=uniform_noise)
        post = core.absorb(gp_bo, torch.ones(gp_bo.n_theta_simil, dtype=dt, device=dev),
                           torch.ones(gp_bo.n_theta_noise, dtype=dt, device=dev), xj, yj)
        ps = pathwise.sample_paths(gp_bo, post, kw("thompson").get("draws", rng(12)), c, 64)
        z_cand = torch.linspace(0.0, 10.0, 8 * n_devices, dtype=dt, device=dev)[:, None]
        _, scores, post2 = _thompson_step(gp_bo, post, ps, z_cand, mesh)
        return scores, post2.chol

    def ski_step():
        # SKI LML + grad with the data rows sharded
        x_ski, y_ski = _series(32 * n_data, 5, 0.0)
        return _ski_value_and_grad(gp, ones_s, ones_n, T(x_ski), T(y_ski), kw("ski").get("draws", rng(13)), mesh,
                                   grid_size=16, num_probes=2, cg_iters=8, lanczos_iters=4)

    def advi_step():
        # full-rank ADVI fits sharded over the mesh
        advi_kw = kw("advi")
        v0 = T(advi_kw.pop("v0", _normal(14, (c, p), dt, dev, 0.05)))
        return (_advi_sharded(logp, v0, mesh, num_steps=3, num_draws=2, **advi_kw),)

    steps = {
        "chain_adam": chain_adam,
        "data_lml": data_lml,
        "nuts": lambda: (sample.run_nuts_sharded(logp, zeros(c, p), rng(1), mesh, num_warmup=4, num_samples=2,
                                                 max_tree_depth=3, **kw("nuts")).positions,),
        "chees": lambda: (sample.run_chees_sharded(logp, zeros(c, p), rng(4), mesh, num_warmup=4, num_samples=2,
                                                   max_num_steps=4, **kw("chees")).positions,),
        "chees_pops": lambda: (sample.run_chees_pops_sharded(
            logp, zeros(c, p), rng(6), mesh, n_pops=n_devices, num_warmup=4, num_samples=2, max_num_steps=4,
            **kw("chees_pops")).positions,),
        "ghmc": ghmc,
        "ess": ess,
        "sharded_lml": sharded_lml,
        "pt_chees": lambda: (sample.run_pt_chees_sharded(
            logp, zeros(c, p), rng(5), mesh, n_replicas=3, num_warmup=4, num_samples=2, max_num_steps=4,
            **kw("pt_chees")).positions,),
        "pt_distributed": lambda: (sample.run_pt_distributed(
            logp, zeros(p), rng(2), mesh, n_replicas=c, num_warmup=4, num_samples=2, max_tree_depth=3,
            **kw("pt_distributed")).positions,),
        "pt_chees_distributed": lambda: (sample.run_pt_chees_distributed(
            logp, zeros(4, p), rng(6), mesh, n_ladders=4, n_replicas=c, num_warmup=4, num_samples=2,
            max_num_steps=4, **kw("pt_chees_distributed")).positions,),
        # particle x data SMC, and large-N ChEES exact and matrix-free
        "smc_large_n": lambda: (large_n.run_smc_large_n(
            gp, xs, ys, rng(3), mesh, num_particles=4 * n_chain, num_mcmc_steps=1, block=8, max_stages=2,
            mutation="hmc", **kw("smc_large_n")).particles,),
        "chees_large_n": lambda: (large_n.run_chees_large_n(
            gp, xs, ys, rng(7), mesh, num_chains=2 * n_chain, num_warmup=4, num_samples=2, block=8,
            max_num_steps=4, **kw("chees_large_n")).positions,),
        "chees_large_n_iterative": lambda: (large_n.run_chees_large_n(
            gp, xs, ys, rng(8), mesh, num_chains=2 * n_chain, num_warmup=2, num_samples=2, block=8,
            max_num_steps=4, method="iterative", num_probes=4, cg_iters=20, lanczos_iters=8, precond_rank=4,
            **kw("chees_large_n_iterative")).positions,),
        "svgp": svgp,
        # request-sharded serving
        "serve": lambda: serving.serve_predict_sharded(gp, serve.fit_serving(gp, ones_s, ones_n, xj, yj), z_req,
                                                       mesh)[:1],
        "mixture": mixture,
        # Laplace classification with the data rows sharded
        "laplace": lambda: _laplace_rowsharded(gp, bernoulli_logit, ones_s, no_theta, ones_n, xj, yb, mesh,
                                               max_iters=5, block=8),
        "thompson": thompson,
        "ski": ski_step,
        "advi": advi_step,
    }
    outputs: list[Tensor] = []
    for name, _ in steps_for(n_devices):
        if only is not None and name not in only:
            continue
        outs = list(steps[name]())
        outputs.extend(outs)
        if after_step is not None:
            after_step(name, outs)
    return outputs


def main() -> None:
    """``__graft_entry__.py``'s ``__main__``: the forward step on the card,
    then the dry run over the world found (``torchrun``'s ``env://``, else
    a world of one); under torchrun each rank takes the card of its
    ``LOCAL_RANK``."""
    import os

    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    world = pmesh.init_multihost()
    dryrun_multichip(world)
    torch.cuda.synchronize()
    print("dryrun_multichip ok on", world, "devices")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
