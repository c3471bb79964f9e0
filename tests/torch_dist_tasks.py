"""Tasks that the gloo ranks of ``torch_dist_pool.RankPool`` run: every rank
calls the same function with the same numpy inputs, takes its slab, runs the
port's multi-device code under a mesh, and returns numpy results (its own
rows, or the gathered global result).  The port is imported alone; a task
that replays JAX's draws first puts JAX on the CPU in float64
(:func:`jax_cpu`) and takes the draws helpers of the port's test files.

Meshes are cached per shape and rank list: every rank makes each mesh once,
in the order the tasks ask for them.  A task on a mesh of fewer ranks than
the world returns None on the ranks outside it.
"""

from __future__ import annotations

import numpy as np
import torch

from gogp_torch.ops import distributed
from gogp_torch.parallel import mesh as pmesh

_MESHES: dict = {}


def mesh(n_chain: int, n_data: int, ranks=None) -> pmesh.Mesh:
    key = (n_chain, n_data, None if ranks is None else tuple(ranks))
    if key not in _MESHES:
        _MESHES[key] = pmesh.make_mesh(n_chain, n_data, ranks)
    return _MESHES[key]


def mesh_for(shape) -> pmesh.Mesh:
    """``shape``: (n_chain, n_data) over the first n_chain * n_data ranks."""
    n_chain, n_data = shape
    return mesh(n_chain, n_data, list(range(n_chain * n_data)))


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def N(t):
    if isinstance(t, torch.Generator):
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return {k: N(v) for k, v in zip(t._fields, t)}
    if isinstance(t, (tuple, list)):
        return type(t)(N(v) for v in t)
    return t


def rows(a, m: pmesh.Mesh, axis=pmesh.DATA_AXIS):
    return pmesh.Sharding(m, pmesh._axes(axis)).slab(T(a))


# --- mesh ------------------------------------------------------------------


def mesh_layout(shape):
    m = mesh_for(shape)
    if not m.member:
        return None
    with m:
        flat = pmesh.axis_index((pmesh.CHAIN_AXIS, pmesh.DATA_AXIS))
        me = torch.tensor([float(flat)], dtype=torch.float64)
        return dict(
            coords=(m.axis_index(pmesh.CHAIN_AXIS), m.axis_index(pmesh.DATA_AXIS)),
            sizes=(m.axis_size(pmesh.CHAIN_AXIS), m.axis_size(pmesh.DATA_AXIS), m.size),
            psum_chain=float(pmesh.psum(me, pmesh.CHAIN_AXIS)),
            psum_data=float(pmesh.psum(me, pmesh.DATA_AXIS)),
            psum_all=float(pmesh.psum(me, (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS))),
            pmean_all=float(pmesh.pmean(me, (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS))),
            gather_all=N(pmesh.all_gather(me, (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS))),
            gather_rev=N(pmesh.all_gather(me, (pmesh.DATA_AXIS, pmesh.CHAIN_AXIS))),
            gather_chain=N(pmesh.all_gather(me, pmesh.CHAIN_AXIS)),
            bcast=float(m.broadcast(me, (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS), 1 if m.size > 1 else 0)),
            describe=pmesh.describe(m),
        )


def mesh_errors():
    out = []
    try:
        pmesh.make_mesh(8, 1)
    except ValueError as e:
        out.append(str(e))
    try:
        pmesh.psum(torch.ones(()), pmesh.DATA_AXIS)
    except RuntimeError as e:
        out.append(str(e))
    return out


def sharding_roundtrip(shape, x, axis):
    m = mesh_for(shape)
    if not m.member:
        return None
    axes = tuple(axis)
    slab = pmesh.shard_leading(m, (T(x),), axes)[0]
    return N(slab), N(pmesh.gather_leading(m, slab, axes))


# --- ops.distributed ----------------------------------------------------------


def cholesky(K, n_data, block):
    m = mesh_for((1, n_data))
    if not m.member:
        return None
    with m:
        return N(distributed.cholesky_rowsharded(rows(K, m), pmesh.DATA_AXIS, block))


def cholesky_error(K, n_data, block):
    m = mesh_for((1, n_data))
    with m:
        try:
            distributed.cholesky_rowsharded(rows(K, m), pmesh.DATA_AXIS, block)
        except ValueError as e:
            return str(e)


def solves(L, B, n_data, block):
    m = mesh_for((1, n_data))
    if not m.member:
        return None
    with m:
        L_loc = rows(L, m)
        return (N(distributed.solve_lower_rowsharded(L_loc, rows(B, m), pmesh.DATA_AXIS, block)),
                N(distributed.solve_upper_rowsharded(L_loc, rows(B, m), pmesh.DATA_AXIS, block)))


def lml_value_and_grad(K, y, n_data, block, cot=1.0):
    m = mesh_for((1, n_data))
    if not m.member:
        return None
    K_loc = rows(K, m).requires_grad_(True)
    y_loc = rows(y, m).requires_grad_(True)
    f = distributed.make_sharded_lml(m, pmesh.DATA_AXIS, block)
    val = f(K_loc, y_loc)
    Kbar, ybar = torch.autograd.grad(val * cot, (K_loc, y_loc))
    return float(val.detach()), N(Kbar), N(ybar)


def diag_step_counts(K, n_data, block):
    """The diagonal step's factor calls: K2's wrapper on the card, its plain
    version elsewhere; counted by wrapping both."""
    from gogp_torch.ops import cholesky_blocked as cb

    m = mesh_for((1, n_data))
    if not m.member:
        return None
    calls = {"kernel": 0, "plain": 0}
    real_k, real_p = cb.cholesky_inv_tile, cb.cholesky_inv_tile_plain

    def k(A):
        calls["kernel"] += 1
        return real_k(A)

    def p(A):
        calls["plain"] += 1
        return real_p(A)

    cb.cholesky_inv_tile, cb.cholesky_inv_tile_plain = k, p
    try:
        with m:
            distributed.cholesky_rowsharded(rows(K, m), pmesh.DATA_AXIS, block)
    finally:
        cb.cholesky_inv_tile, cb.cholesky_inv_tile_plain = real_k, real_p
    return calls


# --- samplers -------------------------------------------------------------------


def jax_cpu():
    """JAX on the CPU in float64, for the draws helpers of the tests."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def K(key):
    """A JAX key from its numpy form."""
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(key, dtype=np.uint32))


def _sampler_setup(shape):
    m = mesh_for(shape)
    if not m.member:
        return None, None
    jax_cpu()
    from test_torch_hmc import t_mvn

    return m, t_mvn


def run_sampler(shape, runner, x0, key, kw, jax_draws=True, seed=0):
    """``parallel.sample.<runner>`` on the correlated Gaussian of
    ``test_torch_hmc`` on a mesh of ``shape``; with ``jax_draws`` the
    draws hooks replay the JAX twin's key stream for ``key``, else the
    port's generator seeded ``seed`` on every rank."""
    from gogp_torch.parallel import sample

    m, logp = _sampler_setup(shape)
    if m is None:
        return None
    import jax

    rng = torch.Generator().manual_seed(seed)
    key = K(key)
    kw = dict(kw)
    x0 = T(x0)
    if runner == "run_chees_sharded" and jax_draws:
        from test_torch_infer import JaxDraws

        kw["draws"] = JaxDraws(key)
    elif runner == "run_ghmc_sharded" and jax_draws:
        from test_torch_infer import JaxDraws

        from gogp_tpu.infer import ghmc as jghmc
        from test_torch_hmc import j_mvn

        js = jghmc.ghmc_init(j_mvn, x0.numpy(), key, kw.get("init_step_size", 0.1))
        kw.update(draws=JaxDraws(js.rng), momenta=T(js.momenta))
    elif runner == "run_chees_pops_sharded" and jax_draws:
        from test_torch_chees_groups import JaxGroupDraws

        kw["draws"] = lambda pops: JaxGroupDraws(jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jax.numpy.arange(pops.start, pops.stop)))
    elif runner == "run_pt_chees_sharded" and jax_draws:
        from test_torch_chees_groups import JaxGroupDraws
        from test_torch_tempering import JaxSwapDraws

        k, k_init = jax.random.split(key)
        K_rungs = kw.get("n_replicas", 8)
        kw.update(draws=JaxGroupDraws(jax.random.split(k_init, K_rungs)),
                  swap_draws=JaxSwapDraws(k, ladders=x0.shape[0]))
    elif runner == "run_pt_chees_distributed" and jax_draws:
        from test_torch_chees_groups import JaxGroupDraws
        from test_torch_tempering import JaxSwapDraws

        k, k_init = jax.random.split(key)
        kw.update(draws=JaxGroupDraws(jax.random.split(k_init, kw.get("n_replicas", 8))),
                  swap_draws=JaxSwapDraws(k, ladders=kw.get("n_ladders", 16)))
    elif runner == "run_pt_distributed" and jax_draws:
        from test_torch_nuts import JaxNUTSDraws
        from test_torch_tempering import JaxSwapDraws

        k, k_init = jax.random.split(key)
        kw.update(draws=JaxNUTSDraws(jax.random.split(k_init, kw.get("n_replicas", 8))), swap_draws=JaxSwapDraws(k))
    elif runner == "run_pt_sharded" and jax_draws:
        from test_torch_nuts import JaxNUTSDraws
        from test_torch_tempering import JaxSwapDraws, _jax_pt_keys

        chain_keys = jax.random.split(key, x0.shape[0])

        def per_chain(c):
            k, replica_keys = _jax_pt_keys(chain_keys[c], kw.get("n_replicas", 4))
            return JaxNUTSDraws(replica_keys), JaxSwapDraws(k)

        kw["draws"] = per_chain
    elif runner in ("run_nuts_sharded", "run_hmc_sharded") and jax_draws:
        keys = jax.random.split(key, x0.shape[0])
        if runner == "run_nuts_sharded":
            from test_torch_nuts import JaxNUTSDraws

            kw["draws"] = JaxNUTSDraws(keys)
        else:
            from test_torch_hmc import JaxHMCDraws

            kw["draws"] = JaxHMCDraws(keys)
    return N(getattr(sample, runner)(logp, x0, rng, m, **kw))


def run_smc(shape, x0, key, kw, jax_draws=True, seed=0):
    from gogp_torch.parallel import smc_sharded

    m, logp = _sampler_setup(shape)
    if m is None:
        return None
    kw = dict(kw)
    if jax_draws:
        from test_torch_advi_smc import JaxSMCDraws

        kw["draws"] = JaxSMCDraws(K(key), kw["num_particles"], len(x0)).hook()
    if kw.get("free") is not None:
        kw["free"] = T(kw["free"])
    return N(smc_sharded.run_smc_sharded(logp, T(x0), torch.Generator().manual_seed(seed), m, **kw))


def run_ess(shape, chol, y, n_chains, key, warm, samp, jax_draws=True, seed=0):
    """``run_ess_sharded`` of ``n_chains`` chains on a Bernoulli-logit
    likelihood with the prior factor ``chol``."""
    from gogp_torch.gp import likelihoods
    from gogp_torch.parallel import sample

    m = mesh_for(shape)
    if not m.member:
        return None
    jax_cpu()
    from test_torch_elliptical import JaxESSDraws, chain_keys

    y = T(y)
    draws = (JaxESSDraws.for_chains(chain_keys(K(key), n_chains), warm + samp) if jax_draws
             else torch.Generator().manual_seed(seed))

    def loglik(f):
        return likelihoods.bernoulli_logit.sum_logp(torch.zeros(0, dtype=torch.float64), f, y)

    f0 = torch.zeros((n_chains, y.shape[0]), dtype=torch.float64)
    return N(sample.run_ess_sharded(loglik, T(chol), f0, draws, m, warm, samp))


# --- large n --------------------------------------------------------------------


def _rbf_gp():
    from gogp_torch.gp.core import GP
    from gogp_torch.kernels import rbf, uniform_noise

    return GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)


def rowsharded_value_and_grad(shape, x, y, mask, v, block, method="exact", key=None, kw=None):
    """``make_rowsharded_logp`` -> ``make_rowsharded_value_and_grad`` at
    ``v``, and the same gradient through ``psum_grads``."""
    from gogp_torch.parallel import large_n

    m = mesh_for(shape)
    if not m.member:
        return None
    draws = None
    if key is not None:
        jax_cpu()
        from test_torch_pathwise import JaxPathDraws

        draws = JaxPathDraws(K(key))
    with m:
        xs, ys, ms = (pmesh.data_sharding(m).slab(T(a)) for a in (x, y, mask))
        xs = xs[:, None] if xs.dim() == 1 else xs
        logp = large_n.make_rowsharded_logp(_rbf_gp(), xs, pmesh.all_gather(xs, pmesh.DATA_AXIS), ys, ms,
                                            pmesh.DATA_AXIS, block, method=method, draws=draws, **(kw or {}))
        val, g = large_n.make_rowsharded_value_and_grad(logp)(T(v))
        vv = T(v).requires_grad_(True)
        (g2,) = torch.autograd.grad(large_n.psum_grads(logp)(vv), vv)
        batch = large_n.psum_grads(logp)(torch.stack([T(v), T(v) + 0.1]))
    return float(val), N(g), N(g2), N(batch)


def chees_large_n(shape, x, y, key, method, kw, jax_draws=True, seed=0):
    from gogp_torch.parallel import large_n

    m = mesh_for(shape)
    if not m.member:
        return None
    kw = dict(kw)
    if jax_draws:
        jax = jax_cpu()
        from test_torch_infer import JaxDraws
        from test_torch_pathwise import JaxPathDraws

        key = K(key)
        key_init, key_loop = jax.random.split(key)
        dim = 3
        kw.update(draws=JaxDraws(key_loop),
                  init_eps=T(jax.random.normal(key_init, (kw["num_chains"], dim), jax.numpy.float64)))
        if method in ("iterative", "ski"):
            kw["probes"] = JaxPathDraws(jax.random.fold_in(key, 2))
    res = large_n.run_chees_large_n(_rbf_gp(), T(x), T(y), torch.Generator().manual_seed(seed), m, method=method,
                                    **kw)
    return N(res)


def smc_large_n(shape, x, y, key, kw, jax_draws=True, seed=0):
    from gogp_torch.parallel import large_n

    m = mesh_for(shape)
    if not m.member:
        return None
    kw = dict(kw)
    if jax_draws:
        jax_cpu()
        from test_torch_advi_smc import JaxSMCDraws

        kw["draws"] = JaxSMCDraws(K(key), kw["num_particles"], 3).hook()
    return N(large_n.run_smc_large_n(_rbf_gp(), T(x), T(y), torch.Generator().manual_seed(seed), m, **kw))


# --- serving ----------------------------------------------------------------------


def serving_from_jax(shape, sm, z):
    """The mixture prediction from this rank's slab of the JAX twin's
    compiled mixture (``convert.serving_mixture_slab_from_numpy``)."""
    from gogp_torch import convert
    from gogp_torch.parallel import serving as pserving

    m = mesh_for(shape)
    if not m.member:
        return None
    local = convert.serving_mixture_slab_from_numpy(sm, m.axis_index(pmesh.CHAIN_AXIS),
                                                    m.axis_size(pmesh.CHAIN_AXIS), "cpu")
    return N(pserving.serve_predict_mixture_sharded(_rbf_gp(), local, T(z), m))


def serving(shape, x, y, vs, theta, z):
    """Both sharded predictions: the mixture of the draws ``vs`` compiled
    rank by rank and sliced from a whole compiled mixture, and the
    request-sharded batch of one posterior."""
    from gogp_torch.gp import serve
    from gogp_torch.parallel import serving as pserving

    m = mesh_for(shape)
    if not m.member:
        return None
    gp = _rbf_gp()
    x, y, z = T(x), T(y), T(z)
    local = pserving.compile_mixture_sharded(gp, T(vs), x, y, m)
    whole = pserving.shard_mixture(serve.compile_mixture(gp, T(vs), x, y), m)
    sp = serve.fit_serving(gp, T(theta[:2]), T(theta[2:]), x, y)
    return (N(pserving.serve_predict_mixture_sharded(gp, local, z, m)),
            N(pserving.serve_predict_mixture_sharded(gp, whole, z, m)),
            N(pserving.serve_predict_sharded(gp, sp, z, m)), local.n_draws)



# --- the graft entry (gogp_torch.graft_entry) --------------------------------------


def _graft(shape):
    """(mesh, graft_entry, study, gp, x, y): the dry run's flagship problem
    at n = 16 on a mesh of ``shape``; (None, ...) off the mesh."""
    from gogp_torch import graft_entry as ge

    m = mesh_for(shape)
    study, gp, _ = ge._flagship()
    x, y = ge._series(16, 0, 0.1)
    return (m if m.member else None), ge, study, gp, x, y


def _graft_logp(study, x, y):
    from gogp_torch.tutorial.bayes import build_logjoint

    return build_logjoint(study, x, y, "cpu", torch.float64)[0]


def graft_chain_adam(shape, v0):
    m, ge, study, gp, x, y = _graft(shape)
    if m is None:
        return None
    return N(ge._chain_adam_step(_graft_logp(study, x, y), T(v0), m))


def graft_data_lml(shape):
    m, ge, study, gp, x, y = _graft(shape)
    if m is None:
        return None
    return N(ge._data_sharded_value_and_grad(gp, T(x), T(y), torch.ones(16, dtype=torch.float64),
                                             torch.zeros(gp.n_theta, dtype=torch.float64), m, 8))


def graft_svgp(shape, n_sv, state_dtype):
    """The SVGP step from the twin's start: theta 1, Z = x[::2], the state
    in ``state_dtype`` (the twin's dry run: float32)."""
    from gogp_torch.gp import sparse
    from gogp_torch.infer import mle

    m, ge, study, gp, _, _ = _graft(shape)
    if m is None:
        return None
    x, y = ge._series(n_sv, 4, 0.0)
    params = sparse.SVGPParams(torch.zeros(gp.n_theta, dtype=torch.float64),
                               sparse.svgp_init(gp, x[::2], dtype=getattr(torch, state_dtype)))
    params, _, elbo = ge._svgp_step(gp, params, mle.adam_init([params.log_theta, *params.state]), T(x), T(y), n_sv,
                                    m)
    return N([params.log_theta, *params.state, elbo])


def graft_laplace(shape, max_iters):
    """The row-sharded Laplace fit and LML, and the port's replicated
    laplace_fit and laplace_lml on the same problem."""
    from gogp_torch.gp import laplace
    from gogp_torch.gp.likelihoods import bernoulli_logit

    m, ge, study, gp, x, y = _graft(shape)
    if m is None:
        return None
    xs, yb = T(x), T((y > 0).astype(np.float64))
    ts, tl, tn = torch.ones(gp.n_theta_simil, dtype=torch.float64), torch.zeros(0, dtype=torch.float64), \
        torch.ones(gp.n_theta_noise, dtype=torch.float64)
    got = ge._laplace_rowsharded(gp, bernoulli_logit, ts, tl, tn, xs, yb, m, max_iters=max_iters, block=8)
    post = laplace.laplace_fit(gp, bernoulli_logit, ts, tl, xs, yb, theta_noise=tn, max_iters=max_iters)
    lml = laplace.laplace_lml(gp, bernoulli_logit, ts, tl, xs, yb, theta_noise=tn, max_iters=max_iters)
    return N(got), N((post.f_hat, lml))


def _graft_bo(n_devices):
    from gogp_torch.gp import core
    from gogp_torch.kernels import matern52_ref, periodic, uniform_noise

    from gogp_torch import graft_entry as ge

    x, y = ge._series(16, 0, 0.1)
    gp_bo = core.GP(ndim=1, simil=matern52_ref.scaled() + periodic, noise=uniform_noise)
    post = core.absorb(gp_bo, torch.ones(gp_bo.n_theta_simil, dtype=torch.float64),
                       torch.ones(gp_bo.n_theta_noise, dtype=torch.float64), T(x), T(y))
    z = torch.linspace(0.0, 10.0, 8 * n_devices, dtype=torch.float64)[:, None]
    return ge, gp_bo, post, z


def graft_thompson(shape, key):
    """The Thompson step on 2 n paths of 64 features drawn with the twin's
    key tree (``JaxPathDraws``)."""
    from gogp_torch.gp import pathwise

    m = mesh_for(shape)
    if not m.member:
        return None
    jax_cpu()
    from test_torch_pathwise import JaxPathDraws

    n_devices = shape[0] * shape[1]
    ge, gp_bo, post, z = _graft_bo(n_devices)
    ps = pathwise.sample_paths(gp_bo, post, JaxPathDraws(K(key)), 2 * n_devices, 64)
    x_new, scores, post2 = ge._thompson_step(gp_bo, post, ps, z, m)
    return N((x_new, scores, post2.chol, post2.alpha, post2.x))


def graft_ski(shape, key, n_ski):
    m, ge, study, gp, _, _ = _graft(shape)
    if m is None:
        return None
    jax_cpu()
    from test_torch_pathwise import JaxPathDraws

    x, y = ge._series(n_ski, 5, 0.0)
    ones = torch.ones(gp.n_theta_simil, dtype=torch.float64), torch.ones(gp.n_theta_noise, dtype=torch.float64)
    return N(ge._ski_value_and_grad(gp, *ones, T(x), T(y), JaxPathDraws(K(key)), m, grid_size=16, num_probes=2,
                                    cg_iters=8, lanczos_iters=4))


def graft_advi(shape, v0, eps):
    """The ADVI fits of ``v0`` with each fit's steps' eps ``eps[i]``."""
    m, ge, study, gp, x, y = _graft(shape)
    if m is None:
        return None
    return N(ge._advi_sharded(_graft_logp(study, x, y), T(v0), m, eps_draws=lambda i: (lambda step: T(eps[i][step])),
                              num_steps=3, num_draws=2))


def graft_dryrun(n_devices, reference=()):
    """The whole dry run on the world's first ``n_devices`` ranks, float64 on
    the CPU: (the steps' names in order, the outputs, and on rank 0 the
    steps named in ``reference`` run alone on a 1x1 mesh of rank 0)."""
    from gogp_torch import graft_entry as ge

    one = mesh(1, 1, [0])
    names = []
    out = ge.dryrun_multichip(n_devices, device="cpu", dtype=torch.float64,
                              after_step=lambda name, outs: names.append((name, len(outs))))
    if out is None:
        return None
    ref = None
    if reference and one.member:
        ref = N(ge.dryrun_multichip(n_devices, device="cpu", dtype=torch.float64, mesh=one, only=reference))
    return names, N(out), ref


def graft_dryrun_error(n_devices):
    from gogp_torch import graft_entry as ge

    try:
        ge.dryrun_multichip(n_devices, device="cpu", dtype=torch.float64)
    except ValueError as e:
        return str(e)


def graft_dryrun_twin_draws(n_devices):
    """The dry run in float64 with the twin's draws for its deterministic
    steps: the chain and ADVI starts, the mixture's draws, the paths' and
    SKI's keys, each ADVI fit's eps."""
    from gogp_torch import graft_entry as ge

    jax = jax_cpu()
    from test_torch_advi_smc import jax_eps
    from test_torch_pathwise import JaxPathDraws

    n_data = 2 if n_devices % 2 == 0 else 1
    c, normal = 2 * n_devices, jax.random.normal
    keys = jax.random.split(jax.random.PRNGKey(15), c)
    eps = [jax_eps(k, 3, 2, 6) for k in keys]
    draws = {"chain_adam": {"v0": np.asarray(0.1 * normal(jax.random.PRNGKey(0), (c, 6)))},
             "mixture": {"vs": np.asarray(0.05 * normal(jax.random.PRNGKey(10), (2 * (n_devices // n_data), 6)))},
             "thompson": {"draws": JaxPathDraws(jax.random.PRNGKey(12))},
             "ski": {"draws": JaxPathDraws(jax.random.PRNGKey(13))},
             "advi": {"v0": np.asarray(0.05 * normal(jax.random.PRNGKey(14), (c, 6))),
                      "eps_draws": lambda i: (lambda step: T(eps[i][step]))}}
    out = ge.dryrun_multichip(n_devices, device="cpu", dtype=torch.float64, draws=draws)
    return None if out is None else N(out)
