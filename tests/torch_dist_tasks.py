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

