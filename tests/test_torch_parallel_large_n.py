"""The port's row-sharded large-N GP (gogp_torch.parallel.large_n and the
row-sharded form of ops.iterative) against the JAX package's, in float64 on
the CPU, on tests/test_large_n.py's n = 64 problem.

Four gloo ranks (one pool for the file, ``torch_dist_pool``) run the port;
the JAX twin runs in shard_map on the test process's virtual CPU devices.
Tolerances: the exact log-density 1e-9 (value) and 1e-8 (the
psum-completed gradient); the iterative one 1e-7 (value) and 1e-6
(gradient), the port's dense iterative tests' bounds, since CG's iterates
amplify the two packages' summation orders; the samplers chain for chain
on JAX's draws, 1e-6 (ChEES over the distributed factorization, whose
reductions run in other orders) and 1e-5 relative, 1e-4 absolute over the
CG/SLQ and SKI surrogates: CG stops at a relative residual of 1e-6, so a
surrogate's value agrees between the packages to a few 1e-5 where one
stops an iteration before the other, and the leapfrog carries that into
the positions; 1e-8 for SMC's particles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist_pool import RankPool

from gogp_tpu.gp.core import GP, lml_iterative
from gogp_tpu.kernels import rbf, uniform_noise
from gogp_tpu.models.params import gp_observe
from gogp_tpu.parallel import DATA_AXIS
from gogp_tpu.parallel import large_n as jlarge
from gogp_tpu.parallel import make_mesh as jmake_mesh
from gogp_torch.parallel import large_n

EXACT = dict(rtol=1e-9, atol=1e-9)
GRAD = dict(rtol=1e-8, atol=1e-8)
ITER = dict(rtol=1e-7, atol=1e-7)
ITER_GRAD = dict(rtol=1e-6, atol=1e-6)
CHAIN = dict(rtol=1e-6, atol=1e-8)
SURROGATE = dict(rtol=1e-5, atol=1e-4)

JGP = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def problem():
    n = 64
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def jax_rowsharded(x, y, mask, v, method="exact", key=None, kw=None):
    """The twin's make_rowsharded_logp -> value_and_grad over a 1x4 mesh."""
    mesh = jmake_mesh(n_chain=1, n_data=4, devices=jax.devices()[:4])

    def device_fn(x_local, y_local, m_local):
        logp = jlarge.make_rowsharded_logp(JGP, x_local, jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
                                           y_local, m_local, DATA_AXIS, 8, method=method, key=key, **(kw or {}))
        return jlarge.make_rowsharded_value_and_grad(logp, DATA_AXIS)(jnp.asarray(v))

    f = jax.jit(jax.shard_map(device_fn, mesh=mesh, in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
                              out_specs=(P(), P()), check_vma=False))
    val, g = f(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    return float(val), np.asarray(g)


@pytest.mark.parametrize("padded", [False, True])
def test_exact_logp_matches_jax_and_dense(pool, problem, padded):
    """Value and psum-completed gradient on a 1x4 mesh against the twin's
    and against the dense ``gp_observe``; with the last 16 points masked,
    the padding correction of the constant term.  ``psum_grads`` gives the
    same gradient, and a (2, dim) batch row by row; one rank gives the
    same as four."""
    x, y = problem
    mask = np.r_[np.ones(48), np.zeros(16)] if padded else np.ones(64)
    v = np.array([0.3, -0.5, -1.0])
    jval, jgrad = jax_rowsharded(x, y, mask, v)
    dval, dgrad = jax.value_and_grad(lambda v: gp_observe(JGP, v, x=jnp.asarray(x), y=jnp.asarray(y),
                                                          mask=jnp.asarray(mask)))(jnp.asarray(v))
    four = pool.run("rowsharded_value_and_grad", (1, 4), x[:, 0], y, mask, v, 8)
    one = pool.run("rowsharded_value_and_grad", (1, 1), x[:, 0], y, mask, v, 8)[0]
    for val, g, g2, batch in (four[0], one):
        np.testing.assert_allclose(val, jval, **EXACT)
        np.testing.assert_allclose(val, float(dval), **EXACT)
        np.testing.assert_allclose(g, jgrad, **GRAD)
        np.testing.assert_allclose(g, np.asarray(dgrad), **GRAD)
        np.testing.assert_allclose(g2, g, **GRAD)
        np.testing.assert_allclose(batch[0], val, **EXACT)
    assert all(o[0] == four[0][0] for o in four)


@pytest.mark.parametrize("precond_rank,cg_iters,lanczos", [(0, 300, 32), (16, 200, 24)])
def test_iterative_logp_matches_jax(pool, problem, precond_rank, cg_iters, lanczos):
    """method="iterative" with the twin's probes (its key through the
    port's draws hook), with and without the pivoted preconditioner built
    from gathered column slices: the row-sharded twin's value and
    gradient, and the dense iterative LML's value."""
    x, y = problem
    mask = np.ones(64)
    v = np.array([0.2, -0.1, -1.0])
    key = jax.random.PRNGKey(11)
    kw = dict(num_probes=16, cg_iters=cg_iters, lanczos_iters=lanczos, precond_rank=precond_rank)
    jval, jgrad = jax_rowsharded(x, y, mask, v, "iterative", key, kw)
    th = np.exp(v)
    dense = float(lml_iterative(JGP, jnp.asarray(th[:2]), jnp.asarray(th[2:]), jnp.asarray(x), jnp.asarray(y), key,
                                **kw))
    four = pool.run("rowsharded_value_and_grad", (1, 4), x[:, 0], y, mask, v, 8, "iterative", np.asarray(key), kw)
    one = pool.run("rowsharded_value_and_grad", (1, 1), x[:, 0], y, mask, v, 8, "iterative", np.asarray(key), kw)[0]
    for val, g, g2, _ in (four[0], one):
        np.testing.assert_allclose(val, jval, **ITER)
        np.testing.assert_allclose(val, dense, **ITER)
        np.testing.assert_allclose(g, jgrad, **ITER_GRAD)
        np.testing.assert_allclose(g2, g, **ITER_GRAD)


@pytest.mark.parametrize("method", ["exact", "iterative", "ski"])
def test_run_chees_large_n_matches_jax(pool, problem, method):
    """ChEES over the row-sharded log-density on a (2, 2) mesh (chains over
    the chain axis, rows over the data axis; for "ski" the chains over both
    and x, y whole), 4 chains, 6 + 3 transitions on JAX's draws: the
    twin's chains; one rank the same.  Block 32: two blocks a rank, each
    gloo collective costing about half a millisecond here."""
    x, y = problem
    key = jax.random.PRNGKey(0)
    kw = dict(num_chains=4, num_warmup=6, num_samples=3, sigma0=0.5, init_step_size=0.05, init_traj_length=0.5,
              max_num_steps=8)
    extra = dict(iterative=dict(num_probes=8, cg_iters=200, lanczos_iters=24),
                 ski=dict(grid_size=128, num_probes=8, cg_iters=200, lanczos_iters=24), exact={})[method]
    jkw = dict(kw, **extra)
    if method != "ski":
        jkw["block"] = 32
    mesh = jmake_mesh(n_chain=2, n_data=2, devices=jax.devices()[:4])
    want = jlarge.run_chees_large_n(JGP, jnp.asarray(x), jnp.asarray(y), key, mesh, method=method, **jkw)
    four = pool.run("chees_large_n", (2, 2), x, y, np.asarray(key), method, jkw)[0]
    one = pool.run("chees_large_n", (1, 1), x, y, np.asarray(key), method, jkw)[0]
    tol = CHAIN if method == "exact" else SURROGATE
    for got in (four, one):
        for name in ("positions", "logps", "accept_probs"):
            np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)), err_msg=name, **tol)
        for name in ("step_size", "log_traj", "inv_mass"):
            np.testing.assert_allclose(got["state"][name], np.asarray(getattr(want.state, name)), err_msg=name,
                                       **tol)
    assert four["positions"].shape == (3, 4, 3)


def test_run_chees_large_n_ski_rejects_mask(problem):
    x, y = problem
    with pytest.raises(ValueError, match="padding mask"):
        large_n.run_chees_large_n(None, torch.tensor(x), torch.tensor(y), torch.Generator(), None, method="ski",
                                  mask=torch.ones(64, dtype=torch.float64))


def test_run_smc_large_n_matches_jax(pool, problem):
    """SMC with HMC mutation over the distributed factorization on a (2, 2)
    mesh (particles over the chain axis, rows over the data axis), 4
    particles, 2 stages on JAX's draws: the twin's particles and log
    evidence; one rank the same, and on the port's own generator one rank
    and four alike."""
    x, y = problem
    key = jax.random.PRNGKey(3)
    kw = dict(num_particles=4, sigma0=1.5, num_mcmc_steps=1, block=32, max_stages=2)
    mesh = jmake_mesh(n_chain=2, n_data=2, devices=jax.devices()[:4])
    want = jlarge.run_smc_large_n(JGP, jnp.asarray(x), jnp.asarray(y), key, mesh, **kw)
    four = pool.run("smc_large_n", (2, 2), x, y, np.asarray(key), kw)[0]
    one = pool.run("smc_large_n", (1, 1), x, y, np.asarray(key), kw)[0]
    for got in (four, one):
        assert got["num_stages"] == int(want.num_stages) == 2
        np.testing.assert_allclose(got["particles"], np.asarray(want.particles), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(got["log_evidence"], float(want.log_evidence), rtol=1e-8)
    np.testing.assert_allclose(four["accept_rate"], one["accept_rate"], rtol=1e-8)
    own4 = pool.run("smc_large_n", (2, 2), x, y, np.asarray(key), kw, False, 4)[0]
    own1 = pool.run("smc_large_n", (1, 1), x, y, np.asarray(key), kw, False, 4)[0]
    np.testing.assert_allclose(own4["particles"], own1["particles"], rtol=1e-8, atol=1e-8)
    assert np.isfinite(own4["particles"]).all()
