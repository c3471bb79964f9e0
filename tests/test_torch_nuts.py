"""The port's NUTS (gogp_torch.infer.nuts) against ``jax.vmap`` of the JAX
package's, in float64 on the CPU.

The port builds every chain's tree in lockstep (one batched value and
gradient per leaf, a chain that has turned or diverged frozen by
``torch.where``); JAX vmaps one chain's while loops.  The port takes each
transition's draws from ``draws(state)``, so these tests hand it JAX's own
(nuts.py's ``split(rng, 5)`` and ``fold_in`` per depth and leaf).  The
chains' step sizes differ, so their trees end at different depths in one
transition: the lockstep masks are exercised.  Tolerances: 1e-10 absolute
on the correlated Gaussian (the target of ``test_torch_hmc.py``, whose
gradient both packages compute term by term); 1e-8 on the hyperpriors
posterior, whose log-joints differ in their last bits (summation orders of
the Cholesky and the quadratic form), each transition starting from JAX's
state.  ``run_nuts`` is held to the Gaussian's moments within Monte Carlo
error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import COV, MEAN, TOL, T, assert_states_close, j_mvn, start, t_mvn

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import hmc as jhmc
from gogp_tpu.infer import nuts as jnuts
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_torch import convert
from gogp_torch.infer import adapt, hmc, nuts
from gogp_torch.ops import linalg
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

STATE = dict(rtol=0, atol=1e-8)

_leaf = jax.jit(jax.vmap(lambda k, d, n: jax.random.uniform(jax.random.fold_in(jax.random.fold_in(k, d), n),
                                                             dtype=jnp.float64), in_axes=(0, None, None)))
_merge = jax.jit(jax.vmap(lambda k, d: jax.random.uniform(jax.random.fold_in(k, d), dtype=jnp.float64),
                          in_axes=(0, None)))
_direction = jax.jit(jax.vmap(lambda k, d: jax.random.bernoulli(jax.random.fold_in(k, d)), in_axes=(0, None)))


class JaxNUTSDraws:
    """The port's ``draws(state)`` from JAX's keys, one per chain: each
    transition ``key, key_mom, key_dirs, key_sub, key_merge = split(rng,
    5)``, then ``fold_in`` by depth and leaf (nuts.py)."""

    def __init__(self, keys):
        self.keys = keys
        self.leaves = 0  # leaf uniforms asked for

    def __call__(self, state):
        dim = state.position.shape[1]
        keys = jax.vmap(lambda k: jax.random.split(k, 5))(self.keys)
        self.keys = keys[:, 0]
        momentum = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(keys[:, 1])

        def leaf(depth, n):
            self.leaves += 1
            return T(_leaf(keys[:, 3], depth, n))

        return nuts.NUTSDraws(T(momentum), lambda depth: T(_direction(keys[:, 2], depth)),
                              lambda depth: T(_merge(keys[:, 4], depth)), leaf)


def test_tree_arithmetic_matches_jax():
    """The host integers of the checkpoint stack against JAX's bit tricks."""
    ns = np.arange(2048)
    assert [nuts._popcount(int(n)) for n in ns] == np.asarray(jnuts._popcount(jnp.asarray(ns))).tolist()
    assert [nuts._trailing_ones(int(n)) for n in ns] == np.asarray(jnuts._trailing_ones(jnp.asarray(ns))).tolist()


@pytest.mark.parametrize("free", [None, (1.0, 0.0, 1.0)])
def test_nuts_warmup_matches_jax_vmap(free):
    """12 warmup transitions (``nuts_transition`` then ``warmup_step``) of 8
    chains whose step sizes differ from 0.04 to 0.5, the first 6 free from
    one start, the rest each from JAX's state (``test_torch_hmc.py`` says
    why); the trees' depths differ between chains within transitions."""
    js, ts, keys = start(free=free)
    jfree = None if free is None else jnp.asarray(free)
    draws = JaxNUTSDraws(keys)
    sched = adapt.build_schedule(12)
    jstep = jax.jit(jax.vmap(lambda s: jnuts.nuts_transition(j_mvn, s, 10, jfree)))
    trace = []
    for i in range(12):
        if i >= 6:
            ts = convert.hmc_state_from_numpy(js, "cpu")
        js = jstep(js._replace(rng=draws.keys))
        ts = nuts.nuts_transition(t_mvn, ts, 10, free, draws, trace)
        assert_states_close(ts, js, **TOL)
        js = jax.vmap(jhmc.warmup_step, in_axes=(0, None, None))(js, sched.update_mass[i], sched.window_end[i])
        ts = hmc.warmup_step(ts, bool(sched.update_mass[i]), bool(sched.window_end[i]))
        assert_states_close(ts, js, **TOL)
    spread = [int(t.depth.max() - t.depth.min()) for t in trace]
    assert min(spread) >= 1 and max(spread) >= 3, spread
    assert sum(t.leapfrogs for t in trace) == draws.leaves  # one batched leaf per leapfrog step
    assert all(t.leapfrogs == int(t.num_leaves.max()) for t in trace)
    if free is not None:
        assert torch.all(ts.position[:, 1] == start(free=free)[1].position[:, 1])


def test_nuts_hyperpriors_plain_route_matches_jax():
    """Two transitions of 6 chains on the hyperpriors posterior (the port's
    plain route, built under force_plain, against JAX's ``build_logjoint``),
    each from JAX's state, with chains at different depths."""
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    y = tio.normalize(y)[0]
    with linalg.force_plain():
        logp, _, _, free = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)
    jlogp, _, _, jfree = jbayes.build_logjoint(jhp.make_study(), x, y)
    chains = 6
    x0 = 0.1 * np.random.default_rng(5).normal(size=(chains, 6))
    keys = jax.random.split(jax.random.PRNGKey(5), chains)
    steps = jnp.asarray(np.geomspace(0.03, 0.4, chains))
    js = jax.vmap(lambda q, k: jhmc.init_state(jlogp, q, k, 0.1, jfree))(jnp.asarray(x0), keys)
    js = js._replace(step_size=steps, da=jax.vmap(jadapt.da_init)(steps))
    own = hmc.init_state(logp, T(x0), torch.Generator(), 0.1, free)
    np.testing.assert_allclose(own.logp.numpy(), np.asarray(js.logp), rtol=1e-12)
    np.testing.assert_allclose(own.grad.numpy(), np.asarray(js.grad), rtol=0, atol=1e-9)
    draws = JaxNUTSDraws(keys)
    jstep = jax.jit(jax.vmap(lambda s: jnuts.nuts_transition(jlogp, s, 10, jfree)))
    trace = []
    for _ in range(2):
        ts = convert.hmc_state_from_numpy(js, "cpu")
        js = jstep(js._replace(rng=draws.keys))
        ts = nuts.nuts_transition(logp, ts, 10, free, draws, trace)
        for name in ("position", "logp", "grad", "accept_prob"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name,
                                       **STATE)
    assert max(int(t.depth.max() - t.depth.min()) for t in trace) >= 2


@pytest.mark.parametrize("free", [None, (1.0, 1.0, 0.0)])
def test_run_nuts_moments(free):
    """The port's own generator: the Gaussian's moments within Monte Carlo
    error (the counterpart of tests/test_inference.py::TestNUTS); a pinned
    coordinate stays at its start."""
    x0 = 0.1 * torch.randn((8, 3), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    cov = COV
    if free is not None:  # the third coordinate pinned at its mean: the others' conditional law
        x0[:, 2] = MEAN[2]
        cov = COV[:2, :2] - np.outer(COV[:2, 2], COV[2, :2]) / COV[2, 2]
    trace = []
    res = nuts.run_nuts(t_mvn, x0, torch.Generator().manual_seed(1), num_warmup=100, num_samples=150,
                        free=None if free is None else T(free), trace=trace)
    assert res.positions.shape == (150, 8, 3) and len(trace) == 250
    s = res.positions.reshape(-1, 3).numpy()
    k = 3 if free is None else 2
    np.testing.assert_allclose(s[:, :k].mean(0), MEAN[:k], atol=0.15)
    np.testing.assert_allclose(np.cov(s[:, :k].T), cov, atol=0.25)
    if free is not None:
        assert (s[:, 2] == MEAN[2]).all()
    assert 0.6 < float(res.accept_probs.mean()) < 1.0
    assert not any(bool(t.diverging.any()) for t in trace[100:])
