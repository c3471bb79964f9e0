"""The port's sampler stack (gogp_torch.infer: adapt, chees, diagnostics)
against the JAX package's, in float64 on the CPU.

The same numpy inputs go through both.  Randomness: the port's ChEES takes
each transition's draws from one place, so these tests hand it the draws
JAX makes itself (the same ``jax.random`` calls as chees.py:176-183).
Tolerances: 1e-12 relative for the adaptation arithmetic (the same
operations in the same order), 1e-9 for the diagnostics (FFT and variance
reductions in other orders), 1e-8 for sampler states after many leapfrog
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import chees as jchees
from gogp_tpu.infer import diagnostics as jdiag
from gogp_torch import convert
from gogp_torch.infer import adapt, chees, diagnostics

EXACT = dict(rtol=1e-12, atol=1e-14)
DIAG = dict(rtol=1e-9, atol=1e-12)
STATE = dict(rtol=1e-8, atol=1e-10)


def T(a):
    return torch.tensor(np.asarray(a))


def test_dual_averaging_matches_jax():
    accepts = np.random.default_rng(0).uniform(size=40)
    js, ts = jadapt.da_init(0.1), adapt.da_init(0.1, dtype=torch.float64)
    for i, a in enumerate(accepts):
        js = jadapt.da_update(js, jnp.asarray(a), target=0.75)
        ts = adapt.da_update(ts, T(a), target=0.75)
        if i == 20:  # a window refresh restarts at the current step size
            js, ts = jadapt.da_init(jnp.exp(js.log_step)), adapt.da_init(torch.exp(ts.log_step))
    for name in ("log_step", "log_step_avg", "gradient_avg", "mu"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), **EXACT)
    assert int(ts.t) == int(js.t)


def test_welford_matches_jax():
    X = np.random.default_rng(1).normal(size=(30, 3))
    jw, tw = jadapt.welford_init(3, jnp.float64), adapt.welford_init(3, torch.float64)
    for x in X[:20]:
        jw, tw = jadapt.welford_update(jw, jnp.asarray(x)), adapt.welford_update(tw, T(x))
    jb, tb = jadapt.welford_init(3, jnp.float64), adapt.welford_init(3, torch.float64)
    for x in X[20:]:
        jb, tb = jadapt.welford_update(jb, jnp.asarray(x)), adapt.welford_update(tb, T(x))
    jw, tw = jadapt.welford_combine(jw, jb), adapt.welford_combine(tw, tb)
    for name in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)), **EXACT)
    for reg in (True, False):
        np.testing.assert_allclose(adapt.welford_variance(tw, reg).numpy(),
                                   np.asarray(jadapt.welford_variance(jw, reg)), **EXACT)


@pytest.mark.parametrize("num_warmup", [0, 19, 150, 512])
def test_build_schedule_matches_jax(num_warmup):
    js, ts = jadapt.build_schedule(num_warmup), adapt.build_schedule(num_warmup)
    np.testing.assert_array_equal(ts.update_mass, np.asarray(js.update_mass))
    np.testing.assert_array_equal(ts.window_end, np.asarray(js.window_end))


def test_halton2_matches_jax():
    idx = np.concatenate([np.arange(1100), [2**20 + 3, 2**23 - 1, 2**24 + 5]])
    want = np.asarray(jax.vmap(jchees._halton2)(jnp.asarray(idx, jnp.int32)))
    got = chees._halton2(torch.tensor(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(chees._halton2(5)) == float(jchees._halton2(jnp.asarray(5)))


def test_adam_update_matches_jax():
    grads = np.random.default_rng(2).normal(size=25)
    js, ts = jchees._adam_init(jnp.float64), chees._adam_init(torch.float64)
    for g in grads:
        jup, js = jchees._adam_update(js, jnp.asarray(g), 0.025)
        tup, ts = chees._adam_update(ts, T(g), 0.025)
        np.testing.assert_allclose(tup.numpy(), np.asarray(jup), **EXACT)
    np.testing.assert_allclose(ts.m.numpy(), np.asarray(js.m), **EXACT)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **EXACT)


def _ar1(chains=4, draws=400, dim=3, phi=0.8, seed=0, drift=0.0):
    rng = np.random.default_rng(seed)
    out = np.zeros((chains, draws, dim))
    for t in range(1, draws):
        out[:, t] = phi * out[:, t - 1] + rng.normal(size=(chains, dim))
    out[0] += drift  # one chain off the others: R-hat above 1
    return out


@pytest.mark.parametrize("drift", [0.0, 2.0])
def test_diagnostics_match_jax(drift):
    x = _ar1(drift=drift)
    jx, tx = jnp.asarray(x), T(x)
    for name in ("ess", "split_rhat", "bulk_ess", "bulk_rhat", "rank_normalize"):
        np.testing.assert_allclose(getattr(diagnostics, name)(tx).numpy(),
                                   np.asarray(jax.jit(getattr(jdiag, name))(jx)), **DIAG)
    np.testing.assert_allclose(diagnostics.ess(tx, split=False).numpy(),
                               np.asarray(jax.jit(lambda a: jdiag.ess(a, split=False))(jx)), **DIAG)
    np.testing.assert_allclose(diagnostics.ess(tx[0, :, 0]).numpy(),
                               np.asarray(jax.jit(jdiag.ess)(jx[0, :, 0])), **DIAG)
    # jdiag.gated_min_ess's own arithmetic on the jitted bulk diagnostics
    e, r = np.asarray(jax.jit(jdiag.bulk_ess)(jx)), np.asarray(jax.jit(jdiag.bulk_rhat)(jx))
    got = diagnostics.gated_min_ess(tx)
    np.testing.assert_allclose(got[:2], (e.min(), r.max()), **DIAG)
    assert got[2] == bool(r.max() <= 1.01)
    assert not (drift and got[2])
    got, want = diagnostics.diagnose(tx), jdiag.diagnose(jx)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in got], **DIAG)


# --- ChEES on a correlated Gaussian, with JAX's own draws ---------------------

COV_INV = np.linalg.inv(np.array([[2.0, 1.2], [1.2, 1.5]]))
MEAN = np.array([1.0, -2.0])


def j_mvn(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


def t_mvn(V):
    d = V - T(MEAN)
    return -0.5 * ((d @ T(COV_INV)) * d).sum(-1)


class JaxDraws:
    """The port's ``draws(state)`` fed from the JAX key stream: per
    transition, ``key, key_iter = split(rng)`` and each chain's momentum and
    acceptance uniform from ``fold_in(key_iter, chain)`` (chees.py:176-183)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, state):
        chains, dim = state.positions.shape
        self.key, key_iter = jax.random.split(self.key)

        def chain_draws(i):
            km, ka = jax.random.split(jax.random.fold_in(key_iter, i))
            return jax.random.normal(km, (dim,), jnp.float64), jax.random.uniform(ka, (), jnp.float64)

        r0, u = jax.vmap(chain_draws)(jnp.arange(chains))
        return T(r0), T(u)


def assert_states_close(got, want, **tol):
    for name in ("positions", "logps", "grads", "step_size", "inv_mass", "log_traj", "accept_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    assert got.step == int(want.step)


@pytest.mark.parametrize("free", [None, (1.0, 0.0)])
def test_chees_matches_jax_with_injected_draws(free):
    """30 warmup and 10 sampling transitions of 6 chains; a free mask pins
    the second coordinate."""
    x0 = 0.3 * np.random.default_rng(4).normal(size=(6, 2))
    key = jax.random.PRNGKey(0)
    jfree = None if free is None else jnp.asarray(free)
    sched = jadapt.build_schedule(30)
    js = jchees.chees_init(j_mvn, jnp.asarray(x0), key, 0.1, 1.0, jfree)
    ts = chees.chees_init(t_mvn, T(x0), torch.Generator(), 0.1, 1.0, None if free is None else T(free))
    assert_states_close(ts, js, **EXACT)
    ts = convert.chees_state_from_numpy(js, "cpu")
    draws = JaxDraws(js.rng)

    js = jax.jit(lambda s: jchees.chees_warm_chunk(j_mvn, s, sched.update_mass, sched.window_end, free=jfree))(js)
    ts = chees.chees_warm_chunk(t_mvn, ts, *adapt.build_schedule(30), free=free, draws=draws)
    assert_states_close(ts, js, **STATE)
    js, ts = jchees.finalize_chees_warmup(js), chees.finalize_chees_warmup(ts)
    js, (jpos, _, jacc) = jax.jit(lambda s: jchees.chees_sample_chunk(j_mvn, s, 10, free=jfree))(js)
    ts, (tpos, _, tacc) = chees.chees_sample_chunk(t_mvn, ts, 10, free=free, draws=draws)
    assert_states_close(ts, js, **STATE)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **STATE)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **STATE)
    if free is not None:
        assert torch.all(tpos[..., 1] == T(x0)[:, 1])


def test_run_chees_moments():
    """The port's own generator: the Gaussian's moments within Monte-Carlo
    error (the counterpart of tests/test_chees.py::test_gaussian_moments)."""
    x0 = 0.1 * torch.randn((16, 2), generator=torch.Generator().manual_seed(10), dtype=torch.float64)
    res = chees.run_chees(t_mvn, x0, torch.Generator().manual_seed(0), num_warmup=300, num_samples=300)
    s = res.positions.reshape(-1, 2).numpy()
    assert np.allclose(s.mean(axis=0), MEAN, atol=0.1)
    assert np.allclose(np.cov(s.T), np.linalg.inv(COV_INV), atol=0.3)
    assert res.positions.shape == (300, 16, 2)
