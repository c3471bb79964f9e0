"""The port's GHMC (gogp_torch.infer.ghmc) against the JAX package's, in
float64 on the CPU, and the JAX tests' behaviours (tests/test_ghmc.py) on
the port's own generator.

The port takes each transition's draws, the momentum refresh xi and the
acceptance uniforms, from ``draws(state)``; these tests hand it JAX's own
(``key, key_iter = split(rng)``, each chain's from ``fold_in(key_iter,
chain)``, ``test_torch_infer.JaxDraws``), starting from JAX's state
(``convert.ghmc_state_from_numpy``: JAX draws the initial momenta per
chain).  On ``test_torch_hmc.py``'s correlated Gaussian the warmup and
sampling transitions are held to 1e-10 from JAX's state and the
free-running ``run_ghmc`` to 1e-8 (dual averaging grows the last-bit
differences); on the hyperpriors posterior (the port's K7 route, K7's plain
version on the CPU) transitions from JAX's state to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import COV, MEAN, T, j_mvn, t_mvn
from test_torch_infer import JaxDraws

from gogp_tpu.infer import ghmc as jghmc
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_torch import convert
from gogp_torch.infer import diagnostics, ghmc
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

EXACT = dict(rtol=1e-12, atol=1e-14)
TOL = dict(rtol=0, atol=1e-10)
STATE = dict(rtol=0, atol=1e-8)
FIELDS = ("positions", "momenta", "logps", "grads", "step_size", "sigma", "accept_probs")


def assert_states_close(got, want, **tol):
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **tol)
    for name in ("log_step", "log_step_avg", "gradient_avg"):
        np.testing.assert_allclose(getattr(got.da, name).numpy(), np.asarray(getattr(want.da, name)),
                                   err_msg=f"da.{name}", **tol)
    assert got.step == int(want.step)


def _hyperpriors_k7():
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    y = tio.normalize(y)[0]
    logp, _, _, free = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)
    jlogp, _, _, jfree = jbayes.build_logjoint(jhp.make_study(), x, y)
    return logp, free, jlogp, jfree


def test_fold_stats_and_damping_match_jax():
    X = np.random.default_rng(0).normal(size=(10, 3)) * [3.0, 1.0, 0.2]
    free = np.array([1.0, 1.0, 0.0])
    for f in (None, free):
        got = ghmc._fold_stats(T(X), None if f is None else T(f))
        want = jghmc._fold_stats(jnp.asarray(X), None, None if f is None else jnp.asarray(f))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
        js = jghmc.ghmc_init(j_mvn, jnp.asarray(X), jax.random.PRNGKey(0), 0.3)._replace(sigma=want)
        ts = convert.ghmc_state_from_numpy(js, "cpu")
        np.testing.assert_allclose(ghmc._damping(ts, None if f is None else T(f)).numpy(),
                                   np.asarray(jghmc._damping(js, None if f is None else jnp.asarray(f))), **EXACT)


@pytest.mark.parametrize("target,free", [("gaussian", None), ("gaussian", (1.0, 0.0, 1.0)), ("hyperpriors", None)])
def test_ghmc_transitions_match_jax(target, free):
    """8 chains: warmup transitions (sigma from the folds, dual averaging)
    then sampling transitions, each from JAX's state: 30 + 10 on the
    Gaussian, 4 + 4 on hyperpriors."""
    if target == "gaussian":
        logp, jlogp, dim, warm, tol = t_mvn, j_mvn, 3, 30, TOL
        tfree, jfree = (None, None) if free is None else (T(free), jnp.asarray(free))
    else:
        (logp, tfree, jlogp, jfree), dim, warm, tol = _hyperpriors_k7(), 6, 4, STATE
    x0 = 0.3 * np.random.default_rng(1).normal(size=(8, dim))
    js = jghmc.ghmc_init(jlogp, jnp.asarray(x0), jax.random.PRNGKey(1), 0.1)
    own = ghmc.ghmc_init(logp, T(x0), torch.Generator(), 0.1)
    np.testing.assert_allclose(own.logps.numpy(), np.asarray(js.logps), rtol=1e-12)
    np.testing.assert_allclose(own.grads.numpy(), np.asarray(js.grads), **tol)
    warm_step = jax.jit(lambda s: jghmc.ghmc_warmup_step(jghmc.ghmc_transition(jlogp, s, True, jfree)))
    sample_step = jax.jit(lambda s: jghmc.ghmc_transition(jlogp, s, False, jfree))
    flips = 0
    for i in range(warm + (10 if target == "gaussian" else 4)):
        if i == warm:
            js = jghmc.finalize_ghmc_warmup(js)
        ts = convert.ghmc_state_from_numpy(js, "cpu")
        draws = JaxDraws(js.rng)
        if i < warm:
            js = warm_step(js)
            ts = ghmc.ghmc_warmup_step(ghmc.ghmc_transition(logp, ts, True, tfree, draws=draws))
        else:
            js = sample_step(js)
            ts = ghmc.ghmc_transition(logp, ts, False, tfree, draws=draws)
        flips += int((ts.accept_probs < 1.0).sum())
        assert_states_close(ts._replace(step=i + 1), js, **tol)
    assert flips > 0  # some rejections: the momentum flip is exercised
    if free is not None:
        assert torch.all(ts.positions[:, 1] == T(x0)[:, 1])


@pytest.mark.parametrize("free", [None, (1.0, 1.0, 0.0)])
def test_run_ghmc_matches_jax(free):
    """``run_ghmc`` free-running, 8 chains, 30 warmup and 20 sampling
    transitions, the port on JAX's draws from JAX's initial momenta."""
    x0 = 0.3 * np.random.default_rng(2).normal(size=(8, 3))
    rng = jax.random.PRNGKey(2)
    jfree = None if free is None else jnp.asarray(free)
    want = jax.jit(lambda q: jghmc.run_ghmc(j_mvn, q, rng, num_warmup=30, num_samples=20, free=jfree))(
        jnp.asarray(x0))
    js = jghmc.ghmc_init(j_mvn, jnp.asarray(x0), rng, 0.1)
    got = ghmc.run_ghmc(t_mvn, T(x0), torch.Generator(), num_warmup=30, num_samples=20,
                        free=None if free is None else T(free), draws=JaxDraws(js.rng),
                        momenta=T(js.momenta))
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), **STATE)
    np.testing.assert_allclose(got.accept_probs.numpy(), np.asarray(want.accept_probs), **STATE)
    assert_states_close(got.state, want.state, **STATE)


def test_gaussian_moments_rhat_and_accept():
    x0 = 0.1 * torch.randn((16, 3), generator=torch.Generator().manual_seed(10), dtype=torch.float64)
    res = ghmc.run_ghmc(t_mvn, x0, torch.Generator().manual_seed(0), num_warmup=600, num_samples=2000)
    s = res.positions.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.1)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.3)
    assert float(diagnostics.split_rhat(res.positions.transpose(0, 1)).max()) < 1.05
    assert 0.8 < float(res.accept_probs.mean()) < 1.0  # dual averaging targets 0.9


def test_cross_fold_preconditioner_finds_scales():
    """A 10:1 anisotropic Gaussian: each fold's frozen sigma recovers the
    ratio from the other fold."""
    scales = T([10.0, 1.0])
    x0 = torch.randn((32, 2), generator=torch.Generator().manual_seed(12), dtype=torch.float64) * scales
    res = ghmc.run_ghmc(lambda V: -0.5 * ((V / scales) ** 2).sum(-1), x0, torch.Generator().manual_seed(2),
                        num_warmup=800, num_samples=100)
    ratio = res.state.sigma[:, 0] / res.state.sigma[:, 1]
    assert bool(((ratio > 4.0) & (ratio < 25.0)).all()), res.state.sigma


def test_chunked_equals_monolithic_sampling():
    state = ghmc.ghmc_init(t_mvn, torch.zeros((4, 3), dtype=torch.float64), torch.Generator().manual_seed(5), 0.3)

    def fresh():
        return state._replace(rng=torch.Generator().manual_seed(6))

    _, (whole, _, _) = ghmc.ghmc_sample_chunk(t_mvn, fresh(), 40)
    s2, (first, _, _) = ghmc.ghmc_sample_chunk(t_mvn, fresh(), 20)
    _, (second, _, _) = ghmc.ghmc_sample_chunk(t_mvn, s2, 20)
    assert torch.equal(whole, torch.cat([first, second]))


def test_free_mask_pins_coordinates():
    """Pinned dims stay put and the free dims sample the conditional (the
    pinned dim is left out of the preconditioner and the damping)."""
    free = T([1.0, 1.0, 0.0])
    x0 = T(np.tile([0.0, 0.0, 2.0], (16, 1)))
    res = ghmc.run_ghmc(t_mvn, x0, torch.Generator().manual_seed(3), num_warmup=600, num_samples=2000, free=free)
    s = res.positions.numpy()
    assert (s[:, :, 2] == 2.0).all()
    k = np.linalg.inv(COV)[:2, :2]  # the conditional's precision
    cmean = MEAN[:2] - np.linalg.solve(k, np.linalg.inv(COV)[:2, 2]) * (2.0 - MEAN[2])
    flat = s[:, :, :2].reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(0), cmean, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), np.linalg.inv(k), atol=0.3)


def test_odd_or_tiny_population_raises():
    with pytest.raises(ValueError, match="even population"):
        ghmc.ghmc_init(t_mvn, torch.zeros((5, 3), dtype=torch.float64), torch.Generator())
    with pytest.raises(ValueError, match=">= 4"):
        ghmc.run_ghmc(t_mvn, torch.zeros((2, 3), dtype=torch.float64), torch.Generator())


def test_divergences_do_not_stick():
    res = ghmc.run_ghmc(t_mvn, torch.zeros((8, 3), dtype=torch.float64), torch.Generator().manual_seed(7),
                        num_warmup=400, num_samples=100, init_step_size=50.0)
    assert bool(torch.isfinite(res.positions).all())
    assert float(res.state.step_size) < 5.0 and float(res.accept_probs.mean()) > 0.5
