"""The hyperpriors Bayesian slice of the port (gogp_torch.dists,
tutorial.io, tutorial.hyperpriors, gp.core.predict_mixture, tutorial.bayes)
against the JAX package, in float64 on the CPU.

The slice as a whole: both packages' ChEES-HMC start from one state
(``convert.chees_state_from_numpy``) on the hyperpriors posterior, 8 chains,
and the port takes the draws JAX makes itself (the same ``jax.random`` calls
as chees.py:176-183).  The port's log-joint runs on the K7 route (K7's plain
version on the CPU), JAX's on its own route (``gp_observe`` plus priors under
autodiff).  Tolerances: values 1e-9 relative, gradients and sampler states
1e-8; the forecast on the draws 1e-8.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import dists as jdists
from gogp_tpu.gp import core as jcore
from gogp_tpu.infer import chees as jchees
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_tpu.tutorial import io as jio
from gogp_torch import convert, dists
from gogp_torch.gp import core as tcore
from gogp_torch.infer import adapt, chees
from gogp_torch.ops import linalg
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

VALUE = dict(rtol=1e-9, atol=0)
STATE = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the slice test runs thousands of (8, 44, 44)
    factorizations, which a pool of threads slows down many times over on a
    loaded CPU (the tier-1 run's 6 workers).  Restored afterwards for the
    other tests of the process."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.tensor(np.asarray(a))


# --- dists, io ----------------------------------------------------------------

_RNG = np.random.default_rng(0)
_POS = _RNG.uniform(0.2, 3.0, 5)
_REAL = _RNG.normal(size=5)


@pytest.mark.parametrize("name,args", [
    ("normal_logp", (0.3, 1.7, _REAL)),
    ("expon_logp", (1.3, _POS)),
    ("laplace_logp", (-0.2, 0.8, _REAL)),
    ("lognormal_logp", (0.1, 0.6, _POS)),
    ("halfnormal_logp", (1.4, _POS)),
    ("gamma_logp", (2.5, 1.5, _POS)),
])
def test_dists_match_jax(name, args):
    want = np.asarray(getattr(jdists, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(dists, name)(*(T(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    # numbers mixed with a tensor take the tensor's dtype, and autograd runs
    x = T(args[-1]).requires_grad_(True)
    lp = getattr(dists, name)(*args[:-1], x)
    np.testing.assert_allclose(lp.detach().numpy(), want, rtol=1e-12)
    (g,) = torch.autograd.grad(lp.sum(), x)
    jg = jax.grad(lambda a: jnp.sum(getattr(jdists, name)(*args[:-1], a)))(jnp.asarray(args[-1]))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12)


def test_io_matches_jax():
    text = hyperpriors.selfcheck_data()
    assert text == jhp.selfcheck_data()
    (tx, ty), (jx, jy) = tio.load_csv(text), jio.load_csv(text)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tx.shape == (44, 1)
    for got, want in zip(tio.normalize(ty), jio.normalize(jy)):
        np.testing.assert_array_equal(got, want)
    assert tio.load_csv("")[0].shape == (0, 1)
    rows = [[0.5, float("nan"), -1.25, 3.0], [1e-7, 2.0, 1e6, float("nan")]]
    bufs = io.StringIO(), io.StringIO()
    tio.write_forecast_rows(bufs[0], rows)
    jio.write_forecast_rows(bufs[1], rows)
    assert bufs[0].getvalue() == bufs[1].getvalue()


# --- hyperpriors, predict_mixture ---------------------------------------------


def _hyperpriors_data():
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    return x, tio.normalize(y)[0]


def test_hyperpriors_priors_and_covariance_match_jax():
    x, y = _hyperpriors_data()
    V = 0.4 * np.random.default_rng(1).normal(size=(5, 6))
    mask = np.ones(x.shape[0])
    got = hyperpriors.make_priors(x, y)(T(V), T(mask))
    jpri = jhp.make_priors(x, y)
    want = np.array([float(jpri(jnp.asarray(v), jnp.asarray(mask))) for v in V])
    np.testing.assert_allclose(got.numpy(), want, **VALUE)
    tgp, jgp = hyperpriors.make_study().gp, jhp.make_study().gp
    theta = np.exp(V[0])
    K = tcore.masked_cov(tgp, T(theta[:5]), T(theta[5:]), T(x), None)
    jK = jcore.masked_cov(jgp, jnp.asarray(theta[:5]), jnp.asarray(theta[5:]), jnp.asarray(x), None)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=1e-12, atol=1e-14)


def test_predict_mixture_matches_jax():
    x, y = _hyperpriors_data()
    tgp, jgp = hyperpriors.make_study().gp, jhp.make_study().gp
    vs = 0.3 * np.random.default_rng(2).normal(size=(7, 6))
    z = np.linspace(0, 30, 13)[:, None]
    mask = np.ones(x.shape[0])
    mask[-4:] = 0.0  # padded rows
    got = tcore.predict_mixture(tgp, T(vs), T(x), T(y), T(z), T(mask))
    want = jax.jit(lambda v: jcore.predict_mixture(jgp, v, x, y, z, mask))(jnp.asarray(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)


# --- the log-joint on both routes -----------------------------------------------


@pytest.mark.parametrize("plain", [False, True])
def test_logjoint_matches_jax(plain):
    """The port's K7 route, and its plain route (built under force_plain),
    against jax.vmap(jax.value_and_grad) of JAX's log-joint."""
    x, y = _hyperpriors_data()
    study, jstudy = hyperpriors.make_study(), jhp.make_study()
    with linalg.force_plain() if plain else contextlib.nullcontext():
        logp, observed, v0, free = bayes.build_logjoint(study, x, y, "cpu", torch.float64)
    jlogp, _, jv0, jfree = jbayes.build_logjoint(jstudy, x, y)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    V = 0.3 * np.random.default_rng(3).normal(size=(4, 6))
    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(jnp.asarray(V))
    q = T(V).requires_grad_(True)
    val = logp(q)
    (grad,) = torch.autograd.grad(val.sum(), q)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(want_v), **VALUE)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-8 * np.abs(want_g).max())


@pytest.mark.parametrize("plain", [False, True])
def test_on_host_logjoint_matches_jax(plain):
    """``bayes.on_host``, the log-joint NUTS takes (its value and gradient in
    one copy, the gradient handed back by the backward), against JAX's, with
    each row's gradient scaled by its own cotangent."""
    x, y = _hyperpriors_data()
    with linalg.force_plain() if plain else contextlib.nullcontext():
        logp = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)[0]
    jlogp = jbayes.build_logjoint(jhp.make_study(), x, y)[0]
    V = 0.3 * np.random.default_rng(4).normal(size=(4, 6))
    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(jnp.asarray(V))
    weights = np.array([1.0, -0.5, 2.0, 0.25])
    q = T(V).requires_grad_(True)
    val = bayes.on_host(logp, "cpu")(q)
    (grad,) = torch.autograd.grad(val, q, T(weights))
    want_g = weights[:, None] * np.asarray(want_g)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(want_v), **VALUE)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=1e-8 * np.abs(want_g).max())


def test_barebones_logjoint_matches_jax():
    """The barebones study (no priors) on the plain route: the log-joint at
    three points against JAX's ``build_logjoint``."""
    _, study, data = bayes.get_study("barebones")
    x, y = tio.load_csv(data)
    y = tio.normalize(y)[0]
    with linalg.force_plain():
        logp, _, v0, free = bayes.build_logjoint(study, x, y, "cpu", torch.float64)
    jlogp, _, jv0, jfree = jbayes.build_logjoint(jbayes.get_study("barebones")[1], x, y)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    V = 0.3 * np.random.default_rng(4).normal(size=(3, 3))
    np.testing.assert_allclose(logp(T(V)).numpy(), np.asarray(jax.vmap(jlogp)(jnp.asarray(V))), **VALUE)


# --- the slice as a whole -----------------------------------------------------


def _jax_draws(key):
    """Draws in the order the JAX transition makes them (chees.py:176-183):
    per transition ``key, key_iter = split(rng)``, each chain's momentum and
    acceptance uniform from ``fold_in(key_iter, chain)``."""
    state = {"key": key}

    def draws(s):
        chains, dim = s.positions.shape
        state["key"], key_iter = jax.random.split(state["key"])

        def chain_draws(i):
            km, ka = jax.random.split(jax.random.fold_in(key_iter, i))
            return jax.random.normal(km, (dim,), jnp.float64), jax.random.uniform(ka, (), jnp.float64)

        r0, u = jax.vmap(chain_draws)(jnp.arange(chains))
        return T(r0), T(u)

    return draws


def test_hyperpriors_chees_slice_matches_jax():
    """8 chains, 30 warmup and 10 sampling transitions of ChEES-HMC, then
    the mixture forecast on the draws.

    The warmup is held transition by transition: each port transition starts
    from JAX's state and takes JAX's draws.  Free-running, the two warmups
    part after about ten transitions whatever the port does: the log-joints
    differ in their last bits (the K7 route takes the LML from L^-1, JAX's
    from L), the early warmup's large steps make near-divergent trajectories
    that grow such a difference by up to 1e5 in one transition, and the
    first Adam steps on log T move it by up to the learning rate whatever
    the size of the ChEES gradient, so a near-zero gradient that a chaotic
    chain perturbs moves log T visibly.  The seed (2) is one whose warmup
    has no such transition, so log T is held too.  Sampling, at the frozen
    step size, runs free from the warmed state."""
    x, y = _hyperpriors_data()
    study, jstudy = hyperpriors.make_study(), jhp.make_study()
    logp, observed, v0, free = bayes.build_logjoint(study, x, y, "cpu", torch.float64)
    jlogp, jposterior_of, jv0, jfree = jbayes.build_logjoint(jstudy, x, y)
    chains, num_warmup, num_samples, seed = 8, 30, 10, 2
    x0 = 0.1 * np.random.default_rng(seed).normal(size=(chains, 6))

    js = jchees.chees_init(jlogp, jnp.asarray(x0), jax.random.PRNGKey(seed), 0.1, 1.0, jfree)
    own = chees.chees_init(logp, T(x0), torch.Generator(), 0.1, 1.0, free)
    np.testing.assert_allclose(own.logps.numpy(), np.asarray(js.logps), **VALUE)
    np.testing.assert_allclose(own.grads.numpy(), np.asarray(js.grads), **STATE)

    jstep = jax.jit(lambda s, um, we: jchees.chees_warmup_step(
        jchees.chees_transition(jlogp, s, adapt_traj=True, free=jfree), um, we))
    sched = adapt.build_schedule(num_warmup)
    assert sched.window_end.any()  # the mass is refreshed at least once
    for um, we in zip(*sched):
        ts = convert.chees_state_from_numpy(js, "cpu")
        ts = chees.chees_warm_chunk(logp, ts, [um], [we], free=free, draws=_jax_draws(js.rng))
        js = jstep(js, um, we)
        for name in ("positions", "logps", "grads", "step_size", "log_traj", "inv_mass", "accept_probs"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       err_msg=f"{name} after warmup step {ts.step}", **STATE)
        for name in ("count", "mean", "m2"):
            np.testing.assert_allclose(getattr(ts.welford, name).numpy(), np.asarray(getattr(js.welford, name)),
                                       err_msg=f"welford.{name}", **STATE)

    js = jchees.finalize_chees_warmup(js)
    ts = chees.finalize_chees_warmup(convert.chees_state_from_numpy(js, "cpu"))
    np.testing.assert_allclose(ts.step_size.numpy(), np.asarray(js.step_size), **STATE)
    draws = _jax_draws(js.rng)
    js, (jpos, _, jacc) = jax.jit(lambda s: jchees.chees_sample_chunk(jlogp, s, num_samples, free=jfree))(js)
    ts, (tpos, _, tacc) = chees.chees_sample_chunk(logp, ts, num_samples, free=free, draws=draws)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **STATE)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **STATE)
    for name in ("positions", "logps", "grads", "log_traj", "inv_mass"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name, **STATE)
    assert bool((tacc > 0.5).any())

    z = np.linspace(0, 2 * x[:, 0].max(), 20)[:, None]
    draws_t, draws_j = tpos.reshape(-1, 6), np.asarray(jpos).reshape(-1, 6)
    got = bayes.mixture_forecast(study.gp, observed, draws_t, z, max_draws=32)
    want = jbayes.mixture_forecast(jstudy.gp, jposterior_of, draws_j, z, max_draws=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-10)


def test_main_selfcheck_on_cpu():
    """The command line end to end at a small size: 50 finite rows with
    sigma > 0, then the theta-mean line, for ChEES and for the engines and
    options that the port once refused (GHMC, PT-ChEES, ``--pops``,
    ``--race``)."""
    for argv in (["hyperpriors", "--engine", "chees"],
                 ["hyperpriors", "--engine", "ghmc"],
                 ["hyperpriors", "--engine", "pt-chees", "--replicas", "3"],
                 ["hyperpriors", "--engine", "chees", "--pops", "2"],
                 ["hyperpriors", "--engine", "chees", "--race", "2"]):
        lines = run_main([*argv, "--chains", "4", "--warmup", "20", "--samples", "16", "--platform", "cpu",
                          "selfcheck"])
        rows = np.array([[float(v) for v in line.split(",")] for line in lines[:-1]])
        assert rows.shape == (50, 4), argv
        assert np.isnan(rows[:, 1]).all() and np.isfinite(rows[:, [0, 2, 3]]).all() and (rows[:, 3] > 0).all()
        n_theta = bayes.get_study(argv[0])[1].gp.n_theta
        assert lines[-1].startswith("# posterior theta mean: ") and len(lines[-1].split(",")) == n_theta


def run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bayes.main(argv)
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("study,engine", [
    ("hyperpriors", "nuts"),
    ("hyperpriors", "hmc"),
    ("barebones", "smc"),
    ("anynoise", "advi"),
    ("barebones", "advi-full"),
    ("warpedtime", "nuts"),
    ("anynoise", "nuts"),
])
def test_engines_produce_forecast(study, engine):
    """Each engine through the command line on tests/test_bayes_driver.py's
    pairs of study and engine (and NUTS on the latent-input studies), at
    2 chains, a grid of 10 and, to keep the CPU's time short, 10 warmup
    transitions (40 ADVI steps) and 8 samples (128 SMC particles): finite
    rows with sigma >= 0 and the theta-mean line."""
    lines = run_main([study, "--engine", engine, "--samples", "8", "--warmup", "10", "--chains", "2",
                      "--grid", "10", "--platform", "cpu", "selfcheck"])
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[:-1]])
    assert rows.shape == (10, 4)
    assert np.isnan(rows[:, 1]).all() and np.isfinite(rows[:, [0, 2, 3]]).all() and (rows[:, 3] >= 0).all()
    n_theta = bayes.get_study(study)[1].gp.n_theta
    assert lines[-1].startswith("# posterior theta mean: ") and len(lines[-1].split(",")) == n_theta


@pytest.mark.parametrize("engine,draws", [
    ("pt-chees", 4 * 2),
    ("ghmc", 4 * 2),
    ("chees --pops 2", 4 * 2),
    ("chees --race 2", 4 * 2),
])
def test_new_engines_draw_as_jax_sizes(engine, draws):
    """``sample_posterior`` with the JAX command line's sizes for the
    engines of the PT-ChEES, GHMC, populations and race branches: 4
    chains, 8 samples, so 2 draws a chain (a ladder's cold chain for
    PT-ChEES, every 16th of 32 transitions for GHMC), each finite."""
    x, y = _hyperpriors_data()
    logp, _, v0, free = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)
    name, *opts = engine.split()
    pops = int(opts[1]) if opts[:1] == ["--pops"] else 1
    race = int(opts[1]) if opts[:1] == ["--race"] else 0
    out = bayes.sample_posterior(logp, v0, free, name, 0, 8, 20, 4, pops=pops, replicas=3, race=race)
    assert out.shape == (draws, 6) and torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["warpedtime", "anynoise"])
def test_latent_logjoint_matches_jax(name):
    """A latent-input study's log-joint over the full parameter vector
    (inputs and outputs too) against ``jax.vmap(jax.value_and_grad)`` of
    JAX's, at 4 points around v0; the same v0 and free mask; then the
    mixture forecast, each draw conditioned on its own inputs."""
    _, study, data = bayes.get_study(name)
    x, y = tio.load_csv(data)
    y = tio.normalize(y)[0]
    logp, observed, v0, free = bayes.build_logjoint(study, x, y, "cpu", torch.float64)
    jlogp, jposterior_of, jv0, jfree = jbayes.build_logjoint(jbayes.get_study(name)[1], x, y)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    assert observed.latent and v0.shape[0] == study.gp.n_theta + 2 * x.shape[0]
    V = np.asarray(jv0) + 0.05 * np.random.default_rng(6).normal(size=(4, v0.shape[0])) * np.asarray(jfree)
    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(jnp.asarray(V))
    q = T(V).requires_grad_(True)
    val = logp(q)
    (grad,) = torch.autograd.grad(val.sum(), q)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(want_v), **VALUE)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-9 * np.abs(want_g).max())
    z = np.linspace(x[:, 0].min(), 2 * x[:, 0].max(), 7)[:, None]
    got = bayes.mixture_forecast(study.gp, observed, T(V), z)
    want = jbayes.mixture_forecast(jbayes.get_study(name)[1].gp, jposterior_of, V, z)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)


def test_sample_posterior_holds_fixed_coordinates():
    """``sample_posterior`` keeps ``num_samples // chains`` draws per chain,
    leaves a coordinate that ``free`` fixes at v0 (in the start and in every
    draw) and gives the same draws from the same seed."""
    _, study, data = bayes.get_study("hyperpriors")
    x, y = tio.load_csv(data)
    logp, _, v0, free = bayes.build_logjoint(study, x, tio.normalize(y)[0], "cpu", torch.float64)
    free = free.clone()
    free[2] = 0.0
    draws = bayes.sample_posterior(logp, v0, free, "chees", 3, 8, 3, 4)
    assert draws.shape == (8, 6) and torch.isfinite(draws).all()
    assert (draws[:, 2] == v0[2]).all() and (draws[:, [0, 1, 3, 4, 5]] != 0).all()
    assert torch.equal(draws, bayes.sample_posterior(logp, v0, free, "chees", 3, 8, 3, 4))
