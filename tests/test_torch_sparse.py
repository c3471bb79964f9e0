"""Parity of the port's sparse GPs (gogp_torch.gp.sparse) with
gogp_tpu.gp.sparse.

The same numpy inputs in float64 go through both packages, at the JAX
tests' sizes (n 16-48, m 4-8).  Values agree to rtol 1e-9, gradients to 1e-8
of their largest entry.  The fits run step for step against JAX's for 20
steps with JAX's own draws handed in through the port's ``SVGPDraws`` hook
(the starting permutation and each step's minibatch indices): their ELBO
traces and final parameters to rtol 1e-9 too.  The blocked route runs
under ``cb.force_blocked(32)`` at m = 64 (K1's and K5's plain versions on
the CPU, with the analytic pullbacks) against JAX's XLA path, the
natural-gradient step's state to 1e-9 of each field's largest entry (the
blocked route's rounding, 2e-11 absolute on entries near 1e-3).  The JAX
side runs under ``jax.jit``: eager, each of its ops compiles per shape.

Titsias's exactness (the bound equals the exact LML at Z = X) is held
against the port's own ``core.lml`` to rtol 1e-8, the JAX test's tolerance:
the jitter of 1e-12 on Kuu moves the bound by about that much.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.gp import sparse as jsparse
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_torch import convert
from gogp_torch.gp import core, likelihoods, sparse
from gogp_torch.infer import mle
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=juniform)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
JGP_CLS = jcore.GP(ndim=1, simil=jrbf.scaled())
TGP_CLS = core.GP(ndim=1, simil=rbf.scaled())
TS, TN = np.exp([0.3, -0.2]), np.exp([-1.0])
E = np.zeros(0)


def _problem(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _classes(n=32, seed=2):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-3 * x[:, 0]))).astype(np.float64)
    return x, y


def _t(a):
    return torch.tensor(np.array(a))


def _jit(fn, *args):
    """``fn(*args)`` compiled once: JAX's eager ops each compile per shape,
    which costs several seconds a test."""
    return jax.jit(fn)(*args)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _grad_close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def _states(x, m, seed=3, scale=0.3):
    """A variational state with a nonzero mean and a full lower factor, in
    both packages."""
    rng = np.random.default_rng(seed)
    z = x[:: x.shape[0] // m][:m]
    q_mu = rng.normal(size=m)
    q_sqrt = np.tril(scale * rng.normal(size=(m, m)), -1) + np.diag(0.5 + rng.uniform(size=m))
    return jsparse.SVGPState(jnp.asarray(z), jnp.asarray(q_mu), jnp.asarray(q_sqrt)), \
        sparse.SVGPState(_t(z), _t(q_mu), _t(q_sqrt))


def _state_close(got, want, tol=TOL):
    for name in sparse.SVGPState._fields:
        _close(getattr(got, name), getattr(want, name), tol)


# -- SGPR --------------------------------------------------------------------


@pytest.mark.parametrize("n,stride,masked", [(24, 3, False), (40, 4, False), (40, 4, True)])
def test_sgpr_elbo_matches_jax(n, stride, masked):
    x, y = _problem(n)
    z = x[::stride]
    mask = None
    if masked:
        mask = np.ones(n)
        mask[-5:] = 0.0
    want = _jit(lambda x, y, z: jsparse.sgpr_elbo(JGP, TS, TN, x, y, z, None if mask is None else jnp.asarray(mask)),
                x, y, z)
    got = sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(z), None if mask is None else _t(mask))
    _close(got, want)


def test_sgpr_fit_and_predict_match_jax():
    x, y = _problem(30)
    z = x[::3]
    t = np.linspace(-1.0, 11.0, 17)[:, None]
    jpost = _jit(lambda x, y, z: jsparse.sgpr_fit(JGP, TS, TN, x, y, z), x, y, z)
    jpred = _jit(lambda post, t: jsparse.sgpr_predict(JGP, post, t), jpost, t)
    post = sparse.sgpr_fit(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(z))
    for name in sparse.SGPRPosterior._fields:
        _close(getattr(post, name), getattr(jpost, name))
    for got, want in zip(sparse.sgpr_predict(TGP, post, _t(t)), jpred):
        _close(got, want)
    # the converted JAX cache serves the same predictions
    carried = convert.sgpr_posterior_from_numpy(jpost, "cpu")
    for got, want in zip(sparse.sgpr_predict(TGP, carried, _t(t)), jpred):
        _close(got, want)


@pytest.mark.parametrize("n,m", [(16, 4), (40, 8)])
def test_sgpr_flat_vector_value_and_grad_match_jax(n, m):
    x, y = _problem(n, seed=1)
    z0 = x[:: n // m][:m]
    v = np.concatenate([np.log(np.r_[TS, TN]), z0.ravel()])
    jlogp = jsparse.make_sgpr_logp(JGP, x, y, m)
    want_v, want_g = _jit(jax.value_and_grad(jlogp), v)
    vt = _t(v).requires_grad_(True)
    got = sparse.make_sgpr_logp(TGP, _t(x), _t(y), m)(vt)
    (g,) = torch.autograd.grad(got, vt)
    _close(got, want_v)
    _grad_close(g, want_g)
    assert torch.equal(sparse.join_sparse_params(TGP, _t(np.log(np.r_[TS, TN])), _t(z0)), _t(v))
    with pytest.raises(ValueError, match="sparse parameter vector length"):
        sparse.split_sparse_params(TGP, _t(v[:-1]), m)


def test_sgpr_titsias_exact_at_z_eq_x():
    """With Z = X the collapsed bound is the exact LML (the port's own), and
    SGPR predicts as the exact GP."""
    x, y = _problem()
    exact = core.lml(TGP, _t(TS), _t(TN), _t(x), _t(y))
    elbo = sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(x), jitter=1e-12)
    np.testing.assert_allclose(float(elbo), float(exact), rtol=1e-8)
    t = _t(np.linspace(-1.0, 11.0, 17)[:, None])
    post = sparse.sgpr_fit(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(x), jitter=1e-12)
    for got, want in zip(sparse.sgpr_predict(TGP, post, t), core.predict(TGP, _t(TS), _t(TN), _t(x), _t(y), t)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    # a bound, tightening as m grows
    x, y = _problem(40)
    exact = float(core.lml(TGP, _t(TS), _t(TN), _t(x), _t(y)))
    e4 = float(sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(x[::4])))
    e2 = float(sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(x[::2])))
    assert e4 < e2 <= exact + 1e-9


def test_sgpr_mask_padding_invariance():
    x, y = _problem(20)
    z = x[::3]
    ref = sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(z))
    xp = np.concatenate([x, np.full((4, 1), 99.0)])
    yp = np.concatenate([y, np.full(4, -7.0)])
    mask = np.r_[np.ones(20), np.zeros(4)]
    padded = sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(xp), _t(yp), _t(z), mask=_t(mask))
    np.testing.assert_allclose(float(padded), float(ref), rtol=1e-10)
    _close(padded, _jit(lambda xp, yp, z, mask: jsparse.sgpr_elbo(JGP, TS, TN, xp, yp, z, mask=mask), xp, yp, z, mask))


# -- SVGP --------------------------------------------------------------------


@pytest.mark.parametrize("form", ["gaussian", "laplace", "callable"])
@pytest.mark.parametrize("n_total,masked", [(None, False), (96, True)])
def test_svgp_elbo_matches_jax(form, n_total, masked):
    x, y = _problem(18)
    jstate, tstate = _states(x, 6)
    mask = None
    if masked:
        mask = np.ones(18)
        mask[:3] = 0.0
    jlike = tlike = None
    if form == "laplace":
        jlike, tlike = jlik.laplace_noise.for_svgp([0.3]), likelihoods.laplace_noise.for_svgp([0.3])
    elif form == "callable":
        s = TN[0] ** 2

        def jlike(yi, fi):
            return -0.5 * (jnp.log(2 * jnp.pi * s) + (yi - fi) ** 2 / s)

        def tlike(yi, fi):
            return -0.5 * (np.log(2 * np.pi * s) + (yi - fi) ** 2 / s)

    want = _jit(lambda st, x, y: jsparse.svgp_elbo(JGP, TS, TN, st, x, y, n_total=n_total,
                                                   mask=None if mask is None else jnp.asarray(mask),
                                                   likelihood=jlike), jstate, x, y)
    got = sparse.svgp_elbo(TGP, _t(TS), _t(TN), tstate, _t(x), _t(y), n_total=n_total,
                           mask=None if mask is None else _t(mask), likelihood=tlike)
    _close(got, want)


def test_svgp_gauss_hermite_equals_closed_form():
    x, y = _problem(18)
    _, state = _states(x, 6)
    s = TN[0] ** 2

    def gauss(yi, fi):
        return -0.5 * (np.log(2 * np.pi * s) + (yi - fi) ** 2 / s)

    analytic = sparse.svgp_elbo(TGP, _t(TS), _t(TN), state, _t(x), _t(y))
    quad = sparse.svgp_elbo(TGP, _t(TS), _t(TN), state, _t(x), _t(y), likelihood=gauss, quad_order=30)
    np.testing.assert_allclose(float(quad), float(analytic), rtol=1e-9)


def test_svgp_elbo_gradient_matches_jax():
    x, y = _problem(18)
    jstate, tstate = _states(x, 6)
    lik_j, lik_t = jlik.laplace_noise.for_svgp([0.3]), likelihoods.laplace_noise.for_svgp([0.3])

    def jfn(lt, z, q_mu, q_sqrt):
        th = jnp.exp(lt)
        return jsparse.svgp_elbo(JGP, th[:2], th[2:], jsparse.SVGPState(z, q_mu, q_sqrt), x, y, n_total=50,
                                 likelihood=lik_j)

    lt = np.log(np.r_[TS, TN])
    want = _jit(jax.grad(jfn, argnums=(0, 1, 2, 3)), lt, *jstate)
    leaves = [_t(lt).requires_grad_(True)] + [f.clone().requires_grad_(True) for f in tstate]
    th = torch.exp(leaves[0])
    got = sparse.svgp_elbo(TGP, th[:2], th[2:], sparse.SVGPState(*leaves[1:]), _t(x), _t(y), n_total=50,
                           likelihood=lik_t)
    for g, w in zip(torch.autograd.grad(got, leaves), want):
        _grad_close(g, w)


def test_svgp_predict_and_optimal_state_match_jax():
    x, y = _problem(30)
    z = x[::3]
    t = np.linspace(0.0, 10.0, 13)[:, None]
    jopt = _jit(lambda x, y, z: jsparse.svgp_optimal_state(JGP, TS, TN, x, y, z), x, y, z)
    jpred = _jit(lambda st, t: jsparse.svgp_predict(JGP, TS, st, t), jopt, t)
    opt = sparse.svgp_optimal_state(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(z))
    _state_close(opt, jopt)
    for got, want in zip(sparse.svgp_predict(TGP, _t(TS), opt, _t(t)), jpred):
        _close(got, want)
    # its ELBO is SGPR's bound, and any other q is worse
    e_opt = sparse.svgp_elbo(TGP, _t(TS), _t(TN), opt, _t(x), _t(y))
    np.testing.assert_allclose(float(e_opt), float(sparse.sgpr_elbo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(z))),
                               rtol=1e-8)
    other = opt._replace(q_mu=opt.q_mu + 0.1)
    assert float(sparse.svgp_elbo(TGP, _t(TS), _t(TN), other, _t(x), _t(y))) < float(e_opt)
    # the converted JAX state predicts the same
    carried = convert.svgp_state_from_numpy(jopt, "cpu")
    _close(sparse.svgp_predict(TGP, _t(TS), carried, _t(t))[1], jpred[1])


def test_svgp_init_and_kl():
    x, _ = _problem(12)
    state = sparse.svgp_init(TGP, _t(x[::3]))
    assert state.q_mu.dtype == torch.float64 and torch.equal(state.q_sqrt, torch.eye(4, dtype=torch.float64))
    assert float(sparse.kl_whitened(state.q_mu, state.q_sqrt)) == 0.0
    jstate, tstate = _states(x, 4)
    _close(sparse.kl_whitened(tstate.q_mu, tstate.q_sqrt), jsparse.kl_whitened(jstate.q_mu, jstate.q_sqrt))


def test_svgp_minibatch_rescaling_is_unbiased():
    x, y = _problem(32)
    _, state = _states(x, 8)
    args = (TGP, _t(TS), _t(TN), state)
    full = sparse.svgp_elbo(*args, _t(x), _t(y))
    b1 = sparse.svgp_elbo(*args, _t(x[:16]), _t(y[:16]), n_total=32)
    b2 = sparse.svgp_elbo(*args, _t(x[16:]), _t(y[16:]), n_total=32)
    np.testing.assert_allclose(float(b1 + b2), 2 * float(full), rtol=1e-10)


# -- natural gradients ------------------------------------------------------


@pytest.mark.parametrize("start", ["init", "state"])
@pytest.mark.parametrize("family", ["gaussian", "bernoulli_logit"])
def test_natgrad_step_matches_jax(family, start):
    if family == "gaussian":
        x, y = _problem(40, seed=1)
        jgp, tgp, ts, tn, jlike, tlike, gamma = JGP, TGP, TS, TN, None, None, 1.0
    else:
        x, y = _classes()
        jgp, tgp, ts, tn, gamma = JGP_CLS, TGP_CLS, np.array([2.0, 1.0]), E, 0.5
        jlike, tlike = jlik.bernoulli_logit.for_svgp(E), likelihoods.bernoulli_logit.for_svgp(E)
    if start == "init":
        z = x[::5]
        jstate, tstate = jsparse.svgp_init(jgp, z, dtype=jnp.float64), sparse.svgp_init(tgp, _t(z))
    else:
        jstate, tstate = _states(x, 8)
    want = _jit(lambda st, x, y: jsparse.svgp_natgrad_step(jgp, ts, tn, st, x, y, gamma, n_total=60,
                                                           likelihood=jlike), jstate, x, y)
    got = sparse.svgp_natgrad_step(tgp, _t(ts), _t(tn), tstate, _t(x), _t(y), gamma, n_total=60, likelihood=tlike)
    _state_close(got, want)


def test_natgrad_gaussian_one_step_is_optimal():
    """gamma = 1, the whole batch, a Gaussian likelihood: one step from the
    KL-zero start lands on svgp_optimal_state, and a second stays there."""
    x, y = _problem(48, seed=1)
    z = x[::6]
    args = (TGP, _t(TS), _t(TN))
    stepped = sparse.svgp_natgrad_step(*args, sparse.svgp_init(TGP, _t(z)), _t(x), _t(y), 1.0)
    e_opt = float(sparse.svgp_elbo(*args, sparse.svgp_optimal_state(*args, _t(x), _t(y), _t(z)), _t(x), _t(y)))
    np.testing.assert_allclose(float(sparse.svgp_elbo(*args, stepped, _t(x), _t(y))), e_opt, atol=1e-9)
    again = sparse.svgp_natgrad_step(*args, stepped, _t(x), _t(y), 1.0)
    np.testing.assert_allclose(float(sparse.svgp_elbo(*args, again, _t(x), _t(y))), e_opt, atol=1e-9)


# -- the fits, step for step with JAX's draws -------------------------------

ITERS = 20


def _jax_draws(seed, n, batch, iters=ITERS):
    """The permutation and minibatch indices JAX's svgp_fit draws from
    PRNGKey(seed), as the port's draws hook."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    perm = np.asarray(jax.random.permutation(sub, n))
    idx = [np.asarray(jax.random.randint(k, (batch,), 0, n)) for k in jax.random.split(key, iters)]
    return sparse.SVGPDraws(perm=lambda n_: torch.tensor(perm), batch=lambda step, n_, b: torch.tensor(idx[step]))


def _params_close(got, want, tol=TOL):
    _close(got.log_theta, want.log_theta, tol)
    _state_close(got.state, want.state, tol)


FIT_CASES = {
    "adam": dict(batch=16, rate=0.05),
    "adam_fixed_theta": dict(batch=16, rate=0.05, train_theta=False),
    "adam_laplace": dict(batch=16, rate=0.05, likelihood="laplace"),
    "adam_full_batch": dict(rate=0.05),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_svgp_fit_step_for_step(case):
    cfg = dict(FIT_CASES[case])
    x, y = _problem(48, seed=5)
    lt0 = np.log(np.r_[TS, TN])
    jlike = tlike = None
    if cfg.pop("likelihood", None):
        jlike, tlike = jlik.laplace_noise.for_svgp([0.3]), likelihoods.laplace_noise.for_svgp([0.3])
    jparams, jtrace = jsparse.svgp_fit(JGP, x, y, m=8, key=jax.random.PRNGKey(0), iters=ITERS, log_theta0=lt0,
                                       likelihood=jlike, **cfg)
    draws = _jax_draws(0, 48, cfg.get("batch") or 48)
    params, trace = sparse.svgp_fit(TGP, _t(x), _t(y), m=8, iters=ITERS, log_theta0=_t(lt0), likelihood=tlike,
                                    draws=draws, **cfg)
    _close(trace, jtrace)
    _params_close(params, jparams)
    if not cfg.get("train_theta", True):
        assert torch.equal(params.log_theta, _t(lt0))
    assert torch.equal(convert.svgp_params_from_numpy(jparams, "cpu").log_theta, _t(jparams.log_theta))


@pytest.mark.parametrize("train_theta", [True, False])
def test_svgp_fit_natgrad_step_for_step(train_theta):
    x, y = _problem(48, seed=3)
    jparams, jtrace = jsparse.svgp_fit_natgrad(JGP, x, y, m=8, key=jax.random.PRNGKey(1), iters=ITERS, batch=16,
                                               gamma=0.5, rate=0.05, train_theta=train_theta)
    params, trace = sparse.svgp_fit_natgrad(TGP, _t(x), _t(y), m=8, iters=ITERS, batch=16, gamma=0.5, rate=0.05,
                                            train_theta=train_theta, draws=_jax_draws(1, 48, 16))
    _close(trace, jtrace)
    _params_close(params, jparams)


def test_svgp_fit_stream_step_for_step():
    x, y = _problem(48, seed=4)
    rng = np.random.default_rng(9)
    batches = [(x[i], y[i]) for i in (rng.integers(0, 48, 12) for _ in range(ITERS))]
    z0 = x[::6]
    jparams, jtrace = jsparse.svgp_fit_stream(JGP, iter(batches), 48, 8, z0, iters=ITERS, rate=0.05)
    params, trace = sparse.svgp_fit_stream(TGP, iter(batches), 48, 8, z0, iters=ITERS, rate=0.05, device="cpu")
    assert trace.dtype == torch.float64 and params.state.z.device.type == "cpu"
    _close(trace, jtrace)
    _params_close(params, jparams)
    with pytest.raises(ValueError, match="z0 rows"):
        sparse.svgp_fit_stream(TGP, iter(batches), 48, 7, z0, iters=1, device="cpu")


def test_svgp_fit_generator_draws_and_training():
    """Without a hook the fit draws from a generator: a seed repeats the fit,
    and training raises the ELBO."""
    x, y = _problem(48, seed=5)
    runs = [sparse.svgp_fit(TGP, _t(x), _t(y), m=8, rng=torch.Generator().manual_seed(7), iters=60, batch=16,
                            rate=0.05) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    trace = runs[0][1]
    assert float(trace[-10:].mean()) > float(trace[0])


# -- the blocked route (K1's and K5's plain versions) ------------------------


def _counting(*names):
    """Patch each of cb's ``names`` with a wrapper that counts its calls."""
    counts = dict.fromkeys(names, 0)
    patches = []
    for name in names:
        real = getattr(cb, name)

        def wrapped(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        patches.append(unittest.mock.patch.object(cb, name, wrapped))
    return counts, patches


def test_sgpr_gradient_blocked_route_matches_jax():
    x, y = _problem(128, seed=6)
    m = 64
    z0 = x[::2]
    v = np.concatenate([np.log(np.r_[TS, TN]), z0.ravel()])
    want_v, want_g = _jit(jax.value_and_grad(jsparse.make_sgpr_logp(JGP, x, y, m)), v)
    counts, patches = _counting("fused_cholesky_invs", "blocked_trsm_lower", "blocked_trsm_lower_t")
    with cb.force_blocked(32), patches[0], patches[1], patches[2]:
        vt = _t(v).requires_grad_(True)
        got = sparse.make_sgpr_logp(TGP, _t(x), _t(y), m)(vt)
        (g,) = torch.autograd.grad(got, vt)
    # K1 for Kuu and B; the TRSMs forward; each Cholesky pullback's two
    # transposed TRSMs and each TRSM pullback's one
    assert counts == {"fused_cholesky_invs": 2, "blocked_trsm_lower": 2, "blocked_trsm_lower_t": 2 * 2 + 2}
    _close(got, want_v)
    _grad_close(g, want_g)


def test_natgrad_step_blocked_route_matches_jax():
    x, y = _problem(128, seed=6)
    z = x[::2]
    jstate = jsparse.svgp_init(JGP, z, dtype=jnp.float64)
    want = _jit(lambda st, x, y: jsparse.svgp_natgrad_step(JGP, TS, TN, st, x, y, 0.7), jstate, x, y)
    counts, patches = _counting("fused_cholesky_invs")
    with cb.force_blocked(32), patches[0]:
        got = sparse.svgp_natgrad_step(TGP, _t(TS), _t(TN), sparse.svgp_init(TGP, _t(z)), _t(x), _t(y), 0.7)
    assert counts["fused_cholesky_invs"] == 5  # Kuu, S twice, P_new, S_new
    for name in sparse.SVGPState._fields:  # a blocked route's rounding: to 1e-9 of each field's largest entry
        _grad_close(getattr(got, name), getattr(want, name), 1e-9)


def test_sgpr_logp_drives_mle_adam():
    """make_sgpr_logp under the house optimizer moves thetas and Z, as JAX's
    Adam does (10 steps, to rtol 1e-8)."""
    from gogp_tpu.infer import mle as jmle

    x, y = _problem(40, seed=3)
    m = 6
    v0 = np.concatenate([np.zeros(3), x[:: 40 // m][:m].ravel()])
    want = jmle.adam(jax.jit(jax.value_and_grad(jsparse.make_sgpr_logp(JGP, x, y, m))), jnp.asarray(v0), iters=10,
                     rate=0.05)
    logp = sparse.make_sgpr_logp(TGP, _t(x), _t(y), m)

    def value_and_grad(v):
        v = v.detach().requires_grad_(True)
        val = logp(v)
        return val.detach(), torch.autograd.grad(val, v)[0]

    got = mle.adam(value_and_grad, _t(v0), iters=10, rate=0.05)
    _close(got.x, want.x)
    assert float(got.value) > float(logp(_t(v0)))


def test_exports_match_jax():
    """``gogp_torch.gp`` exports the sparse and Student-t names that
    ``gogp_tpu.gp`` does, from the twin modules; ``gogp_torch.kernels`` the
    deep and multi-output ones."""
    import gogp_tpu.gp as jgp
    import gogp_tpu.kernels as jkernels
    from gogp_tpu.gp import tprocess as jtp

    import gogp_torch.gp as tgp
    import gogp_torch.kernels as tkernels
    from gogp_torch.gp import tprocess

    for jsub, tsub in ((jsparse, sparse), (jtp, tprocess)):
        names = [n for n, v in vars(jgp).items() if not n.startswith("_") and v is getattr(jsub, n, None)]
        assert names and all(getattr(tgp, n) is getattr(tsub, n) for n in names), names
    for n in ("deep", "icm", "lmc", "stack_tasks", "task_inputs", "init_icm_theta"):
        assert hasattr(jkernels, n) and hasattr(tkernels, n), n
