"""Parity of the port's Laplace approximation (gogp_torch.gp.laplace) with
gogp_tpu.gp.laplace.

Float64 on the CPU, the same numpy data through both.  The fit's fields
agree to rtol 1e-9 (atol 1e-12) and the Newton loop takes JAX's iterations
(counted as the smallest ``max_iters`` at which JAX's ``_newton_solve``
returns its converged mode bit for bit).  The LML to rtol 1e-9, its
gradient to 1e-8 of its largest entry; predictions, class probabilities,
the serving bridge and ``make_laplace_logp`` to rtol 1e-9.

Where a batch (one-vs-rest) is held against ``jax.vmap``, the fields that
depend on the Newton iterate at which the tolerance stops (grad_ll, the
predictions) are held to rtol 1e-7: psi's tolerance fixes that iterate only
to about 1e-9, and a batch and a single fit may pick different steps of the
grid among trial objectives that tie to rounding (JAX's own vmapped and
single fits of one class differ by 1.3e-9 in grad_ll).

The prefix-masked batch is held against ``jax.vmap``: every row's LML and
its Newton iterations; the mode of the batch against each row alone.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import laplace as jlap
from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.gp import serve as jserve
from gogp_tpu.kernels import rbf as jrbf
from gogp_torch.gp import core, laplace, likelihoods, serve
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled())
TGP = core.GP(ndim=1, simil=rbf.scaled())
TS = np.array([1.4, 0.9])
E = np.zeros(0)
LIKS = ["bernoulli_logit", "bernoulli_probit"]


def _data(n=28, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = (np.sin(x) + 0.4 * rng.normal(size=n) > 0).astype(float)
    mask = np.ones(n)
    mask[-3:] = 0.0
    return x, y, mask


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: many small batched ops, which a pool of threads
    slows down on a loaded CPU (the suite runs six workers).  Restored
    afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.tensor(np.array(a))


def _liks(name):
    return getattr(jlik, name), getattr(likelihoods, name)


def jax_loop_count(fn, *args, **kwargs):
    """The trip count of the one ``lax.while_loop`` that ``fn`` runs: the
    counter its final state carries last (JAX's Newton and EP loops)."""
    states = []
    real = jax.lax.while_loop

    def recording(cond, body, init):
        out = real(cond, body, init)
        states.append(out)
        return out

    with unittest.mock.patch.object(jax.lax, "while_loop", recording):
        fn(*args, **kwargs)
    (state,) = states
    return int(state[-1])


def jax_newton_iters(jl, tl, K, y, mask, max_iters=40, tol=1e-9):
    return jax_loop_count(jlap._newton_solve, jl, tl, K, y, mask, max_iters, tol)


@pytest.mark.parametrize("name", LIKS)
def test_fit_matches_jax(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    want = jlap.laplace_fit(JGP, jl, TS, E, x, y, mask=mask)
    got = laplace.laplace_fit(TGP, tl, _t(TS), _t(E), _t(x), _t(y), mask=_t(mask))
    for field in jlap.LaplacePosterior._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), **TOL,
                                   err_msg=field)
    K = jcore.masked_cov(JGP, jnp.asarray(TS), jnp.zeros(0), jnp.asarray(x)[:, None], jnp.asarray(mask))
    assert int(got.iters) == jax_newton_iters(jl, jnp.zeros(0), K, jnp.asarray(y), jnp.asarray(mask))


def test_student_t_fit_matches_jax():
    """A non-log-concave likelihood: W clipped, the step grid's line search
    at work."""
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 6, 20))
    y = np.sin(x) + 0.1 * rng.standard_t(2.0, size=20)
    th = np.array([0.3, 2.5])
    want = jlap.laplace_fit(JGP, jlik.student_t, TS, th, x, y)
    got = laplace.laplace_fit(TGP, likelihoods.student_t, _t(TS), _t(th), _t(x), _t(y))
    np.testing.assert_allclose(got.f_hat.numpy(), np.asarray(want.f_hat), **TOL)
    K = jcore.masked_cov(JGP, jnp.asarray(TS), jnp.zeros(0), jnp.asarray(x)[:, None], None)
    assert int(got.iters) == jax_newton_iters(jlik.student_t, jnp.asarray(th), K, jnp.asarray(y), jnp.ones(20))


@pytest.mark.parametrize("name", LIKS + ["poisson"])
def test_lml_value_and_gradient(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    if name == "poisson":
        y = np.random.default_rng(1).poisson(2.0, size=x.size).astype(float)
    want, g = jax.value_and_grad(lambda ts: jlap.laplace_lml(JGP, jl, ts, E, x, y, mask=mask))(jnp.asarray(TS))
    ts = _t(TS).requires_grad_(True)
    got = laplace.laplace_lml(TGP, tl, ts, _t(E), _t(x), _t(y), mask=_t(mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-9)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(g), rtol=0, atol=1e-8 * np.abs(np.asarray(g)).max())


def test_gaussian_lml_is_the_exact_lml():
    """With the Gaussian likelihood the approximation is exact: laplace_lml
    equals gp.lml with noise variance sigma^2, value and gradient."""
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0, 5, 16))
    y = np.sin(x) + 0.2 * rng.normal(size=16)
    sigma = 0.3
    gp_noisy = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    ts = _t(TS).requires_grad_(True)
    got = laplace.laplace_lml(TGP, likelihoods.gaussian, ts, _t([sigma]), _t(x), _t(y))
    got.backward()
    ts2 = _t(TS).requires_grad_(True)
    want = core.lml(gp_noisy, ts2, _t([np.sqrt(sigma * sigma + 1e-10)]), _t(x), _t(y))  # K + (sigma^2 + jitter) I
    want.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-8)
    np.testing.assert_allclose(ts.grad.numpy(), ts2.grad.numpy(), rtol=1e-6)
    jwant, jg = jax.value_and_grad(lambda t: jlap.laplace_lml(JGP, jlik.gaussian, t, jnp.asarray([sigma]), x, y))(
        jnp.asarray(TS))
    assert float(got.detach()) == pytest.approx(float(jwant), rel=1e-9)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), rtol=1e-8)


@pytest.mark.parametrize("name", LIKS)
def test_predict_and_prob_match_jax(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    z = np.linspace(-1, 11, 7)
    pj = jlap.laplace_fit(JGP, jl, TS, E, x, y, mask=mask)
    pt = laplace.laplace_fit(TGP, tl, _t(TS), _t(E), _t(x), _t(y), mask=_t(mask))
    for g, w in zip(laplace.laplace_predict(TGP, pt, _t(z)), jlap.laplace_predict(JGP, pj, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(laplace.laplace_predict_prob(TGP, tl, pt, _t(z)).numpy(),
                               np.asarray(jlap.laplace_predict_prob(JGP, jl, pj, z)), **TOL)


def test_predict_expect_matches_jax():
    mu, var = np.array([0.3, -1.2, 2.0]), np.array([0.5, 0.0, 2.5])
    want = jlap.predict_expect(jnp.tanh, jnp.asarray(mu), jnp.asarray(var), order=20)
    got = laplace.predict_expect(torch.tanh, _t(mu), _t(var), order=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", LIKS)
def test_serving_bridge_matches_jax(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    z = np.linspace(-1, 11, 7)
    pj = jlap.laplace_fit(JGP, jl, TS, E, x, y, mask=mask)
    pt = laplace.laplace_fit(TGP, tl, _t(TS), _t(E), _t(x), _t(y), mask=_t(mask))
    sj, st = jlap.compile_laplace_serving(JGP, pj), laplace.compile_laplace_serving(TGP, pt)
    for field in serve.ServingPosterior._fields:
        np.testing.assert_allclose(getattr(st, field).numpy(), np.asarray(getattr(sj, field)), **TOL, err_msg=field)
    want = jlap.serve_predict_prob(JGP, jl, sj, E, z)
    got = laplace.serve_predict_prob(TGP, tl, st, _t(E), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the cache serves what the posterior predicts
    np.testing.assert_allclose(got.numpy(), laplace.laplace_predict_prob(TGP, tl, pt, _t(z)).numpy(), **TOL)
    for g, w in zip(serve.serve_predict(TGP, st, _t(z)), jserve.serve_predict(JGP, sj, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_blocked_route_matches_plain():
    """At n = 256 under force_blocked(128): B's factor through the blocked
    Cholesky and its pullback, the predictions through the blocked TRSM,
    the serving inverse through blocked_tril_inv."""
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 40, 256))
    y = (np.sin(x / 3) + 0.3 * rng.normal(size=256) > 0).astype(float)
    z = np.linspace(0, 40, 9)
    lik = likelihoods.bernoulli_logit

    def run():
        ts = _t(TS).requires_grad_(True)
        val = laplace.laplace_lml(TGP, lik, ts, _t(E), _t(x), _t(y))
        val.backward()
        post = laplace.laplace_fit(TGP, lik, _t(TS), _t(E), _t(x), _t(y))
        sp = laplace.compile_laplace_serving(TGP, post)
        return val.detach(), ts.grad, laplace.laplace_predict_prob(TGP, lik, post, _t(z)), \
            laplace.serve_predict_prob(TGP, lik, sp, _t(E), _t(z))

    want = run()
    with cb.force_blocked(128):
        got = run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12)


def test_ovr_matches_jax():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 9, 24))
    labels = np.minimum((x // 3).astype(int) + (rng.uniform(size=24) < 0.15), 2)
    thetas = np.array([[1.2, 0.8], [0.9, 1.1], [1.5, 0.7]])
    z = np.linspace(0, 9, 6)
    jl, tl = _liks("bernoulli_logit")
    for th in (TS, thetas):
        pj = jlap.laplace_fit_ovr(JGP, jl, th, E, x, labels, 3)
        pt = laplace.laplace_fit_ovr(TGP, tl, _t(th), _t(E), _t(x), _t(labels), 3)
        np.testing.assert_allclose(pt.f_hat.numpy(), np.asarray(pj.f_hat), **TOL)
        np.testing.assert_allclose(pt.grad_ll.numpy(), np.asarray(pj.grad_ll), rtol=1e-7, atol=1e-10)
        want = jlap.laplace_predict_ovr(JGP, jl, pj, z)
        got = laplace.laplace_predict_ovr(TGP, tl, pt, _t(z))
        assert got.shape == (6, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-14)


def test_make_laplace_logp_matches_jax():
    x, y, mask = _data()
    jl, tl = _liks("bernoulli_probit")
    jlogp, jn = jlap.make_laplace_logp(JGP, jl, x, y, mask)
    tlogp, tn = laplace.make_laplace_logp(TGP, tl, _t(x), _t(y), _t(mask))
    assert tn == jn == 2
    v = np.array([0.2, -0.3])
    want, g = jax.value_and_grad(jlogp)(jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    got = tlogp(vt)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-9)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g), rtol=0, atol=1e-8 * np.abs(np.asarray(g)).max())


def test_prefix_batch_matches_jax_vmap():
    """Every prefix of the data at once, one mask a row: the port's lockstep
    batch against jax.vmap of laplace_lml, row by row, with each row's
    Newton iterations (the short prefixes stop first and stay frozen)."""
    x, y, _ = _data(n=20, seed=6)
    n = x.size
    masks = (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(float)
    thetas = TS[None, :] * np.exp(0.1 * np.random.default_rng(7).normal(size=(n, 2)))
    jl, tl = _liks("bernoulli_logit")
    want = jax.vmap(lambda t, m: jlap.laplace_lml(JGP, jl, t, E, x, y, mask=m))(jnp.asarray(thetas),
                                                                                 jnp.asarray(masks))
    got = laplace.laplace_lml(TGP, tl, _t(thetas), torch.zeros(n, 0, dtype=torch.float64), _t(x), _t(y),
                              mask=_t(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    post = laplace.laplace_fit(TGP, tl, _t(thetas), torch.zeros(n, 0, dtype=torch.float64), _t(x), _t(y),
                               mask=_t(masks))
    iters = post.iters.numpy()
    assert iters[0] == 1 and len(set(iters.tolist())) > 1  # rows stop at different iterations
    for r in (0, 5, n - 1):
        K = jcore.masked_cov(JGP, jnp.asarray(thetas[r]), jnp.zeros(0), jnp.asarray(x)[:, None],
                             jnp.asarray(masks[r]))
        assert iters[r] == jax_newton_iters(jl, jnp.zeros(0), K, jnp.asarray(y), jnp.asarray(masks[r]))
        alone = laplace.laplace_fit(TGP, tl, _t(thetas[r]), _t(E), _t(x), _t(y), mask=_t(masks[r]))
        np.testing.assert_allclose(post.f_hat[r].numpy(), alone.f_hat.numpy(), rtol=1e-12, atol=1e-14)


def test_jax_posterior_converts():
    """A JAX LaplacePosterior and EPPosterior, carried over as numpy, predict
    what the JAX package predicts; a likelihood theta converts to 1-D."""
    from gogp_tpu.gp import ep as jep
    from gogp_torch import convert
    from gogp_torch.gp import ep

    x, y, mask = _data()
    z = np.linspace(-1, 11, 5)
    jl, tl = _liks("bernoulli_logit")
    pj = jlap.laplace_fit(JGP, jl, TS, E, x, y, mask=mask)
    pt = convert.laplace_posterior_from_numpy(pj, "cpu")
    assert pt.iters is None
    np.testing.assert_allclose(laplace.laplace_predict_prob(TGP, tl, pt, _t(z)).numpy(),
                               np.asarray(jlap.laplace_predict_prob(JGP, jl, pj, z)), **TOL)
    ej = jep.ep_fit(JGP, jl, TS, E, x, y, mask=mask)
    et = convert.ep_posterior_from_numpy(ej, "cpu")
    np.testing.assert_allclose(ep.ep_predict_prob(TGP, tl, et, _t(z)).numpy(),
                               np.asarray(jep.ep_predict_prob(JGP, jl, ej, z)), **TOL)
    assert convert.likelihood_theta_from_numpy(np.float64(0.5), "cpu").shape == (1,)
