"""Parity of the port's parallel EP (gogp_torch.gp.ep) with gogp_tpu.gp.ep.

Float64 on the CPU, the same numpy data through both.  The fit's sites and
factor agree to rtol 1e-9 (atol 1e-12) and the sweeps are JAX's (the trip
count of its ``while_loop``); the LML to rtol 1e-9 and its gradient to 1e-8
of its largest entry; the tilted moments, predictions, class probabilities,
the serving bridge and ``make_ep_logp`` to rtol 1e-9.  The prefix-masked
batch is held against ``jax.vmap`` row by row, with each row's sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_laplace import jax_loop_count, one_torch_thread  # noqa: F401 (an autouse fixture)

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import ep as jep
from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.kernels import rbf as jrbf
from gogp_torch.gp import core, ep, laplace, likelihoods, serve
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled())
TGP = core.GP(ndim=1, simil=rbf.scaled())
TS = np.array([1.3, 0.8])
E = np.zeros(0)


def _data(n=26, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = (np.sin(x) + 0.4 * rng.normal(size=n) > 0).astype(float)
    mask = np.ones(n)
    mask[-3:] = 0.0
    return x, y, mask


def _t(a):
    return torch.tensor(np.array(a))


def _liks(name):
    return getattr(jlik, name), getattr(likelihoods, name)


def jax_sweeps(jl, tl, K, y, mask, max_sweeps=60, tol=1e-8, damping=0.7, order=32):
    return jax_loop_count(jep._ep_sweeps, jl, tl, K, y, mask, max_sweeps, tol, damping, order, None)


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit"])
def test_fit_matches_jax(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    want = jep.ep_fit(JGP, jl, TS, E, x, y, mask=mask)
    got = ep.ep_fit(TGP, tl, _t(TS), _t(E), _t(x), _t(y), mask=_t(mask))
    for field in jep.EPPosterior._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)), **TOL,
                                   err_msg=field)
    K = jcore.masked_cov(JGP, jnp.asarray(TS), jnp.zeros(0), jnp.asarray(x)[:, None], jnp.asarray(mask))
    assert int(got.sweeps) == jax_sweeps(jl, jnp.zeros(0), K, jnp.asarray(y), jnp.asarray(mask))


@pytest.mark.parametrize("name,theta", [("bernoulli_logit", []), ("bernoulli_probit", []), ("gaussian", [0.4]),
                                        ("student_t", [0.5, 3.0])])
def test_tilted_moments_match_jax(name, theta):
    """Closed forms (gaussian, probit) and Gauss-Hermite (the others)."""
    jl, tl = _liks(name)
    rng = np.random.default_rng(1)
    y = (rng.uniform(size=9) < 0.5).astype(float) if "bernoulli" in name else rng.normal(size=9)
    mu_c, s2_c = rng.normal(size=9), rng.uniform(0.1, 3.0, size=9)
    want = jep._tilted_moments(jl, jnp.asarray(theta, dtype=jnp.float64), jnp.asarray(y), jnp.asarray(mu_c),
                               jnp.asarray(s2_c), 32)
    got = ep._tilted_moments(tl, _t(np.asarray(theta, dtype=float)), _t(y), _t(mu_c), _t(s2_c), 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit"])
def test_lml_value_and_gradient(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    want, g = jax.value_and_grad(lambda ts: jep.ep_lml(JGP, jl, ts, E, x, y, mask=mask))(jnp.asarray(TS))
    ts = _t(TS).requires_grad_(True)
    got = ep.ep_lml(TGP, tl, ts, _t(E), _t(x), _t(y), mask=_t(mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-9)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(g), rtol=0, atol=1e-8 * np.abs(np.asarray(g)).max())


def test_gaussian_ep_is_the_exact_lml():
    """EP is exact for the Gaussian likelihood: ep_lml is gp.lml with noise
    variance sigma^2 (plus the default jitter)."""
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0, 5, 14))
    y = np.sin(x) + 0.2 * rng.normal(size=14)
    sigma = 0.3
    got = ep.ep_lml(TGP, likelihoods.gaussian, _t(TS), _t([sigma]), _t(x), _t(y))
    want = core.lml(core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise), _t(TS),
                    _t([np.sqrt(sigma * sigma + 1e-10)]), _t(x), _t(y))
    assert float(got) == pytest.approx(float(want), rel=1e-8)
    jwant = jep.ep_lml(JGP, jlik.gaussian, TS, np.array([sigma]), x, y)
    assert float(got) == pytest.approx(float(jwant), rel=1e-9)


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit"])
def test_predict_serving_and_logp_match_jax(name):
    jl, tl = _liks(name)
    x, y, mask = _data()
    z = np.linspace(-1, 11, 7)
    pj = jep.ep_fit(JGP, jl, TS, E, x, y, mask=mask)
    pt = ep.ep_fit(TGP, tl, _t(TS), _t(E), _t(x), _t(y), mask=_t(mask))
    for g, w in zip(ep.ep_predict(TGP, pt, _t(z)), jep.ep_predict(JGP, pj, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    prob = ep.ep_predict_prob(TGP, tl, pt, _t(z))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jep.ep_predict_prob(JGP, jl, pj, z)), **TOL)
    sj, st = jep.compile_ep_serving(JGP, pj), ep.compile_ep_serving(TGP, pt)
    for field in serve.ServingPosterior._fields:
        np.testing.assert_allclose(getattr(st, field).numpy(), np.asarray(getattr(sj, field)), **TOL, err_msg=field)
    np.testing.assert_allclose(laplace.serve_predict_prob(TGP, tl, st, _t(E), _t(z)).numpy(), prob.numpy(), **TOL)
    jlogp, _ = jep.make_ep_logp(JGP, jl, x, y, mask)
    tlogp, n_params = ep.make_ep_logp(TGP, tl, _t(x), _t(y), _t(mask))
    assert n_params == 2
    v = np.array([0.1, -0.2])
    want, g = jax.value_and_grad(jlogp)(jnp.asarray(v))
    vt = _t(v).requires_grad_(True)
    got = tlogp(vt)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-9)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g), rtol=0, atol=1e-8 * np.abs(np.asarray(g)).max())


def test_blocked_route_matches_plain():
    """n = 256 under force_blocked(128): B's blocked Cholesky with its
    pullback and the blocked TRSM of every sweep's marginals."""
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 40, 256))
    y = (np.sin(x / 3) + 0.3 * rng.normal(size=256) > 0).astype(float)
    lik = likelihoods.bernoulli_probit

    def run():
        ts = _t(TS).requires_grad_(True)
        val = ep.ep_lml(TGP, lik, ts, _t(E), _t(x), _t(y), max_sweeps=8)
        val.backward()
        return val.detach(), ts.grad

    want = run()
    with cb.force_blocked(128):
        got = run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12)


def test_prefix_batch_matches_jax_vmap():
    """Every prefix at once, one mask a row, against jax.vmap of ep_lml,
    with each row's sweeps (short prefixes stop first, frozen)."""
    x, y, _ = _data(n=16, seed=6)
    n = x.size
    masks = (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(float)
    thetas = TS[None, :] * np.exp(0.1 * np.random.default_rng(7).normal(size=(n, 2)))
    jl, tl = _liks("bernoulli_probit")
    want = jax.vmap(lambda t, m: jep.ep_lml(JGP, jl, t, E, x, y, mask=m))(jnp.asarray(thetas), jnp.asarray(masks))
    empty = torch.zeros(n, 0, dtype=torch.float64)
    got = ep.ep_lml(TGP, tl, _t(thetas), empty, _t(x), _t(y), mask=_t(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    post = ep.ep_fit(TGP, tl, _t(thetas), empty, _t(x), _t(y), mask=_t(masks))
    sweeps = post.sweeps.numpy()
    assert len(set(sweeps.tolist())) > 1
    for r in (0, 4, n - 1):
        K = jcore.masked_cov(JGP, jnp.asarray(thetas[r]), jnp.zeros(0), jnp.asarray(x)[:, None],
                             jnp.asarray(masks[r]))
        assert sweeps[r] == jax_sweeps(jl, jnp.zeros(0), K, jnp.asarray(y), jnp.asarray(masks[r]))
