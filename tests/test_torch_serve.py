"""Parity of the port's serving caches (gogp_torch.gp.serve) and of
``linalg.tril_inv`` with the JAX package.

The same numpy inputs in float64 go through both packages.  ``tril_inv``:
the plain route against JAX's ``linalg.tril_inv`` (XLA on the CPU), the
blocked route at n = 256 with block 128 (plain tile inverses on the CPU)
against JAX's ``blocked_tril_inv`` with its Pallas tile inverses in
interpret mode, both to rtol 1e-12 of the largest entry; a gradient through
the blocked route raises, the plain route's matches ``jax.grad``.  Every
serving entry point agrees with its JAX twin to rtol 1e-9 (atol 1e-12, for
sigma near 0), ``serve_sample`` on JAX's own normal draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import serve as jserve
from gogp_tpu.kernels import matern32 as jmatern32
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.ops import linalg as jlinalg
from gogp_torch.gp import core, serve
from gogp_torch.kernels import matern32, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jmatern32.scaled(), noise=juniform.scaled_by(0.01))
TGP = core.GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))
TS, TN = np.array([1.3, 0.9]), np.array([0.7])


def _data(n=24, m=9, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 6, n))
    y = np.sin(x) + 0.1 * rng.normal(size=n)
    z = np.concatenate([np.linspace(-1, 7, m - 2), x[[3, 10]]])  # two test points on the data
    mask = np.ones(n)
    mask[-3:] = 0.0
    return x, y, z, mask


def _t(a):
    return torch.tensor(np.array(a))


def _factor(n, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return np.linalg.cholesky(A @ A.T / n + np.eye(n))


def test_accurate_precision_is_full_f32():
    """On the card "tensorfloat32" is TF32, below torch's default f32, so
    the accurate default is "float32"."""
    assert linalg.ACCURATE_PRECISION == "float32"
    assert not cb.uses_tf32(linalg.ACCURATE_PRECISION)


def test_tril_inv_plain_route():
    L = _factor(40)
    want = np.asarray(jlinalg.tril_inv(jnp.asarray(L)))
    got = linalg.tril_inv(_t(L))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_tril_inv_blocked_route():
    L = _factor(256)
    with cp.force_interpret():
        want = np.asarray(cp.blocked_tril_inv(jnp.asarray(L), 128))
    with cb.force_blocked(128):
        got = linalg.tril_inv(_t(L), "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_tril_inv_gradient():
    """The plain route differentiates as JAX's XLA route does; the blocked
    route is forward-only and raises rather than returning a gradient."""
    L = _factor(24)
    G = np.random.default_rng(2).normal(size=L.shape)
    want = jax.grad(lambda L: jnp.sum(jlinalg.tril_inv(L) * G))(jnp.asarray(L))
    Lt = _t(L).requires_grad_(True)
    (linalg.tril_inv(Lt) * _t(G)).sum().backward()
    np.testing.assert_allclose(Lt.grad.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    Lb = _t(_factor(256)).requires_grad_(True)
    with cb.force_blocked(128):
        W = linalg.tril_inv(Lb)
    with pytest.raises(NotImplementedError):
        W.sum().backward()


def _both(n=24, m=9):
    x, y, z, mask = _data(n, m)
    sj = jserve.fit_serving(JGP, TS, TN, x, y, mask)
    st = serve.fit_serving(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    return sj, st, z


def test_fit_serving_matches_jax():
    sj, st, _ = _both()
    for name in serve.ServingPosterior._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)), **TOL, err_msg=name)


@pytest.mark.parametrize("fn", ["serve_predict", "serve_predict_y", "serve_predict_cov"])
def test_serve_predictions_match_jax(fn):
    sj, st, z = _both()
    want = getattr(jserve, fn)(JGP, sj, z)
    got = getattr(serve, fn)(TGP, st, _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_serve_predict_matches_the_exact_path():
    """The cache serves what ``predict_from_posterior`` solves for."""
    x, y, z, mask = _data()
    post = core.absorb(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    want = core.predict_from_posterior(TGP, post, _t(z))
    got = serve.serve_predict(TGP, serve.compile_posterior(TGP, post), _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert float(got[1][-1]) < 0.1 * np.sqrt(TS[0])  # on an observed point, far below the prior's std


def test_serve_sample_on_jax_draws():
    sj, st, z = _both()
    key = jax.random.PRNGKey(3)
    want = jserve.serve_sample(JGP, sj, z, key, num_samples=4)
    eps = jax.random.normal(key, (4, z.shape[0]), dtype=jnp.float64)
    got = serve.serve_sample(TGP, st, _t(z), num_samples=4, eps=_t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = serve.serve_sample(TGP, st, _t(z), num_samples=4, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (4, z.shape[0]) and torch.isfinite(drawn).all()


def _mixture(S=5):
    x, y, z, mask = _data()
    vs = np.log(np.concatenate([TS, TN]))[None, :] + 0.1 * np.random.default_rng(1).normal(size=(S, 3))
    mj = jserve.compile_mixture(JGP, vs, x, y, mask)
    mt = serve.compile_mixture(TGP, _t(vs), _t(x), _t(y), _t(mask))
    return mj, mt, vs, x, y, z, mask


def test_compile_mixture_matches_jax():
    mj, mt, *_ = _mixture()
    assert mt.n_draws == mj.n_draws == 5
    for name in serve.ServingMixture._fields:
        np.testing.assert_allclose(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), **TOL, err_msg=name)


@pytest.mark.parametrize("fn", ["serve_predict_mixture", "serve_predict_mixture_y"])
def test_mixture_predictions_match_jax(fn):
    mj, mt, _, _, _, z, _ = _mixture()
    want = getattr(jserve, fn)(JGP, mj, z)
    got = getattr(serve, fn)(TGP, mt, _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mixture_matches_predict_mixture():
    """The compiled mixture serves ``core.predict_mixture``'s moments."""
    _, mt, vs, x, y, z, mask = _mixture()
    want = core.predict_mixture(TGP, _t(vs), _t(x), _t(y), _t(z), _t(mask))
    got = serve.serve_predict_mixture(TGP, mt, _t(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_no_kernel_launch_on_the_cpu():
    cb.reset_launch_counts()
    sj, st, z = _both()
    serve.serve_predict(TGP, st, _t(z))
    assert all(v == 0 for v in cb.LAUNCHES.values())


def test_jax_caches_convert():
    """A JAX ServingPosterior and ServingMixture, carried over as numpy,
    serve what the JAX package serves."""
    from gogp_torch import convert

    sj, _, z = _both()
    st = convert.serving_posterior_from_numpy({k: np.asarray(v) for k, v in sj._asdict().items()}, "cpu")
    for g, w in zip(serve.serve_predict(TGP, st, _t(z)), jserve.serve_predict(JGP, sj, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    mj, *_ = _mixture()
    mt = convert.serving_mixture_from_numpy(mj, "cpu")
    for g, w in zip(serve.serve_predict_mixture(TGP, mt, _t(z)), jserve.serve_predict_mixture(JGP, mj, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
