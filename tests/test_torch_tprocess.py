"""Parity of the port's Student-t process (gogp_torch.gp.tprocess) with
gogp_tpu.gp.tprocess.

The same numpy inputs in float64 go through both.  ``tp_lml``'s value
(with and without a mask) agrees to rtol 1e-9 and its gradient in nu and the
thetas to 1e-8 of the largest entry; ``tp_absorb``'s posterior,
``tp_predict`` and ``make_tp_logp`` (value and gradient) likewise.  As
nu -> inf the TP's LML and bands tend to the port's own ``core.lml`` and
``core.predict`` (to the JAX test's 1e-4 and 1e-5: at nu = 1e7 the
remaining terms are of order n / nu); the blocked route under
``cb.force_blocked(32)`` (K1's plain version and Murray's pullback, the
blocked TRSM for the bands) against JAX.  The JAX side runs under
``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import tprocess as jtp
from gogp_tpu.kernels import constant_noise as jconstant
from gogp_tpu.kernels import rbf as jrbf
from gogp_torch.gp import core, tprocess
from gogp_torch.kernels import constant_noise, rbf
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=jconstant(0.2))
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=constant_noise(0.2))
TS, E = np.array([1.3, 0.9]), np.zeros(0)


def _data(n=15, seed=1):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 6, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _t(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _grad_close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def _mask(n, pad):
    mask = np.ones(n)
    if pad:
        mask[-pad:] = 0.0
    return mask


@pytest.mark.parametrize("pad", [0, 4])
@pytest.mark.parametrize("nu", [2.5, 4.5, 30.0])
def test_tp_lml_value_and_grad_match_jax(nu, pad):
    x, y = _data(16)
    mask = _mask(16, pad)

    def jfn(nu, ts):
        return jtp.tp_lml(JGP, nu, ts, E, x, y, mask=jnp.asarray(mask))

    want_v, want_g = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(nu, TS)
    nu_t, ts_t = _t(nu).requires_grad_(True), _t(TS).requires_grad_(True)
    got = tprocess.tp_lml(TGP, nu_t, ts_t, _t(E), _t(x), _t(y), mask=_t(mask))
    _close(got, want_v)
    for g, w in zip(torch.autograd.grad(got, (nu_t, ts_t)), want_g):
        _grad_close(g, w)


def test_tp_lml_padding_invariance():
    x, y = _data(12, seed=6)
    ll = tprocess.tp_lml(TGP, 5.0, _t(TS), _t(E), _t(x), _t(y))
    xp = np.concatenate([x, np.full((5, 1), 42.0)])
    yp = np.concatenate([y, np.zeros(5)])
    ll_pad = tprocess.tp_lml(TGP, 5.0, _t(TS), _t(E), _t(xp), _t(yp), mask=_t(_mask(17, 5)))
    np.testing.assert_allclose(float(ll_pad), float(ll), atol=1e-9)


@pytest.mark.parametrize("nu", [3.0, 12.0])
def test_tp_absorb_and_predict_match_jax(nu):
    x, y = _data(15, seed=3)
    z = np.array([[1.1], [2.2], [4.4], [6.5]])
    jpost, (jmu, jsd) = jax.jit(lambda x, y, z: (lambda p: (p, jtp.tp_predict(JGP, nu, p, z)))(
        jtp.tp_absorb(JGP, nu, TS, E, x, y)))(x, y, z)
    post = tprocess.tp_absorb(TGP, nu, _t(TS), _t(E), _t(x), _t(y))
    for name in core.Posterior._fields:
        _close(getattr(post, name), getattr(jpost, name))
    mu, sd = tprocess.tp_predict(TGP, nu, post, _t(z))
    _close(mu, jmu)
    _close(sd, jsd)
    # a 1-D z is a column of points, as in the JAX twin's reshape
    _close(tprocess.tp_predict(TGP, nu, post, _t(z[:, 0]))[1], jsd)


def test_make_tp_logp_matches_jax():
    x, y = _data(10, seed=5)
    jlogp, jn = jtp.make_tp_logp(JGP, x, y)
    logp, n = tprocess.make_tp_logp(TGP, _t(x), _t(y))
    assert n == jn == 3
    v0 = np.array([0.5, 0.2, -0.1])
    want_v, want_g = jax.jit(jax.value_and_grad(jlogp))(v0)
    v = _t(v0).requires_grad_(True)
    got = logp(v)
    (g,) = torch.autograd.grad(got, v)
    _close(got, want_v)
    _grad_close(g, want_g)


def test_gp_limit_is_the_ports_exact_core():
    x, y = _data(15, seed=2)
    ll_tp = float(tprocess.tp_lml(TGP, 1e7, _t(TS), _t(E), _t(x), _t(y)))
    ll_gp = float(core.lml(TGP, _t(TS), _t(E), _t(x), _t(y)))
    np.testing.assert_allclose(ll_tp, ll_gp, atol=1e-4)
    post = tprocess.tp_absorb(TGP, 1e7, _t(TS), _t(E), _t(x), _t(y))
    z = _t([[1.1], [6.5]])
    mu_t, sd_t = tprocess.tp_predict(TGP, 1e7, post, z)
    mu_g, sd_g = core.predict(TGP, _t(TS), _t(E), _t(x), _t(y), z)
    np.testing.assert_allclose(mu_t.numpy(), mu_g.numpy(), atol=1e-9)
    np.testing.assert_allclose(sd_t.numpy(), sd_g.numpy(), atol=1e-5)


def test_surprising_residuals_inflate_bands():
    x, y = _data(15, seed=4)
    z = _t([[3.0]])
    small = tprocess.tp_absorb(TGP, 4.0, _t(TS), _t(E), _t(x), _t(0.1 * y))
    big = tprocess.tp_absorb(TGP, 4.0, _t(TS), _t(E), _t(x), _t(5.0 * y))
    assert float(tprocess.tp_predict(TGP, 4.0, big, z)[1][0]) > 2.0 * float(tprocess.tp_predict(TGP, 4.0, small, z)[1][0])


def test_tp_blocked_route_matches_jax():
    x, y = _data(64, seed=7)
    z = np.linspace(0.0, 6.0, 32)[:, None]

    def jfn(nu, ts):
        return jtp.tp_lml(JGP, nu, ts, E, x, y)

    want_v, want_g = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(3.5, TS)
    want_sd = jax.jit(lambda: jtp.tp_predict(JGP, 3.5, jtp.tp_absorb(JGP, 3.5, TS, E, x, y), z)[1])()
    with cb.force_blocked(32):
        nu_t, ts_t = _t(3.5).requires_grad_(True), _t(TS).requires_grad_(True)
        got = tprocess.tp_lml(TGP, nu_t, ts_t, _t(E), _t(x), _t(y))
        grads = torch.autograd.grad(got, (nu_t, ts_t))
        sd = tprocess.tp_predict(TGP, 3.5, tprocess.tp_absorb(TGP, 3.5, _t(TS), _t(E), _t(x), _t(y)), _t(z))[1]
    _close(got, want_v)
    for g, w in zip(grads, want_g):
        _grad_close(g, w)
    _grad_close(sd, want_sd, 1e-9)
