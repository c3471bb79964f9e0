"""Parity of the port's SKI path (gogp_torch.ops.ski and gogp_torch.gp.ski)
with gogp_tpu's, in f64 on the CPU, with JAX's probes through the
``PathDraws`` hook.

The interpolation weights and indices, the three forms of W^T V, W U and the
block-Toeplitz matvec agree to rounding (the JAX matmul form at "highest",
its full-f64 precision on the CPU).  The LMLs and predictions go through CG
to the twins' tolerance and are held as ``test_torch_iterative.py``
explains: values rtol 1e-7, gradients 1e-6, predictions 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import ski as jski
from gogp_tpu.kernels import matern32 as jm32
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as junif
from gogp_tpu.kernels.base import NoiseKernel as JNoiseKernel
from gogp_tpu.ops import ski as jski_ops
from gogp_torch.gp import core, ski
from gogp_torch.kernels import matern32, rbf, uniform_noise
from gogp_torch.kernels.base import NoiseKernel
from gogp_torch.ops import ski as ski_ops
from test_torch_iterative import GRAD_RTOL, PRED_RTOL, TOL, VALUE_RTOL, _rel, _t
from test_torch_pathwise import JaxPathDraws

KEY = 3
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=junif)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
JGP2 = jcore.GP(ndim=2, simil=jm32.scaled(), noise=junif)
TGP2 = core.GP(ndim=2, simil=matern32.scaled(), noise=uniform_noise)
V0 = np.array([0.0, -0.3, -0.7])
V2 = np.array([0.0, 0.0, -1.0])
ESTIMATOR = dict(num_probes=8, cg_iters=50, lanczos_iters=16)


def _data(n=200, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, 1))  # unsorted: lml_ski sorts
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)


def _data2d(n=150, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 4, (n, 2))
    return x, np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)


def _taps(x, dims):
    h = (x.max(0) - x.min(0)) / (np.array(dims) - 7)
    return x.min(0) - 3 * h, h


def test_cubic_interp_matches_jax():
    x = np.sort(np.random.default_rng(2).uniform(0, 10, 200))
    g0, h = _taps(x[:, None], (64,))
    want_i, want_w = jski_ops.cubic_interp(jnp.asarray(x), g0[0], h[0], 64)
    got_i, got_w = ski_ops.cubic_interp(_t(x), _t(g0[0]), _t(h[0]), 64)
    assert got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert _rel(got_w, want_w) < TOL
    np.testing.assert_allclose(got_w.sum(1).numpy(), 1.0, rtol=1e-12)  # partition of unity
    x2, _ = _data2d()
    g0, h = _taps(x2, (16, 12))
    want_i, want_w = jski_ops.cubic_interp_nd(jnp.asarray(x2), g0, h, (16, 12))
    got_i, got_w = ski_ops.cubic_interp_nd(_t(x2), _t(g0), _t(h), (16, 12))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_w.shape == (150, 16) and _rel(got_w, want_w) < TOL


def test_interp_forms_match_each_other_and_jax():
    """W^T V by scatter, by sorted segment sums and by one-hot matmuls, and
    W U, against JAX's, whole and in row chunks (a 4 KiB budget here forces
    8 rows a one-hot chunk and 21 to 42 a tap block); a batch through each
    form; W's gradient the same chunked as whole."""
    x = np.sort(np.random.default_rng(3).uniform(0, 10, 200))
    g = 64
    g0, h = _taps(x[:, None], (g,))
    ji, jw = jski_ops.cubic_interp(jnp.asarray(x), g0[0], h[0], g)
    ti, tw = ski_ops.cubic_interp(_t(x), _t(g0[0]), _t(h[0]), g)
    V = np.random.default_rng(4).normal(size=(200, 3))
    U = np.random.default_rng(5).normal(size=(g, 3))
    want = jski_ops.interp_t(ji, jw, g, jnp.asarray(V))
    want_w = np.asarray(jski_ops.interp(ji, jw, jnp.asarray(U)))
    forms = {"scatter": ski_ops.interp_t, "sorted": ski_ops.interp_t_sorted, "matmul": ski_ops.interp_t_matmul}
    budget = ski_ops.TRANSIENT_BYTES

    def w_grad():
        Ut = _t(U).requires_grad_(True)
        (ski_ops.interp(ti, tw, Ut) * _t(V)).sum().backward()
        return Ut.grad

    whole_grad = w_grad()
    try:
        for chunked in (False, True):
            ski_ops.TRANSIENT_BYTES = 8 * g * 8 if chunked else budget
            for name, fn in forms.items():
                got = fn(ti, tw, g, _t(V))
                assert _rel(got, want) < TOL, name
                batch = fn(ti, tw, g, _t(np.stack([V, 2.0 * V])))
                assert _rel(batch[1], 2.0 * np.asarray(want)) < TOL, name
            np.testing.assert_allclose(ski_ops.interp(ti, tw, _t(U)).numpy(), want_w, rtol=TOL, atol=1e-14)
            assert _rel(ski_ops.interp(ti, tw, _t(np.stack([U, 2.0 * U])))[1], 2.0 * want_w) < TOL
        assert _rel(w_grad(), whole_grad) < TOL
    finally:
        ski_ops.TRANSIENT_BYTES = budget
    assert _rel(ski_ops.interp_t_sorted(ti, tw, g, _t(V)), jski_ops.interp_t_sorted(ji, jw, g, jnp.asarray(V))) < TOL
    assert _rel(ski_ops.interp_t_matmul(ti, tw, g, _t(V)),
                jski_ops.interp_t_matmul(ji, jw, g, jnp.asarray(V), "highest")) < TOL


def test_bttb_matvec_matches_dense_and_jax():
    dims = (8, 6)
    rng = np.random.default_rng(6)
    pts = np.stack(np.meshgrid(np.arange(dims[0]) * 0.5, np.arange(dims[1]) * 0.7, indexing="ij"), -1).reshape(-1, 2)
    th = _t([1.3, 0.9])
    K = TGP2.simil.matrix(th, _t(pts), _t(pts)).numpy()
    lags = TGP2.simil.matrix(th, _t(pts), torch.zeros(1, 2, dtype=torch.float64))[:, 0].reshape(dims)
    V = rng.normal(size=(48, 3))
    got = ski_ops.bttb_matvec_fn(lags)(_t(V))
    assert _rel(got, K @ V) < TOL
    assert _rel(got, jski_ops.bttb_matvec_fn(jnp.asarray(lags.numpy()))(jnp.asarray(V))) < TOL
    assert _rel(ski_ops.bttb_matvec_fn(lags)(_t(V[:, 0])), K @ V[:, 0]) < TOL
    batch = ski_ops.bttb_matvec_fn(torch.stack([lags, 3.0 * lags]), d=2)(_t(np.stack([V, V])))
    assert _rel(batch[1], 3.0 * (K @ V)) < TOL


def _lml_pair(jgp, tgp, x, y, v, **kw):
    key = jax.random.PRNGKey(KEY)

    def f(v, y):
        th = jnp.exp(v)
        return jski.lml_ski(jgp, th[:2], th[2:], x, y, key, **kw)

    want, (want_gv, want_gy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(v, y)
    vt, yt = _t(v).requires_grad_(True), _t(y).requires_grad_(True)
    th = torch.exp(vt)
    got = ski.lml_ski(tgp, th[:2], th[2:], _t(x), yt, JaxPathDraws(key), **kw)
    got.backward()
    assert _rel(got, want) < VALUE_RTOL
    assert _rel(vt.grad, want_gv) < GRAD_RTOL and _rel(yt.grad, want_gy) < GRAD_RTOL
    return got.detach()


def test_lml_ski_1d_each_method_matches_jax():
    """Unsorted 1-D inputs (sorted inside, y's gradient back in the caller's
    order), each W^T form on the same probes; the three agree."""
    x, y = _data()
    values = [_lml_pair(JGP, TGP, x, y, V0, grid_size=64, method=m, **ESTIMATOR)
              for m in ("scatter", "sorted", "matmul")]
    assert max(_rel(v, values[0]) for v in values) < VALUE_RTOL


def test_lml_ski_2d_and_heteroscedastic_match_jax():
    x, y = _data2d()
    _lml_pair(JGP2, TGP2, x, y, V2, grid_size=(16, 16), method="scatter", **ESTIMATOR)
    # heteroscedastic: noise variance theta^2 (1 + x^2 / 10), per point
    jnoise = JNoiseKernel(1, lambda th, x: th[0] ** 2 * (1.0 + x[..., 0] ** 2 / 10.0), "het")
    tnoise = NoiseKernel(1, lambda th, x: th[0] ** 2 * (1.0 + x[..., 0] ** 2 / 10.0), "het")
    x1, y1 = _data()
    _lml_pair(jcore.GP(ndim=1, simil=jrbf.scaled(), noise=jnoise), core.GP(ndim=1, simil=rbf.scaled(), noise=tnoise),
              x1, y1, V0, grid_size=64, method="scatter", **ESTIMATOR)


def test_sorted_method_is_1d_only():
    x, y = _data2d(20)
    th = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError, match='method="sorted" is 1-D only'):
        ski.lml_ski(TGP2, th[:2], th[2:], _t(x), _t(y), None, grid_size=16, method="sorted")
    with pytest.raises(ValueError, match="grid_size has 3 axes for 2-D inputs"):
        ski.lml_ski(TGP2, th[:2], th[2:], _t(x), _t(y), None, grid_size=(8, 8, 8))


@pytest.mark.parametrize("ndim", [1, 2])
def test_predict_ski_matches_jax(ndim):
    if ndim == 1:
        (x, y), jgp, tgp, v, grid = _data(), JGP, TGP, V0, 64
        z = np.linspace(0, 10, 9)[:, None]
    else:
        (x, y), jgp, tgp, v, grid = _data2d(), JGP2, TGP2, V2, (16, 16)
        z = np.random.default_rng(7).uniform(0.5, 3.5, (5, 2))
    th = np.exp(v)
    want = jax.jit(lambda x, y, z: jski.predict_ski(jgp, th[:2], th[2:], x, y, z, grid_size=grid))(x, y, z)
    got = ski.predict_ski(tgp, _t(th[:2]), _t(th[2:]), _t(x), _t(y), _t(z), grid_size=grid)
    for g, w in zip(got, want):
        assert g.shape == (z.shape[0],) and _rel(g, w) < PRED_RTOL


@pytest.mark.parametrize("method", ["scatter", "matmul"])
def test_batched_lml_ski_matches_vmap(method):
    x, y = _data(120, seed=8)
    V = np.array([[0.0, -0.3, -0.7], [0.2, -0.1, -0.9], [-0.1, -0.5, -0.6]])
    key = jax.random.PRNGKey(5)
    kw = dict(grid_size=64, num_probes=8, cg_iters=40, lanczos_iters=12, method=method)

    def f(v):
        th = jnp.exp(v)
        return jski.lml_ski(JGP, th[:2], th[2:], x, y, key, **kw)

    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(f)))(V)
    vt = _t(V).requires_grad_(True)
    th = torch.exp(vt)
    got = ski.lml_ski(TGP, th[:, :2], th[:, 2:], _t(x), _t(y), JaxPathDraws(key), **kw)
    got.sum().backward()
    assert got.shape == (3,) and _rel(got, want) < VALUE_RTOL and _rel(vt.grad, want_g) < GRAD_RTOL


def test_exports_match_jax():
    assert set(ski_ops.__all__) == set(jski_ops.__all__)
    assert set(ski.__all__) == set(jski.__all__)
    assert all(hasattr(ski_ops, name) for name in ski_ops.__all__)
    assert all(hasattr(ski, name) for name in ski.__all__)
