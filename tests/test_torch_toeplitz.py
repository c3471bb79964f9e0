"""Parity of the port's Toeplitz path (gogp_torch.ops.toeplitz,
gogp_torch.gp.core.lml_toeplitz and predict_toeplitz) with gogp_tpu's, in
f64 on the CPU, with JAX's probes through the ``PathDraws`` hook.

The FFT matvec and the column accessor agree with the dense matrix to
rounding.  The LMLs and predictions go through CG to the twins' tolerance,
so they are held as ``test_torch_iterative.py`` explains: values rtol 1e-7,
gradients 1e-6, predictions 1e-5.

With ``precond_rank > 0`` the twin cannot be differentiated with respect to
theta_noise: its ``custom_vjp`` closes over the noise variance that builds
the preconditioner, and JAX raises an escaped-tracer error.  So the ranked
case is held in (theta_simil, y) with theta_noise a constant; the port's
gradient in theta_noise there is the frozen-solution form, the
preconditioner being a constant of the estimator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as junif
from gogp_tpu.ops import toeplitz as jtz
from gogp_torch.gp import core
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import toeplitz
from test_torch_iterative import GRAD_RTOL, PRED_RTOL, TOL, VALUE_RTOL, _rel, _t
from test_torch_pathwise import JaxPathDraws

KEY = 3
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=junif)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
V0 = np.array([0.0, -0.3, -0.7])
ESTIMATOR = dict(num_probes=8, cg_iters=50, lanczos_iters=16)


def _grid(n=128, seed=1):
    x = np.linspace(0.0, 12.7, n)[:, None]
    y = np.sin(x[:, 0]) + 0.1 * np.random.default_rng(seed).normal(size=n)
    return x, y


def _column(n=128):
    x, _ = _grid(n)
    th = np.exp(V0)
    K = np.asarray(jcore.masked_cov(JGP, th[:2], th[2:], x, None))
    return K[:, 0], K


def test_matvec_and_column_match_dense():
    c, K = _column()
    V = np.random.default_rng(2).normal(size=(K.shape[0], 3))
    mv = toeplitz.toeplitz_matvec_fn(_t(c))
    assert _rel(mv(_t(V)), K @ V) < TOL
    assert _rel(mv(_t(V[:, 0])), K @ V[:, 0]) < TOL
    assert _rel(mv(_t(V)), jtz.toeplitz_matvec_fn(jnp.asarray(c))(jnp.asarray(V))) < TOL
    assert _rel(toeplitz.circulant_spectrum(_t(c)), jtz.circulant_spectrum(jnp.asarray(c))) < TOL
    col = toeplitz.toeplitz_col_fn(_t(c))
    jcol = jtz.toeplitz_col_fn(jnp.asarray(c))
    for j in (0, 5, 127):
        np.testing.assert_array_equal(col(torch.tensor(j)).numpy(), np.asarray(jcol(j)))
        assert _rel(col(torch.tensor(j)), K[:, j]) < TOL
    # a batch of first columns: B operators in one FFT, a column each
    cs = np.stack([c, 0.5 * c])
    Vb = np.stack([V, V])
    got = toeplitz.toeplitz_matvec_fn(_t(cs))(_t(Vb))
    assert _rel(got[1], 0.5 * (K @ V)) < TOL
    np.testing.assert_array_equal(toeplitz.toeplitz_col_fn(_t(cs))(torch.tensor([3, 7]))[1].numpy(),
                                  0.5 * np.asarray(jcol(7)))


@pytest.mark.parametrize("rank", [0, 4])
def test_lml_toeplitz_matches_jax(rank):
    x, y = _grid()
    key = jax.random.PRNGKey(KEY)
    kw = dict(ESTIMATOR, precond_rank=rank)
    tn = np.exp(V0[2:])
    # rank 0: gradient in all three log-thetas; rank 4 in theta_simil only
    nv_free = rank == 0

    def f(v, y):
        th = jnp.exp(v)
        return jcore.lml_toeplitz(JGP, th[:2], th[2:] if nv_free else tn, x, y, key, **kw)

    v = V0 if nv_free else V0[:2]
    want, (want_gv, want_gy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(v, y)
    vt, yt = _t(v).requires_grad_(True), _t(y).requires_grad_(True)
    th = torch.exp(vt)
    got = core.lml_toeplitz(TGP, th[:2], th[2:] if nv_free else _t(tn), _t(x), yt, JaxPathDraws(key), **kw)
    got.backward()
    assert _rel(got, want) < VALUE_RTOL
    assert _rel(vt.grad, want_gv) < GRAD_RTOL and _rel(yt.grad, want_gy) < GRAD_RTOL
    if not nv_free:  # the port's theta_noise gradient: finite, nonzero
        vt = _t(V0).requires_grad_(True)
        th = torch.exp(vt)
        core.lml_toeplitz(TGP, th[:2], th[2:], _t(x), _t(y), JaxPathDraws(key), **kw).backward()
        assert torch.isfinite(vt.grad).all() and vt.grad[2] != 0
        assert _rel(vt.grad[:2], want_gv) < GRAD_RTOL


def test_lml_toeplitz_matches_dense_iterative():
    """The same probes through the FFT matvec and through the dense K: the
    same estimate (the twin's test_matches_dense_iterative_estimator)."""
    x, y = _grid()
    th = _t(np.exp(V0))
    draws = JaxPathDraws(jax.random.PRNGKey(KEY))
    a = core.lml_toeplitz(TGP, th[:2], th[2:], _t(x), _t(y), draws, **ESTIMATOR)
    b = core.lml_iterative(TGP, th[:2], th[2:], _t(x), _t(y), draws, **ESTIMATOR)
    assert _rel(a, b) < VALUE_RTOL


def test_batched_lml_toeplitz_matches_vmap():
    x, y = _grid(100, seed=4)
    V = np.array([[0.0, -0.3, -0.7], [0.2, -0.1, -0.9], [-0.1, -0.5, -0.6]])
    key = jax.random.PRNGKey(5)
    kw = dict(num_probes=8, cg_iters=40, lanczos_iters=12)

    def f(v):
        th = jnp.exp(v)
        return jcore.lml_toeplitz(JGP, th[:2], th[2:], x, y, key, **kw)

    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(f)))(V)
    vt = _t(V).requires_grad_(True)
    th = torch.exp(vt)
    got = core.lml_toeplitz(TGP, th[:, :2], th[:, 2:], _t(x), _t(y), JaxPathDraws(key), **kw)
    got.sum().backward()
    assert got.shape == (3,) and _rel(got, want) < VALUE_RTOL and _rel(vt.grad, want_g) < GRAD_RTOL


@pytest.mark.parametrize("case", ["irregular", "multidim"])
def test_errors_where_jax_raises(case):
    x, y = _grid(32)
    th = torch.ones(3, dtype=torch.float64)
    if case == "irregular":
        x_bad = x.copy()
        x_bad[5, 0] += 0.05
        with pytest.raises(ValueError, match="equally spaced") as err:
            core.lml_toeplitz(TGP, th[:2], th[2:], _t(x_bad), _t(y), None)
        with pytest.raises(ValueError, match="equally spaced") as jerr:
            jcore.lml_toeplitz(JGP, jnp.ones(2), jnp.ones(1), x_bad, y, jax.random.PRNGKey(0))
        assert str(err.value) == str(jerr.value)
    else:
        gp2 = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
        with pytest.raises(ValueError, match="1-D inputs on a regular grid"):
            core.lml_toeplitz(gp2, th[:2], th[2:], torch.zeros(8, 2, dtype=torch.float64),
                              torch.zeros(8, dtype=torch.float64), None)
        with pytest.raises(ValueError, match="predict_toeplitz needs 1-D"):
            core.predict_toeplitz(gp2, th[:2], th[2:], torch.zeros(8, 2, dtype=torch.float64),
                                  torch.zeros(8, dtype=torch.float64), torch.zeros(2, 2, dtype=torch.float64))


@pytest.mark.parametrize("rank", [0, 4])
def test_predict_toeplitz_matches_jax(rank):
    x, y = _grid()
    th = np.exp(V0)
    z = np.linspace(-1.0, 14.0, 11)[:, None]
    want = jax.jit(lambda x, y, z: jcore.predict_toeplitz(JGP, th[:2], th[2:], x, y, z, precond_rank=rank))(x, y, z)
    got = core.predict_toeplitz(TGP, _t(th[:2]), _t(th[2:]), _t(x), _t(y), _t(z), precond_rank=rank)
    for g, w in zip(got, want):
        assert g.shape == (11,) and _rel(g, w) < PRED_RTOL


def test_exports_match_jax():
    public = {name for name, obj in vars(jtz).items()
              if not name.startswith("_") and getattr(obj, "__module__", None) == jtz.__name__}
    assert public == set(jtz.__all__) == set(toeplitz.__all__)
    assert all(hasattr(toeplitz, name) for name in toeplitz.__all__)
