"""The port's analytic pullbacks against jax.grad of the JAX package.

The JAX package differentiates its kernel path through analytic pullbacks
(cholesky_pallas.py): the GPML-5.9 backward of ``lml_core`` (with
``blocked_tril_inv`` and ``syrk_lower_t``), Murray's Cholesky pullback and
the TRSM VJPs.  The port has them as ``torch.autograd.Function``s in
``gogp_torch.ops.cholesky_blocked``; on the CPU, under ``force_blocked(64)``,
they run with the plain tile versions.  JAX runs its Pallas kernels in
interpret mode (``force_interpret()``).  Everything is float64.

Tolerances: atol 1e-10 on W = inv(L), W^T W and solves of SPD matrices with
entries of order n; rtol 1e-8 (atol 1e-10) on gradients, which pass through
K^-1 of a covariance with condition number up to about 1e4 (f64, the same
formulas, another blocking and summation order).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import GP as JGP
from gogp_tpu import matern32 as j_matern32
from gogp_tpu import uniform_noise as j_uniform
from gogp_tpu.gp import core as jcore
from gogp_tpu.models import params as jparams
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.ops import linalg as jlinalg
from gogp_torch import GP, matern32, uniform_noise
from gogp_torch.gp import core as tcore
from gogp_torch.models import params as tparams
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

ATOL = 1e-10
GRAD = dict(rtol=1e-8, atol=1e-10)


def T(a):
    return torch.tensor(np.asarray(a))


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


@pytest.fixture(scope="module")
def factor256():
    """(K, y, L, invs) at n = 256, b = 64: an SPD matrix, its factor and the
    factor's diagonal-tile inverses, from numpy."""
    K = spd(256, seed=7)
    y = np.random.default_rng(8).normal(size=256)
    L = np.linalg.cholesky(K)
    invs = np.stack([np.linalg.inv(L[k:k + 64, k:k + 64]) for k in range(0, 256, 64)])
    return K, y, L, invs


# -- the composites of the lml_core backward ---------------------------------


def test_blocked_tril_inv_matches_jax(factor256):
    _, _, L, invs = factor256
    want = cp.blocked_tril_inv(jnp.asarray(L), 64, jnp.asarray(invs))
    got = cb.blocked_tril_inv(T(L), 64, T(invs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(L), atol=ATOL)
    np.testing.assert_allclose(cb.blocked_tril_inv(T(L), 64).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("min_size", [1024, 64, 32])
def test_syrk_lower_t_matches_jax(factor256, min_size):
    """min_size 64 and 32 run the 2 x 2 recursion one and two levels deep."""
    _, _, L, _ = factor256
    W = np.linalg.inv(L)
    want = cp.syrk_lower_t(jnp.asarray(W), min_size=min_size)
    got = cb.syrk_lower_t(T(W), min_size=min_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), W.T @ W, atol=ATOL)


def test_blocked_trsm_lower_t_matches_jax(factor256):
    _, _, L, _ = factor256
    B = np.random.default_rng(9).normal(size=(256, 5))
    with cp.force_interpret():
        want = cp.blocked_trsm_lower_t(jnp.asarray(L), jnp.asarray(B), 64)
    got = cb.blocked_trsm_lower_t(T(L), T(B), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    got1 = cb.blocked_trsm_lower_t(T(L), T(B[:, 0]), 64)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want)[:, 0], atol=ATOL)


def test_cho_solve_mat_matches_jax(factor256):
    K, _, L, _ = factor256
    B = np.random.default_rng(10).normal(size=(256, 4))
    with cp.force_interpret():
        want = jlinalg.cho_solve_mat(jnp.asarray(L), jnp.asarray(B))
    with cb.force_blocked(64):
        got = linalg.cho_solve_mat(T(L), T(B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(linalg.cho_solve_mat(T(L), T(B)).numpy(), np.linalg.solve(K, B), atol=ATOL)


# -- the lml_core backward on both driver routes -----------------------------


@pytest.mark.parametrize("route,n", [("fused", 256), ("stepwise", 128)])
def test_lml_core_gradient_matches_jax_grad(route, n):
    """(Kbar, ybar) of the GPML-5.9 backward: K1's plain version (fused) or
    the stepwise driver, on both sides (JAX's stepwise driver in interpret
    mode is the slower, hence the smaller n)."""
    K = spd(n, seed=13)
    y = np.random.default_rng(14).normal(size=n)
    stepwise = route == "stepwise"
    with cp.force_interpret(), (cp.no_fused_whole() if stepwise else contextlib.nullcontext()):
        value, (Kbar, ybar) = jax.value_and_grad(cp.lml_core, argnums=(0, 1))(jnp.asarray(K), jnp.asarray(y), 64)
    Kt, yt = T(K).requires_grad_(True), T(y).requires_grad_(True)
    with cb.force_blocked(64), (cb.no_fused_whole() if stepwise else contextlib.nullcontext()):
        got = linalg.lml_core(Kt, yt)
        got.backward()
    got = got.detach()
    assert abs(float(got) - float(value)) <= 1e-10 * abs(float(value))
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(Kbar), **GRAD)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(ybar), **GRAD)


def test_value_only_lml_core_launches_no_transpose_solve(monkeypatch, factor256):
    """alpha = L^-T z is the backward's residual: a value-only call does not
    solve it; a call that needs a gradient does, once."""
    K, y, _, _ = factor256
    calls = []
    real = cb.trsv_lower_t
    monkeypatch.setattr(cb, "trsv_lower_t", lambda *a: calls.append(1) or real(*a))
    with cb.force_blocked(64):
        linalg.lml_core(T(K), T(y))
        with torch.no_grad():
            linalg.lml_core(T(K).requires_grad_(True), T(y))
        assert calls == []
        linalg.lml_core(T(K).requires_grad_(True), T(y)).backward()
        assert calls == [1]
        linalg.lml_core(T(K), T(y).requires_grad_(True)).backward()
    assert calls == [1, 1]


# -- through the GP layer ------------------------------------------------------


N, M = 128, 16


def _barebones():
    """The reference's barebones study (tutorial/barebones.py:23) on both
    sides, and bench.py-style data at n = 128 with y normalised."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=N)
    y = (y - y.mean()) / y.std(ddof=1)
    jgp = JGP(ndim=1, simil=j_matern32.scaled(), noise=j_uniform.scaled_by(0.01))
    tgp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))
    return jgp, tgp, x, y


def _grad_both(jfn, tfn, v):
    with cp.force_interpret():
        jval, jg = jax.value_and_grad(jfn)(jnp.asarray(v))
    vt = T(v).requires_grad_(True)
    with cb.force_blocked(64):
        tval = tfn(vt)
        (tg,) = torch.autograd.grad(tval, vt)
    return (float(jval), np.asarray(jg)), (float(tval.detach()), tg.numpy())


@pytest.mark.parametrize("mode", ["hyper", "with_obs", "masked"])
def test_gp_observe_gradient_matches_jax_grad(mode):
    """Hyperparameters only; withObs (gradients wrt inputs and outputs, the
    output part -alpha); hyperparameters only with 20 padded rows."""
    jgp, tgp, x, y = _barebones()
    v = np.log([1.3, 9.0, 0.8])
    mask = None
    if mode == "masked":
        mask = np.ones(N)
        mask[-20:] = 0.0
    if mode == "with_obs":
        v = np.concatenate([v, x[:, 0], y])
        kw_j = kw_t = {}
    else:
        kw_j = dict(x=x, y=y, mask=mask)
        kw_t = dict(x=T(x), y=T(y), mask=None if mask is None else T(mask))
    (jv, jg), (tv, tg) = _grad_both(
        lambda vv: jparams.gp_observe(jgp, vv, **kw_j), lambda vv: tparams.gp_observe(tgp, vv, **kw_t), v
    )
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    np.testing.assert_allclose(tg, jg, **GRAD)
    if mode == "with_obs":
        post = tparams.gp_posterior(tgp, T(v))
        np.testing.assert_allclose(tg[-N:], -post.alpha.numpy(), **GRAD)


@pytest.mark.parametrize("what", ["predict", "lml_from_posterior"])
def test_posterior_gradients_match_jax_grad(what):
    """Through the Cholesky pullback (absorb) and, for the forecast, the TRSM
    pullback (predict_from_posterior's trsm_lower)."""
    jgp, tgp, x, y = _barebones()
    z = np.linspace(0, 100, M)[:, None]
    v = np.log([1.3, 9.0, 0.8])

    def jfn(vv):
        post = jparams.gp_posterior(jgp, vv, x=x, y=y)
        if what == "lml_from_posterior":
            return jcore.lml_from_posterior(post)
        mu, sigma = jcore.predict_from_posterior(jgp, post, z)
        return mu.sum() + sigma.sum()

    def tfn(vv):
        post = tparams.gp_posterior(tgp, vv, x=T(x), y=T(y))
        if what == "lml_from_posterior":
            return tcore.lml_from_posterior(post)
        mu, sigma = tcore.predict_from_posterior(tgp, post, T(z))
        return mu.sum() + sigma.sum()

    (jv, jg), (tv, tg) = _grad_both(jfn, tfn, v)
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    np.testing.assert_allclose(tg, jg, **GRAD)


def test_trsm_pullbacks_match_jax(factor256):
    """trsm_lower_ad and trsm_lower_t_ad: gradients wrt L and B.  The JAX
    side runs its pullbacks with XLA's tile inverses (outside interpret
    mode): the pullbacks are not Pallas, and the tile inverses are tested
    against K5 in test_torch_cholesky.py."""
    _, _, L, _ = factor256
    B = np.random.default_rng(11).normal(size=(256, 3))
    C = np.random.default_rng(12).normal(size=(256, 3))

    def jfn(L_, B_):
        X = cp.trsm_lower_ad(L_, B_, 64, None)
        return jnp.sum(cp.trsm_lower_t_ad(L_, X, 64, None) * C)

    gL, gB = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(L), jnp.asarray(B))
    Lt, Bt = T(L).requires_grad_(True), T(B).requires_grad_(True)
    (cb.trsm_lower_t_ad(Lt, cb.trsm_lower_ad(Lt, Bt, 64), 64) * T(C)).sum().backward()
    np.testing.assert_allclose(Lt.grad.numpy(), np.asarray(gL), **GRAD)
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB), **GRAD)
