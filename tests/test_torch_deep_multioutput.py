"""Parity of the port's deep kernels (gogp_torch.kernels.deep) and
multi-output kernels (gogp_torch.kernels.multioutput) with their JAX twins.

The same numpy inputs in float64 go through both.  Covariance matrices,
``stack_tasks``/``task_inputs``, ``warp_features`` and ``init_deep_v`` agree
to rtol 1e-9; ``gp_observe``'s value to rtol 1e-9 and its gradient to 1e-8
of the largest entry.  ``deep`` with identity weights reproduces its base
to 1e-12 (one linear layer: x W + b with W = 1, b = 0 is exact).  The JAX
side runs under ``jax.jit`` where it differentiates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.kernels import deep as jdk
from gogp_tpu.kernels import matern32 as jmatern32
from gogp_tpu.kernels import multioutput as jmo
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_tpu.models.params import gp_observe as jgp_observe
from gogp_torch.gp import core, serve
from gogp_torch.kernels import deep as dk
from gogp_torch.kernels import matern32, rbf, uniform_noise
from gogp_torch.kernels import multioutput as mo
from gogp_torch.models.params import gp_observe
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)


def _t(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _grad_close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def _observe_both(jgp, tgp, v, x, y):
    """gp_observe's value and gradient at v in both packages."""
    want_v, want_g = jax.jit(jax.value_and_grad(lambda v: jgp_observe(jgp, v, x=x, y=y)))(v)
    vt = _t(v).requires_grad_(True)
    got = gp_observe(tgp, vt, x=_t(x), y=_t(y))
    (g,) = torch.autograd.grad(got, vt)
    _close(got, want_v)
    _grad_close(g, want_g)


# -- deep --------------------------------------------------------------------


def test_deep_identity_weights_reproduce_base():
    k = dk.deep(rbf.scaled(), ndim=2, hidden=())
    theta = torch.cat([torch.exp(_t(dk.identity_weights(2, hidden=()))), _t([1.3, 0.8])])
    x = _t(np.random.default_rng(0).normal(size=(7, 2)))
    want = rbf.scaled().matrix(_t([1.3, 0.8]), x, x)
    np.testing.assert_allclose(k.matrix(theta, x, x).numpy(), want.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="square layers"):
        dk.identity_weights(1)


def test_deep_structure_matches_jax():
    k, jk = dk.deep(rbf.scaled(), 1, (4, 4), 2), jdk.deep(jrbf.scaled(), 1, (4, 4), 2)
    assert k.n_theta == jk.n_theta == dk.n_weights(1, (4, 4), 2) + 2
    assert dk.n_weights(1, (4, 4), 2) == jdk.n_weights(1, (4, 4), 2) == (1 * 4 + 4) + (4 * 4 + 4) + (4 * 2 + 2)
    assert k.name == jk.name


@pytest.mark.parametrize("hidden,out_dim", [((4,), 2), ((8, 8), None)])
def test_deep_matrix_and_features_match_jax(hidden, out_dim):
    v = dk.init_deep_v(np.random.default_rng(1), [0.2, -0.1], 1, hidden=hidden, out_dim=out_dim)
    jv = jdk.init_deep_v(np.random.default_rng(1), [0.2, -0.1], 1, hidden=hidden, out_dim=out_dim)
    _close(v, jv)
    x = np.random.default_rng(2).normal(size=(9, 1))
    xb = np.random.default_rng(3).normal(size=(5, 1))
    theta = np.exp(np.asarray(jv))
    want = jax.jit(jdk.deep(jrbf.scaled(), 1, hidden, out_dim).matrix)(theta, x, xb)
    _close(dk.deep(rbf.scaled(), 1, hidden, out_dim).matrix(_t(theta), _t(x), _t(xb)), want)
    for raw, w in ((True, v), (False, torch.exp(v))):
        _close(dk.warp_features(w, _t(x), 1, hidden, out_dim, raw=raw),
               jdk.warp_features(jnp.asarray(np.asarray(w)), x, 1, hidden, out_dim, raw=raw))


def test_deep_features_path_equals_pair_path():
    k = dk.deep(rbf.scaled(), 1, (4,), 2)
    v = dk.init_deep_v(np.random.default_rng(1), [0.2, -0.1], 1, hidden=(4,), out_dim=2)
    x = _t(np.random.default_rng(2).normal(size=(6, 1)))
    feats = dk.warp_features(v, x, 1, (4,), 2)
    theta = torch.exp(v)
    np.testing.assert_allclose(k.matrix(theta, x, x).numpy(), rbf.scaled().matrix(theta[-2:], feats, feats).numpy(),
                               atol=1e-12)


def test_deep_gp_observe_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 3, size=(10, 1))
    y = np.sin(x[:, 0])
    v0 = np.concatenate([np.asarray(jdk.init_deep_v(rng, [0.1, 0.1], 1, hidden=(3,))), [-1.0]])
    _observe_both(jcore.GP(1, jdk.deep(jrbf.scaled(), 1, (3,)), noise=juniform),
                  core.GP(1, dk.deep(rbf.scaled(), 1, (3,)), noise=uniform_noise), v0, x, y)


def test_deep_blocked_route_matches_jax():
    """gp_observe through the blocked driver (K1's and the solves' plain
    versions, GPML 5.9's pullback) on the default (8, 8) warp."""
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 8, size=(64, 1)), axis=0)
    y = np.sin(x[:, 0] / 1.5) + 0.1 * rng.normal(size=64)
    v0 = np.concatenate([np.asarray(jdk.init_deep_v(rng, [0.0, 0.0], 1)), [-1.0]])
    with cb.force_blocked(32):
        _observe_both(jcore.GP(1, jdk.deep(jrbf.scaled(), 1), noise=juniform),
                      core.GP(1, dk.deep(rbf.scaled(), 1), noise=uniform_noise), v0, x, y)


# -- multi-output ------------------------------------------------------------


def _two_tasks(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x1 = np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0)
    x2 = np.sort(rng.uniform(0.0, 10.0, size=(n // 2, 1)), axis=0)
    y1 = np.sin(x1[:, 0]) + 0.05 * rng.normal(size=n)
    y2 = -2.0 * np.sin(x2[:, 0]) + 0.05 * rng.normal(size=n // 2)
    return x1, y1, x2, y2


def test_stack_tasks_and_task_inputs_match_jax():
    x1, y1, x2, y2 = _two_tasks()
    X, y = mo.stack_tasks([_t(x1), _t(x2[:, 0])], [_t(y1), _t(y2)])
    jX, jy = jmo.stack_tasks([x1, x2[:, 0]], [y1, y2])
    _close(X, jX)
    _close(y, jy)
    _close(mo.task_inputs(_t(x1[:, 0]), 1), jmo.task_inputs(x1[:, 0], 1))


def test_icm_spec_and_theta_init():
    k = mo.icm(rbf.scaled(), 2, 3)
    assert k.spec == ("icm", k.spec[1], 2, 3) and k.spec[1].name == rbf.scaled().name
    assert k.n_theta == mo.icm(rbf.scaled(), 2, 3).n_theta == jmo.icm(jrbf.scaled(), 2, 3).n_theta == 2 + 6 + 2
    assert k.name == jmo.icm(jrbf.scaled(), 2, 3).name
    got = mo.init_icm_theta([0.1, -0.2], 2, 3, w_scale=0.5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmo.init_icm_theta(jnp.asarray([0.1, -0.2]), 2, 3, 0.5)))


@pytest.mark.parametrize("rank", [1, 2])
def test_icm_and_lmc_matrices_match_jax(rank):
    rng = np.random.default_rng(1)
    X, _ = jmo.stack_tasks([rng.uniform(0, 5, (4, 1)), rng.uniform(0, 5, (3, 1))], [np.zeros(4), np.zeros(3)])
    X = np.asarray(X)
    theta = np.concatenate([[2.0], np.exp(rng.normal(size=2 * rank)), [0.2, 0.05]])
    _close(mo.icm(rbf, 2, rank).matrix(_t(theta), _t(X), _t(X)), jax.jit(jmo.icm(jrbf, 2, rank).matrix)(theta, X, X))
    lmc, jlmc = mo.lmc([rbf, matern32], 2, rank), jmo.lmc([jrbf, jmatern32], 2, rank)
    th = np.abs(rng.normal(size=lmc.n_theta)) + 0.3
    _close(lmc.matrix(_t(th), _t(X), _t(X)), jax.jit(jlmc.matrix)(th, X, X))
    _close(lmc.diag_matrix(_t(th), _t(X)), jax.jit(jlmc.diag_matrix)(th, X))


def test_icm_block_structure():
    """K[(x, i), (x', j)] = B[i, j] k(x, x'), B = W W^T + diag(kappa)."""
    W = np.array([[0.7, -0.3], [1.1, 0.4]])
    kappa = np.array([0.2, 0.05])
    theta = _t(np.concatenate([[2.0], np.exp(W.reshape(-1)), kappa]))
    xs = np.random.default_rng(1).uniform(0, 5, size=(6, 1))
    X, _ = mo.stack_tasks([_t(xs[:4]), _t(xs[4:])], [_t(np.zeros(4)), _t(np.zeros(2))])
    tasks = np.array([0, 0, 0, 0, 1, 1])
    want = (W @ W.T + np.diag(kappa))[np.ix_(tasks, tasks)] * rbf.matrix(_t([2.0]), _t(xs), _t(xs)).numpy()
    np.testing.assert_allclose(mo.icm(rbf, 2, 2).matrix(theta, X, X).numpy(), want, atol=1e-12)


def test_icm_gp_observe_matches_jax():
    x1, y1, x2, y2 = _two_tasks()
    X, y = (np.asarray(a) for a in jmo.stack_tasks([x1, x2], [y1, y2]))
    v0 = np.concatenate([np.asarray(jmo.init_icm_theta(jnp.asarray([0.0]), 2, 1, w_scale=0.5), dtype=np.float64),
                         [np.log(0.3)]])
    _observe_both(jcore.GP(2, jmo.icm(jrbf, 2, 1), noise=juniform), core.GP(2, mo.icm(rbf, 2, 1), noise=uniform_noise),
                  v0, X, y)


def test_icm_serving_composes():
    x1, y1, x2, y2 = _two_tasks()
    X, y = mo.stack_tasks([_t(x1), _t(x2)], [_t(y1), _t(y2)])
    gp = core.GP(2, mo.icm(rbf, 2, 1), noise=uniform_noise)
    ts, tn = torch.exp(_t([0.0, 1.0, -1.0, np.log(0.1), np.log(0.1)])), _t([0.05])
    z = mo.task_inputs(torch.linspace(0, 10, 9, dtype=torch.float64)[:, None], 0)
    sp = serve.fit_serving(gp, ts, tn, X, y)
    for got, want in zip(serve.serve_predict(gp, sp, z), core.predict(gp, ts, tn, X, y, z)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7)
