"""Parity of the port's Bayesian optimization (gogp_torch.bo) with
gogp_tpu.bo.

Float64 on the CPU.  JAX's draws go into the port through the pathwise
``PathDraws`` hook (``JaxPathDraws``), so every acquisition, update and run
is held step for step against JAX's: scores, chosen indices, the streamed
posterior and the incumbent to rtol 1e-9 (atol 1e-12 near 0).  The
streamed posterior also runs on the blocked route under
``cb.force_blocked(32)`` at capacity 64 (K5's plain version on the CPU),
against JAX and against one ``absorb`` of the same points.  The JAX side
runs under ``jax.jit``: eager, each of its ops compiles per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from gogp_tpu import bo as jbo
from gogp_tpu.gp import core as jcore
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_torch import bo, convert
from gogp_torch.gp import core, pathwise
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb
from test_torch_pathwise import JaxPathDraws

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=juniform)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
JGP2 = jcore.GP(ndim=2, simil=jrbf.scaled(), noise=juniform)
TGP2 = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
TS, TN = np.array([5.0, 1.5]), np.array([0.05])
GRID = np.linspace(0.0, 10.0, 51)[:, None]


def _t(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


def _state_close(got: bo.BOState, want, tol=TOL):
    for name in core.Posterior._fields:
        _close(getattr(got.post, name), getattr(want.post, name), tol, name)
    _close(got.best_x, want.best_x, tol, "best_x")
    _close(got.best_y, want.best_y, tol, "best_y")


def _jobj(x):
    return -((x[0] - 3.1) ** 2)


_tobj = _jobj  # the same arithmetic on a torch tensor


def _states(capacity=8, xs=((2.0,), (7.0,), (5.5,)), ys=(0.3, -0.2, 0.9)):
    """One state in both packages after one batched update."""
    jst = jbo.bo_update(JGP, jbo.bo_init(JGP, TS, TN, capacity, dtype=jnp.float64), jnp.asarray(xs), jnp.asarray(ys))
    tst = bo.bo_update(TGP, bo.bo_init(TGP, _t(TS), _t(TN), capacity, dtype=torch.float64), _t(xs), _t(ys))
    return jst, tst


# -- acquisition math ---------------------------------------------------------


def test_ei_closed_form_and_zero_at_observed_points():
    got = float(bo.expected_improvement(_t([1.0]), _t([1.0]), _t(0.0))[0])
    assert abs(got - (norm.cdf(1.0) + norm.pdf(1.0))) < 1e-12
    assert float(bo.expected_improvement(_t([0.5]), _t([0.0]), _t(1.0))[0]) == 0.0
    e = bo.expected_improvement(_t([-1.0, 0.0, 1.0]), torch.ones(3, dtype=torch.float64), _t(0.0)).numpy()
    assert e[0] < e[1] < e[2]


def test_ucb_beta_tradeoff():
    mu, sigma = _t([1.0, 0.0]), _t([0.0, 1.0])
    low = bo.upper_confidence_bound(mu, sigma, beta=0.5).numpy()
    high = bo.upper_confidence_bound(mu, sigma, beta=5.0).numpy()
    assert low[0] > low[1] and high[1] > high[0]


def test_ei_and_ucb_match_jax():
    rng = np.random.default_rng(0)
    mu, sigma = rng.normal(size=40), np.abs(rng.normal(size=40))
    sigma[::7] = 0.0
    for best, xi in ((0.3, 0.0), (-1.0, 0.1), (-np.inf, 0.0)):
        _close(bo.expected_improvement(_t(mu), _t(sigma), _t(best), xi),
               jbo.expected_improvement(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(best), xi))
    _close(bo.upper_confidence_bound(_t(mu), _t(sigma), 1.7), jbo.upper_confidence_bound(mu, sigma, 1.7))


# -- acquire, update -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["ei", "ucb", "thompson", "thompson-path"])
def test_acquire_matches_jax(kind):
    jst, tst = _states()
    _state_close(tst, jst)
    key = 11
    jidx, jscores = jax.jit(lambda st, k: jbo.acquire(JGP, st, jnp.asarray(GRID), kind, k, 0.01, 1.5))(
        jst, jax.random.PRNGKey(key))
    idx, scores = bo.acquire(TGP, convert.bo_state_from_numpy(jst, "cpu"), _t(GRID), kind, JaxPathDraws(key), 0.01,
                             1.5)
    # the exact draw factors the 51-point grid's posterior covariance, whose
    # condition number (about 1e8 with its 1e-8 jitter) takes LAPACK's and
    # XLA's different Cholesky roundings to about 1e-8 in the scores
    _close(scores, jscores, dict(rtol=1e-9, atol=1e-7) if kind == "thompson" else TOL)
    assert int(idx) == int(jidx)


def test_acquire_needs_a_key_for_thompson():
    _, tst = _states()
    for kind in ("thompson", "thompson-path"):
        with pytest.raises(ValueError, match="key"):
            bo.acquire(TGP, tst, _t(GRID), kind)
    with pytest.raises(ValueError, match="unknown"):
        bo.acquire(TGP, tst, _t(GRID), "pi")


def test_empty_state_scores_the_prior():
    st = bo.bo_init(TGP, _t(TS), _t(TN), 4, dtype=torch.float64)
    _, ucb = bo.acquire(TGP, st, _t(GRID), "ucb", beta=2.0)
    _close(ucb, np.full(51, 2.0 * np.sqrt(TS[0])))
    assert float(st.best_y) == -np.inf and st.post.x.device.type == "cpu"


@pytest.mark.parametrize("gp_ndim,x_new,y_new", [
    (1, [4.0, 6.0, 1.0], [0.2, 0.5, -0.1]),  # 1-D x of length != ndim: a batch of 1-D points
    (1, [4.0], 0.2),  # length == ndim: one point
    (2, [4.0, 1.0], 0.2),  # 2-D GP, 1-D x: one point
    (2, [[4.0, 1.0], [2.0, 3.0]], [0.1, 0.7]),
])
def test_bo_update_matches_jax(gp_ndim, x_new, y_new):
    jgp, tgp_ = (JGP, TGP) if gp_ndim == 1 else (JGP2, TGP2)
    ts = TS if gp_ndim == 1 else np.array([1.0, 2.0])
    jst = jbo.bo_init(jgp, ts, TN, 6, dtype=jnp.float64)
    tst = bo.bo_init(tgp_, _t(ts), _t(TN), 6, dtype=torch.float64)
    for _ in range(2):
        jst = jbo.bo_update(jgp, jst, jnp.asarray(x_new), jnp.asarray(y_new))
        tst = bo.bo_update(tgp_, tst, _t(x_new), _t(y_new))
        _state_close(tst, jst)


# -- runs ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ei", "ucb", "thompson", "thompson-path"])
def test_bo_run_matches_jax_step_for_step(kind):
    iters, n_init = 10, 3
    jrun = jax.jit(lambda k: jbo.bo_run(JGP, TS, TN, _jobj, jnp.asarray(GRID), iters, k, kind=kind, n_init=n_init,
                                        xi=0.01, beta=2.0))
    jst, jys = jrun(jax.random.PRNGKey(2))
    tst, tys = bo.bo_run(TGP, _t(TS), _t(TN), _tobj, _t(GRID), iters, JaxPathDraws(2), kind=kind, n_init=n_init,
                         xi=0.01, beta=2.0)
    _close(tys, jys)
    _state_close(tst, jst)
    assert abs(float(tst.best_x[0]) - 3.1) < 0.3


def test_streamed_posterior_on_the_blocked_route():
    """Capacity 64 under force_blocked(32): every acquisition's TRSM and
    every append's on the blocked route (K5's plain version), step for step
    against JAX, and the stream's end against one absorb of its points."""
    iters, n_init = 60, 4
    grid = np.linspace(0.0, 10.0, 101)[:, None]
    jst, jys = jax.jit(lambda k: jbo.bo_run(JGP, TS, TN, _jobj, jnp.asarray(grid), iters, k, kind="ucb",
                                            n_init=n_init))(jax.random.PRNGKey(4))
    calls = []
    real = cb.tril_inv_tile

    def counted(L):
        calls.append(L.shape[0])
        return real(L)

    with cb.force_blocked(32), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "tril_inv_tile", counted)
        tst, tys = bo.bo_run(TGP, _t(TS), _t(TN), _tobj, _t(grid), iters, JaxPathDraws(4), kind="ucb", n_init=n_init)
    assert calls == [2] * (1 + 2 * iters)  # the first update, then each step's predict and append
    _close(tys, jys)
    _state_close(tst, jst)
    one = core.absorb(TGP, _t(TS), _t(TN), tst.post.x, tst.post.y)
    _close(tst.post.chol, one.chol.numpy())
    _close(tst.post.alpha, one.alpha.numpy(), dict(rtol=1e-8, atol=1e-10))


def test_acquire_batch_thompson_matches_jax_and_picks_distinct_points():
    jst, tst = _states(xs=((2.0,), (8.0,)), ys=(0.5, 1.5))
    jidx, jscores = jax.jit(lambda st, k: jbo.acquire_batch_thompson(JGP, st, jnp.asarray(GRID), k, 6))(
        jst, jax.random.PRNGKey(0))
    idx, scores = bo.acquire_batch_thompson(TGP, tst, _t(GRID), JaxPathDraws(0), 6)
    _close(scores, jscores)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert len(set(idx.tolist())) == 6 and scores.shape == (6, 51)
    # a grid of 3 candidates and q = 3: every candidate exactly once
    idx3, _ = bo.acquire_batch_thompson(TGP, tst, _t(GRID[::25]), torch.Generator().manual_seed(1), 3)
    assert sorted(idx3.tolist()) == [0, 1, 2]


def test_thompson_path_optimize_matches_jax():
    jst, tst = _states(xs=((2.0,), (5.0,), (8.0,)), ys=(0.5, 1.8, -0.2))
    bounds = (np.array([0.0]), np.array([10.0]))
    jx, jv = jax.jit(lambda st, k: jbo.thompson_path_optimize(JGP, st, k, (jnp.asarray(bounds[0]),
                                                                           jnp.asarray(bounds[1])),
                                                              num_restarts=4, steps=5))(jst, jax.random.PRNGKey(3))
    x, v = bo.thompson_path_optimize(TGP, tst, JaxPathDraws(3), (_t(bounds[0]), _t(bounds[1])), num_restarts=4,
                                     steps=5)
    _close(x, jx)
    _close(v, jv)


def test_thompson_path_optimize_beats_a_coarse_grid_on_the_same_path():
    _, tst = _states(xs=((2.0,), (5.0,), (8.0,)), ys=(0.5, 1.8, -0.2))
    draws = pathwise.GeneratorDraws(torch.Generator().manual_seed(3))
    x_opt, v_opt = bo.thompson_path_optimize(TGP, tst, draws, (_t([0.0]), _t([10.0])), num_restarts=8, steps=200)
    # the same draws again give the same sampled path: its max over a coarse
    # grid cannot beat the continuous optimum
    kp, _ = pathwise.GeneratorDraws(torch.Generator().manual_seed(3)).split(2)
    ps = pathwise.sample_paths(TGP, tst.post, kp, 1, 512)
    grid_best = float(pathwise.eval_paths(TGP, ps, _t(np.linspace(0.0, 10.0, 11)[:, None])).max())
    assert float(v_opt) >= grid_best - 1e-9 and 0.0 <= float(x_opt[0]) <= 10.0


def test_exports_match_jax():
    assert set(bo.__all__) == set(jbo.__all__)
    assert all(callable(getattr(bo, name)) for name in bo.__all__)
