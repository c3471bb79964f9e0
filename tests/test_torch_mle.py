"""The port's optimizers (gogp_torch.infer.mle) and the fit-then-forecast
slice against the JAX package, in float64 on the CPU.

Adam is held to the JAX ``adam`` step for step (optax's arithmetic: the same
x, value and iteration count to rtol 1e-10 on the quadratic and 1e-8 on the
GP, where 50 steps compound the different summation orders of the LML
gradient).  LBFGS is optax's algorithm with its zoom line search on both
sides, but for a failed search that found no point of sufficient decrease
no higher than the start, where the port takes no step: the same
iteration count, x to atol 1e-5 (1e-6 on the quadratic) and the LML to rtol
1e-9 at gradient threshold 1e-6.  The slice runs the port's blocked path
under ``force_blocked(64)`` (K1's plain version, the K3 and K5 plain
versions) and JAX's Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gogp_tpu import GP as JGP
from gogp_tpu import matern32 as j_matern32
from gogp_tpu import uniform_noise as j_uniform
from gogp_tpu.gp import core as jcore
from gogp_tpu.infer import mle as jmle
from gogp_tpu.models import make_gp_logp as j_make_gp_logp
from gogp_tpu.models import masked_value_and_grad as j_masked_vg
from gogp_tpu.models import model as jmodel
from gogp_tpu.models import params as jparams
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.tutorial import io as tio
from gogp_torch import GP, convert, make_gp_logp, masked_value_and_grad, matern32, mle, uniform_noise
from gogp_torch.gp import core as tcore
from gogp_torch.models import model as tmodel
from gogp_torch.models import params as tparams
from gogp_torch.ops import cholesky_blocked as cb

TARGET = [1.0, -2.0, 0.5]


def T(a):
    return torch.tensor(np.asarray(a))


def j_quadratic(v):
    return -jnp.sum((v - jnp.asarray(TARGET)) ** 2)


def t_quadratic(v):
    return -((v - torch.tensor(TARGET, dtype=v.dtype)) ** 2).sum()


def assert_same_result(got, want, rtol):
    want = convert.opt_result(want, "cpu")
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=rtol, atol=1e-12)
    assert (got.iters, got.converged, got.stalled) == (want.iters, want.converged, want.stalled)


def problem(n, seed=0):
    """bench.py's generator (bench.py:42-51) at n points, y normalised as
    evaluate does, and the barebones study's GP on both sides."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, (n, 1)), axis=0)
    y, _, _ = tio.normalize(np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n))
    jgp = JGP(ndim=1, simil=j_matern32.scaled(), noise=j_uniform.scaled_by(0.01))
    tgp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))
    return jgp, tgp, x, y


# -- Adam, step for step -------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_adam_quadratic_matches_jax(threshold):
    """300 steps, or the threshold stop: the step whose gradient falls below
    the threshold still applies its update."""
    want = jmle.adam(jax.value_and_grad(j_quadratic), jnp.zeros(3), iters=300, rate=0.05, threshold=threshold)
    got = mle.adam(masked_value_and_grad(t_quadratic), torch.zeros(3, dtype=torch.float64),
                   iters=300, rate=0.05, threshold=threshold)
    assert_same_result(got, want, rtol=1e-10)
    assert got.iters < 300 and got.converged if threshold else got.iters == 300


def test_adam_barebones_gp_matches_jax():
    jgp, tgp, x, y = problem(128)
    want = jmle.adam(j_masked_vg(j_make_gp_logp(jgp, x=x, y=y)), jnp.zeros(3), iters=50)
    got = mle.adam(masked_value_and_grad(make_gp_logp(tgp, x=T(x), y=T(y))),
                   torch.zeros(3, dtype=torch.float64), iters=50)
    assert_same_result(got, want, rtol=1e-8)
    assert got.iters == 50


def test_adam_non_finite_guard_matches_jax():
    """A logp that turns NaN once x[0] passes 0.3: the step there is
    zeroed, the last finite value kept, and the run ends stalled."""

    def j_logp(v):
        return j_quadratic(v) + jnp.where(v[0] > 0.3, jnp.nan, 0.0)

    def t_logp(v):
        return t_quadratic(v) + torch.where(v[0] > 0.3, float("nan"), 0.0)

    want = jmle.adam(jax.value_and_grad(j_logp), jnp.zeros(3), iters=300, rate=0.05)
    got = mle.adam(masked_value_and_grad(t_logp), torch.zeros(3, dtype=torch.float64), iters=300, rate=0.05)
    assert got.stalled and not got.converged and got.iters < 300
    assert torch.isfinite(got.value) and torch.isfinite(got.x).all()
    assert_same_result(got, want, rtol=1e-10)


def test_adam_free_mask_matches_jax():
    free = [0.0, 1.0, 1.0]
    want = jmle.adam(j_masked_vg(j_quadratic, jnp.asarray(free)), jnp.zeros(3), iters=200, rate=0.05)
    got = mle.adam(masked_value_and_grad(t_quadratic, T(free)), torch.zeros(3, dtype=torch.float64),
                   iters=200, rate=0.05)
    assert float(got.x[0]) == 0.0
    assert_same_result(got, want, rtol=1e-10)


# -- LBFGS, the same optimum ----------------------------------------------------


def test_lbfgs_quadratic_reaches_jax_optimum():
    want = jmle.lbfgs(j_quadratic, jnp.zeros(3), iters=100)
    got = mle.lbfgs(t_quadratic, torch.zeros(3, dtype=torch.float64), iters=100)
    assert got.converged and bool(want.converged) and not got.stalled and got.iters < 100
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), TARGET, atol=1e-6)


def test_lbfgs_barebones_gp_reaches_jax_optimum():
    jgp, tgp, x, y = problem(64)
    want = jmle.lbfgs(j_make_gp_logp(jgp, x=x, y=y), jnp.zeros(3), iters=200)
    got = mle.lbfgs(make_gp_logp(tgp, x=T(x), y=T(y)), torch.zeros(3, dtype=torch.float64), iters=200)
    assert got.converged and bool(want.converged) and got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=1e-9)


def test_lbfgs_free_mask_reaches_jax_optimum():
    free = [1.0, 0.0, 1.0]
    want = jmle.lbfgs(j_quadratic, jnp.zeros(3), iters=100, free=jnp.asarray(free))
    got = mle.lbfgs(t_quadratic, torch.zeros(3, dtype=torch.float64), iters=100, free=T(free))
    assert float(got.x[1]) == 0.0 and got.converged and got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6)


def test_lbfgs_stall_flag():
    """A gradient of the wrong sign: every trial point of the line search
    is worse than the start, so the step is exactly zero while the gradient
    is above the threshold.  The run restarts its memory once, fails again
    and stops, stalled, at x0: it never ends below its start."""

    class WrongSign(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            ctx.save_for_backward(v)
            return -(v * v).sum()

        @staticmethod
        def backward(ctx, g):
            (v,) = ctx.saved_tensors
            return g * 2 * v

    x0 = torch.ones(2, dtype=torch.float64)
    got = mle.lbfgs(WrongSign.apply, x0, iters=20)
    assert got.stalled and not got.converged and got.iters == 2
    np.testing.assert_array_equal(got.x.numpy(), [1.0, 1.0])
    assert float(got.value) >= float(WrongSign.apply(x0))


@pytest.mark.parametrize("case", ["kink", "unbounded"])
def test_failed_search_takes_optax_safe_step(case):
    """A zoom search that fails but found points of sufficient decrease
    steps to the lowest of them, at optax's step length: at a kink the
    bracket shrinks below its threshold (the curvature condition cannot
    hold there); on a line falling without end the doubling never brackets
    in 20 trials.  Held against ``optax.scale_by_zoom_linesearch`` (the
    line search of ``optax.lbfgs``) on one row: the step length and the
    value to 1e-12, the gradient there exactly."""
    jf, tf, x0 = {
        "kink": (lambda x: jnp.abs(x[0] - 0.3) + 0.01 * x[0] ** 2,
                 lambda X: (X[:, 0] - 0.3).abs() + 0.01 * X[:, 0] ** 2, [0.0]),
        "unbounded": (lambda x: -x[0] - 0.5 * x[1], lambda X: -X[:, 0] - 0.5 * X[:, 1], [0.0, 1.0]),
    }[case]
    d = np.ones(len(x0))
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20)
    p = jnp.asarray(x0)
    v, g = jax.value_and_grad(jf)(p)
    _, state = ls.update(jnp.asarray(d), ls.init(p), p, value=v, grad=g, value_fn=jf)
    assert float(state.info.curvature_error) > 0  # the search failed

    def objective(X):
        X = X.detach().requires_grad_(True)
        with torch.enable_grad():
            val = tf(X)
            (grad,) = torch.autograd.grad(val.sum(), X)
        return val.detach(), grad

    X = T([x0])
    f, grad = objective(X)
    t, value, g_t = mle._zoom_linesearch(objective, X, T([d]), f, grad, torch.tensor([True]))
    want_t = float(state.learning_rate)
    assert 0.0 < want_t and float(value[0]) < float(f[0])
    np.testing.assert_allclose(float(t[0]), want_t, rtol=1e-12)
    np.testing.assert_allclose(float(value[0]), float(jf(p + want_t * jnp.asarray(d))), rtol=1e-12)
    np.testing.assert_array_equal(g_t[0].numpy(), np.asarray(jax.grad(jf)(p + float(t[0]) * jnp.asarray(d))))


def test_lbfgs_stall_outside_domain_matches_jax():
    """A log-density that is NaN wherever x leaves x0: every trial of the
    line search is outside the domain.  JAX (optax) takes no step and stops
    after one iteration; the port restarts its memory once and stops after
    two, at the same x and value, stalled."""

    def j_logp(v):
        return jnp.where(jnp.abs(v - 1.0).max() > 0, jnp.nan, -jnp.sum(v * v))

    def t_logp(v):
        return torch.where((v - 1.0).abs().max() > 0, float("nan"), -(v * v).sum())

    want = convert.opt_result(jmle.lbfgs(j_logp, jnp.ones(2), iters=20), "cpu")
    got = mle.lbfgs(t_logp, torch.ones(2, dtype=torch.float64), iters=20)
    assert got.stalled and bool(want.stalled) and not got.converged
    assert (want.iters, got.iters) == (1, 2)
    np.testing.assert_array_equal(got.x.numpy(), want.x.numpy())
    assert float(got.value) == float(want.value) == -2.0


def test_lbfgs_starting_at_optimum_stops_at_once():
    got = mle.lbfgs(t_quadratic, torch.tensor(TARGET, dtype=torch.float64), iters=100)
    assert got.iters == 1 and got.converged and not got.stalled


# -- models/model.py -------------------------------------------------------------


def test_model_helpers_match_jax():
    np.testing.assert_array_equal(tmodel.free_mask_warpedtime(3, 5, dtype=torch.float64).numpy(),
                                  np.asarray(jmodel.free_mask_warpedtime(3, 5)))
    np.testing.assert_array_equal(tmodel.free_mask_anynoise(3, 5, ndim=2, dtype=torch.float64).numpy(),
                                  np.asarray(jmodel.free_mask_anynoise(3, 5, ndim=2)))
    v = np.array([0.3, -1.0, 2.0])
    jsum = jmodel.add_logps(j_quadratic, lambda vv: jnp.sum(vv**3))
    tsum = tmodel.add_logps(t_quadratic, lambda vv: (vv**3).sum())
    jv, jg = j_masked_vg(jsum, jnp.asarray([1.0, 0.0, 1.0]))(jnp.asarray(v))
    tv, tg = masked_value_and_grad(tsum, T([1.0, 0.0, 1.0]))(T(v))
    assert abs(float(tv) - float(jv)) <= 1e-14
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-14)
    assert not tv.requires_grad and not tg.requires_grad
    _, g0 = masked_value_and_grad(lambda vv: torch.zeros((), dtype=vv.dtype))(T(v))
    np.testing.assert_array_equal(g0.numpy(), 0.0)


# -- the slice: fit, then forecast -------------------------------------------------


def test_fit_then_forecast_slice_matches_jax():
    """Barebones GP at n = 256: Adam for 30 steps from v0 = 0 through the
    blocked path (K1, K3, K3 transpose and the GPML-5.9 backward), then
    gp_posterior (K1 through absorb) and the forecast at 32 points (K5
    through trsm_lower).  v rtol 1e-8 (30 steps of f64 gradients), mean and
    std atol 1e-9."""
    jgp, tgp, x, y = problem(256)
    z = np.linspace(0, 100, 32)
    with cp.force_interpret():
        want = jmle.adam(j_masked_vg(j_make_gp_logp(jgp, x=x, y=y)), jnp.zeros(3), iters=30, threshold=0.0)
        post = jparams.gp_posterior(jgp, want.x, x=x, y=y)
        want_pred = (jcore.predict_from_posterior(jgp, post, z[:, None]),
                     jcore.predict_y_from_posterior(jgp, post, z[:, None]))
    cb.reset_launch_counts()
    with cb.force_blocked(64):
        got = mle.adam(masked_value_and_grad(make_gp_logp(tgp, x=T(x), y=T(y))),
                       torch.zeros(3, dtype=torch.float64), iters=30, threshold=0.0)
        tpost = tparams.gp_posterior(tgp, got.x, x=T(x), y=T(y))
        got_pred = (tcore.predict_from_posterior(tgp, tpost, T(z)),
                    tcore.predict_y_from_posterior(tgp, tpost, T(z)))
    assert all(v == 0 for v in cb.LAUNCHES.values())  # CPU tensors: plain versions
    assert_same_result(got, want, rtol=1e-8)
    for (mu_g, s_g), (mu_w, s_w) in zip(got_pred, want_pred):
        assert mu_g.shape == (32,) and torch.isfinite(s_g).all()
        np.testing.assert_allclose(mu_g.numpy(), np.asarray(mu_w), atol=1e-9)
        np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), atol=1e-9)


def test_opt_result_conversion():
    want = jmle.lbfgs(j_quadratic, jnp.zeros(3), iters=5)
    got = convert.opt_result(want, "cpu")
    assert isinstance(got, mle.OptResult)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert got.iters == int(want.iters) and got.converged == bool(want.converged)
    assert got.x.dtype == torch.float64 and got.value.shape == ()
