"""The port's forward slice (conditioning, log density, forecast) against the
JAX package, end to end through both front doors.

The port runs its blocked path under ``force_blocked(64)`` (plain tile
functions on the CPU); JAX runs its Pallas kernels in interpret mode; both
take the stepwise driver (``no_fused_whole()``; the K1 route is held against
JAX in test_torch_backward.py and test_torch_mle.py).  n = 256 with
20 padded rows, float64.  Tolerance: rtol 1e-9 on log densities, atol 1e-9
on means and standard deviations (f64, the same math, a different blocking
and summation order).  Also: the reference goldens of test_gp_golden.py on
the port, the plain path's autograd gradient against jax.grad, and the
conversion of JAX state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_gp_golden as golden
from gogp_tpu.gp import core as jcore
from gogp_tpu.kernels import constant_noise as j_constant
from gogp_tpu.kernels import rbf as j_rbf
from gogp_tpu.kernels import uniform_noise as j_uniform
from gogp_tpu.models import params as jparams
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_torch import convert
from gogp_torch import kernels as tk
from gogp_torch.gp import core as tcore
from gogp_torch.models import params as tparams
from gogp_torch.ops import cholesky_blocked as cb

N, M, PAD = 256, 32, 20
RTOL_LML, ATOL_PRED = 1e-9, 1e-9


def T(a):
    return torch.tensor(np.asarray(a))


def _problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 1.5) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.fixture(scope="module")
def slice_results():
    """Every slice output from both packages, computed once."""
    x, y = _problem()
    mask = np.ones(N)
    mask[-PAD:] = 0.0
    z = np.linspace(0, 10, M)[:, None]
    v = np.log([1.2, 0.8, 0.3])
    ts, tn = np.exp(v[:2]), np.exp(v[2:])

    jgp = jcore.GP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform)
    with cp.force_interpret(), cp.no_fused_whole():
        post = jcore.absorb(jgp, ts, tn, x, y, mask)
        want = {
            "lml_from_posterior": jcore.lml_from_posterior(post),
            "lml": jcore.lml(jgp, ts, tn, x, y, mask),
            "gp_observe": jparams.gp_observe(jgp, jnp.asarray(v), x=x, y=y, mask=mask),
            "predict": jcore.predict_from_posterior(jgp, post, z),
            "predict_y": jcore.predict_y_from_posterior(jgp, post, z),
            "alpha": post.alpha,
            "chol": post.chol,
        }

    tgp = tcore.GP(ndim=1, simil=tk.rbf.scaled(), noise=tk.uniform_noise)
    cb.reset_launch_counts()
    with cb.force_blocked(64), cb.no_fused_whole():
        tpost = tcore.absorb(tgp, T(ts), T(tn), T(x), T(y), T(mask))
        got = {
            "lml_from_posterior": tcore.lml_from_posterior(tpost),
            "lml": tcore.lml(tgp, T(ts), T(tn), T(x), T(y), T(mask)),
            "gp_observe": tparams.gp_observe(tgp, T(v), x=T(x), y=T(y), mask=T(mask)),
            "predict": tcore.predict_from_posterior(tgp, tpost, T(z)),
            "predict_y": tcore.predict_y_from_posterior(tgp, tpost, T(z)),
            "alpha": tpost.alpha,
            "chol": tpost.chol,
        }
    return want, got


@pytest.mark.parametrize("name", ["lml_from_posterior", "lml", "gp_observe"])
def test_log_density_matches_jax(slice_results, name):
    want, got = slice_results
    w, g = float(want[name]), float(got[name])
    assert abs(g - w) <= RTOL_LML * abs(w), (g, w)


@pytest.mark.parametrize("name", ["predict", "predict_y"])
def test_forecast_matches_jax(slice_results, name):
    want, got = slice_results
    (mu_w, s_w), (mu_g, s_g) = want[name], got[name]
    assert mu_g.shape == (M,) and s_g.shape == (M,)
    np.testing.assert_allclose(mu_g.numpy(), np.asarray(mu_w), atol=ATOL_PRED)
    np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), atol=ATOL_PRED)


@pytest.mark.parametrize("name", ["chol", "alpha"])
def test_posterior_state_matches_jax(slice_results, name):
    want, got = slice_results
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-9)


def test_padding_rows_are_identity(slice_results):
    _, got = slice_results
    L = got["chol"].numpy()
    np.testing.assert_array_equal(L[-PAD:, -PAD:], np.eye(PAD))
    np.testing.assert_array_equal(L[-PAD:, :-PAD], 0.0)
    np.testing.assert_array_equal(got["alpha"].numpy()[-PAD:], 0.0)


# -- reference goldens on the port (tests/test_gp_golden.py) ----------------


def _torch_noise(jax_noise):
    if jax_noise.name == "uniform_noise":
        return tk.uniform_noise
    std = float(jax_noise.name.removeprefix("constant_noise(").removesuffix(")"))
    return tk.constant_noise(std)


def _f64(a):
    return torch.tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("case", golden.PRODUCE_CASES, ids=[c[0] for c in golden.PRODUCE_CASES])
def test_golden_produce(case):
    name, noise_std, x, y, z, want_mu, want_sigma = case
    gp = tcore.GP(ndim=1, simil=tk.normal, noise=tk.constant_noise(noise_std))
    theta = _f64([1.0])
    if len(x) == 0:
        mu, sigma = tcore.predict_prior(gp, theta, _f64(z))
    else:
        post = tcore.absorb(gp, theta, _f64([]), _f64(x), _f64(y))
        mu, sigma = tcore.predict_from_posterior(gp, post, _f64(z))
    np.testing.assert_allclose(mu.numpy(), want_mu, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), want_sigma, atol=1e-6)


def test_golden_produce_padded_equivalence():
    gp = tcore.GP(ndim=1, simil=tk.normal, noise=tk.constant_noise(0.1))
    theta, z = _f64([1.0]), _f64([[-2.0], [3.0]])
    post = tcore.absorb(gp, theta, _f64([]), _f64([[0.0], [1.0]]), _f64([1.0, -1.0]))
    xp = _f64([[0.0], [1.0], [7.7], [7.7], [7.7]])
    yp = _f64([1.0, -1.0, -9.9, -9.9, -9.9])
    post_p = tcore.absorb(gp, theta, _f64([]), xp, yp, _f64([1.0, 1.0, 0.0, 0.0, 0.0]))
    for a, b in zip(tcore.predict_from_posterior(gp, post, z), tcore.predict_from_posterior(gp, post_p, z)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-12)
    assert abs(float(tcore.lml_from_posterior(post_p)) - float(tcore.lml_from_posterior(post))) < 1e-12


@pytest.mark.parametrize("case", golden.ELEMENTAL_CASES, ids=[c[0] for c in golden.ELEMENTAL_CASES])
def test_golden_elemental_model(case):
    """Value, autograd gradient against finite differences (the reference's
    own check), and the hyperparameters-only calling convention."""
    name, noise, x_vec, want_ll = case
    gp = tcore.GP(ndim=1, simil=tk.normal, noise=_torch_noise(noise))
    v = _f64(x_vec).requires_grad_(True)
    ll = tparams.gp_observe(gp, v)
    assert abs(float(ll.detach()) - want_ll) < 1e-6, name
    if ll.requires_grad:
        (grad,) = torch.autograd.grad(ll, v)
        dx = 1e-8
        for j in range(v.shape[0]):
            vj = v.detach().clone()
            vj[j] += dx
            dldx = (float(tparams.gp_observe(gp, vj)) - float(ll.detach())) / dx
            assert abs(float(grad[j]) - dldx) <= 1e-4, f"{name}: d/dx{j}"
    rest = x_vec[gp.n_theta:]
    n = len(rest) // 2
    x, y = _f64(rest[:n]).reshape(n, 1), _f64(rest[n:])
    ll_h = tparams.gp_observe(gp, _f64(x_vec[: gp.n_theta]), x=x, y=y)
    assert abs(float(ll_h) - want_ll) < 1e-6, name


def test_golden_gradient_wrt_outputs_is_minus_alpha():
    gp = tcore.GP(ndim=1, simil=tk.normal, noise=tk.constant_noise(0.1))
    v = _f64([0.3, -2.0, -1.0, 0.5, 1.0]).requires_grad_(True)
    (grad,) = torch.autograd.grad(tparams.gp_observe(gp, v), v)
    post = tparams.gp_posterior(gp, v.detach())
    np.testing.assert_allclose(grad[-2:].numpy(), -post.alpha.numpy(), atol=1e-10)


@pytest.mark.parametrize("what", ["lml", "predict"])
def test_golden_composite_exact_arithmetic(what):
    """scale * matern52_ref + periodic with uniform noise against the
    50-digit mpmath GP of test_gp_golden.py, at 1e-9."""
    import mpmath as mp

    mpgp = golden._MPGP(golden._mp_pair_composite, lambda tn, xi: tn[0] * tn[0])
    xs = [mp.mpf(q) for q in ("0", "0.5", "1", "1.75", "2.5", "3")]
    ys = [mp.mpf(q) for q in ("0.3", "-0.2", "0.75", "1.0", "-0.5", "0.1")]
    th_s = [mp.mpf(q) for q in ("1.3", "0.9", "1.1", "2.0")]
    th_n = [mp.mpf("0.25")]
    gp = tcore.GP(ndim=1, simil=tk.matern52_ref.scaled() + tk.periodic, noise=tk.uniform_noise)
    x, y = _f64([[float(q)] for q in xs]), _f64([float(q) for q in ys])
    ts, tn = _f64([1.3, 0.9, 1.1, 2.0]), _f64([0.25])
    if what == "lml":
        want = float(mpgp.lml(th_s, th_n, xs, ys))
        assert abs(float(tcore.lml(gp, ts, tn, x, y)) - want) < 1e-9
        v = torch.log(_f64([1.3, 0.9, 1.1, 2.0, 0.25]))
        assert abs(float(tparams.gp_observe(gp, v, x=x, y=y)) - want) < 1e-9
    else:
        zs = [mp.mpf(q) for q in ("0.25", "1.6", "3.5")]
        want_mu, want_sigma = mpgp.predict(th_s, th_n, xs, ys, zs)
        post = tcore.absorb(gp, ts, tn, x, y)
        mu, sigma = tcore.predict_from_posterior(gp, post, _f64([[float(q)] for q in zs]))
        np.testing.assert_allclose(mu.numpy(), [float(m) for m in want_mu], atol=1e-9)
        np.testing.assert_allclose(sigma.numpy(), [float(s) for s in want_sigma], atol=1e-9)


# -- gradients, parameters, robustness --------------------------------------


def test_gp_observe_gradient_matches_jax_grad():
    """Plain path (n = 48, below every kernel gate): autograd of the withObs
    protocol against jax.grad, gradients wrt log-thetas, inputs and outputs.
    rtol 1e-8, atol 1e-10 (f64 Cholesky pullbacks, different algorithms)."""
    x, y = _problem(48, seed=1)
    v = np.concatenate([np.log([1.2, 0.8, 0.3]), x[:, 0], y])
    jgp = jcore.GP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform)
    want = jax.grad(lambda vv: jparams.gp_observe(jgp, vv))(jnp.asarray(v))
    tgp = tcore.GP(ndim=1, simil=tk.rbf.scaled(), noise=tk.uniform_noise)
    vt = T(v).requires_grad_(True)
    (got,) = torch.autograd.grad(tparams.gp_observe(tgp, vt), vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


def test_split_params_rejects_bad_tail_and_round_trips():
    gp = tcore.GP(ndim=2, simil=tk.rbf.ard(2), noise=tk.uniform_noise)
    with pytest.raises(ValueError, match="not a multiple of ndim"):
        tparams.split_params(gp, torch.zeros(gp.n_theta + 4))
    log_theta, x, y = _f64([0.1, 0.2, 0.3, 0.4]), torch.arange(6.0).reshape(3, 2), _f64([1.0, 2.0, 3.0])
    v = tparams.join_params(gp, log_theta, x.double(), y)
    p = tparams.split_params(gp, v)
    np.testing.assert_allclose(p.theta_simil.numpy(), np.exp([0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(p.x.numpy(), x.numpy())
    np.testing.assert_array_equal(p.y.numpy(), y.numpy())
    assert float(tparams.make_gp_logp(gp)(_f64([0.0, 0.0, 0.0, 0.0]))) == 0.0


def test_robust_absorb_matches_jax():
    """Duplicate inputs with no noise: the plain factor fails and the jitter
    loop rescues it, as in JAX."""
    x = np.array([[0.0], [0.5], [0.5], [1.0]])
    y = np.array([0.1, 0.4, 0.4, -0.2])
    jgp = jcore.GP(ndim=1, simil=j_rbf, noise=j_constant(0.0))
    want = jcore.absorb(jgp, jnp.ones(1), jnp.zeros(0), x, y, robust=True)
    tgp = tcore.GP(ndim=1, simil=tk.rbf, noise=tk.constant_noise(0.0))
    got = tcore.absorb(tgp, _f64([1.0]), _f64([]), T(x), T(y), robust=True)
    assert torch.isfinite(got.chol).all()
    np.testing.assert_allclose(got.chol.numpy(), np.asarray(want.chol), atol=1e-10)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=1e-6)


def test_convert_round_trip():
    """JAX posterior -> numpy -> port -> numpy is exact, and the converted
    posterior forecasts as the JAX one does."""
    x, y = _problem(40, seed=2)
    jgp = jcore.GP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform)
    post = jcore.absorb(jgp, jnp.asarray([1.2, 0.8]), jnp.asarray([0.3]), x, y)
    fields = {k: np.asarray(v) for k, v in post._asdict().items()}
    tpost = convert.posterior_from_numpy(fields, device="cpu")
    back = convert.posterior_to_numpy(tpost)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    z = np.linspace(-1, 11, 7)[:, None]
    tgp = tcore.GP(ndim=1, simil=tk.rbf.scaled(), noise=tk.uniform_noise)
    mu_w, s_w = jcore.predict_from_posterior(jgp, post, z)
    mu_g, s_g = tcore.predict_from_posterior(tgp, tpost, T(z))
    np.testing.assert_allclose(mu_g.numpy(), np.asarray(mu_w), atol=1e-12)
    np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), atol=1e-12)
    v = convert.array_from_numpy(np.log([1.2, 0.8, 0.3]), "cpu")
    assert v.dtype == torch.float64 and v.device.type == "cpu"
