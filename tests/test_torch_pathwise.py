"""Parity of the port's pathwise sampling (gogp_torch.gp.pathwise) with
gogp_tpu.gp.pathwise, and its moments in the port alone.

JAX's own draws go into the port through the ``PathDraws`` hook
(:class:`JaxPathDraws`: each split a ``jax.random.split``, each draw JAX's,
in float64), so that the port computes from the same numbers: the features
of every ``spec`` tag, the paths and their evaluations agree with JAX's to
rtol 1e-9 (atol 1e-12 near 0), on the plain route and on the blocked one
under ``cb.force_blocked(32)`` at n = 64 (K5's plain version on the CPU).
The posteriors are JAX's own, carried across (``convert``), so that the
comparison is of this module alone.

The moment checks of the JAX package's tests (prior and posterior path
moments, coherence, padding) run in the port alone with its generator's
draws, at the JAX tests' sizes and bounds: each bound is several times the
Monte Carlo error of its mean or covariance over 8192 paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import laplace as jlap
from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.gp import pathwise as jpw
from gogp_tpu.gp import sparse as jsparse
from gogp_tpu import kernels as jk
from gogp_torch import convert
from gogp_torch import gp as tgp
from gogp_torch import kernels as tk
from gogp_torch.gp import core, laplace, likelihoods, pathwise, serve, sparse
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
KEY = 7


def _t(a, ref=None):
    a = torch.tensor(np.array(a))
    return a if ref is None else a.to(ref.device, ref.dtype)


class JaxPathDraws:
    """JAX's key tree through the port's ``PathDraws`` hook: each split a
    ``jax.random.split`` of this node's key, each draw JAX's own from it, in
    float64, handed to the port as a tensor like ``ref``."""

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key

    def split(self, num):
        return tuple(JaxPathDraws(k) for k in jax.random.split(self.key, num))

    def normal(self, shape, ref):
        return _t(jax.random.normal(self.key, tuple(shape), jnp.float64), ref)

    def uniform(self, shape, ref):
        return _t(jax.random.uniform(self.key, tuple(shape), jnp.float64), ref)

    def gamma(self, a, shape, ref):
        return _t(jax.random.gamma(self.key, jnp.asarray(np.asarray(a)), tuple(shape), jnp.float64), ref)

    def bernoulli(self, p, shape, ref):
        return torch.tensor(np.array(jax.random.bernoulli(self.key, p, tuple(shape))))

    def categorical(self, logits, shape):
        return torch.tensor(np.array(jax.random.categorical(self.key, jnp.asarray(logits.numpy()), shape=tuple(shape))))

    def rademacher(self, shape, ref):
        return _t(jax.random.rademacher(self.key, tuple(shape), jnp.float64), ref)

    def choice(self, n, k, ref):
        return torch.tensor(np.array(jax.random.choice(self.key, n, (k,), replace=False)))


def _jit(fn, *args):
    """``fn(*args)`` compiled once: JAX's eager ops each compile per shape,
    which costs seconds a test."""
    return jax.jit(fn)(*args)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


def _features_close(got, want, tol=TOL):
    for name in ("omega", "phase", "a", "task_load"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            _close(g, w, tol, name)


def _icm_theta(w, kappa, base_theta):
    """An ICM theta in the protocol's layout: [base | exp(W) | kappa]."""
    return list(base_theta) + [float(np.exp(v)) for v in w] + list(kappa)


# (name, JAX kernel, port kernel, theta, ndim): every spec tag, as the JAX
# tests list them, and ICM and LMC
CASES = [
    ("rbf", jk.normal, tk.normal, [1.3], 1),
    ("matern12", jk.matern12, tk.matern12, [0.8], 1),
    ("matern32", jk.matern32, tk.matern32, [0.8], 1),
    ("matern52", jk.matern52, tk.matern52, [1.1], 1),
    ("matern52_ref", jk.matern52_ref, tk.matern52_ref, [1.1], 1),
    ("matern52_ref_2d", jk.matern52_ref, tk.matern52_ref, [0.9], 2),
    ("periodic", jk.periodic, tk.periodic, [1.1, 2.3], 1),
    ("periodic_short", jk.periodic, tk.periodic, [0.05, 2.3], 1),
    ("rq", jk.rational_quadratic, tk.rational_quadratic, [1.0, 1.5], 1),
    ("scaled_rbf", jk.normal.scaled(), tk.normal.scaled(), [1.7, 0.9], 1),
    ("sum", jk.normal.scaled() + jk.matern32.scaled(), tk.normal.scaled() + tk.matern32.scaled(),
     [0.8, 1.2, 1.4, 0.7], 1),
    ("prod", jk.normal * jk.matern32, tk.normal * tk.matern32, [1.5, 0.9], 1),
    ("sm", jk.spectral_mixture(2), tk.spectral_mixture(2), [0.6, 0.9, 0.3, 1.1, 0.05, 0.2], 1),
    ("sm_2d", jk.spectral_mixture(2, 2), tk.spectral_mixture(2, 2),
     [0.6, 0.9, 0.3, 1.1, 0.2, 0.4, 0.05, 0.2, 0.1, 0.3], 2),
    ("rbf2d", jk.normal, tk.normal, [1.0], 2),
    ("ard", jk.normal.ard(2), tk.normal.ard(2), [0.7, 1.9, 1.0], 2),
    ("matern32_2d", jk.matern32, tk.matern32, [1.2], 2),
    ("icm", jk.icm(jk.normal, 2, 1), tk.icm(tk.normal, 2, 1), _icm_theta([0.9, -0.6], [0.3, 0.5], [1.1]), 2),
    ("icm_scaled", jk.icm(jk.normal.scaled(), 3, 2).scaled(), tk.icm(tk.normal.scaled(), 3, 2).scaled(),
     [1.3] + _icm_theta([0.9, -0.6, 0.2, 0.4, -0.1, 0.3], [0.3, 0.5, 0.2], [0.8, 1.1]), 2),
    ("lmc", jk.lmc([jk.normal, jk.matern32], 2, 1), tk.lmc([tk.normal, tk.matern32], 2, 1),
     _icm_theta([0.8, 0.4], [0.2, 0.3], [1.0]) + _icm_theta([-0.5, 0.7], [0.4, 0.1], [0.7]), 2),
]


def _points(ndim, m=7, seed=3, tasks=0):
    rng = np.random.default_rng(seed)
    if tasks:
        return np.concatenate([rng.uniform(-2.0, 2.0, (m, ndim - 1)), rng.integers(0, tasks, (m, 1))], axis=1)
    return rng.uniform(-2.0, 2.0, (m, ndim))


def _tasks(name):
    return {"icm": 2, "icm_scaled": 3, "lmc": 2}.get(name, 0)


@pytest.mark.parametrize("name,jkern,tkern,theta,ndim", CASES, ids=[c[0] for c in CASES])
def test_features_match_jax(name, jkern, tkern, theta, ndim):
    f = 64
    want = _jit(lambda th, k: jpw.sample_features(jkern, th, k, f, ndim), jnp.asarray(theta, jnp.float64),
                jax.random.PRNGKey(KEY))
    got = pathwise.sample_features(tkern, _t(theta), JaxPathDraws(KEY), f, ndim)
    _features_close(got, want)
    z = _points(ndim, tasks=_tasks(name))
    _close(pathwise.eval_features(got, _t(z)), _jit(jpw.eval_features, want, z))


def test_bessel_weights_match_jax():
    z = np.array([1e-3, 0.5, 3.0, 40.0, 400.0, 4000.0])
    for zi in z:
        _close(pathwise._bessel_ive(64, _t(zi)), jpw._bessel_ive(64, jnp.asarray(zi)))
    # the quadrature against scipy's exp(-z) I_k(z) where the weights
    # matter (above 1e-12 of the largest), to 1e-12 absolute
    from scipy.special import ive

    for zi in (0.5, 3.0, 40.0, 400.0):
        want = ive(np.arange(64), zi)
        keep = want > 1e-12 * want.max()
        got = pathwise._bessel_ive(64, _t(zi)).numpy()
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-12)


def test_prior_paths_match_jax():
    kern, theta = tk.normal.scaled(), [1.5, 0.9]
    wfeat, ww = jpw.prior_paths(jk.normal.scaled(), jnp.asarray(theta), jax.random.PRNGKey(3), 5, 32, 1)
    feat, w = pathwise.prior_paths(kern, _t(theta), JaxPathDraws(3), 5, 32, 1)
    _features_close(feat, wfeat)
    _close(w, ww)
    z = np.linspace(-1.5, 1.5, 6)[:, None]
    _close(pathwise.eval_prior_paths(feat, w, _t(z)), jpw.eval_prior_paths(wfeat, ww, jnp.asarray(z)))


JGP = jcore.GP(ndim=1, simil=jk.normal.scaled(), noise=jk.uniform_noise)
TGP = core.GP(ndim=1, simil=tk.normal.scaled(), noise=tk.uniform_noise)


def _toy(n=24, noise=0.15, pad=0, seed=0):
    """The JAX tests' toy problem, padded by ``pad`` rows; its JAX
    posterior and the same posterior carried across."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    y = np.sin(1.3 * x[:, 0]) + noise * rng.normal(size=n)
    mask = np.concatenate([np.ones(n), np.zeros(pad)])
    x, y = np.concatenate([x, np.zeros((pad, 1))]), np.concatenate([y, np.zeros(pad)])
    jpost = _jit(lambda x, y, m: jcore.absorb(JGP, jnp.asarray([1.1, 0.8]), jnp.asarray([noise]), x, y, m), x, y, mask)
    return jpost, convert.posterior_from_numpy(jpost, "cpu"), x, y, mask


@pytest.mark.parametrize("pad", [0, 6], ids=["unpadded", "masked"])
def test_sample_and_eval_paths_match_jax(pad):
    jpost, post, _, _, _ = _toy(pad=pad)
    want = _jit(lambda p, k: jpw.sample_paths(JGP, p, k, 6, num_features=64), jpost, jax.random.PRNGKey(5))
    got = pathwise.sample_paths(TGP, post, JaxPathDraws(5), 6, num_features=64)
    _features_close(got.feat, want.feat)
    for name in ("weights", "v", "theta_simil", "x", "mask"):
        _close(getattr(got, name), getattr(want, name), msg=name)
    z = np.linspace(-3.5, 3.5, 9)[:, None]
    _close(pathwise.eval_paths(TGP, got, _t(z)), _jit(lambda ps, z: jpw.eval_paths(JGP, ps, z), want, z))
    if pad:
        assert float(got.v[-pad:].abs().max()) < 1e-12


def test_sample_paths_blocked_route_matches_jax():
    """n = 64 under force_blocked(32): cho_solve_mat is two blocked TRSMs
    with K5's plain version for the tile inverses."""
    jpost, post, _, _, _ = _toy(n=60, pad=4, noise=0.2)
    want = _jit(lambda p, k: jpw.sample_paths(JGP, p, k, 8, num_features=128), jpost, jax.random.PRNGKey(6))
    calls = []
    real = cb.tril_inv_tile

    def counted(L):
        calls.append(L.shape)
        return real(L)

    with cb.force_blocked(32), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "tril_inv_tile", counted)
        got = pathwise.sample_paths(TGP, post, JaxPathDraws(6), 8, num_features=128)
    assert calls == [(2, 32, 32), (2, 32, 32)]
    _close(got.v, want.v)
    z = np.linspace(-3.0, 3.0, 11)[:, None]
    _close(pathwise.eval_paths(TGP, got, _t(z)), _jit(lambda ps, z: jpw.eval_paths(JGP, ps, z), want, z))


def test_multitask_paths_match_jax():
    """ICM over two tasks: features, the Matheron update and the paths at
    both tasks' test points."""
    jk_icm, tk_icm = jk.icm(jk.normal, 2, 1), tk.icm(tk.normal, 2, 1)
    jgp = jcore.GP(ndim=2, simil=jk_icm, noise=jk.uniform_noise)
    tgp_ = core.GP(ndim=2, simil=tk_icm, noise=tk.uniform_noise)
    rng = np.random.default_rng(2)
    x1 = np.sort(rng.uniform(-3, 3, size=(12, 1)), axis=0)
    x2 = np.sort(rng.uniform(-3, 3, size=(10, 1)), axis=0)
    X, Y = jk.stack_tasks([x1, x2], [np.sin(x1[:, 0]), 0.5 * np.sin(x2[:, 0]) + 0.1])
    theta = jnp.asarray(_icm_theta([0.9, 0.5], [0.3, 0.4], [1.0]))
    jpost = _jit(lambda X, Y: jcore.absorb(jgp, theta, jnp.asarray([0.2]), X, Y), X, Y)
    post = convert.posterior_from_numpy(jpost, "cpu")
    want = _jit(lambda p, k: jpw.sample_paths(jgp, p, k, 4, num_features=48), jpost, jax.random.PRNGKey(8))
    got = pathwise.sample_paths(tgp_, post, JaxPathDraws(8), 4, num_features=48)
    _features_close(got.feat, want.feat)
    _close(got.v, want.v)
    z = np.concatenate([np.asarray(jk.task_inputs(jnp.asarray(np.linspace(-3, 3, 6)[:, None]), t)) for t in (0, 1)])
    _close(pathwise.eval_paths(tgp_, got, _t(z)), _jit(lambda ps, z: jpw.eval_paths(jgp, ps, z), want, z))


def _laplace_problem(pad=0):
    rng = np.random.default_rng(5)
    n = 24
    x = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * np.sin(1.4 * x[:, 0])))).astype(float)
    mask = np.concatenate([np.ones(n), np.zeros(pad)])
    return np.concatenate([x, np.zeros((pad, 1))]), np.concatenate([y, np.zeros(pad)]), mask


@pytest.mark.parametrize("pad", [0, 4], ids=["unpadded", "masked"])
def test_sample_paths_laplace_matches_jax(pad):
    jgp = jcore.GP(ndim=1, simil=jk.normal.scaled())
    tgp_ = core.GP(ndim=1, simil=tk.normal.scaled())
    x, y, mask = _laplace_problem(pad)
    jpost = _jit(lambda x, y, m: jlap.laplace_fit(jgp, jlik.bernoulli_logit, jnp.asarray([1.2, 1.0]), jnp.zeros(0),
                                                  x, y, mask=m), x, y, mask)
    post = convert.laplace_posterior_from_numpy(jpost, "cpu")
    want = _jit(lambda p, k: jpw.sample_paths_laplace(jgp, p, k, 6, num_features=64), jpost, jax.random.PRNGKey(1))
    got = pathwise.sample_paths_laplace(tgp_, post, JaxPathDraws(1), 6, num_features=64)
    _close(got.v, want.v)
    z = np.linspace(-3, 3, 7)[:, None]
    _close(pathwise.eval_paths(tgp_, got, _t(z)), _jit(lambda ps, z: jpw.eval_paths(jgp, ps, z), want, z))
    # and from the port's own fit of the same problem (Newton to the same mode)
    own = laplace.laplace_fit(tgp_, likelihoods.bernoulli_logit, _t([1.2, 1.0]), _t(np.zeros(0)), _t(x), _t(y),
                              mask=_t(mask))
    again = pathwise.sample_paths_laplace(tgp_, own, JaxPathDraws(1), 6, num_features=64)
    _close(again.v, want.v, dict(rtol=1e-7, atol=1e-10))
    if pad:
        assert float(got.v[-pad:].abs().max()) < 1e-12


def _sparse_problem():
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(-3, 3, (120, 1)), axis=0)
    y = np.sin(1.2 * x[:, 0]) + 0.1 * rng.normal(size=120)
    z = np.linspace(-3, 3, 16)[:, None]
    ts, tn = np.array([1.0, 0.9]), np.array([0.1])
    return x, y, z, ts, tn


def test_sample_paths_svgp_matches_jax():
    x, y, z, ts, tn = _sparse_problem()
    jstate = _jit(lambda x, y, z: jsparse.svgp_optimal_state(JGP, jnp.asarray(ts), jnp.asarray(tn), x, y, z), x, y, z)
    # a state with a full lower q_sqrt, as a fitted SVGP has
    jstate = jstate._replace(q_sqrt=jstate.q_sqrt + 0.05 * jnp.tril(jnp.ones_like(jstate.q_sqrt), -1))
    state = convert.svgp_state_from_numpy(jstate, "cpu")
    want = _jit(lambda st, k: jpw.sample_paths_svgp(JGP, jnp.asarray(ts), st, k, 5, num_features=64), jstate,
                jax.random.PRNGKey(0))
    got = pathwise.sample_paths_svgp(TGP, _t(ts), state, JaxPathDraws(0), 5, num_features=64)
    _features_close(got.feat, want.feat)
    for name in ("weights", "theta_simil", "z"):
        _close(getattr(got, name), getattr(want, name), msg=name)
    # v = Kzz^{-1}(u - fp(Z)): Kzz of 16 close inducing points carries only
    # its 1e-6 jitter, and its condition number (about 1e6) takes the two
    # packages' rounding to 1e-9 of v's largest entry
    _close(got.v, want.v, dict(rtol=1e-9, atol=1e-9 * float(np.abs(want.v).max())))
    t = np.linspace(-3.5, 3.5, 9)[:, None]
    _close(pathwise.eval_paths_sparse(TGP, got, _t(t)), _jit(lambda ps, t: jpw.eval_paths_sparse(JGP, ps, t), want, t))


def test_converters_round_trip_jax_states():
    jpost, _, _, _, _ = _toy()
    want = _jit(lambda p, k: jpw.sample_paths(JGP, p, k, 3, num_features=16), jpost, jax.random.PRNGKey(5))
    ps = convert.path_state_from_numpy(want, "cpu")
    z = np.linspace(-3, 3, 5)[:, None]
    _close(pathwise.eval_paths(TGP, ps, _t(z)), _jit(lambda ps, z: jpw.eval_paths(JGP, ps, z), want, z))
    x, y, zz, ts, tn = _sparse_problem()
    sw = _jit(lambda x, y, zz, k: jpw.sample_paths_svgp(
        JGP, jnp.asarray(ts), jsparse.svgp_optimal_state(JGP, jnp.asarray(ts), jnp.asarray(tn), x, y, zz), k, 3,
        num_features=16), x, y, zz, jax.random.PRNGKey(1))
    sps = convert.sparse_path_state_from_numpy(sw, "cpu")
    _close(pathwise.eval_paths_sparse(TGP, sps, _t(z)), _jit(lambda ps, z: jpw.eval_paths_sparse(JGP, ps, z), sw, z))
    assert convert.path_features_from_numpy(want.feat, "cpu").task_load is None


@pytest.mark.parametrize("case", ["no_spec", "periodic_2d", "icm_under_prod", "sm_ndim", "lmc_tasks"])
def test_errors_where_jax_raises(case):
    kern, ndim, match = {
        "no_spec": (tk.normal.warp_inputs(lambda x: x * 2.0), 1, "spectral structure"),
        "periodic_2d": (tk.periodic, 2, "1-D only"),
        "icm_under_prod": (tk.icm(tk.normal, 2, 1) * tk.matern32, 2, "icm"),
        "sm_ndim": (tk.spectral_mixture(2, 1), 2, "ndim"),
        "lmc_tasks": (tk.icm(tk.normal, 2, 1) + tk.icm(tk.normal, 3, 1), 2, "task count"),
    }[case]
    with pytest.raises(ValueError, match=match):
        pathwise.sample_features(kern, torch.ones(kern.n_theta, dtype=torch.float64), torch.Generator().manual_seed(0),
                                 64, ndim)


def test_exports_match_jax():
    import gogp_tpu.gp as jgp_pkg

    jax_names = {"PathFeatures", "PathState", "SparsePathState", "eval_paths", "eval_paths_sparse",
                 "eval_prior_paths", "prior_paths", "sample_features", "sample_paths", "sample_paths_laplace",
                 "sample_paths_svgp"}
    assert all(hasattr(jgp_pkg, name) for name in jax_names | {"sample_paths_ski"})
    assert all(getattr(tgp, name) is getattr(pathwise, name) for name in jax_names)
    assert not hasattr(pathwise, "sample_paths_ski")


def test_generator_draws_share_f32_and_f64():
    """One seed gives the same draws in both dtypes (drawn in f64, cast):
    the weights bit for bit, the features to f32's rounding."""
    theta = torch.tensor([1.3, 0.7], dtype=torch.float64)
    (feat, w) = pathwise.prior_paths(tk.normal.scaled(), theta, torch.Generator().manual_seed(4), 3, 32, 1)
    (feat32, w32) = pathwise.prior_paths(tk.normal.scaled(), theta.float(), torch.Generator().manual_seed(4), 3, 32, 1)
    assert w32.dtype == torch.float32
    np.testing.assert_array_equal(w32.numpy(), w.float().numpy())
    for g, w_ in zip(feat32[:3], feat[:3]):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=3e-7)


# -- moments in the port alone (the JAX tests' checks, bounds and sizes) --


def _khat(kernel, theta, pts, f=16384, ndim=1, seed=KEY):
    feat = pathwise.sample_features(kernel, _t(theta), torch.Generator().manual_seed(seed), f, ndim)
    phi = pathwise.eval_features(feat, _t(pts))
    return phi @ phi.T


@pytest.mark.parametrize("name,jkern,tkern,theta,ndim", CASES, ids=[c[0] for c in CASES])
def test_feature_expansion_matches_kernel(name, jkern, tkern, theta, ndim):
    """Bochner: Phi Phi^T -> K as F grows; 0.07 (0.1 for LMC) at F =
    16384 (32768 for LMC), the JAX tests' bounds."""
    pts = _points(ndim, tasks=_tasks(name), m=8)
    f, bound = (32768, 0.1) if name == "lmc" else (16384, 0.08 if name.startswith("icm") else 0.07)
    k_true = tkern.matrix(_t(theta), _t(pts), _t(pts))
    assert float((_khat(tkern, theta, pts, f=f, ndim=ndim) - k_true).abs().max()) < bound


def test_periodic_discrete_spectrum_is_exactly_periodic():
    feat = pathwise.sample_features(tk.periodic, _t([1.4, 2.0]), torch.Generator().manual_seed(1), 512, 1)
    z = _t([[0.3], [0.7]])
    _close(pathwise.eval_features(feat, z + 2.0), pathwise.eval_features(feat, z).numpy(), dict(rtol=0, atol=1e-9))


def test_prior_path_moments():
    kern, theta = tk.normal.scaled(), _t([1.5, 0.9])
    pts = _t(np.linspace(-1.5, 1.5, 6)[:, None])
    feat, w = pathwise.prior_paths(kern, theta, torch.Generator().manual_seed(7), 8192, 8192, 1)
    fs = pathwise.eval_prior_paths(feat, w, pts).numpy()
    assert np.max(np.abs(fs.mean(0))) < 0.08
    assert np.max(np.abs(np.cov(fs.T) - kern.matrix(theta, pts, pts).numpy())) < 0.12


def _toy_port(n=24, noise=0.15):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    y = np.sin(1.3 * x[:, 0]) + noise * rng.normal(size=n)
    return core.absorb(TGP, _t([1.1, 0.8]), _t([noise]), _t(x), _t(y)), x, y


def test_posterior_path_mean_matches_predict():
    """The Matheron mean is exact in expectation at any F: 0.06, the JAX
    test's bound, over 8192 paths of 256 features."""
    post, _, _ = _toy_port()
    z = _t(np.linspace(-3.5, 3.5, 9)[:, None])
    ps = pathwise.sample_paths(TGP, post, torch.Generator().manual_seed(1), 8192, num_features=256)
    mu, _ = core.predict_from_posterior(TGP, post, z)
    assert float((pathwise.eval_paths(TGP, ps, z).mean(0) - mu).abs().max()) < 0.06


def test_posterior_path_covariance_matches_joint():
    post, _, _ = _toy_port()
    z = _t(np.linspace(-3.0, 3.0, 8)[:, None])
    ps = pathwise.sample_paths(TGP, post, torch.Generator().manual_seed(2), 8192, num_features=8192)
    fs = pathwise.eval_paths(TGP, ps, z).numpy()
    _, cov = serve.serve_predict_cov(TGP, serve.compile_posterior(TGP, post), z)
    assert np.abs(np.cov(fs.T) - cov.numpy()).max() < 0.08


def test_paths_are_coherent_functions():
    post, _, _ = _toy_port()
    ps = pathwise.sample_paths(TGP, post, torch.Generator().manual_seed(3), 4, num_features=128)
    z1 = _t([[0.1], [1.2], [2.5]])
    a = pathwise.eval_paths(TGP, ps, z1)
    _close(pathwise.eval_paths(TGP, ps, z1), a.numpy(), dict(rtol=1e-12))
    _close(pathwise.eval_paths(TGP, ps, _t([[1.2]]))[:, 0], a[:, 1].numpy(), dict(rtol=1e-12))


def test_padding_invariance():
    post, x, y = _toy_port(n=16)
    z = _t([[0.5], [-1.0]])
    fs = pathwise.eval_paths(TGP, pathwise.sample_paths(TGP, post, torch.Generator().manual_seed(5), 64, 512), z)
    xp, yp = np.concatenate([x, np.zeros((8, 1))]), np.concatenate([y, np.zeros(8)])
    mask = np.concatenate([np.ones(16), np.zeros(8)])
    post_p = core.absorb(TGP, post.theta_simil, post.theta_noise, _t(xp), _t(yp), _t(mask))
    ps_p = pathwise.sample_paths(TGP, post_p, torch.Generator().manual_seed(5), 64, 512)
    fs_p = pathwise.eval_paths(TGP, ps_p, z)
    assert float((fs.mean(0) - fs_p.mean(0)).abs().max()) < 0.35
    assert float(ps_p.v[16:].abs().max()) < 1e-9


def test_sparse_path_moments_match_svgp_predict():
    x, y, z, ts, tn = _sparse_problem()
    state = sparse.svgp_optimal_state(TGP, _t(ts), _t(tn), _t(x), _t(y), _t(z))
    t = _t(np.linspace(-3.5, 3.5, 9)[:, None])
    ps = pathwise.sample_paths_svgp(TGP, _t(ts), state, torch.Generator().manual_seed(0), 8192, num_features=8192)
    fs = pathwise.eval_paths_sparse(TGP, ps, t)
    mu, sd = sparse.svgp_predict(TGP, _t(ts), state, t)
    assert float((fs.mean(0) - mu).abs().max()) < 0.06
    assert float((fs.std(0) - sd).abs().max()) < 0.06


def test_laplace_path_moments():
    tgp_ = core.GP(ndim=1, simil=tk.normal.scaled())
    x, y, _ = _laplace_problem()
    post = laplace.laplace_fit(tgp_, likelihoods.bernoulli_logit, _t([1.2, 1.0]), _t(np.zeros(0)), _t(x), _t(y))
    ps = pathwise.sample_paths_laplace(tgp_, post, torch.Generator().manual_seed(1), 8192, num_features=4096)
    z = _t(np.linspace(-3, 3, 7)[:, None])
    fs = pathwise.eval_paths(tgp_, ps, z)
    mu, sd = laplace.laplace_predict(tgp_, post, z)
    assert float((fs.mean(0) - mu).abs().max()) < 0.07
    assert float((fs.std(0) - sd).abs().max()) < 0.07
