"""Parity of the port's iterative engine (gogp_torch.ops.iterative and the
iterative, matrix-free parts of gogp_torch.gp.core) with gogp_tpu's, in f64
on the CPU, with JAX's own probes handed in through the ``PathDraws`` hook
(:class:`JaxPathDraws`: each split a ``jax.random.split``).

Tolerances.  The building blocks given the same operator and probes (the
pivots and the preconditioner, SLQ's Lanczos quadrature, the CG recurrence
coefficients, CG run to a tight tolerance) agree to rounding: rtol 1e-9.
The LMLs and predictions solve by CG to the twins' default relative residual
of 1e-6 (or to their iteration budget).  CG's iterates amplify the two
packages' different summation orders (XLA's and torch's matmuls and sums)
until that stopping point, so their solutions agree to about 1e-8 of their
size, not to rounding: the values are held at rtol 1e-7 and the gradients
at 1e-6 of their largest entry (at most 9.6e-9 and 6.6e-8 measured), the
predictions at 1e-5 (their solves stop at 1e-6; 5e-6 measured).  For the
same reason an iteration count can part by one where the last residual lies
within rounding of the tolerance, and in CG's erratic middle phase that
band is wide: on this file's covariance the last residual of one
unpreconditioned right-hand side moved from 6.4 to 1.07 times the tolerance
under numpy's against torch's matmul.  The count tests hold block solves,
whose counts sit clear of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gogp_tpu.gp as jgp_pkg
from gogp_tpu.gp import core as jcore
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as junif
from gogp_tpu.ops import iterative as jit_ops
from gogp_torch import gp as tgp
from gogp_torch.gp import core
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import iterative
from test_torch_pathwise import JaxPathDraws

TOL = 1e-9  # rounding
VALUE_RTOL, GRAD_RTOL, PRED_RTOL = 1e-7, 1e-6, 1e-5  # through CG at tol 1e-6
KEY = 7
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=junif)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
V0 = np.array([0.0, -0.5, -0.7])  # log-theta: scale, lengthscale, noise std
ESTIMATOR = dict(num_probes=8, cg_iters=50, lanczos_iters=16)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want) -> float:
    """Largest absolute difference over the largest entry of ``want``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _problem(n=96, pad=0, seed=0):
    """Sorted inputs on [0, 10], a noisy sine; ``pad`` zero rows masked out."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    mask = np.ones(n)
    if pad:
        x, y = np.concatenate([x, np.zeros((pad, 1))]), np.concatenate([y, np.zeros(pad)])
        mask = np.concatenate([mask, np.zeros(pad)])
    return x, y, mask


def _cov(v=V0, n=96):
    x, _, _ = _problem(n)
    th = np.exp(v)
    return np.asarray(jcore.masked_cov(JGP, th[:2], th[2:], x, None)), float(th[2] ** 2)


@pytest.mark.parametrize("rank", [0, 4])
def test_cg_solve_matches_jax(rank):
    """X and the iteration count, with and without the preconditioner, to a
    tight tolerance; also a single right-hand side."""
    K, nv = _cov()
    B = np.random.default_rng(1).normal(size=(K.shape[0], 3))

    def jax_solve(K, B):
        pc = jit_ops.pivoted_precond(K, rank, nv) if rank else None
        return jit_ops.cg_solve(K, B, 200, 1e-10, precond=pc)

    want, want_iters = jax.jit(jax_solve)(K, B)
    pc = iterative.pivoted_precond(_t(K), rank, nv) if rank else None
    got, iters = iterative.cg_solve(_t(K), _t(B), 200, 1e-10, precond=pc)
    assert iters == int(want_iters)
    assert _rel(got, want) < TOL
    # a vector is the (n, 1) block squeezed
    got1, iters1 = iterative.cg_solve(_t(K), _t(B[:, 0]), 200, 1e-10, precond=pc)
    got2, iters2 = iterative.cg_solve(_t(K), _t(B[:, :1]), 200, 1e-10, precond=pc)
    assert got1.shape == (K.shape[0],) and iters1 == iters2
    np.testing.assert_array_equal(got1.numpy(), got2[:, 0].numpy())


def test_cg_solve_batch_counts_each_element():
    """(B, n, n) operators in one lockstep solve: each element's X and its
    own iteration count, as ``jax.vmap`` of the twin gives them, and as
    the port's own solve of each element alone gives them."""
    Ks = np.stack([_cov(v)[0] for v in ([0.0, -0.5, -0.7], [0.0, -0.5, -0.2], [0.0, -0.5, 0.5])])
    B = np.random.default_rng(2).normal(size=(3, Ks.shape[1], 2))
    want, want_iters = jax.jit(jax.vmap(lambda K, b: jit_ops.cg_solve(K, b, 200, 1e-10)))(Ks, B)
    got, iters = iterative.cg_solve(_t(Ks), _t(B), 200, 1e-10)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want_iters))
    assert iters.tolist() == [iterative.cg_solve(_t(K), _t(b), 200, 1e-10)[1] for K, b in zip(Ks, B)]
    assert len(set(iters.tolist())) == 3  # the elements stop apart
    assert _rel(got, want) < TOL


def test_pivoted_cholesky_and_precond_match_jax():
    """The pivots (dense and from a column accessor), the Woodbury apply, the
    determinant-lemma logdet and N(0, P) samples."""
    K, nv = _cov()
    n, rank = K.shape[0], 8
    want_L = jax.jit(lambda K: jit_ops.pivoted_cholesky(K, rank, 0.1))(K)
    assert _rel(iterative.pivoted_cholesky(_t(K), rank, 0.1), want_L) < TOL
    jpc = jit_ops.pivoted_precond(jnp.asarray(K), rank, nv)
    pc = iterative.pivoted_precond(_t(K), rank, nv)
    np.testing.assert_array_equal(np.argmax(np.abs(pc.L.numpy()), 0), np.argmax(np.abs(np.asarray(jpc.L)), 0))
    assert _rel(pc.L, jpc.L) < TOL
    assert _rel(pc.logdet, jpc.logdet) < TOL
    rng = np.random.default_rng(3)
    V, eps_n, eps_r = rng.normal(size=(n, 4)), rng.normal(size=(5, n)), rng.normal(size=(5, rank))
    assert _rel(pc(_t(V)), jpc(jnp.asarray(V))) < TOL
    assert _rel(pc(_t(V[:, 0])), jpc(jnp.asarray(V[:, 0]))) < TOL
    assert _rel(pc.sample(_t(eps_n), _t(eps_r)), jpc.sample(eps_n, eps_r)) < TOL
    diag = jnp.diagonal(jnp.asarray(K))
    jcols = jit_ops.pivoted_precond_cols(lambda i: jnp.asarray(K)[:, i], diag, rank, jnp.full(n, nv))
    cols = iterative.pivoted_precond_cols(lambda i: _t(K)[:, i], _t(diag), rank, torch.full((n,), nv, dtype=torch.float64))
    assert _rel(cols.L, jcols.L) < TOL
    assert _rel(cols.L, pc.L) < TOL  # the same preconditioner as the dense build


def test_rademacher_replays_jax():
    key = jax.random.PRNGKey(KEY)
    want = jit_ops.rademacher(key, (4, 33), jnp.float64)
    got = iterative.rademacher(JaxPathDraws(key), (4, 33), torch.zeros((), dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_hook_is_one_below_both_layers():
    """The engines and the pathwise sampler share one draws hook, which sits
    in the ops layer; a generator stands in for it, seeded 0 when None."""
    from gogp_torch.gp import pathwise
    from gogp_torch.ops import draws

    assert pathwise.PathDraws is draws.PathDraws and pathwise.GeneratorDraws is draws.GeneratorDraws
    assert pathwise.as_draws is draws.as_draws and iterative.as_draws is draws.as_draws
    ref = torch.zeros((), dtype=torch.float64)
    a = iterative.rademacher(draws.as_draws(None, ref), (3, 5), ref)
    b = iterative.rademacher(draws.as_draws(torch.Generator().manual_seed(0), ref), (3, 5), ref)
    assert torch.equal(a, b)


def test_slq_logdet_and_coefficients_match_jax():
    """Plain SLQ over Rademacher probes (the p probes as one block) and
    preconditioned SLQ from the PCG coefficients, on the same operator."""
    K, nv = _cov()
    n = K.shape[0]
    probes = jit_ops.rademacher(jax.random.PRNGKey(KEY), (8, n), jnp.float64)
    want = jax.jit(lambda K, p: jit_ops.slq_logdet(K, p, 16))(K, probes)
    assert _rel(iterative.slq_logdet(_t(K), _t(probes), 16), want) < TOL
    # a callable operator takes the same path
    assert _rel(iterative.slq_logdet(lambda V: _t(K) @ V, _t(probes), 16), want) < TOL
    rng = np.random.default_rng(4)
    eps_n, eps_r = rng.normal(size=(8, n)), rng.normal(size=(8, 4))

    def jax_pcg(K, en, er):
        pc = jit_ops.pivoted_precond(K, 4, nv)
        Z = pc.sample(en, er)
        return jit_ops.slq_logdet_pcg(K, pc, en, er, 16), jit_ops.cg_coefficients(K, Z, 12, precond=pc)

    want_ld, (want_X, want_a, want_b) = jax.jit(jax_pcg)(K, eps_n, eps_r)
    pc = iterative.pivoted_precond(_t(K), 4, nv)
    assert _rel(iterative.slq_logdet_pcg(_t(K), pc, _t(eps_n), _t(eps_r), 16), want_ld) < TOL
    X, a, b = iterative.cg_coefficients(_t(K), pc.sample(_t(eps_n), _t(eps_r)), 12, precond=pc)
    assert a.shape == (12, 8) and _rel(a, want_a) < TOL and _rel(b, want_b) < TOL and _rel(X, want_X) < TOL


def test_slq_logdet_is_nan_where_jax_is():
    """A non-finite operator (a sampler's overflowing proposal) gives NaN
    through the quadrature, as JAX's eigh gives it, not an error."""
    K = _cov()[0].copy()
    K[3, 3] = np.nan
    probes = jit_ops.rademacher(jax.random.PRNGKey(KEY), (4, K.shape[0]), jnp.float64)
    assert np.isnan(float(jax.jit(lambda K, p: jit_ops.slq_logdet(K, p, 8))(K, probes)))
    assert torch.isnan(iterative.slq_logdet(_t(K), _t(probes), 8))


def _jax_lml(fn, v, y, **kw):
    """JAX's value and gradient in (log-theta, y), jitted once."""

    def f(v, y):
        th = jnp.exp(v)
        return fn(th[:2], th[2:], y, **kw)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(v, y)


def _port_lml(fn, v, y, **kw):
    vt, yt = _t(v).requires_grad_(True), _t(y).requires_grad_(True)
    th = torch.exp(vt)
    value = fn(th[:2], th[2:], yt, **kw)
    value.backward()
    return value.detach(), vt.grad, yt.grad


def _assert_lml(got, want):
    (value, gv, gy), (want_value, (want_gv, want_gy)) = got, want
    assert _rel(value, want_value) < VALUE_RTOL
    assert _rel(gv, want_gv) < GRAD_RTOL
    assert _rel(gy, want_gy) < GRAD_RTOL


@pytest.mark.parametrize("rank", [0, 4])
def test_lml_iterative_matches_jax(rank):
    """Value, theta gradient and y gradient (ybar = -alpha) with 8 padded
    rows; the value-only call (y solved alone) gives the same value."""
    x, y, mask = _problem(88, pad=8)
    kw = dict(ESTIMATOR, precond_rank=rank)
    key = jax.random.PRNGKey(KEY)
    want = _jax_lml(lambda ts, tn, y: jcore.lml_iterative(JGP, ts, tn, x, y, key, mask, **kw), V0, y)
    got = _port_lml(lambda ts, tn, y: core.lml_iterative(TGP, ts, tn, _t(x), y, JaxPathDraws(key), _t(mask), **kw),
                    V0, y)
    _assert_lml(got, want)
    th = _t(np.exp(V0))
    value_only = core.lml_iterative(TGP, th[:2], th[2:], _t(x), _t(y), JaxPathDraws(key), _t(mask), **kw)
    assert _rel(value_only, want[0]) < VALUE_RTOL


@pytest.mark.parametrize("rank", [0, 4])
def test_lml_iterative_matfree_matches_jax(rank):
    """K rebuilt 32 rows at a time, the gradient from the frozen solutions'
    quadratic forms (checkpointed panels), with padded rows."""
    x, y, mask = _problem(88, pad=8)
    kw = dict(ESTIMATOR, precond_rank=rank, panel=32)
    key = jax.random.PRNGKey(KEY)
    want = _jax_lml(lambda ts, tn, y: jcore.lml_iterative_matfree(JGP, ts, tn, x, y, key, mask, **kw), V0, y)
    got = _port_lml(lambda ts, tn, y: core.lml_iterative_matfree(TGP, ts, tn, _t(x), y, JaxPathDraws(key), _t(mask),
                                                                 **kw), V0, y)
    _assert_lml(got, want)
    # the dense engine on the same probes: the same estimator to CG's room
    dense = _port_lml(lambda ts, tn, y: core.lml_iterative(TGP, ts, tn, _t(x), y, JaxPathDraws(key), _t(mask),
                                                           precond_rank=rank, **ESTIMATOR), V0, y)
    assert _rel(got[0], dense[0]) < VALUE_RTOL and _rel(got[1], dense[1]) < GRAD_RTOL


def test_matfree_panel_divisibility():
    x, y, _ = _problem(96)
    th = _t(np.exp(V0))
    with pytest.raises(ValueError, match="not divisible by panel"):
        core.lml_iterative_matfree(TGP, th[:2], th[2:], _t(x), _t(y), JaxPathDraws(KEY), panel=40)
    with pytest.raises(ValueError, match="not divisible by panel"):
        iterative.matfree_matvec(lambda r: None, 96, 40)


def test_predict_iterative_matches_jax():
    x, y, mask = _problem(88, pad=8)
    th = np.exp(V0)
    z = np.linspace(-1.0, 11.0, 13)[:, None]
    want = jax.jit(lambda x, y, z: jcore.predict_iterative(JGP, th[:2], th[2:], x, y, z, mask, panel=32))(x, y, z)
    got = core.predict_iterative(TGP, _t(th[:2]), _t(th[2:]), _t(x), _t(y), _t(z), _t(mask), panel=32)
    for g, w in zip(got, want):
        assert g.shape == (13,) and _rel(g, w) < PRED_RTOL


@pytest.mark.parametrize("rank", [0, 4])
def test_batched_lml_iterative_matches_vmap(rank):
    """B = 3 hyperparameter settings in one lockstep call: (3,) values and
    their gradients against ``jax.vmap`` of the twin, shared probes."""
    x, y, _ = _problem(80, seed=5)
    V = np.array([[0.0, -0.3, -0.7], [0.2, -0.1, -0.9], [-0.1, -0.5, -0.6]])
    kw = dict(num_probes=8, cg_iters=40, lanczos_iters=12, precond_rank=rank)
    key = jax.random.PRNGKey(5)

    def f(v):
        th = jnp.exp(v)
        return jcore.lml_iterative(JGP, th[:2], th[2:], x, y, key, **kw)

    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(f)))(V)
    vt = _t(V).requires_grad_(True)
    th = torch.exp(vt)
    got = core.lml_iterative(TGP, th[:, :2], th[:, 2:], _t(x), _t(y), JaxPathDraws(key), **kw)
    got.sum().backward()
    assert got.shape == (3,)
    assert _rel(got, want) < VALUE_RTOL and _rel(vt.grad, want_g) < GRAD_RTOL


def test_exports_match_jax():
    """Every public name of the twin's module, the row-sharded form
    included, and every name of gogp_tpu.gp's core, pathwise and SKI
    exports."""
    public = {name for name, obj in vars(jit_ops).items()
              if not name.startswith("_") and getattr(obj, "__module__", None) == jit_ops.__name__}
    assert public - set(iterative.__all__) == set()
    assert all(hasattr(iterative, name) for name in iterative.__all__)
    names = ["GP", "Posterior", "absorb", "lml", "lml_from_posterior", "lml_iterative", "lml_iterative_matfree",
             "lml_toeplitz", "predict", "predict_iterative", "predict_toeplitz", "predict_from_posterior",
             "predict_y_from_posterior", "predict_mixture", "predict_prior", "LOOResult", "aic", "bic", "loo",
             "loo_from_posterior", "loo_score", "PathFeatures", "PathState", "SparsePathState", "eval_paths",
             "eval_paths_sparse", "eval_prior_paths", "prior_paths", "sample_features", "sample_paths",
             "sample_paths_laplace", "sample_paths_ski", "sample_paths_svgp", "lml_ski", "predict_ski"]
    assert all(hasattr(jgp_pkg, name) for name in names)
    missing = [name for name in names if not hasattr(tgp, name)]
    assert not missing, missing
