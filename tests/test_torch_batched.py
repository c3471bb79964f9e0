"""The batched exact route: stacks and ``torch.func.vmap`` against ``jax.vmap``.

The JAX package batches its kernel path with ``custom_vmap``
(cholesky_pallas.py:633-644, 1474-1493): a vmapped Cholesky takes the
stepwise driver with its tile kernel over the batch, a vmapped LML core the
library's batched factor plus the tile inverses over every tile.  The port
takes explicit (B, n, n) stacks on the same routes, and ``torch.func.vmap``
reaches them through each ``autograd.Function``'s ``vmap`` staticmethod.
Before those rules existed, ``torch.func.vmap`` of ``linalg.lml_core`` and
of ``linalg.cholesky`` raised under ``force_blocked`` (the CPU stand-in for
the card's gate): an ``autograd.Function`` needs ``setup_context`` and a
vmap rule under functorch transforms.

The JAX side runs ``jax.vmap`` under ``cp.force_interpret()`` (its Pallas
kernels in interpret mode, as tests/test_pallas.py runs them), jitted; the
port runs under ``force_blocked(16)`` at n = 64 and B = 3, the plain tile
versions on the CPU.  Everything is float64, on the same numpy-seeded
inputs.  Tolerances: values rtol 1e-9, gradients rtol 1e-8 (atol 1e-10 for
entries near 0): the same formulas on another blocking (JAX picks block 64
at n = 64) and summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import GP as JGP
from gogp_tpu import dists as jdists
from gogp_tpu import matern32 as j_matern32
from gogp_tpu.kernels import rbf as j_rbf
from gogp_tpu import uniform_noise as j_uniform
from gogp_tpu.gp import core as jcore
from gogp_tpu.models import params as jparams
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.ops import linalg as jlinalg
from gogp_torch import GP, dists, matern32, rbf, uniform_noise
from gogp_torch.gp import core as tcore
from gogp_torch.models import params as tparams
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

B, N, BLOCK = 3, 64, 16
VALUE = dict(rtol=1e-9, atol=1e-12)
GRAD = dict(rtol=1e-8, atol=1e-10)


def T(a):
    return torch.tensor(np.asarray(a))


def stack(seed=0, b=B, n=N):
    """(b, n, n) SPD matrices with entries of order 1 and condition near 1e2."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(b, n, n)) / np.sqrt(n)
    return np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)


def vec(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape)


def jax_vmapped(fn, *args, in_axes=0):
    """``jax.vmap(fn)`` jitted, under force_interpret()."""
    with cp.force_interpret():
        return jax.jit(jax.vmap(fn, in_axes=in_axes))(*args)


# -- the batched factor and tile inverses ----------------------------------------


def test_stack_cholesky_takes_the_stepwise_driver_like_jax_vmap():
    """A stack never takes K1 (the twin's reroute, :633-644): the stepwise
    driver, the tile kernel (K2's plain version here) once per block column
    over the whole stack."""
    Ks = stack(1)
    want_L, want_invs = jax_vmapped(lambda K: cp.blocked_cholesky_invs(K, BLOCK), jnp.asarray(Ks))
    calls = []
    real = cb._cholesky_inv_tile_into

    def counted(A, L, V):
        calls.append(tuple(A.shape))
        return real(A, L, V)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "_cholesky_inv_tile_into", counted)
        L, invs = cb.blocked_cholesky_invs(T(Ks), BLOCK)
    assert calls == [(B, BLOCK, BLOCK)] * (N // BLOCK)
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), **VALUE)
    np.testing.assert_allclose(invs.numpy(), np.asarray(want_invs), **VALUE)
    assert invs.shape == (B, N // BLOCK, BLOCK, BLOCK)


def test_stack_lml_factor_and_tile_inverses_match_jax_vmap():
    """The LML core's batched factor (the twin's def_vmap, :1474-1493): the
    library's batched Cholesky, then every tile of every matrix inverted in
    one call of the tile-inverse kernel (K5's plain version here)."""
    Ks = stack(2)
    want_L, want_invs = jax_vmapped(lambda K: cp._chol_invs_for_lml(K, BLOCK), jnp.asarray(Ks))
    calls = []
    real = cb.tril_inv_tile

    def counted(tiles):
        calls.append(tuple(tiles.shape))
        return real(tiles)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "tril_inv_tile", counted)
        L, invs = cb._chol_invs_for_lml(T(Ks), BLOCK)
    assert calls == [(B, N // BLOCK, BLOCK, BLOCK)]
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), **VALUE)
    np.testing.assert_allclose(invs.numpy(), np.asarray(want_invs), **VALUE)


# -- the batched LML value and its gradients --------------------------------------


@pytest.mark.parametrize("shared_y", [True, False], ids=["y shared", "y per element"])
def test_stack_lml_core_value_and_gradients_match_jax_vmap(shared_y):
    Ks = stack(3)
    y = vec(4, N) if shared_y else vec(4, B, N)

    def jfn(K, yy):
        return jlinalg.lml_core(K, yy)

    in_axes = (0, None if shared_y else 0)
    want_v = jax_vmapped(jfn, jnp.asarray(Ks), jnp.asarray(y), in_axes=in_axes)
    with cp.force_interpret():
        want_gK, want_gy = jax.jit(jax.grad(lambda K, yy: jax.vmap(jfn, in_axes=in_axes)(K, yy).sum(),
                                            argnums=(0, 1)))(jnp.asarray(Ks), jnp.asarray(y))
    Kt, yt = T(Ks).requires_grad_(True), T(y).requires_grad_(True)
    with cb.force_blocked(BLOCK):
        got = linalg.lml_core(Kt, yt)
        gK, gy = torch.autograd.grad(got.sum(), (Kt, yt))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_v), **VALUE)
    np.testing.assert_allclose(gK.numpy(), np.asarray(want_gK), **GRAD)
    np.testing.assert_allclose(gy.numpy(), np.asarray(want_gy), **GRAD)


def test_stack_lml_core_value_only_solves_no_transpose():
    """A value-only call on a stack launches no transpose solve, as for one
    matrix."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "trsv_lower_t", lambda *a: calls.append("t") or cb.trsv_lower_t_plain(*a[:2]))
        mp.setattr(cb, "trsv_solvers", lambda n, block: (cb.trsv_lower, cb.trsv_lower_t))
        with cb.force_blocked(BLOCK), torch.no_grad():
            linalg.lml_core(T(stack(5)), T(vec(6, N)))
    assert calls == []


# -- torch.func.vmap of the front doors (the fault this route repairs) --------------


def test_vmap_lml_core_and_cholesky_match_jax_vmap():
    """The calls that raised before the vmap rules: ``torch.func.vmap`` of
    ``linalg.lml_core`` and of ``linalg.cholesky`` under force_blocked, the
    gradient taken outside the vmap, against ``jax.vmap`` of the twin's under
    force_interpret()."""
    Ks, y = stack(7), vec(8, N)
    jK, jy = jnp.asarray(Ks), jnp.asarray(y)
    with cp.force_interpret():
        want_v, (want_gK, want_gy) = jax.jit(jax.value_and_grad(
            lambda K, yy: jax.vmap(lambda k: jlinalg.lml_core(k, yy))(K).sum(), argnums=(0, 1)))(jK, jy)
        want_L, want_gL = jax.jit(jax.value_and_grad(
            lambda K: (jax.vmap(jlinalg.cholesky)(K) ** 2).sum()))(jK)
    Kt, yt = T(Ks).requires_grad_(True), T(y).requires_grad_(True)
    with cb.force_blocked(BLOCK):
        v = torch.func.vmap(lambda k: linalg.lml_core(k, yt))(Kt)
        gK, gy = torch.autograd.grad(v.sum(), (Kt, yt))
        L = torch.func.vmap(linalg.cholesky)(Kt)
        (gL,) = torch.autograd.grad((L**2).sum(), Kt)
    np.testing.assert_allclose(float(v.sum().detach()), float(want_v), **VALUE)
    np.testing.assert_allclose(gK.numpy(), np.asarray(want_gK), **GRAD)
    np.testing.assert_allclose(gy.numpy(), np.asarray(want_gy), **GRAD)
    np.testing.assert_allclose(float((L.detach() ** 2).sum()), float(want_L), **VALUE)
    np.testing.assert_allclose(gL.numpy(), np.asarray(want_gL), **GRAD)


def test_vmap_routes_through_the_batched_functions():
    """Under vmap the blocked Functions run once, on the physical (B, ...)
    tensors: the LML core's forward sees the whole stack."""
    seen = []
    real = cb._lml_forward

    def spy(K, y, *rest):
        seen.append((tuple(K.shape), tuple(y.shape)))
        return real(K, y, *rest)

    with pytest.MonkeyPatch.context() as mp, cb.force_blocked(BLOCK):
        mp.setattr(cb, "_lml_forward", spy)
        torch.func.vmap(lambda k: linalg.lml_core(k, T(vec(9, N))))(T(stack(9)))
    assert seen == [((B, N, N), (B, N))]


@pytest.mark.parametrize("shared_factor", [False, True], ids=["factor per element", "one factor"])
def test_vmap_trsm_and_cho_solve_mat_match_jax_vmap(shared_factor):
    """The TRSM front doors under vmap; one factor shared by the batch solves
    the batch's right-hand sides side by side."""
    Ls = np.linalg.cholesky(stack(10))
    Bs = vec(11, B, N, 5)
    L_in = Ls[0] if shared_factor else Ls
    ax = (None if shared_factor else 0, 0)
    want_X = jax_vmapped(jlinalg.trsm_lower, jnp.asarray(L_in), jnp.asarray(Bs), in_axes=ax)
    with cp.force_interpret():
        want_g = jax.jit(jax.grad(lambda L, b: (jax.vmap(jlinalg.cho_solve_mat, in_axes=ax)(L, b) ** 2).sum(),
                                  argnums=(0, 1)))(jnp.asarray(L_in), jnp.asarray(Bs))
    Lt, Bt = T(L_in).requires_grad_(True), T(Bs).requires_grad_(True)
    dims = (None if shared_factor else 0, 0)
    with cb.force_blocked(BLOCK):
        X = torch.func.vmap(linalg.trsm_lower, in_dims=dims)(Lt, Bt)
        S = torch.func.vmap(linalg.cho_solve_mat, in_dims=dims)(Lt, Bt)
        gL, gB = torch.autograd.grad((S**2).sum(), (Lt, Bt))
    np.testing.assert_allclose(X.detach().numpy(), np.asarray(want_X), **VALUE)
    np.testing.assert_allclose(gL.numpy(), np.asarray(want_g[0]), **GRAD)
    np.testing.assert_allclose(gB.numpy(), np.asarray(want_g[1]), **GRAD)


def test_stack_and_vmap_tril_inv_match_jax():
    Ls = np.linalg.cholesky(stack(12))
    want = jax_vmapped(jlinalg.tril_inv, jnp.asarray(Ls))
    with cb.force_blocked(BLOCK):
        got = linalg.tril_inv(T(Ls))
        got_vmap = torch.func.vmap(linalg.tril_inv)(T(Ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)
    np.testing.assert_allclose(got_vmap.numpy(), np.asarray(want), **VALUE)


def test_vmap_of_a_raw_kernel_wrapper_runs_on_the_batch():
    """The raw wrappers' guard (``_ForwardOnly``) maps over a batch too, and
    still has no gradient."""
    Ls = T(np.linalg.cholesky(stack(13)))
    got = torch.func.vmap(lambda l: cb._ForwardOnly.apply("tril_inv_tile", cb.tril_inv_tile_plain, l))(Ls)
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(Ls.numpy()), **VALUE)
    A = T(stack(14)[:, :BLOCK, :BLOCK]).requires_grad_(True)
    Lv, _ = torch.func.vmap(lambda a: cb._ForwardOnly.apply("cholesky_inv_tile", cb.cholesky_inv_tile_plain, a))(A)
    with pytest.raises(NotImplementedError, match="no gradient of its own"):
        Lv.sum().backward()


# -- the precision rescue on a batch --------------------------------------------------


@pytest.mark.parametrize("how", ["stack", "vmap"])
def test_rescue_recomputes_only_the_non_finite_elements(how, monkeypatch):
    """Engaged, a batch whose fast path is not finite in one element is
    recomputed once at "float32" (one host read) and that element alone
    takes the recomputed value and gradient, as the twin's ``lax.cond``
    becomes a select under vmap.  The fast path is patched to give NaN in
    element 1 on its first call."""
    Ks, y = stack(15), vec(16, N)
    calls = []
    real = cb._lml_forward

    def patched(K, yy, block, needs_grad, tf32):
        calls.append(tf32)
        out = real(K, yy, block, needs_grad, tf32)
        if len(calls) == 1:
            return (out[0].index_fill(0, torch.tensor([1]), float("nan")), *out[1:])
        return out

    monkeypatch.setattr(cb, "_lml_forward", patched)
    Kt = T(Ks).requires_grad_(True)
    with linalg.precision_rescue(min_n=0), cb.force_blocked(BLOCK):
        if how == "stack":
            v = linalg.lml_core(Kt, T(y), precision="tensorfloat32")
        else:
            v = torch.func.vmap(lambda k: linalg.lml_core(k, T(y), precision="tensorfloat32"))(Kt)
        (gK,) = torch.autograd.grad(v.sum(), Kt)
    assert calls == [True, False]
    with cp.force_interpret():
        want_v, want_g = jax.jit(jax.value_and_grad(
            lambda K: jax.vmap(lambda k: jlinalg.lml_core(k, jnp.asarray(y)))(K).sum()))(jnp.asarray(Ks))
    np.testing.assert_allclose(float(v.sum().detach()), float(want_v), **VALUE)
    np.testing.assert_allclose(gK.numpy(), np.asarray(want_g), **GRAD)


# -- the GP layer: the predictive mixture and the bayes-style log-joint -------------------


def _problem(n=N, seed=17):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.normal(size=n)
    return x, y


def test_predict_mixture_matches_jax():
    """``predict_mixture`` factors the (S, n, n) stack through the batched
    stepwise driver and solves with the blocked TRSM (the twin vmaps absorb
    and predict_from_posterior)."""
    x, y = _problem()
    z = np.linspace(-1, 11, 24)
    vs = 0.2 * vec(18, 5, 3)
    jgp = JGP(ndim=1, simil=j_matern32.scaled(), noise=j_uniform)
    gp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise)
    with cp.force_interpret():
        want_mu, want_sd = jax.jit(lambda v: jcore.predict_mixture(jgp, v, x, y, z))(jnp.asarray(vs))
    calls = []
    real = cb._cholesky_inv_tile_into
    with pytest.MonkeyPatch.context() as mp, cb.force_blocked(BLOCK):
        mp.setattr(cb, "_cholesky_inv_tile_into", lambda A, L, V: calls.append(A.shape[0]) or real(A, L, V))
        mu, sd = tcore.predict_mixture(gp, T(vs), T(x), T(y), T(z))
    assert calls == [5] * (N // BLOCK)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), **VALUE)
    np.testing.assert_allclose(sd.numpy(), np.asarray(want_sd), **VALUE)


def test_bayes_style_vmapped_log_joint_and_posterior_match_jax():
    """The batched log-joint as ``tutorial/bayes.py`` builds one
    (``torch.func.vmap`` of ``gp_observe`` plus the priors), its gradient
    taken outside, and the vmapped posterior and prediction
    (``bayes.mixture_forecast``'s latent route), against ``jax.vmap`` of the
    twin's."""
    x, y = _problem(seed=19)
    z = np.linspace(0, 10, 16)
    V = 0.2 * vec(20, 4, 3)
    jgp = JGP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    jx, jy = jnp.asarray(x)[:, None], jnp.asarray(y)

    def jlogp(v):
        return jparams.gp_observe(jgp, v, x=jx, y=jy) + jnp.sum(jdists.normal_logp(0.0, 1.0, v))

    def jpred(v):
        return jcore.predict_from_posterior(jgp, jparams.gp_posterior(jgp, v, x=jx, y=jy), jnp.asarray(z))

    with cp.force_interpret():
        want_v, want_g = jax.jit(jax.value_and_grad(lambda V: jax.vmap(jlogp)(V).sum()))(jnp.asarray(V))
        want_each = jax.jit(jax.vmap(jlogp))(jnp.asarray(V))
        want_mu, want_sd = jax.jit(jax.vmap(jpred))(jnp.asarray(V))
    xt, yt, zt = T(x)[:, None], T(y), T(z)

    def logp(v):
        return tparams.gp_observe(gp, v, x=xt, y=yt) + dists.normal_logp(0.0, 1.0, v).sum()

    Vt = T(V).requires_grad_(True)
    with cb.force_blocked(BLOCK):
        got = torch.func.vmap(logp)(Vt)
        (g,) = torch.autograd.grad(got.sum(), Vt)
        mu, sd = torch.func.vmap(
            lambda v: tcore.predict_from_posterior(gp, tparams.gp_posterior(gp, v, x=xt, y=yt), zt))(T(V))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_each), **VALUE)
    np.testing.assert_allclose(float(got.sum().detach()), float(want_v), **VALUE)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), **VALUE)
    np.testing.assert_allclose(sd.numpy(), np.asarray(want_sd), **VALUE)


def test_front_doors_route_stacks_by_the_one_matrix_rule():
    """A stack is blocked-eligible under the same rule as one matrix; a
    vector per element or a batch of 4-D goes plain; force_plain sends
    everything plain."""
    Ks = T(stack(21))
    with cb.force_blocked(BLOCK):
        assert cb._eligible_block(Ks) == BLOCK
        assert cb._eligible_block(Ks[:, :, :8]) is None
        assert cb._eligible_block(Ks[None]) is None
        with linalg.force_plain():
            assert linalg._block(Ks) is None
    assert cb._eligible_block(Ks) is None  # a CPU stack, not forced
