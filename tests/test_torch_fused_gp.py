"""K7's module (gogp_torch.ops.fused_gp) against the JAX package's
gogp_tpu.ops.fused_gp, in float64 on the CPU.

The same numpy inputs go through both.  On the CPU the port's dispatch takes
K7's plain version (torch.linalg Cholesky and a triangular solve); JAX's
Pallas kernel runs in interpret mode under ``force_interpret()``, and its
reference route through the value-level Cholesky and Gauss-Jordan inverse.
Tolerances: values 1e-9 relative, gradients 1e-8 relative to their largest
entry (different summation orders in f64; both sides agree to about 1e-13).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import dists as jdists
from gogp_tpu.gp.core import GP as JGP
from gogp_tpu.kernels import Kernel as JKernel
from gogp_tpu.kernels import matern52_ref as j_matern52_ref
from gogp_tpu.kernels import periodic as j_periodic
from gogp_tpu.kernels import rbf as j_rbf
from gogp_tpu.kernels import uniform_noise as j_uniform
from gogp_tpu.ops import fused_gp as jfused
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_tpu.tutorial import io as jio
from gogp_torch import GP, dists, matern52_ref, periodic, rbf, uniform_noise
from gogp_torch.kernels import Kernel
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import fused_gp, linalg
from gogp_torch.tutorial import hyperpriors as thp

VALUE_RTOL, GRAD_RTOL = 1e-9, 1e-8


def _j_composite_pair(theta, xa, xb):
    c1, c2, l1, l2, p = theta[0], theta[1], theta[2], theta[3], theta[4]
    return c1 * j_matern52_ref.pair(jnp.stack([l1]), xa, xb) + c2 * j_periodic.pair(
        jnp.stack([l2, 10.0 * p]), xa, xb)


def _t_composite_pair(theta, xa, xb):
    c1, c2, l1, l2, p = theta[0], theta[1], theta[2], theta[3], theta[4]
    return c1 * matern52_ref.pair(torch.stack([l1]), xa, xb) + c2 * periodic.pair(
        torch.stack([l2, 10.0 * p]), xa, xb)


def _data(n=33, seed=0):
    """tests/test_fused_gp.py's problem data."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _hyperpriors():
    x, y = jio.load_csv(jhp.selfcheck_data())
    y, _, _ = jio.normalize(y)
    jpriors, tpriors = jhp.make_priors(x, y), thp.make_priors(x, y)
    mask = np.ones(x.shape[0])
    return (x, y, jhp.make_study().gp, thp.make_study().gp,
            lambda v: jpriors(v, jnp.asarray(mask)), lambda V: tpriors(V, torch.tensor(mask)))


def problem(name):
    """(x, y, JAX gp, port gp, JAX priors(v), port priors(V))."""
    if name == "hyperpriors":
        return _hyperpriors()
    x, y = _data()
    if name == "simple":
        return x, y, JGP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform), \
            GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise), None, None
    return (x, y,
            JGP(ndim=1, simil=JKernel(5, _j_composite_pair, "hp"), noise=j_uniform.scaled_by(0.01)),
            GP(ndim=1, simil=Kernel(5, _t_composite_pair, "hp"), noise=uniform_noise.scaled_by(0.01)),
            lambda v: jnp.sum(jdists.normal_logp(0.0, 1.5, v)),
            lambda V: dists.normal_logp(0.0, 1.5, V).sum(-1))


def _assert_vg(got, want_vals, want_grads):
    val, grad = got
    np.testing.assert_allclose(val.numpy(), want_vals, rtol=VALUE_RTOL, atol=0)
    scale = np.abs(want_grads).max()
    np.testing.assert_allclose(grad.numpy(), want_grads, rtol=0, atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("name", ["simple", "composite", "hyperpriors"])
@pytest.mark.parametrize("chains", [1, 4])
def test_vg_matches_jax_reference(name, chains):
    x, y, jgp, tgp, jpri, tpri = problem(name)
    V = 0.2 * np.random.default_rng(chains).normal(size=(chains, tgp.n_theta))
    want = jax.jit(jax.vmap(jfused.make_reference_value_and_grad(jgp, x, y, priors_fn=jpri)))(jnp.asarray(V))
    want_vals, want_grads = np.asarray(want[0]), np.asarray(want[1])
    for make in (fused_gp.make_fused_value_and_grad, fused_gp.make_reference_value_and_grad):
        vg = make(tgp, torch.tensor(x), torch.tensor(y), priors_fn=tpri)
        _assert_vg(vg(torch.tensor(V)), want_vals, want_grads)
    # one chain without the chain axis: a scalar and a (p,) gradient
    val, grad = vg(torch.tensor(V[0]))
    assert val.shape == () and grad.shape == (tgp.n_theta,)
    _assert_vg((val, grad), want_vals[0], want_grads[0])


def test_vg_matches_jax_fused_kernel_interpret():
    """The port's K7 route against the Pallas kernel itself (interpret
    mode), vmapped over 4 chains, on the composite problem with priors."""
    x, y, jgp, tgp, jpri, tpri = problem("composite")
    V = 0.2 * np.random.default_rng(7).normal(size=(4, tgp.n_theta))
    with jfused.force_interpret():
        want = jax.jit(jax.vmap(jfused.make_fused_value_and_grad(jgp, x, y, priors_fn=jpri)))(jnp.asarray(V))
    vg = fused_gp.make_fused_value_and_grad(tgp, torch.tensor(x), torch.tensor(y), priors_fn=tpri)
    _assert_vg(vg(torch.tensor(V)), np.asarray(want[0]), np.asarray(want[1]))


def test_linv_plain_matches_jax_linv_value():
    """K7's plain version against the value-level Cholesky + Gauss-Jordan
    inverse that the Pallas kernel runs, on a batch of the hyperpriors
    covariances."""
    x, y, jgp, tgp, _, _ = problem("hyperpriors")
    V = 0.3 * np.random.default_rng(3).normal(size=(3, tgp.n_theta))
    theta = np.exp(V)
    nts = tgp.n_theta_simil
    from gogp_tpu.gp.core import masked_cov as j_masked_cov

    K = np.stack([np.asarray(j_masked_cov(jgp, jnp.asarray(t[:nts]), jnp.asarray(t[nts:]), jnp.asarray(x), None))
                  for t in theta])
    want = np.asarray(jax.jit(jfused.linv_value)(jnp.asarray(K)))
    got = fused_gp.linv_plain(torch.tensor(K)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_RTOL * np.abs(want).max())
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(fused_gp.fused_gp_linv(torch.tensor(K)), fused_gp.linv_plain(torch.tensor(K)))


def test_masked_padding_exact():
    """Padded rows (identity rows of K, zero y) leave the value and the
    gradient of the unpadded problem, on both routes (the counterpart of
    tests/test_fused_gp.py::test_masked_padding_exact)."""
    x, y, _, tgp, _, _ = problem("simple")
    xp = np.concatenate([x, np.zeros((7, 1))])
    yp = np.concatenate([y, np.zeros(7)])
    mask = np.concatenate([np.ones(len(x)), np.zeros(7)])
    V = torch.tensor(0.2 * np.random.default_rng(5).normal(size=(3, tgp.n_theta)))
    for make in (fused_gp.make_fused_value_and_grad, fused_gp.make_reference_value_and_grad):
        val_p, grad_p = make(tgp, torch.tensor(xp), torch.tensor(yp), mask=torch.tensor(mask))(V)
        val_r, grad_r = make(tgp, torch.tensor(x), torch.tensor(y))(V)
        np.testing.assert_allclose(val_p.numpy(), val_r.numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(grad_p.numpy(), grad_r.numpy(), rtol=0, atol=1e-8)


def test_dispatch_rule():
    """K7 for a CUDA float32 batch with n <= K7_MAX_N outside force_plain;
    the plain version for everything else."""

    def fake(device_cuda, dtype, n):
        return types.SimpleNamespace(is_cuda=device_cuda, dtype=dtype, shape=(64, n, n))

    assert fused_gp.takes_kernel(fake(True, torch.float32, 44))
    assert fused_gp.takes_kernel(fake(True, torch.float32, fused_gp.K7_MAX_N))
    assert not fused_gp.takes_kernel(fake(True, torch.float32, fused_gp.K7_MAX_N + 1))
    assert not fused_gp.takes_kernel(fake(True, torch.float64, 44))
    assert not fused_gp.takes_kernel(fake(False, torch.float32, 44))
    with linalg.force_plain():
        assert not fused_gp.takes_kernel(fake(True, torch.float32, 44))
    # on the CPU the route runs the plain version and launches nothing
    x, y, _, tgp, _, _ = problem("simple")
    cb.reset_launch_counts()
    K = torch.eye(5, dtype=torch.float32).expand(2, 5, 5)
    assert torch.equal(fused_gp.linv(K), fused_gp.linv_plain(K))
    fused_gp.make_fused_value_and_grad(tgp, torch.tensor(x, dtype=torch.float32),
                                       torch.tensor(y, dtype=torch.float32))(torch.zeros(2, 3))
    assert cb.LAUNCHES["fused_gp_linv"] == 0
