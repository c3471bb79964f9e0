"""Parity of the port's observation likelihoods (gogp_torch.gp.likelihoods)
with gogp_tpu.gp.likelihoods, family by family.

The same numpy points in float64 go through both.  logp and the masked
grads (d logp/df, -d^2 logp/df^2) agree to rtol 1e-9; the derivatives of W
itself in theta and in f (the third derivative, which laplace_lml's
gradient reads) agree with ``jax.grad`` to rtol 1e-8.  The probit log-cdf is
written from erfcx and erfc where JAX calls log_ndtr.  For 6 <= z < 8 JAX's
log_ndtr takes log(ndtr(z)) and keeps only the absolute precision of 1 - Phi
(its log Phi(8) is -6.66e-16, scipy's and the port's -6.22e-16), so the two
are held to rtol 1e-9 or atol 1e-15 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import likelihoods as jlik
from gogp_torch.gp import likelihoods as tlik

RTOL, ATOL = 1e-9, 1e-12
GRAD = dict(rtol=1e-8, atol=1e-11)

# (family, natural-scale theta, observations y)
FAMILIES = {
    "gaussian": ([0.7], "real"),
    "bernoulli_logit": ([], "binary"),
    "bernoulli_probit": ([], "binary"),
    "poisson": ([], "count"),
    "laplace_noise": ([0.6], "real"),
    "student_t": ([0.5, 3.5], "real"),
}


def _points(kind, n=12, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n) * 2.0
    f[0], f[1] = 9.0, -9.0  # the tails of the links
    y = {"real": rng.normal(size=n), "binary": (rng.uniform(size=n) < 0.5).astype(float),
         "count": rng.poisson(2.0, size=n).astype(float)}[kind]
    if kind == "real":
        y[2] = f[2] + 0.25  # near the Laplace kink, not on it
    mask = np.ones(n)
    mask[-2:] = 0.0
    return f, y, mask


def _jax_grads(lik, theta, f, y):
    g1 = jax.grad(lik.logp, argnums=1)
    g2 = jax.grad(g1, argnums=1)
    return (jax.vmap(lambda fi, yi: g1(theta, fi, yi))(f, y), jax.vmap(lambda fi, yi: -g2(theta, fi, yi))(f, y))


@pytest.mark.parametrize("name", FAMILIES)
def test_logp_and_sum_match_jax(name):
    theta, kind = FAMILIES[name]
    jl, tl = getattr(jlik, name), getattr(tlik, name)
    assert (tl.n_theta, tl.log_concave) == (jl.n_theta, jl.log_concave)
    f, y, mask = _points(kind)
    th = jnp.asarray(theta, dtype=jnp.float64)
    want = np.asarray(jax.vmap(lambda fi, yi: jl.logp(th, fi, yi))(f, y))
    got = tl.pointwise(torch.tensor(theta, dtype=torch.float64), torch.tensor(f), torch.tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_sum = float(jl.sum_logp(th, f, y, mask))
    got_sum = float(tl.sum_logp(torch.tensor(theta, dtype=torch.float64), torch.tensor(f), torch.tensor(y),
                                torch.tensor(mask)))
    assert got_sum == pytest.approx(want_sum, rel=RTOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_grads_match_jax(name):
    theta, kind = FAMILIES[name]
    jl, tl = getattr(jlik, name), getattr(tlik, name)
    f, y, mask = _points(kind)
    gw, ww = jl.grads(jnp.asarray(theta, dtype=jnp.float64), f, y, mask)
    gt, wt = tl.grads(torch.tensor(theta, dtype=torch.float64), torch.tensor(f), torch.tensor(y), torch.tensor(mask))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(ww), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_w_derivatives_match_jax(name):
    """d(sum W)/dtheta and dW_i/df_i: the third derivative that laplace_lml
    differentiates through, once more by autograd through torch.func."""
    theta, kind = FAMILIES[name]
    jl, tl = getattr(jlik, name), getattr(tlik, name)
    f, y, _ = _points(kind)
    weights = np.linspace(0.5, 1.5, f.size)

    def jw(th, fv):
        return jnp.sum(_jax_grads(jl, th, fv, y)[1] * weights)

    th_t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    f_t = torch.tensor(f, requires_grad=True)
    w = tl.grads(th_t, f_t, torch.tensor(y))[1]
    total = (w * torch.tensor(weights)).sum()
    # W independent of f (gaussian) or zero (laplace_noise) has no graph there
    grads = torch.autograd.grad(total, [th_t, f_t], allow_unused=True) if total.requires_grad else (None, None)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, (th_t, f_t))]
    want_f = np.asarray(jax.grad(jw, argnums=1)(jnp.asarray(theta, dtype=jnp.float64), jnp.asarray(f)))
    np.testing.assert_allclose(grads[1].numpy(), want_f, **GRAD)
    if theta:
        want_t = np.asarray(jax.grad(jw, argnums=0)(jnp.asarray(theta, dtype=jnp.float64), jnp.asarray(f)))
        np.testing.assert_allclose(grads[0].numpy(), want_t, **GRAD)


def test_rows_of_thetas():
    """A theta per row (rows, n_theta) against each row alone."""
    f, y, mask = _points("real")
    F = np.stack([f, -f, 0.5 * f])
    thetas = np.array([[0.5, 3.5], [1.2, 8.0], [0.3, 2.1]])
    got_g, got_w = tlik.student_t.grads(torch.tensor(thetas), torch.tensor(F), torch.tensor(y), torch.tensor(mask))
    for r in range(3):
        gw, ww = jlik.student_t.grads(jnp.asarray(thetas[r]), F[r], y, mask)
        np.testing.assert_allclose(got_g[r].numpy(), np.asarray(gw), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_w[r].numpy(), np.asarray(ww), rtol=RTOL, atol=ATOL)


def test_log_ndtr_matches_jax():
    z = np.concatenate([np.linspace(-35, 35, 141), [0.0, -1e-12, 1e-12]])
    want = np.asarray(jax.scipy.special.log_ndtr(jnp.asarray(z)))
    np.testing.assert_allclose(tlik.log_ndtr(torch.tensor(z)).numpy(), want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("name", FAMILIES)
def test_for_svgp_matches_jax(name):
    """``for_svgp``'s ``(y, f) -> logp`` on an (n, q) grid of f, as
    svgp_elbo calls it, against JAX's under the two vmaps svgp_elbo puts
    around it; theta given as a list takes f's dtype."""
    theta, kind = FAMILIES[name]
    jl, tl = getattr(jlik, name), getattr(tlik, name)
    f, y, _ = _points(kind)
    grid = f[:, None] + np.linspace(-1.0, 1.0, 5)[None, :]
    yb = np.broadcast_to(y[:, None], grid.shape)
    want = jax.vmap(jax.vmap(jl.for_svgp(theta)))(jnp.asarray(yb), jnp.asarray(grid))
    got = tl.for_svgp(theta)(torch.tensor(yb), torch.tensor(grid))
    assert got.dtype == torch.float64 and got.shape == grid.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
