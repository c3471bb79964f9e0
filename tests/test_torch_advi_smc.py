"""The port's ADVI and SMC (gogp_torch.infer.advi, gogp_torch.infer.smc)
against the JAX package's, in float64 on the CPU.

Randomness: the port takes its draws from hooks, so these tests hand it the
draws JAX makes itself (advi.py's ``split(rng, num_steps)``; smc.py's key
chain, ``fold_in`` per mutation and a key per particle).  Tolerances: the
ELBO and its gradient to 1e-10 relative (the same reparameterized draws;
on the hyperpriors log-joint, whose K7 route takes the gradient GPML 5.9
gives and scales it by each draw's cotangent, 1e-9); ``run_advi`` and
``run_advi_fullrank`` step for step to 1e-9 absolute; SMC's particles, log
evidence and acceptance to 1e-10 on the correlated Gaussian (its
resampling indices, discrete, match exactly: no tie falls on a rounding).
Moments and the log evidence of the port's own runs within Monte Carlo
error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import COV, MEAN, T, j_mvn, t_mvn

from gogp_tpu.infer import advi as jadvi
from gogp_tpu.infer import smc as jsmc
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_torch.infer import advi, hmc, smc
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

EXACT = dict(rtol=1e-10, atol=0)
STEPS = dict(rtol=0, atol=1e-9)
FREE = (1.0, 0.0, 1.0)


def jax_eps(key, num_steps, num_draws, dim):
    """Each ADVI step's eps as JAX draws it: ``split(rng, num_steps)``."""
    keys = jax.random.split(key, num_steps)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (num_draws, dim), jnp.float64))(keys))


def hyperpriors_logjoints():
    """The port's K7-route log-joint (K7's plain version on the CPU) and
    JAX's, on the hyperpriors study."""
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    y = tio.normalize(y)[0]
    logp = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)[0]
    return logp, jbayes.build_logjoint(jhp.make_study(), x, y)[0]


def grads_of(f, *params):
    leaves = [p.clone().requires_grad_(True) for p in params]
    value = f(*leaves)
    return value.detach(), torch.autograd.grad(value, leaves)


@pytest.mark.parametrize("target", ["gaussian", "hyperpriors"])
@pytest.mark.parametrize("family", ["mean-field", "full-rank"])
@pytest.mark.parametrize("free", [False, True])
def test_elbo_matches_jax(target, family, free):
    """The ELBO and its gradient with respect to the variational parameters
    at one key's eps, against ``jax.value_and_grad`` of JAX's."""
    tlogp, jlogp = (t_mvn, j_mvn) if target == "gaussian" else hyperpriors_logjoints()
    dim = 3 if target == "gaussian" else 6
    rng = np.random.default_rng(7)
    mu = 0.3 * rng.normal(size=dim)
    second = -1.0 + 0.2 * rng.normal(size=dim) if family == "mean-field" else np.tril(0.3 * rng.normal(size=(dim, dim)))
    fr = np.ones(dim) if not free else np.array(FREE + (1.0,) * (dim - 3))
    key = jax.random.PRNGKey(3)
    eps = T(jax.random.normal(key, (8, dim), jnp.float64))
    jfun = jadvi.elbo if family == "mean-field" else jadvi.elbo_fullrank
    tfun = advi.elbo if family == "mean-field" else advi.elbo_fullrank
    jfree, tfree = (jnp.asarray(fr), T(fr)) if free else (None, None)
    want, (jg_mu, jg_2) = jax.value_and_grad(lambda m, s: jfun(jlogp, m, s, key, 8, jfree), argnums=(0, 1))(
        jnp.asarray(mu), jnp.asarray(second))
    got, (g_mu, g_2) = grads_of(lambda m, s: tfun(tlogp, m, s, eps, tfree), T(mu), T(second))
    rtol = 1e-10 if target == "gaussian" else 1e-9
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    for g, w in ((g_mu, jg_mu), (g_2, jg_2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("family", ["mean-field", "full-rank"])
@pytest.mark.parametrize("free", [None, FREE])
def test_run_advi_matches_jax_step_for_step(family, free):
    """20 Adam steps on the correlated Gaussian's ELBO with JAX's eps: the
    ELBO trace and the variational parameters; then posterior draws at
    JAX's eps."""
    key = jax.random.PRNGKey(11)
    x0 = np.array([0.2, -0.1, 0.4])
    eps = jax_eps(key, 20, 8, 3)
    jrun, trun = ((jadvi.run_advi, advi.run_advi) if family == "mean-field"
                  else (jadvi.run_advi_fullrank, advi.run_advi_fullrank))
    jfree = None if free is None else jnp.asarray(free)
    want = jrun(j_mvn, jnp.asarray(x0), key, num_steps=20, learning_rate=0.05, free=jfree)
    got = trun(t_mvn, T(x0), None, num_steps=20, learning_rate=0.05, free=None if free is None else T(free),
               eps_draws=lambda step: T(eps[step]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEPS)
    skey = jax.random.PRNGKey(12)
    jsample = jadvi.sample_posterior if family == "mean-field" else jadvi.sample_posterior_fullrank
    tsample = advi.sample_posterior if family == "mean-field" else advi.sample_posterior_fullrank
    draws = tsample(got, None, 5, free, eps=T(jax.random.normal(skey, (5, 3), jnp.float64)))
    np.testing.assert_allclose(draws.numpy(), np.asarray(jsample(want, skey, 5, jfree)), **STEPS)
    if free is not None:
        assert (draws[:, 1] == x0[1]).all() and float(got.mu[1]) == x0[1]


def test_run_advi_fits_a_gaussian():
    """Mean-field ADVI on an uncorrelated Gaussian is exact (the counterpart
    of tests/test_inference.py::TestADVI::test_gaussian_exact), from the
    port's own generator; the ELBO rises."""

    def logp(V):
        return -0.5 * ((V[:, 0] - 3.0) ** 2 / 4.0 + (V[:, 1] + 1.0) ** 2 / 0.25)

    res = advi.run_advi(logp, torch.zeros(2, dtype=torch.float64), torch.Generator().manual_seed(0),
                        num_steps=3000, learning_rate=0.02, num_draws=16)
    np.testing.assert_allclose(res.mu.numpy(), [3.0, -1.0], atol=0.15)
    np.testing.assert_allclose(torch.exp(res.log_sigma).numpy(), [2.0, 0.5], rtol=0.2)
    assert float(res.elbos[-100:].mean()) > float(res.elbos[:100].mean())


class JaxSMCDraws:
    """The port's SMC draws from JAX's key chain (smc.py): ``key_init,
    key_loop = split(rng)``; per stage ``key, k_res, k_mut = split(key, 3)``;
    mutation ``i``: a key per particle from ``split(fold_in(k_mut, i), P)``,
    each split into a normal key and a uniform key."""

    def __init__(self, rng, num_particles, dim):
        self.key_init, self.key = jax.random.split(rng)
        self.p, self.dim = num_particles, dim

    def init(self):
        return T(jax.random.normal(self.key_init, (self.p, self.dim), jnp.float64))

    def resample(self, stage):
        self.key, k_res, self.k_mut = jax.random.split(self.key, 3)
        return T(jax.random.uniform(k_res, (), jnp.float64))

    def mutation(self, stage, i):
        def one(k):
            k1, k2 = jax.random.split(k)
            return jax.random.normal(k1, (self.dim,), jnp.float64), jax.random.uniform(k2, (), jnp.float64)

        normals, uniforms = jax.vmap(one)(jax.random.split(jax.random.fold_in(self.k_mut, i), self.p))
        return T(normals), T(uniforms)

    def hook(self):
        return smc.SMCDraws(self.init, self.resample, self.mutation)


@pytest.mark.parametrize("mutation,free", [("hmc", None), ("hmc", FREE), ("rwm", None)])
def test_run_smc_matches_jax(mutation, free):
    """64 particles annealed to the correlated Gaussian with JAX's draws:
    the same stages, particles, log evidence and acceptance."""
    key = jax.random.PRNGKey(21)
    x0 = np.array([0.5, 0.0, -0.5])
    kw = dict(num_particles=64, sigma0=2.0, num_mcmc_steps=2, n_leapfrog=4, mutation=mutation)
    want = jsmc.run_smc(j_mvn, jnp.asarray(x0), key, free=None if free is None else jnp.asarray(free), **kw)
    got = smc.run_smc(t_mvn, T(x0), None, free=None if free is None else T(free),
                      draws=JaxSMCDraws(key, 64, 3).hook(), **kw)
    assert got.num_stages == int(want.num_stages) > 2 and got.betas_hit_one == bool(want.betas_hit_one)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(got.log_evidence), float(want.log_evidence), **EXACT)
    np.testing.assert_allclose(float(got.accept_rate), float(want.accept_rate), **EXACT)
    if free is not None:
        assert (got.particles[:, 1] == x0[1]).all()


def test_run_smc_moments_and_evidence():
    """The port's own generator: the Gaussian's moments and its log evidence
    log((2 pi)^(d/2) |Sigma|^(1/2)) within Monte Carlo error (the
    counterpart of tests/test_inference.py::TestSMC)."""
    res = smc.run_smc(t_mvn, torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(2),
                      num_particles=1024, sigma0=3.0)
    assert res.betas_hit_one
    s = res.particles.numpy()
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.3)
    log_z = 1.5 * np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(COV))
    assert abs(float(res.log_evidence) - log_z) < 0.2


def test_smc_mutation_is_not_reversible():
    """The mutation's integrator, mirrored from the JAX package, is not the
    leapfrog: on a 1-D N(0, 1), five steps forward, the momentum flipped,
    five more do not come back to the start (the interior kicks are half of
    velocity Verlet's and the last is missing), where ``hmc.leapfrog``'s
    round trip does, to rounding."""
    vg = hmc.value_and_grad(lambda V: -0.5 * (V * V).sum(-1), None)
    q = torch.tensor([[0.7]], dtype=torch.float64)
    start = hmc.IntegratorState(q, torch.tensor([[0.4]], dtype=torch.float64), *vg(q))
    one = torch.ones(1, dtype=torch.float64)

    def round_trip_miss(integrate):
        out = integrate(start)
        back = integrate(out._replace(momentum=-out.momentum))
        return float((back.position - start.position).abs().max())

    mutation = round_trip_miss(lambda s: smc._mutation_steps(vg, s, 0.3, one, 5, None))
    leapfrog = round_trip_miss(lambda s: hmc.leapfrog(vg, s, 0.3, one, 5))
    assert mutation > 1e-2 and leapfrog < 1e-14, (mutation, leapfrog)
