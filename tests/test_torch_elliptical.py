"""Parity of the port's elliptical slice sampler (gogp_torch.infer.elliptical)
with gogp_tpu.infer.elliptical, on JAX's own draws.

``JaxESSDraws`` replays the JAX twin's key stream through the port's draws
hook: per chain fold_in(key, chain), split into the steps, each step split
four ways into nu's normals, u, t0 and the shrink key, which splits once per
shrink.  Float64 on the CPU: one update and whole chains on JAX's own
prior factor agree with JAX's states to rtol 1e-10 (atol 1e-12), the shrink
counts exactly.  ``run_ess_gp`` factors K itself: LAPACK's factor of this
jitter-only covariance (condition number 3e8) differs from XLA's by 4.7e-11,
so its chains are held to 1e-9 of their largest entry.  The predictions from
JAX's own draws agree to rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_laplace import one_torch_thread  # noqa: F401 (an autouse fixture)

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.infer import elliptical as jess
from gogp_tpu.kernels import rbf as jrbf
from gogp_torch import convert
from gogp_torch.gp import core, likelihoods
from gogp_torch.infer import elliptical as ess
from gogp_torch.kernels import rbf

STATE = dict(rtol=1e-10, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled())
TGP = core.GP(ndim=1, simil=rbf.scaled())
TS = np.array([1.2, 0.9])
E = np.zeros(0)


def _step_draws(k, n):
    """One ess_update's draws from its key, as the JAX twin splits it."""
    kn, ku, kt, kb = jax.random.split(k, 4)
    eps = jax.random.normal(kn, (n,), dtype=jnp.float64)
    u = jax.random.uniform(ku, dtype=jnp.float64)
    t0 = jax.random.uniform(kt, dtype=jnp.float64)

    def shrink(k, _):
        k, ks = jax.random.split(k)
        return k, jax.random.uniform(ks, dtype=jnp.float64)

    return eps, u, t0, jax.lax.scan(shrink, kb, None, length=ess._MAX_SHRINKS)[1]


def chain_keys(key, chains):
    return jax.vmap(lambda c: jax.random.fold_in(key, c))(jnp.arange(chains))


class JaxESSDraws:
    """The port's draws hook on JAX's key stream: ``step_keys`` (*batch,
    steps, 2) holds each chain's key of each update."""

    def __init__(self, step_keys):
        batch, steps = step_keys.shape[:-2], step_keys.shape[-2]
        self.keys = step_keys.reshape((-1, steps) + step_keys.shape[-1:])
        self.batch = batch
        self.step = 0

    @classmethod
    def for_chains(cls, keys, steps: int):
        """``run_ess``'s stream: each chain key (*batch, 2) split into the
        steps."""
        flat = keys.reshape((-1,) + keys.shape[-1:])
        per_step = jax.vmap(lambda k: jax.random.split(k, steps))(flat)
        return cls(per_step.reshape(keys.shape[:-1] + per_step.shape[1:]))

    def __call__(self, shape, dtype, device):
        if self.step == 0:  # every update's draws at once, (chains, steps, ...)
            n = shape[-1]
            self.draws = [np.asarray(a) for a in jax.vmap(jax.vmap(lambda k: _step_draws(k, n)))(self.keys)]
        i = self.step
        self.step += 1
        return ess.ESSDraws(*(torch.tensor(a[:, i].reshape(self.batch + a.shape[2:]), dtype=dtype, device=device)
                              for a in self.draws))


def _problem(n=14, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 8, n))
    y = (np.sin(x) + 0.3 * rng.normal(size=n) > 0).astype(float)
    return x, y


def _t(a):
    return torch.tensor(np.array(a))


def test_ess_update_matches_jax():
    x, y = _problem()
    n, C = x.size, 5
    K = jcore.masked_cov(JGP, jnp.asarray(TS), jnp.zeros(0), jnp.asarray(x)[:, None], None)
    chol = jnp.linalg.cholesky(K)

    def jll(f):
        return jlik.bernoulli_logit.sum_logp(jnp.zeros(0), f, jnp.asarray(y))

    f0 = np.random.default_rng(1).normal(size=(C, n))
    keys = chain_keys(jax.random.PRNGKey(2), C)
    want = jax.vmap(lambda f, k: jess.ess_update(jll, chol, f, jll(f), k))(jnp.asarray(f0), keys)
    draws = JaxESSDraws(keys[:, None])

    def tll(f):
        return likelihoods.bernoulli_logit.sum_logp(torch.zeros(0, dtype=torch.float64), f, _t(y))

    ft = _t(f0)
    got = ess.ess_update(tll, _t(np.asarray(chol)), ft, tll(ft), draws((C, n), torch.float64, "cpu"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **STATE)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **STATE)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].max() > 0  # some chain shrank its bracket


def test_run_ess_matches_jax():
    """Chains on JAX's prior factor, JAX's draws: the sampler alone."""
    x, y = _problem()
    key = jax.random.PRNGKey(4)
    C, warm, samp, thin = 3, 6, 5, 2
    K = jcore.masked_cov(JGP, jnp.asarray(TS), jnp.zeros(0), jnp.asarray(x)[:, None], None)
    chol = jnp.linalg.cholesky(K)

    def jll(f):
        return jlik.bernoulli_logit.sum_logp(jnp.zeros(0), f, jnp.asarray(y))

    want = jess.run_ess(jll, chol, jnp.zeros((C, x.size)), key, warm, samp, thin)

    def tll(f):
        return likelihoods.bernoulli_logit.sum_logp(torch.zeros(0, dtype=torch.float64), f, _t(y))

    draws = JaxESSDraws.for_chains(chain_keys(key, C), warm + samp * thin)
    got = ess.run_ess(tll, _t(np.asarray(chol)), torch.zeros(C, x.size, dtype=torch.float64), draws, warm, samp,
                      thin)
    assert got[0].shape == (C, samp, x.size)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **STATE)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **STATE)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _chains_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_run_ess_gp_matches_jax():
    x, y = _problem()
    key = jax.random.PRNGKey(4)
    C, warm, samp, thin = 3, 6, 5, 2
    want = jess.run_ess_gp(JGP, jlik.bernoulli_logit, TS, E, x, y, key, num_chains=C, num_warmup=warm,
                           num_samples=samp, thin=thin)
    draws = JaxESSDraws.for_chains(chain_keys(key, C), warm + samp * thin)
    got = ess.run_ess_gp(TGP, likelihoods.bernoulli_logit, _t(TS), _t(E), _t(x), _t(y), draws, num_chains=C,
                         num_warmup=warm, num_samples=samp, thin=thin)
    assert got.f.shape == (C, samp, x.size)
    _chains_close(got.f.numpy(), np.asarray(want.f))
    _chains_close(got.loglik.numpy(), np.asarray(want.loglik))
    np.testing.assert_array_equal(got.shrinks.numpy(), np.asarray(want.shrinks))


def test_rows_of_problems_match_each_alone():
    """Thetas and masks with a rows axis: every row's chains in one lockstep
    batch, each row as JAX runs it alone."""
    x, y = _problem(n=10, seed=3)
    n, C, steps = x.size, 2, 4
    masks = (np.arange(n)[None, :] < np.array([3, 7, 10])[:, None]).astype(float)
    thetas = TS[None, :] * np.array([[1.0, 1.0], [1.3, 0.8], [0.7, 1.2]])
    key0 = jax.random.PRNGKey(5)
    row_keys = [jax.random.fold_in(key0, r) for r in range(3)]
    draws = JaxESSDraws.for_chains(jnp.stack([chain_keys(k, C) for k in row_keys]), steps)
    got = ess.run_ess_gp(TGP, likelihoods.bernoulli_probit, _t(thetas), torch.zeros(3, 0, dtype=torch.float64),
                         _t(x), _t(y), draws, mask=_t(masks), num_chains=C, num_warmup=1, num_samples=steps - 1)
    for r in range(3):
        want = jess.run_ess_gp(JGP, jlik.bernoulli_probit, thetas[r], E, x, y, row_keys[r], mask=masks[r],
                               num_chains=C, num_warmup=1, num_samples=steps - 1)
        _chains_close(got.f[r].numpy(), np.asarray(want.f))
        np.testing.assert_array_equal(got.shrinks[r].numpy(), np.asarray(want.shrinks))


@pytest.mark.parametrize("name", ["bernoulli_logit", "bernoulli_probit"])
def test_predictions_from_jax_draws(name):
    x, y = _problem()
    jl, tl = getattr(jlik, name), getattr(likelihoods, name)
    res = jess.run_ess_gp(JGP, jl, TS, E, x, y, jax.random.PRNGKey(6), num_chains=2, num_warmup=10, num_samples=8)
    tres = convert.ess_result_from_numpy({k: np.asarray(v) for k, v in res._asdict().items()}, "cpu")
    z = np.linspace(-1, 9, 6)
    for g, w in zip(ess.ess_predict(TGP, tres, _t(z)), jess.ess_predict(JGP, res, z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ess.ess_predict_prob(TGP, tl, tres, _t(z)).numpy(),
                               np.asarray(jess.ess_predict_prob(JGP, jl, res, z)), rtol=1e-9, atol=1e-12)


def test_generator_draws_run():
    """The default hook: a seeded generator gives the same chains twice."""
    x, y = _problem()
    runs = [ess.run_ess_gp(TGP, likelihoods.bernoulli_logit, _t(TS), _t(E), _t(x), _t(y), num_chains=2,
                           num_warmup=3, num_samples=4, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0].f.numpy(), runs[1].f.numpy())
    assert torch.isfinite(runs[0].loglik).all()


def test_run_ess_gp_nan_where_k_does_not_factor():
    """As in the JAX package, K is factored without jitter escalation: in
    float32 a row whose jitter-only prior does not factor has NaN chains, a
    row that does has finite ones."""
    x = np.linspace(0.0, 10.0, 40)
    y = (np.sin(x) > 0).astype(float)
    masks = (np.arange(40)[None, :] < np.array([3, 40])[:, None]).astype(np.float32)
    ts = np.array([1.0, 3.0])
    f32 = dict(dtype=torch.float32)
    got = ess.run_ess_gp(TGP, likelihoods.bernoulli_logit, torch.tensor(ts, **f32), torch.zeros(0, **f32),
                         torch.tensor(x, **f32), torch.tensor(y, **f32), mask=torch.tensor(masks), num_chains=2,
                         num_warmup=2, num_samples=2, generator=torch.Generator().manual_seed(0))
    for r in range(2):
        want = jess.run_ess_gp(JGP, jlik.bernoulli_logit, ts.astype(np.float32), E.astype(np.float32),
                               x.astype(np.float32), y.astype(np.float32), jax.random.PRNGKey(0), mask=masks[r],
                               num_chains=2, num_warmup=2, num_samples=2)
        assert np.isfinite(np.asarray(want.f)).all() == (r == 0)
        assert torch.isfinite(got.f[r]).all() == (r == 0)
        assert torch.isfinite(torch.diagonal(got.chol[r])).all() == (r == 0)
