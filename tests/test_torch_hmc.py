"""The port's HMC engine (gogp_torch.infer.hmc) against ``jax.vmap`` of the
JAX package's, in float64 on the CPU.

The port runs every chain in lockstep with the chain axis in front; JAX runs
one chain and vmaps it.  Randomness: the port takes each transition's draws
from ``draws(state)``, so these tests hand it the draws JAX makes itself
(hmc.py's ``split(rng, 3)`` per chain).  Tolerances: 1e-10 absolute on
states after 20 transitions of up to some tens of leapfrog steps (the same
operations in the same order, but the Gaussian's quadratic form summed in
another order), 1e-12 for the leapfrog's reversibility.  The moments of
``run_hmc`` are held within Monte Carlo error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import hmc as jhmc
from gogp_torch import convert
from gogp_torch.infer import adapt, hmc

TOL = dict(rtol=0, atol=1e-10)

COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.4], [0.2, -0.4, 0.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0, 0.5])


def T(a):
    return torch.tensor(np.asarray(a))


def _quad(d0, d1, d2, a):
    """d^T A d and -A d, each written out term by term, so that both
    packages compute them in one order (float64 sums are not associative)."""
    q = a[0][0] * d0 * d0 + a[1][1] * d1 * d1 + a[2][2] * d2 * d2
    q = q + 2.0 * a[0][1] * d0 * d1 + 2.0 * a[0][2] * d0 * d2 + 2.0 * a[1][2] * d1 * d2
    g = [-(a[i][0] * d0 + a[i][1] * d1 + a[i][2] * d2) for i in range(3)]
    return -0.5 * q, g


A = COV_INV.tolist()


@jax.custom_vjp
def j_mvn(v):
    d = v - jnp.asarray(MEAN)
    return _quad(d[0], d[1], d[2], A)[0]


def _j_fwd(v):
    return j_mvn(v), v


def _j_bwd(v, ct):
    d = v - jnp.asarray(MEAN)
    return (ct * jnp.stack(_quad(d[0], d[1], d[2], A)[1]),)


j_mvn.defvjp(_j_fwd, _j_bwd)


class _TorchMvn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, V):
        ctx.save_for_backward(V)
        d = V - T(MEAN)
        return _quad(d[:, 0], d[:, 1], d[:, 2], A)[0]

    @staticmethod
    def backward(ctx, ct):
        (V,) = ctx.saved_tensors
        d = V - T(MEAN)
        return ct[:, None] * torch.stack(_quad(d[:, 0], d[:, 1], d[:, 2], A)[1], 1)


def t_mvn(V):
    """The correlated Gaussian's log-density (up to a constant), (chains, 3)
    to (chains,), with the gradient JAX's ``j_mvn`` takes."""
    return _TorchMvn.apply(V)


class JaxHMCDraws:
    """The port's ``draws(state)`` from JAX's keys, one per chain: each
    transition ``key, key_mom, key_acc = split(rng, 3)`` (hmc.py)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, state):
        dim = state.position.shape[1]

        def one(k):
            key, km, ka = jax.random.split(k, 3)
            return key, jax.random.normal(km, (dim,), jnp.float64), jax.random.uniform(ka, (), jnp.float64)

        self.keys, r0, u = jax.vmap(one)(self.keys)
        return T(r0), T(u)


def assert_states_close(got, want, **tol):
    for name in ("position", "logp", "grad", "step_size", "inv_mass", "accept_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **tol)
    for name in ("log_step", "log_step_avg", "gradient_avg", "mu"):
        np.testing.assert_allclose(getattr(got.da, name).numpy(), np.asarray(getattr(want.da, name)),
                                   err_msg=f"da.{name}", **tol)
    for name in ("mean", "m2"):
        np.testing.assert_allclose(getattr(got.welford, name).numpy(), np.asarray(getattr(want.welford, name)),
                                   err_msg=f"welford.{name}", **tol)
    assert (np.asarray(want.da.t) == int(got.da.t)).all()
    assert (np.asarray(want.welford.count) == float(got.welford.count)).all()


def start(chains=8, seed=0, free=None):
    """JAX's and the port's states of ``chains`` chains whose step sizes
    differ from 0.04 to 0.5 (so their step counts differ), and JAX's keys."""
    x0 = 0.5 * np.random.default_rng(seed).normal(size=(chains, 3))
    keys = jax.random.split(jax.random.PRNGKey(seed), chains)
    steps = np.geomspace(0.04, 0.5, chains)
    jfree = None if free is None else jnp.asarray(free)
    js = jax.vmap(lambda q, k: jhmc.init_state(j_mvn, q, k, 0.1, jfree))(jnp.asarray(x0), keys)
    js = js._replace(step_size=jnp.asarray(steps), da=jax.vmap(jadapt.da_init)(jnp.asarray(steps)))
    ts = hmc.init_state(t_mvn, T(x0), torch.Generator(), 0.1, None if free is None else T(free))
    ts = ts._replace(step_size=T(steps), da=adapt.da_init(T(steps)))
    return js, ts, keys


@pytest.mark.parametrize("free", [None, (1.0, 0.0, 1.0)])
def test_hmc_warmup_matches_jax_vmap(free):
    """20 warmup transitions (``hmc_transition`` then ``warmup_step``,
    with a mass window that closes at transition 17) of 8 chains whose step
    counts differ; a free mask pins the second coordinate.

    The first 8 run free from one start.  The rest are held transition by
    transition: each starts from JAX's state.  Free-running, the two part
    slowly whatever the port does: an acceptance probability is exp(-delta),
    delta a difference of two energies, so its last bits carry the energies'
    rounding 1e4 times over, and dual averaging multiplies that into the
    next step size by sqrt(t) / 0.05, so a 1e-16 difference grows to 1e-10
    in about 16 transitions."""
    js, ts, keys = start(free=free)
    jfree = None if free is None else jnp.asarray(free)
    assert_states_close(ts, js, **TOL)
    draws = JaxHMCDraws(keys)
    sched = adapt.build_schedule(20)
    assert sched.window_end[17] and sched.update_mass.any()
    jstep = jax.jit(jax.vmap(lambda s, um, we: jhmc.warmup_step(jhmc.hmc_transition(j_mvn, s, 1.0, free=jfree), um, we),
                             in_axes=(0, None, None)))
    differ = 0
    for i, (um, we) in enumerate(zip(*sched)):
        if i >= 8:
            ts = convert.hmc_state_from_numpy(js, "cpu")
        differ += len(set(np.ceil(1.0 / ts.step_size.numpy()).tolist())) > 1
        js = jstep(js._replace(rng=draws.keys), um, we)
        ts = hmc.warmup_step(hmc.hmc_transition(t_mvn, ts, 1.0, free=free, draws=draws), bool(um), bool(we))
        assert_states_close(ts, js, **TOL)
    assert differ >= 15  # the chains' step counts differ at most transitions
    js, ts = jax.vmap(jhmc.finalize_warmup)(js), hmc.finalize_warmup(ts)
    assert_states_close(ts, js, **TOL)
    if free is not None:
        assert torch.all(ts.position[:, 1] == start(free=free)[1].position[:, 1])


def test_hmc_transition_from_jax_state():
    """Sampling transitions (no adaptation) from JAX's own state, carried
    over by ``convert.hmc_state_from_numpy``."""
    js, _, keys = start(seed=1)
    ts = convert.hmc_state_from_numpy(js, "cpu")
    draws = JaxHMCDraws(keys)
    jstep = jax.jit(jax.vmap(lambda s: jhmc.hmc_transition(j_mvn, s, 1.5, max_num_steps=16)))
    for _ in range(5):
        js = jstep(js._replace(rng=draws.keys))
        ts = hmc.hmc_transition(t_mvn, ts, 1.5, max_num_steps=16, draws=draws)
        assert_states_close(ts, js, **TOL)


def test_leapfrog_is_reversible():
    """Integrate forward, flip the momentum, integrate as long again: back
    at the start, per chain, with per-chain step counts."""
    rng = np.random.default_rng(2)
    q, r = T(rng.normal(size=(5, 3))), T(rng.normal(size=(5, 3)))
    vg = hmc.value_and_grad(t_mvn, None)
    lp, g = vg(q)
    step, inv_mass = T(np.linspace(0.05, 0.3, 5))[:, None], T(rng.uniform(0.5, 2.0, size=(5, 3)))
    n_steps = torch.tensor([1, 4, 7, 12, 3])
    out = hmc.leapfrog(vg, hmc.IntegratorState(q, r, lp, g), step, inv_mass, n_steps)
    back = hmc.leapfrog(vg, out._replace(momentum=-out.momentum), step, inv_mass, n_steps)
    np.testing.assert_allclose(back.position.numpy(), q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(-back.momentum.numpy(), r.numpy(), rtol=0, atol=1e-12)
    one = hmc.leapfrog(vg, hmc.IntegratorState(q[:1], r[:1], lp[:1], g[:1]), step[:1], inv_mass[:1], 1)
    np.testing.assert_array_equal(out.position[0].numpy(), one.position[0].numpy())


@pytest.mark.parametrize("free", [None, (1.0, 1.0, 0.0)])
def test_run_hmc_moments(free):
    """The port's own generator: the Gaussian's moments within Monte Carlo
    error (the counterpart of tests/test_inference.py::TestHMC); a pinned
    coordinate stays at its start."""
    x0 = 0.1 * torch.randn((8, 3), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    cov = COV
    if free is not None:  # the third coordinate pinned at its mean: the others' conditional law
        x0[:, 2] = MEAN[2]
        cov = COV[:2, :2] - np.outer(COV[:2, 2], COV[2, :2]) / COV[2, 2]
    res = hmc.run_hmc(t_mvn, x0, torch.Generator().manual_seed(0), num_warmup=200, num_samples=250,
                      trajectory_length=2.0, free=None if free is None else T(free))
    assert res.positions.shape == (250, 8, 3)
    s = res.positions.reshape(-1, 3).numpy()
    k = 3 if free is None else 2
    np.testing.assert_allclose(s[:, :k].mean(0), MEAN[:k], atol=0.15)
    np.testing.assert_allclose(np.cov(s[:, :k].T), cov, atol=0.25)
    if free is not None:
        assert (s[:, 2] == MEAN[2]).all()
    assert 0.5 < float(res.accept_probs.mean()) < 1.0
