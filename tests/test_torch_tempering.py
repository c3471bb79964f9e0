"""The port's parallel tempering (gogp_torch.infer.tempering) against the
JAX package's, in float64 on the CPU.

The ladder arithmetic (``geometric_ladder``, ``swap_decision``,
``place_rungs``, ``adapt_ladder_betas``) is held to 1e-12: the same
operations, the swap uniforms JAX draws handed in.  ``run_pt_nuts`` runs its
replicas as one lockstep NUTS batch, one beta per row; JAX vmaps one NUTS
chain per replica.  The port takes JAX's draws: each replica's NUTS draws
from its key (``test_torch_nuts.JaxNUTSDraws``) and each sweep's swap
uniforms from the loop key JAX splits (``key, k_swap = split(key)``).  On
``test_torch_hmc.py``'s correlated Gaussian each sweep, from JAX's state, is
held to 1e-10 and the free-running run to 1e-8 (dual averaging grows the
last-bit differences); on the hyperpriors posterior (log-joints that differ
in their last bits) sweeps from JAX's state to 1e-8.  Then the JAX tests' behaviours on the
port's own generator: bimodal mixing, moments, flow and the ladder tuner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import COV, MEAN, T, j_mvn, t_mvn
from test_torch_nuts import JaxNUTSDraws

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import tempering as jtemp
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_torch import convert
from gogp_torch.infer import tempering
from gogp_torch.ops import linalg
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

EXACT = dict(rtol=1e-12, atol=1e-14)
TOL = dict(rtol=0, atol=1e-10)
STATE = dict(rtol=0, atol=1e-8)


class JaxSwapDraws:
    """Each sweep's swap uniforms from JAX's loop key: ``key, k_swap =
    split(key)``, then one uniform per rung (``ladders``: one key per
    ladder, ``split(k_swap, ladders)``, as PT-ChEES draws them)."""

    def __init__(self, key, ladders: int | None = None):
        self.key, self.ladders = key, ladders

    def __call__(self, state):
        K = state.logp.shape[0] if self.ladders is None else state.logps.shape[0]
        self.key, k_swap = jax.random.split(self.key)
        if self.ladders is None:
            return T(jax.random.uniform(k_swap, (K,), jnp.float64))
        keys = jax.random.split(k_swap, self.ladders)
        return T(jax.vmap(lambda k: jax.random.uniform(k, (K,), jnp.float64))(keys))


def bimodal(V):
    a = -0.5 * ((V - 4.0) ** 2).sum(-1) / 0.25
    b = -0.5 * ((V + 4.0) ** 2).sum(-1) / 0.25
    return torch.logaddexp(a, b)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_geometric_ladder_matches_jax(n):
    got = tempering.geometric_ladder(n, 0.05, torch.float64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtemp.geometric_ladder(n, 0.05, jnp.float64)), **EXACT)
    assert got[0] == 1.0 and (n == 1 or np.isclose(float(got[-1]), 0.05))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("K", [5, 6])
def test_swap_decision_matches_jax(parity, K):
    """One ladder, then 4 ladders at once against JAX's vmap over them."""
    rng = np.random.default_rng(K + parity)
    betas = jtemp.geometric_ladder(K, 0.1, jnp.float64)
    raw = jnp.asarray(rng.normal(scale=3.0, size=(4, K)))
    keys = jax.random.split(jax.random.PRNGKey(K), 4)
    want = jax.vmap(lambda r, k: jtemp.swap_decision(betas, r, k, parity))(raw, keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (K,), jnp.float64))(keys)
    got = tempering.swap_decision(T(betas), T(raw), T(u), parity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **EXACT)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2][0]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **EXACT)
    one = tempering.swap_decision(T(betas), T(raw[0]), T(u[0]), parity)
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(want[0][0]))
    assert bool((got[0] != torch.arange(K)).any())  # some swaps accepted


@pytest.mark.parametrize("betas,rej,n_new", [
    ([1.0, 0.681292, 0.464158, 0.316228, 0.215443, 0.1], [0.3, 0.3, 0.3, 0.3, 0.3], 7),
    ([1.0, 0.464158, 0.215443, 0.1], [0.3, 0.3, 0.3], 3),
    ([1.0, 0.7, 0.4, 0.1], [0.9, 0.01, 0.01], 4),
    ([1.0, 0.7, 0.4, 0.1], [0.0, 0.0, 0.0], 4),
    ([1.0, 0.5, 0.25, 0.1, 0.02], [0.05, 0.6, 0.2, 0.8], 9),
])
def test_place_rungs_matches_jax(betas, rej, n_new):
    got = tempering.place_rungs(T(betas), T(rej), n_new)
    want = np.asarray(jtemp.place_rungs(jnp.asarray(betas), jnp.asarray(rej), n_new))
    np.testing.assert_allclose(got.numpy(), want, **EXACT)
    assert got.shape == (n_new,) and got[0] == betas[0] and got[-1] == betas[-1]
    assert bool((torch.diff(got) < 0).all())


def test_adapt_ladder_betas_matches_jax():
    betas = jtemp.geometric_ladder(6, 0.05, jnp.float64)
    rej_sum, count = jnp.asarray([3.0, 9.5, 1.0, 0.0, 4.2]), jnp.asarray([10.0, 10.0, 9.0, 0.0, 9.0])
    got = tempering.adapt_ladder_betas(T(betas), T(rej_sum), T(count))
    np.testing.assert_allclose(got.numpy(), np.asarray(jtemp.adapt_ladder_betas(betas, rej_sum, count)), **EXACT)


def _jax_pt_keys(rng, K):
    key, key_init = jax.random.split(rng)
    return key, jax.random.split(key_init, K)


@pytest.mark.parametrize("free", [None, (1.0, 0.0, 1.0)])
def test_run_pt_nuts_matches_jax(free):
    """4 replicas, depth 6, 20 warmup sweeps (a window end re-places the
    ladder) and 12 sampling sweeps, free-running: cold-chain draws, swap
    rate, flow, ladder and final state.  Held to 1e-8: per-replica dual
    averaging grows the packages' last-bit differences to 3e-10 (1e-9 with
    the free mask) in the step sizes by the end of warmup
    (``test_torch_hmc.py`` says how); the sweeps alone are held to 1e-10 by
    the next test."""
    x0 = jnp.asarray([0.3, -0.4, 0.2])
    rng = jax.random.PRNGKey(3)
    jfree = None if free is None else jnp.asarray(free)
    want = jax.jit(lambda q: jtemp.run_pt_nuts(j_mvn, q, rng, n_replicas=4, beta_min=0.2, num_warmup=20,
                                               num_samples=12, free=jfree))(x0)
    key, replica_keys = _jax_pt_keys(rng, 4)
    got = tempering.run_pt_nuts(t_mvn, T(x0), torch.Generator(), n_replicas=4, beta_min=0.2, num_warmup=20,
                                num_samples=12, free=None if free is None else T(free),
                                draws=JaxNUTSDraws(replica_keys), swap_draws=JaxSwapDraws(key))
    for name in ("positions", "logps", "swap_rate", "betas", "barrier", "pair_rej"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **STATE)
    assert int(got.round_trips) == int(want.round_trips)
    for name in ("position", "logp", "grad", "step_size", "inv_mass"):
        np.testing.assert_allclose(getattr(got.state, name).numpy(), np.asarray(getattr(want.state, name)),
                                   err_msg=name, **STATE)
    geo = tempering.geometric_ladder(4, 0.2, torch.float64)
    assert not torch.allclose(got.betas, geo) and float(got.swap_rate) > 0
    if free is not None:
        assert bool((got.positions[:, 1] == -0.4).all())


def _hyperpriors_logjoints():
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    y = tio.normalize(y)[0]
    with linalg.force_plain():
        logp, _, _, free = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)
    jlogp, _, _, jfree = jbayes.build_logjoint(jhp.make_study(), x, y)
    return logp, free, jlogp, jfree


@pytest.mark.parametrize("target", ["gaussian", "hyperpriors"])
def test_pt_nuts_sweeps_match_jax(target):
    """PT-NUTS sweep by sweep (transition, adaptation, swap, the ladder
    re-placed at a window end; then sampling sweeps with their flow), each
    sweep from JAX's state, ladder and keys: 20 warmup and 3 sampling
    sweeps of 4 replicas on the Gaussian to 1e-10; 2 and 2 on the
    hyperpriors posterior (the plain route, against JAX's
    ``build_logjoint``) to 1e-8."""
    if target == "gaussian":
        logp, free, jlogp, jfree, dim, warm, tol = t_mvn, None, j_mvn, None, 3, 20, TOL
    else:
        (logp, free, jlogp, jfree), dim, warm, tol = _hyperpriors_logjoints(), 6, 2, STATE
    rng = jax.random.PRNGKey(4)
    betas = jtemp.geometric_ladder(4, 0.1, jnp.float64)
    x0 = jnp.asarray(0.1 * np.random.default_rng(4).normal(size=(4, dim)))
    js, key = jtemp.pt_init(jlogp, x0, rng, betas, 0.1, jfree)
    ts = tempering.pt_init(logp, T(x0), torch.Generator(), T(betas), 0.1, free)
    np.testing.assert_allclose(ts.logp.numpy(), np.asarray(js.logp), rtol=1e-12)
    sched = jadapt.build_schedule(warm)
    warm_step = jax.jit(lambda s, k, b, um, we, t: jtemp.pt_warm_chunk(jlogp, s, k, b, um, we, t, 6, 0.8, jfree))
    sample_step = jax.jit(lambda s, k, b, t, f: jtemp.pt_sample_chunk(jlogp, s, k, b, 1, t, 6, jfree, f))
    flow, tflow = jtemp.init_flow(4, jnp.float64), None
    for t in range(warm + 3):
        ts, tbetas = convert.hmc_state_from_numpy(js, "cpu"), T(betas)
        draws, swaps = JaxNUTSDraws(js.rng), JaxSwapDraws(key)
        if t < warm:
            um, we = sched.update_mass[t:t + 1], sched.window_end[t:t + 1]
            js, key, betas = warm_step(js, key, betas, um, we, t)
            ts, tbetas = tempering.pt_warm_chunk(logp, ts, tbetas, um, we, t, 6, 0.8, free, True, draws, swaps)
        else:
            js, key, jpos, _, _, flow = sample_step(js, key, betas, t, flow)
            ts, tpos, _, _, tflow = tempering.pt_sample_chunk(logp, ts, tbetas, 1, t, 6, free, tflow, draws, swaps)
            np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **tol)
        np.testing.assert_allclose(tbetas.numpy(), np.asarray(betas), **tol)
        for name in ("position", "logp", "grad", "step_size", "inv_mass"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name,
                                       **tol)
    want = convert.flow_from_numpy(flow, "cpu", torch.float64)
    assert torch.equal(tflow.labels, want.labels) and torch.equal(tflow.trips, want.trips)
    np.testing.assert_allclose(tflow.rej_sum.numpy(), want.rej_sum.numpy(), **tol)
    if target == "gaussian":
        assert sched.window_end.any() and not np.allclose(np.asarray(betas), np.asarray(
            jtemp.geometric_ladder(4, 0.1, jnp.float64)))


def test_pt_nuts_mixes_bimodal():
    """The port's own generator: PT crosses the barrier between two modes
    at +-4 that one NUTS chain never crosses (tests/test_tempering.py)."""
    res = tempering.run_pt_nuts(bimodal, torch.full((1,), 4.0, dtype=torch.float64),
                                torch.Generator().manual_seed(0), n_replicas=8, beta_min=0.02, num_warmup=200,
                                num_samples=600, max_tree_depth=6)
    frac_neg = float((res.positions[:, 0] < 0).double().mean())
    assert 0.2 < frac_neg < 0.8, frac_neg
    assert float(res.swap_rate) > 0.2 and float(res.barrier) > 0.0
    assert res.pair_rej.shape == (7,) and bool(((res.pair_rej >= 0) & (res.pair_rej <= 1)).all())
    assert int(res.round_trips) >= 1


def test_pt_nuts_moments_on_unimodal():
    res = tempering.run_pt_nuts(t_mvn, torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(1),
                                n_replicas=4, num_warmup=200, num_samples=1200)
    s = res.positions.numpy()
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.4)


def test_tune_ladder_easy_target_shallow():
    """A unimodal Gaussian over a mild beta range has a small barrier: the
    tuner recommends fewer rungs than the pilot's 8, endpoints pinned."""
    betas, pilot = tempering.tune_ladder(lambda V: -0.5 * (V * V).sum(-1), torch.zeros(2, dtype=torch.float64),
                                         torch.Generator().manual_seed(3), beta_min=0.5, pilot_replicas=8,
                                         pilot_warmup=150, pilot_samples=100)
    assert betas.shape[0] < 8 and betas[0] == 1.0 and np.isclose(float(betas[-1]), 0.5)
    assert float(pilot.barrier) < 1.5
