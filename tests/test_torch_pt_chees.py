"""The port's PT-ChEES (gogp_torch.infer.pt_chees) against the JAX
package's, in float64 on the CPU, and the JAX tests' behaviours
(tests/test_pt_chees.py) on the port's own generator.

The port keeps the K rungs as the groups of one ChEES state, the L ladders
as their chains, and runs every rung of every ladder in one lockstep batch;
JAX vmaps its ChEES transition over the rungs and its swap over the
ladders.  The port takes JAX's draws: each rung's ChEES draws from its key
(``test_torch_chees_groups.JaxGroupDraws``) and each sweep's swap uniforms
from ``split(k_swap, L)`` (``test_torch_tempering.JaxSwapDraws``).  Each
sweep (rung transitions, adaptation, swap, the ladder re-placed at a window
end; sampling sweeps with their flow), from JAX's state, is held to 1e-10 on
``test_torch_hmc.py``'s correlated Gaussian and to 1e-8 on the hyperpriors
posterior (the port's K7 route, K7's plain version on the CPU); the
free-running ``run_pt_chees`` to 1e-8 on the Gaussian.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chees_groups import JaxGroupDraws, assert_states_close
from test_torch_hmc import COV, MEAN, T, j_mvn, t_mvn
from test_torch_tempering import JaxSwapDraws, bimodal

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import pt_chees as jpt
from gogp_tpu.tutorial import bayes as jbayes
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_torch import convert
from gogp_torch.infer import chees, pt_chees
from gogp_torch.infer.tempering import geometric_ladder
from gogp_torch.tutorial import bayes, hyperpriors
from gogp_torch.tutorial import io as tio

TOL = dict(rtol=0, atol=1e-10)
STATE = dict(rtol=0, atol=1e-8)


def _hyperpriors_k7():
    x, y = tio.load_csv(hyperpriors.selfcheck_data())
    y = tio.normalize(y)[0]
    logp, _, _, free = bayes.build_logjoint(hyperpriors.make_study(), x, y, "cpu", torch.float64)
    jlogp, _, _, jfree = jbayes.build_logjoint(jhp.make_study(), x, y)
    return logp, free, jlogp, jfree


@pytest.mark.parametrize("target", ["gaussian", "hyperpriors"])
def test_pt_chees_sweeps_match_jax(target):
    """4 rungs x 6 ladders: 20 warmup sweeps (a window end re-places the
    ladder) and 3 sampling sweeps on the Gaussian, 2 and 2 on hyperpriors,
    each sweep from JAX's state, ladder and keys."""
    if target == "gaussian":
        logp, free, jlogp, jfree, dim, warm, tol = t_mvn, None, j_mvn, None, 3, 20, TOL
    else:
        (logp, free, jlogp, jfree), dim, warm, tol = _hyperpriors_k7(), 6, 2, STATE
    K, L, max_steps = 4, 6, 32
    betas = jpt.geometric_ladder(K, 0.1, jnp.float64)
    x0 = jnp.asarray(0.1 * np.random.default_rng(7).normal(size=(L, dim)))
    js = jpt.pt_chees_init(jlogp, x0, jax.random.PRNGKey(7), betas, L, 0.1, 1.0, jfree)
    own = pt_chees.pt_chees_init(logp, T(x0), torch.Generator(), T(betas), L, 0.1, 1.0, free)
    assert own.positions.shape == (K, L, dim) and own.step_size.shape == (K,)
    np.testing.assert_allclose(own.logps.numpy(), np.asarray(js.logps), rtol=1e-12)
    np.testing.assert_allclose(own.grads.numpy(), np.asarray(js.grads), **tol)
    key = jax.random.PRNGKey(8)
    sched = jadapt.build_schedule(warm)
    warm_step = jax.jit(lambda s, k, b, um, we, t: jpt.pt_chees_warm_chunk(jlogp, s, k, b, um, we, t, max_steps,
                                                                           free=jfree))
    sample_step = jax.jit(lambda s, k, b, t, f: jpt.pt_chees_sample_chunk(jlogp, s, k, b, 1, t, max_steps, jfree,
                                                                          f))
    flow, tflow, spreads = jpt._init_flow_ladders(L, betas), None, []
    for t in range(warm + 3):
        ts, tbetas = convert.pt_chees_state_from_numpy(js, "cpu"), T(betas)
        draws, swaps = JaxGroupDraws(js.rng), JaxSwapDraws(key, ladders=L)
        counts = chees.n_leapfrog_steps(ts, max_steps)[0]
        spreads.append(max(counts) - min(counts))
        if t < warm:
            um, we = sched.update_mass[t:t + 1], sched.window_end[t:t + 1]
            js, key, betas = warm_step(js, key, betas, um, we, t)
            ts, tbetas = pt_chees.pt_chees_warm_chunk(logp, ts, tbetas, um, we, t, max_steps, free=free, draws=draws,
                                                      swap_draws=swaps)
        else:
            js, key, jpos, jraw, jfrac, flow = sample_step(js, key, betas, t, flow)
            ts, tpos, traw, tfrac, tflow = pt_chees.pt_chees_sample_chunk(logp, ts, tbetas, 1, t, max_steps, free,
                                                                          tflow, draws, swaps)
            np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), **tol)
            np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), rtol=1e-9, atol=0)
            np.testing.assert_allclose(tfrac.numpy(), np.asarray(jfrac), **tol)
        np.testing.assert_allclose(tbetas.numpy(), np.asarray(betas), **tol)
        assert_states_close(ts, js, **tol)
    want = convert.flow_from_numpy(flow, "cpu", torch.float64)
    assert torch.equal(tflow.labels, want.labels) and torch.equal(tflow.trips, want.trips)
    np.testing.assert_allclose(tflow.rej_sum.numpy(), want.rej_sum.numpy(), **tol)
    np.testing.assert_array_equal(tflow.prop_count.numpy(), want.prop_count.numpy())
    if target == "gaussian":  # the rungs' trajectories differ: the lockstep masks are exercised
        assert max(spreads) >= 2, spreads


def test_run_pt_chees_matches_jax():
    """4 ladders x 3 rungs, 20 warmup and 10 sampling sweeps, free-running:
    the cold chains' draws, the swap rate, the flow, the ladder and the
    final state.  Held to 1e-8: dual averaging grows the last-bit
    differences from the first window on (1e-10 per sweep above)."""
    x0 = jnp.asarray([0.2, -0.1, 0.3])
    rng = jax.random.PRNGKey(9)
    want = jax.jit(lambda q: jpt.run_pt_chees(j_mvn, q, rng, n_ladders=4, n_replicas=3, beta_min=0.2,
                                              num_warmup=20, num_samples=10, max_num_steps=32))(x0)
    key, key_init = jax.random.split(rng)
    got = pt_chees.run_pt_chees(t_mvn, T(x0), torch.Generator(), n_ladders=4, n_replicas=3, beta_min=0.2,
                                num_warmup=20, num_samples=10, max_num_steps=32,
                                draws=JaxGroupDraws(jax.random.split(key_init, 3)),
                                swap_draws=JaxSwapDraws(key, ladders=4))
    assert got.positions.shape == (10, 4, 3)
    for name in ("positions", "logps", "swap_rate", "betas", "barrier", "pair_rej"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name,
                                   **STATE)
    assert int(got.round_trips) == int(want.round_trips)
    assert_states_close(got.state, want.state, **STATE)


def test_rung_shared_adaptation_shapes():
    """Every rung owns one step size, trajectory and mass, adapted from its
    cross-ladder population; hotter rungs adapt other step sizes."""
    res = pt_chees.run_pt_chees(t_mvn, torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(2),
                                n_ladders=4, n_replicas=3, num_warmup=150, num_samples=50, max_num_steps=64)
    st = res.state
    assert st.step_size.shape == (3,) and st.log_traj.shape == (3,) and st.inv_mass.shape == (3, 3)
    assert st.positions.shape == (3, 4, 3) and res.positions.shape == (50, 4, 3)
    assert float(st.step_size.max() - st.step_size.min()) > 1e-5
    assert bool(torch.isfinite(st.log_traj).all())


def test_ladder_adapts_and_stays_pinned():
    res = pt_chees.run_pt_chees(bimodal, torch.full((1,), 4.0, dtype=torch.float64), torch.Generator().manual_seed(3),
                                n_ladders=4, n_replicas=6, beta_min=0.05, num_warmup=150, num_samples=50,
                                max_num_steps=64)
    betas = res.betas
    assert betas[0] == 1.0 and np.isclose(float(betas[-1]), 0.05) and bool((torch.diff(betas) < 0).all())
    assert not torch.allclose(betas, geometric_ladder(6, 0.05, torch.float64), atol=1e-6)


def test_chunked_equals_monolithic_sampling():
    betas = geometric_ladder(3, 0.3, torch.float64)
    state = pt_chees.pt_chees_init(t_mvn, torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(4),
                                   betas, 4, 0.3, 1.0)

    def fresh():
        return state._replace(rng=torch.Generator().manual_seed(5))

    _, whole, _, _, _ = pt_chees.pt_chees_sample_chunk(t_mvn, fresh(), betas, 40)
    s2, first, _, _, flow = pt_chees.pt_chees_sample_chunk(t_mvn, fresh(), betas, 20)
    _, second, _, _, _ = pt_chees.pt_chees_sample_chunk(t_mvn, s2, betas, 20, 20, flow=flow)
    assert torch.equal(whole, torch.cat([first, second]))


def test_moments_and_flow_on_unimodal():
    res = pt_chees.run_pt_chees(t_mvn, torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(0),
                                n_ladders=8, n_replicas=4, beta_min=0.3, num_warmup=200, num_samples=300,
                                max_num_steps=64)
    flat = res.positions.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.2)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)
    assert 0.0 < float(res.swap_rate) <= 1.0 and float(res.barrier) >= 0.0
    assert res.pair_rej.shape == (3,) and bool(((res.pair_rej >= 0) & (res.pair_rej <= 1)).all())
    assert int(res.round_trips) > 8  # an easy target, a shallow ladder: states round-trip


def test_mixes_bimodal():
    """Modes at +-4 that plain ChEES never leaves (tests/test_pt_chees.py):
    the cold chains visit both."""
    res = pt_chees.run_pt_chees(bimodal, torch.full((1,), 4.0, dtype=torch.float64), torch.Generator().manual_seed(1),
                                n_ladders=8, n_replicas=8, beta_min=0.02, num_warmup=200, num_samples=300,
                                max_num_steps=64)
    frac_neg = float((res.positions[..., 0] < 0).double().mean())
    assert 0.2 < frac_neg < 0.8, frac_neg
    assert float(res.swap_rate) > 0.2 and int(res.round_trips) > 0
