"""The port's grouped ChEES (gogp_torch.infer.chees: G populations in one
lockstep batch, the race's arms, ``run_chees_pops``) against the JAX
package's, in float64 on the CPU.

JAX gets groups by vmapping its transition over them; the port runs every
group's leapfrog in one batch, each group to its own step count.  The port
takes each transition's draws from ``draws(state)``, so these tests hand it
JAX's own: per group, ``key, key_iter = split(key)`` and each chain's
momentum and uniform from ``fold_in(key_iter, chain)`` (chees.py:176-183),
each group's key as JAX derives it (``fold_in(rng, i)`` for the race's arms
and the populations).  The target is ``test_torch_hmc.py``'s correlated
Gaussian, whose value and gradient both packages compute term by term.
Tolerances: 1e-12 for the candidates (the same operations), 1e-10 for
states and the race's statistics.  The port's populations are held to
separate ``run_chees`` calls to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hmc import COV, MEAN, T, j_mvn, t_mvn

from gogp_tpu.infer import adapt as jadapt
from gogp_tpu.infer import chees as jchees
from gogp_torch import convert
from gogp_torch.infer import adapt, chees, diagnostics

EXACT = dict(rtol=1e-12, atol=1e-14)
TOL = dict(rtol=0, atol=1e-10)
STATE_FIELDS = ("positions", "logps", "grads", "step_size", "inv_mass", "log_traj", "accept_probs")


class JaxGroupDraws:
    """The port's ``draws(state)`` of a grouped state from one JAX key per
    group, as ``jax.vmap`` of the JAX transition draws them."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, state):
        *_, chains, dim = state.positions.shape
        self.keys, r0, u = _group_draws(self.keys, chains, dim)
        return T(r0), T(u)


@jax.jit
def _split_draws(key, idx, dim_zeros):
    key, key_iter = jax.random.split(key)

    def chain_draws(i):
        km, ka = jax.random.split(jax.random.fold_in(key_iter, i))
        return jax.random.normal(km, dim_zeros.shape, jnp.float64), jax.random.uniform(ka, (), jnp.float64)

    r0, u = jax.vmap(chain_draws)(idx)
    return key, r0, u


def _group_draws(keys, chains, dim):
    return jax.vmap(_split_draws, in_axes=(0, None, None))(keys, jnp.arange(chains), jnp.zeros(dim))


def assert_states_close(got, want, **tol):
    for name in STATE_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **tol)
    for name in ("log_step", "log_step_avg", "gradient_avg"):
        np.testing.assert_allclose(getattr(got.da, name).numpy(), np.asarray(getattr(want.da, name)),
                                   err_msg=f"da.{name}", **tol)
    for name in ("m", "v"):
        np.testing.assert_allclose(getattr(got.adam, name).numpy(), np.asarray(getattr(want.adam, name)),
                                   err_msg=f"adam.{name}", **tol)
    for name in ("mean", "m2"):
        np.testing.assert_allclose(getattr(got.welford, name).numpy(), np.asarray(getattr(want.welford, name)),
                                   err_msg=f"welford.{name}", **tol)
    assert got.step == int(np.asarray(want.step).reshape(-1)[0])


def jax_groups(groups=3, chains=6, seed=0, free=None):
    """JAX's state of ``groups`` populations (vmapped ``chees_init``) whose
    step sizes and trajectories differ, so that their step counts do."""
    x0 = 0.5 * np.random.default_rng(seed).normal(size=(groups, chains, 3))
    keys = jax.random.split(jax.random.PRNGKey(seed), groups)
    jfree = None if free is None else jnp.asarray(free)
    js = jax.vmap(lambda q, k: jchees.chees_init(j_mvn, q, k, 0.1, 1.0, jfree))(jnp.asarray(x0), keys)
    steps = jnp.asarray(np.geomspace(0.06, 0.4, groups))
    return js._replace(step_size=steps, da=jax.vmap(jadapt.da_init)(steps),
                       log_traj=jnp.log(jnp.asarray(np.linspace(1.0, 2.5, groups)))), keys


@pytest.mark.parametrize("free", [None, (1.0, 0.0, 1.0)])
def test_grouped_warmup_matches_jax_vmap(free):
    """20 warmup transitions of 3 groups of 6 chains (the step counts differ
    between groups), against ``jax.vmap`` of JAX's transition and warmup
    step over the groups: the first 10 free from one start, the rest each
    from JAX's state (dual averaging multiplies a last-bit difference into
    the step size, ``test_torch_hmc.py`` says how)."""
    js, keys = jax_groups(free=free)
    jfree = None if free is None else jnp.asarray(free)
    ts = convert.chees_state_from_numpy(js, "cpu")
    own = chees.chees_init(t_mvn, ts.positions, torch.Generator(), 0.1, 1.0, None if free is None else T(free))
    for name in ("positions", "logps", "grads", "inv_mass"):
        np.testing.assert_allclose(getattr(own, name).numpy(), np.asarray(getattr(js, name)), err_msg=name, **EXACT)
    assert own.step_size.shape == (3,) and own.welford.count.shape == ()
    draws = JaxGroupDraws(keys)
    sched = adapt.build_schedule(20)
    jstep = jax.jit(jax.vmap(lambda s, um, we: jchees.chees_warmup_step(
        jchees.chees_transition(j_mvn, s, adapt_traj=True, free=jfree), um, we), in_axes=(0, None, None)))
    spreads = []
    for i, (um, we) in enumerate(zip(*sched)):
        if i >= 10:
            ts = convert.chees_state_from_numpy(js, "cpu")
        counts = chees.n_leapfrog_steps(ts)[0]
        spreads.append(max(counts) - min(counts))
        js = jstep(js._replace(rng=draws.keys), um, we)
        ts = chees.chees_warmup_step(chees.chees_transition(t_mvn, ts, adapt_traj=True, free=free, draws=draws),
                                     bool(um), bool(we))
        assert_states_close(ts, js, **TOL)
    # the groups' step counts differ in most transitions, by up to 20 steps
    assert sum(s > 0 for s in spreads) >= 15 and max(spreads) >= 10 and sched.window_end.any(), spreads
    if free is not None:
        assert torch.all(ts.positions[..., 1] == own.positions[..., 1])


def test_one_group_is_the_ungrouped_transition():
    """A state with one group takes exactly the transition of the same
    population without the group axis."""
    js, _ = jax_groups(groups=1, chains=8, seed=3)
    grouped = convert.chees_state_from_numpy(js, "cpu")
    flat = chees.take_group(grouped, 0)
    draws = chees.generator_draws(flat._replace(rng=torch.Generator().manual_seed(1)))
    a = chees.chees_transition(t_mvn, grouped, adapt_traj=True, draws=lambda s: (draws[0][None], draws[1][None]))
    b = chees.chees_transition(t_mvn, flat, adapt_traj=True, draws=lambda s: draws)
    for name in STATE_FIELDS:
        assert torch.equal(getattr(a, name)[0], getattr(b, name)), name


@pytest.mark.parametrize("n", [2, 4, 5])
def test_race_candidates_match_jax(n):
    js, _ = jax_groups(groups=1, chains=4, seed=1)
    js = jax.tree.map(lambda a: a[0], js)._replace(step_size=jnp.asarray(0.07), log_traj=jnp.log(jnp.asarray(0.9)))
    got = chees.race_candidates(convert.chees_state_from_numpy(js, "cpu"), n, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jchees.race_candidates(js, n, 64)), **EXACT)
    with pytest.raises(ValueError, match=">= 2"):
        chees.race_candidates(convert.chees_state_from_numpy(js, "cpu"), 1, 64)


def _warm_jax(x0, key, warmup, max_steps, free=None):
    jfree = None if free is None else jnp.asarray(free)
    state = jchees.chees_init(j_mvn, jnp.asarray(x0), key, 0.1, 1.0, jfree)
    sched = jadapt.build_schedule(warmup)
    state = jax.jit(lambda s: jchees.chees_warm_chunk(j_mvn, s, sched.update_mass, sched.window_end, max_steps,
                                                     free=jfree))(state)
    return jchees.finalize_chees_warmup(state)


@pytest.mark.parametrize("free", [None, (1.0, 1.0, 0.0)])
def test_chees_race_matches_jax(free):
    """The race from JAX's warmed state, 4 arms of 8 chains probing 16
    transitions: candidates, costs, normalized ESJD, scores, probe ESS and
    the winner's state, each arm on JAX's ``fold_in(rng, arm)`` draws."""
    x0 = 0.5 * np.random.default_rng(2).normal(size=(8, 3))
    js = _warm_jax(x0, jax.random.PRNGKey(2), 60, 32, free)
    jfree = None if free is None else jnp.asarray(free)
    jwin, jinfo = jax.jit(lambda s: jchees.chees_race(j_mvn, s, 4, 16, 32, jfree))(js)
    draws = JaxGroupDraws(jax.vmap(lambda i: jax.random.fold_in(js.rng, i))(jnp.arange(4)))
    win, info = chees.chees_race(t_mvn, convert.chees_state_from_numpy(js, "cpu"), 4, 16, 32,
                                 None if free is None else T(free), draws=draws)
    assert info["winner"] == int(jinfo["winner"])
    np.testing.assert_allclose(info["candidates_log_traj"].numpy(), np.asarray(jinfo["candidates_log_traj"]),
                               **EXACT)
    np.testing.assert_array_equal(info["leapfrog_cost"].numpy(), np.asarray(jinfo["leapfrog_cost"]))
    assert len(set(info["leapfrog_cost"].tolist())) == 4
    for name in ("norm_esjd", "score"):
        np.testing.assert_allclose(info[name].numpy(), np.asarray(jinfo[name]), rtol=1e-10, err_msg=name)
    np.testing.assert_allclose(info["probe_min_ess"].numpy(), np.asarray(jinfo["probe_min_ess"]), rtol=1e-9)
    assert_states_close(win, jwin, **TOL)
    if free is not None:
        assert np.isfinite(info["score"].numpy()).all()
        assert torch.all(win.positions[:, 2] == T(x0)[:, 2])


def test_run_chees_pops_matches_jax():
    """3 populations of 4 chains, 20 warmup transitions (a mass window
    closes at the 18th) and 10 sampling transitions, each population on
    JAX's ``fold_in(rng, population)`` draws.  Free-running, dual averaging
    grows the last-bit differences to 2e-10 by 25 warmup transitions and
    8e-9 by 30."""
    x0 = 0.3 * np.random.default_rng(5).normal(size=(12, 3))
    key = jax.random.PRNGKey(5)
    jres = jax.jit(lambda q: jchees.run_chees_pops(j_mvn, q, key, 3, num_warmup=20, num_samples=10))(jnp.asarray(x0))
    draws = JaxGroupDraws(jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(3)))
    res = chees.run_chees_pops(t_mvn, T(x0), torch.Generator(), 3, num_warmup=20, num_samples=10, draws=draws)
    assert res.positions.shape == (10, 12, 3) and res.state.step_size.shape == (3,)
    np.testing.assert_allclose(res.positions.numpy(), np.asarray(jres.positions), **TOL)
    np.testing.assert_allclose(res.accept_probs.numpy(), np.asarray(jres.accept_probs), **TOL)
    assert_states_close(res.state, jres.state, **TOL)
    assert len(set(res.state.step_size.tolist())) == 3  # each population adapts alone


def test_pops_equal_separate_runs():
    """``run_chees_pops`` on the port's own generators: each population
    takes exactly the transitions a separate ``run_chees`` takes on its
    generator (``spawn_generators`` from the same seed)."""
    x0 = 0.5 * torch.randn((12, 3), generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    res = chees.run_chees_pops(t_mvn, x0, torch.Generator().manual_seed(7), 3, num_warmup=60, num_samples=20)
    gens = chees.spawn_generators(torch.Generator().manual_seed(7), 3)
    for p in range(3):
        one = chees.run_chees(t_mvn, x0[4 * p: 4 * p + 4], gens[p], num_warmup=60, num_samples=20)
        np.testing.assert_allclose(res.positions[:, 4 * p: 4 * p + 4].numpy(), one.positions.numpy(), **EXACT)
        np.testing.assert_allclose(res.logps[:, 4 * p: 4 * p + 4].numpy(), one.logps.numpy(), **EXACT)
        for name in ("step_size", "log_traj", "inv_mass"):
            np.testing.assert_allclose(getattr(res.state, name)[p].numpy(), getattr(one.state, name).numpy(),
                                       err_msg=name, **EXACT)


def test_pops_indivisible_raises():
    with pytest.raises(ValueError, match="divisible"):
        chees.run_chees_pops(t_mvn, torch.zeros((6, 3), dtype=torch.float64), torch.Generator(), n_pops=4)


def _warm_port(seed=0, chains=16, warmup=150, max_steps=32, free=None, x0=None):
    g = torch.Generator().manual_seed(seed)
    if x0 is None:
        x0 = 0.5 * torch.randn((chains, 3), generator=g, dtype=torch.float64)
    state = chees.chees_init(t_mvn, x0, g, 0.1, 1.0, free)
    sched = adapt.build_schedule(warmup)
    state = chees.chees_warm_chunk(t_mvn, state, sched.update_mass, sched.window_end, max_steps, free=free)
    return chees.finalize_chees_warmup(state)


def test_race_picks_max_score_and_advances_state():
    """The port's own generators (the counterpart of tests/test_chees.py's
    TestChEESRace): the winner is the argmax of the scores, carries its
    candidate's trajectory, has run the probe; costs grow with the grid's
    trajectories."""
    state = _warm_port()
    win, info = chees.chees_race(t_mvn, state, 4, 32, 32)
    k = info["winner"]
    assert k == int(torch.argmax(info["score"]))
    assert float(win.log_traj) == float(info["candidates_log_traj"][k])
    assert win.step == state.step + 32
    cost, grid = info["leapfrog_cost"].numpy(), info["candidates_log_traj"].numpy()[1:]
    assert np.all(cost > 0) and np.all(np.diff(cost[1:][np.argsort(grid)]) >= 0)
    assert isinstance(win.rng, torch.Generator) and win.positions.shape == state.positions.shape
    # a pathologically long adapted trajectory loses to a cheaper candidate
    long = state._replace(log_traj=torch.log(31.0 * state.step_size))
    win, info = chees.chees_race(t_mvn, long, 4, 32, 32)
    assert info["winner"] != 0 and float(torch.exp(win.log_traj)) < 0.9 * float(torch.exp(long.log_traj))


def test_race_with_free_mask_scores_free_dims():
    free = T([1.0, 1.0, 0.0])
    x0 = T(np.tile([0.0, 0.0, 5.0], (16, 1)))
    state = _warm_port(seed=8, free=free, x0=x0, warmup=100)
    win, info = chees.chees_race(t_mvn, state, 4, 32, 32, free=free)
    assert torch.isfinite(info["score"]).all() and float(info["score"].max()) > 0.0
    assert torch.all(win.positions[:, 2] == 5.0)


def test_run_chees_with_race_moments():
    """``run_chees(race=4)`` samples the Gaussian (moments within Monte
    Carlo error), its probe diagnostics as ``diagnostics.ess`` gives them."""
    x0 = 0.5 * torch.randn((16, 3), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    res = chees.run_chees(t_mvn, x0, torch.Generator().manual_seed(4), num_warmup=200, num_samples=300,
                          max_num_steps=32, race=4, race_probe=32)
    s = res.positions.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.3)
    assert float(diagnostics.split_rhat(res.positions.transpose(0, 1)).max()) < 1.05
