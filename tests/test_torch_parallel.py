"""The port's process meshes and sharded samplers (gogp_torch.parallel.mesh,
.sample, .smc_sharded) against the JAX package's, in float64 on the CPU.

Four gloo ranks (one pool for the file, ``torch_dist_pool``) run the port on
a (2, 2) mesh and rank 0 alone on a 1x1 mesh; the JAX runners run on a (2,
2) mesh of the test process's virtual CPU devices.  Draws: the ranks replay
JAX's key streams through the port's draws hooks (``torch_dist_tasks``), the
whole population's draws on every rank, each rank keeping its rows, so the
sharded port and the sharded twin sample the same chains.  Tolerance 1e-6
relative, 1e-8 absolute, for the samplers' draws and states against the
twin: the twin pmeans its statistics in XLA's order where the port gathers
them, and the warmup and sampling transitions grow that last-bit
difference to about 1e-7 (measured); 1e-10 for SMC.  The 1- and 4-rank runs of the
port agree bit for bit, on JAX's draws and on the port's own generator.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_hmc import j_mvn
from torch_dist_pool import RankPool

from gogp_tpu.parallel import make_mesh as jmake_mesh
from gogp_tpu.parallel import sample as jsample
from gogp_tpu.parallel import smc_sharded as jsmc
from gogp_torch import convert

STATE = dict(rtol=1e-6, atol=1e-8)
EXACT = dict(rtol=1e-10, atol=1e-12)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(n_chain=2, n_data=2, devices=jax.devices()[:4])


def key_np(seed):
    return np.asarray(jax.random.PRNGKey(seed))


# --- the mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4), (1, 1)])
def test_mesh_layout_and_collectives(pool, shape):
    """Row-major rank layout, the per-axis and whole-mesh groups, psum,
    pmean, all_gather in JAX's order and broadcast."""
    n_chain, n_data = shape
    size = n_chain * n_data
    outs = pool.run("mesh_layout", shape)
    assert outs[size:] == [None] * (4 - size)
    flat = np.arange(size, dtype=float).reshape(n_chain, n_data)
    for r, o in enumerate(outs[:size]):
        i, j = divmod(r, n_data)
        assert o["coords"] == (i, j) and o["sizes"] == (n_chain, n_data, size)
        assert o["psum_chain"] == flat[:, j].sum() and o["psum_data"] == flat[i].sum()
        assert o["psum_all"] == flat.sum() and o["pmean_all"] == flat.mean()
        np.testing.assert_array_equal(o["gather_all"], flat.reshape(-1))
        np.testing.assert_array_equal(o["gather_rev"], flat.T.reshape(-1))
        np.testing.assert_array_equal(o["gather_chain"], flat[:, j])
        assert o["bcast"] == (1.0 if size > 1 else 0.0)
        assert o["describe"] == {"backend": "gloo", "world_size": 4, "mesh": [n_chain, n_data]}


@pytest.mark.parametrize("layer", ["ops", "infer", "gp"])
def test_collectives_sit_below_the_ops_and_parallel_layers(layer):
    """No module of the lower layers imports the parallel package, at module
    level or inside a function: they reach the collectives through
    ``ops.collectives``, which ``parallel.mesh`` re-exports."""
    import ast

    from gogp_torch.ops import collectives
    from gogp_torch.parallel import mesh as pmesh

    for name in ("psum", "pmean", "all_gather", "broadcast", "axis_index", "axis_size", "current"):
        assert getattr(pmesh, name) is getattr(collectives, name)
    assert (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS) == (collectives.CHAIN_AXIS, collectives.DATA_AXIS)
    offenders = []
    for path in sorted((REPO / "gogp_torch" / layer).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            offenders += [f"{path.name}: {m}" for m in mods if m.startswith("gogp_torch.parallel")]
    assert offenders == []


def test_mesh_errors(pool):
    """make_mesh's error on too few ranks is the twin's; a collective with
    no mesh entered says so."""
    assert pool.run("mesh_errors")[0] == ["mesh 8x1 needs 8 devices, have 4",
                                          "no mesh is active: run the sharded body under `with mesh:`"]


@pytest.mark.parametrize("axis", [("chain",), ("data",), ("chain", "data")])
def test_sharding_slabs_and_gather(pool, axis):
    """Each rank's slab is its rows in the mesh's flattened order of
    ``axis``; gathering the slabs gives the global tensor back."""
    x = np.arange(24.0).reshape(8, 3)
    outs = pool.run("sharding_roundtrip", (2, 2), x, axis)
    for r, (slab, back) in enumerate(outs):
        i, j = divmod(r, 2)
        idx = {("chain",): i, ("data",): j, ("chain", "data"): r}[tuple(axis)]
        per = 8 // (4 if len(axis) == 2 else 2)
        np.testing.assert_array_equal(slab, x[idx * per:(idx + 1) * per])
        np.testing.assert_array_equal(slab, convert.slab_from_numpy(x, idx, 8 // per, "cpu").numpy())
        np.testing.assert_array_equal(back, x)


WORKER = textwrap.dedent(
    """
    import sys
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    import torch
    import torch.distributed as dist
    from gogp_torch.parallel import mesh as pmesh

    n = pmesh.init_multihost(f"localhost:{port}", num_processes=2, process_id=pid, backend="gloo")
    assert n == 2, n
    m = pmesh.make_mesh(n_chain=2, n_data=1)
    with m:
        out = pmesh.psum(torch.tensor([1.0, 2.0])[pid:pid + 1], pmesh.CHAIN_AXIS)
    assert float(out) == 3.0, out
    print(f"proc {pid}: psum over 2 processes = {float(out)} OK", flush=True)
    dist.destroy_process_group()
    """
)


def test_init_multihost_two_processes():
    """Two OS processes join a localhost coordinator through
    ``init_multihost`` and psum over a 2x1 mesh (the twin of
    tests/test_multihost.py).  Each destroys its group before it exits: a
    process that exits with its gloo group alive can abort in its teardown
    ("terminate called without an active exception", exit code -6) after
    its psum is done.  Both processes' output goes into every failure's
    message."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(pid), str(port), str(REPO)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=dict(os.environ), text=True)
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        outs.append(out)
    report = "\n".join(f"--- proc {pid}, exit code {p.returncode}:\n{out}"
                       for pid, (p, out) in enumerate(zip(procs, outs)))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, report
        assert f"proc {pid}: psum over 2 processes = 3.0 OK" in out, report


# --- the samplers -------------------------------------------------------------------

X8 = 0.3 * np.random.default_rng(2).normal(size=(8, 3))
X4 = X8[:4]
X1 = np.array([0.3, -0.4, 0.2])

# runner: (position0, kwargs, compared result fields, compared state fields)
RUNNERS = {
    "run_chees_sharded": (X8, dict(num_warmup=20, num_samples=6, max_num_steps=32),
                          ("positions", "logps", "accept_probs"), ("step_size", "inv_mass", "log_traj")),
    "run_ghmc_sharded": (X8, dict(num_warmup=20, num_samples=6),
                         ("positions", "logps", "accept_probs"), ("step_size", "sigma", "momenta")),
    "run_chees_pops_sharded": (X8, dict(n_pops=4, num_warmup=20, num_samples=6, max_num_steps=32),
                               ("positions", "logps", "accept_probs"), ()),
    "run_pt_chees_sharded": (X4, dict(n_replicas=3, beta_min=0.2, num_warmup=20, num_samples=6, max_num_steps=32),
                             ("positions", "logps", "swap_rate", "betas", "barrier", "pair_rej", "round_trips"),
                             ("positions", "step_size", "log_traj")),
    "run_pt_distributed": (X1, dict(n_replicas=4, beta_min=0.2, num_warmup=20, num_samples=6, max_tree_depth=4),
                           ("positions", "logps", "swap_rate", "betas", "barrier", "pair_rej", "round_trips"),
                           ("position", "step_size", "inv_mass")),
    "run_pt_chees_distributed": (X1, dict(n_ladders=4, n_replicas=4, beta_min=0.2, num_warmup=20, num_samples=6,
                                          max_num_steps=32),
                                 ("positions", "logps", "swap_rate", "betas", "barrier", "pair_rej", "round_trips"),
                                 ("positions", "step_size", "log_traj")),
    "run_pt_sharded": (X4, dict(n_replicas=3, beta_min=0.2, num_warmup=8, num_samples=6, max_tree_depth=4),
                       ("positions", "logps", "swap_rate", "betas", "round_trips"), ()),
    "run_nuts_sharded": (X8, dict(num_warmup=20, num_samples=6, max_tree_depth=5),
                         ("positions", "logps", "accept_probs"), ("step_size", "inv_mass")),
    "run_hmc_sharded": (X8, dict(num_warmup=20, num_samples=6, trajectory_length=0.5),
                        ("positions", "logps", "accept_probs"), ("step_size", "inv_mass")),
}


def assert_result(got: dict, want, fields, state_fields, tol):
    for name in fields:
        np.testing.assert_allclose(np.asarray(got[name], dtype=float), np.asarray(getattr(want, name), dtype=float),
                                   err_msg=name, **tol)
    for name in state_fields:
        w = want["state"][name] if isinstance(want, dict) else getattr(want.state, name)
        np.testing.assert_allclose(got["state"][name], np.asarray(w), err_msg=f"state.{name}", **tol)


def assert_same(got: dict, want: dict, fields, state_fields):
    """Bit for bit: the whole population's statistics are gathered and
    reduced in one order, and each chain's log-density does not depend on
    its batch here, so R ranks reproduce one rank exactly."""
    for name in fields:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)
    for name in state_fields:
        np.testing.assert_array_equal(got["state"][name], want["state"][name], err_msg=f"state.{name}")


class _D(dict):
    """A result dict read like the NamedTuple it came from."""

    __getattr__ = dict.__getitem__


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_matches_jax_and_is_rank_invariant(pool, jmesh, runner):
    """On a (2, 2) mesh with JAX's draws the port's runner gives the JAX
    runner's draws and final state; rank 0 alone on a 1x1 mesh gives the
    same, and so it does on the port's own generator."""
    x0, kw, fields, state_fields = RUNNERS[runner]
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda q: getattr(jsample, runner)(j_mvn, q, key, jmesh, **kw))(jnp.asarray(x0))
    four = pool.run("run_sampler", (2, 2), runner, x0, key_np(7), kw)
    for o in four[1:]:  # every rank returns the global result
        assert_same(o, four[0], fields, ())
    assert_result(four[0], want, fields, state_fields, STATE)
    one = pool.run("run_sampler", (1, 1), runner, x0, key_np(7), kw)[0]
    assert_same(one, four[0], fields, state_fields)
    own4 = pool.run("run_sampler", (2, 2), runner, x0, key_np(7), kw, False, 3)[0]
    own1 = pool.run("run_sampler", (1, 1), runner, x0, key_np(7), kw, False, 3)[0]
    assert_same(own1, own4, fields, state_fields)
    assert np.isfinite(np.asarray(own4["positions"], dtype=float)).all()


@pytest.mark.parametrize("mutation", ["hmc", "rwm"])
def test_run_smc_sharded_matches_jax_and_is_rank_invariant(pool, jmesh, mutation):
    """32 particles annealed to the correlated Gaussian: the JAX twin's
    stages, particles, log evidence and acceptance on its draws; the same
    from one rank; on the port's generator, 1 and 4 ranks alike."""
    key = jax.random.PRNGKey(21)
    x0 = np.array([0.5, 0.0, -0.5])
    kw = dict(num_particles=32, sigma0=2.0, num_mcmc_steps=2, n_leapfrog=4, mutation=mutation)
    want = jax.jit(lambda q: jsmc.run_smc_sharded(j_mvn, q, key, jmesh, **kw))(jnp.asarray(x0))
    # the twin's sharded accept rate is its first device's slab's; the
    # whole population's is the serial sampler's, on the same draws
    serial = jax.jit(lambda q: jsmc.run_smc(j_mvn, q, key, **kw))(jnp.asarray(x0))
    np.testing.assert_allclose(np.asarray(serial.particles), np.asarray(want.particles), rtol=0, atol=1e-10)
    four = pool.run("run_smc", (2, 2), x0, key_np(21), kw)
    one = pool.run("run_smc", (1, 1), x0, key_np(21), kw)[0]
    for got in (four[0], one):
        assert got["num_stages"] == int(want.num_stages) > 2 and got["betas_hit_one"] == bool(want.betas_hit_one)
        np.testing.assert_allclose(got["particles"], np.asarray(want.particles), rtol=0, atol=1e-10)
        np.testing.assert_allclose(got["log_evidence"], float(want.log_evidence), **EXACT)
        np.testing.assert_allclose(got["accept_rate"], float(serial.accept_rate), **EXACT)
    np.testing.assert_array_equal(four[0]["particles"], one["particles"])
    own4 = pool.run("run_smc", (2, 2), x0, key_np(21), kw, False, 5)[0]
    own1 = pool.run("run_smc", (1, 1), x0, key_np(21), kw, False, 5)[0]
    np.testing.assert_array_equal(own4["particles"], own1["particles"])
    assert own4["num_stages"] == own1["num_stages"]


def test_run_ess_sharded_matches_jax_and_is_rank_invariant(pool, jmesh):
    """8 chains of elliptical slice sampling on a Bernoulli-logit latent GP:
    JAX's chains on its draws, from 4 ranks and from one."""
    from gogp_tpu.gp import core as jcore
    from gogp_tpu.gp import likelihoods as jlik
    from gogp_tpu.kernels import rbf as jrbf
    from test_torch_elliptical import _problem

    x, y = _problem()
    K = jcore.masked_cov(jcore.GP(ndim=1, simil=jrbf.scaled()), jnp.asarray([1.2, 0.9]), jnp.zeros(0),
                         jnp.asarray(x)[:, None], None)
    chol = np.asarray(jnp.linalg.cholesky(K))
    key = jax.random.PRNGKey(4)
    warm, samp = 6, 5

    def jll(f):
        return jlik.bernoulli_logit.sum_logp(jnp.zeros(0), f, jnp.asarray(y))

    want = jsample.run_ess_sharded(jll, jnp.asarray(chol), jnp.zeros((8, x.size)), key, jmesh, warm, samp)
    four = pool.run("run_ess", (2, 2), chol, y, 8, key_np(4), warm, samp)[0]
    one = pool.run("run_ess", (1, 1), chol, y, 8, key_np(4), warm, samp)[0]
    for got in (four, one):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), **STATE)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), **STATE)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(four[0], one[0])
    own4 = pool.run("run_ess", (2, 2), chol, y, 8, key_np(4), warm, samp, False, 2)[0]
    own1 = pool.run("run_ess", (1, 1), chol, y, 8, key_np(4), warm, samp, False, 2)[0]
    np.testing.assert_array_equal(own4[0], own1[0])


@pytest.mark.parametrize("twin,port", [("gogp_tpu.parallel.mesh", "gogp_torch.parallel.mesh"),
                                       ("gogp_tpu.parallel.sample", "gogp_torch.parallel.sample"),
                                       ("gogp_tpu.parallel.smc_sharded", "gogp_torch.parallel.smc_sharded"),
                                       ("gogp_tpu.parallel.serving", "gogp_torch.parallel.serving"),
                                       ("gogp_tpu.parallel.large_n", "gogp_torch.parallel.large_n"),
                                       ("gogp_tpu.ops.distributed", "gogp_torch.ops.distributed"),
                                       ("gogp_tpu.parallel", "gogp_torch.parallel")])
def test_every_public_name_of_the_twin_has_a_counterpart(twin, port):
    """Each public function of the JAX modules (and each name the package
    exports) exists in the port's twin module."""
    import importlib
    import inspect

    jmod, tmod = importlib.import_module(twin), importlib.import_module(port)
    names = getattr(jmod, "__all__", None) or [
        name for name, obj in vars(jmod).items()
        if not name.startswith("_") and inspect.isfunction(obj) and obj.__module__ == jmod.__name__]
    assert names and [name for name in names if not hasattr(tmod, name)] == []
