"""The multi-device layer with a card a rank: ``init_multihost``'s binding
of each NCCL rank's card, and ``chip_smoke.py``'s multicard rank function
on the CPU.

The binding is held as the plain function ``rank_card`` and through
``init_multihost`` with ``dist.init_process_group`` and the CUDA calls
replaced by recorders (this machine has no card).  The rank function's (a)
cases (``chip_smoke.rank_cases`` with "rows": the row-sharded factor, both
solves, the value and gradient, the iterative form and run_smc_large_n) run
on four gloo ranks of the CPU (``torch_dist_pool``) in float64 at n = 256,
block 32, against the JAX twin's row-sharded factor, solves and LML on a
(1, 4) mesh of the test process's virtual devices: 1e-9 for the factor,
the solves and the value, 1e-8 for the gradient, the parity tests' bounds.
"""

import functools
import os
import subprocess
import sys
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_dist_pool import RankPool

from gogp_tpu.gp.core import GP
from gogp_tpu.kernels import rbf, uniform_noise
from gogp_tpu.ops import distributed as jdist
from gogp_tpu.parallel import DATA_AXIS
from gogp_tpu.parallel import large_n as jlarge
from gogp_tpu.parallel import make_mesh as jmake_mesh
from gogp_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = dict(rtol=1e-9, atol=1e-9)
GRAD = dict(rtol=1e-8, atol=1e-8)
N_ROWS, BLOCK = 256, 32


# --- the binding ---------------------------------------------------------------------


@pytest.mark.parametrize("rank,local_rank,cards,want", [
    (0, "0", 4, 0), (5, "1", 8, 1), (3, "3", 4, 3),  # torchrun's LOCAL_RANK, whatever the rank
    (0, None, 4, 0), (3, None, 4, 3), (6, None, 4, 2), (1, None, 1, 0),  # the rank modulo the cards
])
def test_nccl_rank_card(rank, local_rank, cards, want):
    assert pmesh.rank_card("nccl", rank, cards, local_rank) == want


@pytest.mark.parametrize("local_rank", [None, "2"])
def test_gloo_rank_binds_no_card(local_rank):
    assert pmesh.rank_card("gloo", 3, 4, local_rank) is None


def test_nccl_rank_without_a_card_raises():
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        pmesh.rank_card("nccl", 0, 0)


def _init_calls(backend, env, **kw):
    """init_multihost with the group's constructor and the CUDA calls
    replaced by recorders, four cards visible: (set_device's cards, the
    init_process_group calls)."""
    cards, inits = [], []
    with unittest.mock.patch.dict(os.environ, env, clear=False), \
            unittest.mock.patch.object(pmesh.dist, "is_initialized", lambda: False), \
            unittest.mock.patch.object(pmesh.dist, "init_process_group",
                                       lambda *a, **k: inits.append((a, k))), \
            unittest.mock.patch.object(pmesh.dist, "get_world_size", lambda: kw.get("num_processes") or 1), \
            unittest.mock.patch.object(torch.cuda, "device_count", lambda: 4), \
            unittest.mock.patch.object(torch.cuda, "set_device", cards.append):
        for name in ("RANK", "LOCAL_RANK", "MASTER_ADDR"):
            if name not in env:
                os.environ.pop(name, None)
        pmesh.init_multihost(backend=backend, **kw)
    return cards, inits


@pytest.mark.parametrize("env,kw,card", [
    ({}, dict(coordinator_address="127.0.0.1:1", num_processes=4, process_id=2), 2),  # the rank
    ({"LOCAL_RANK": "1"}, dict(coordinator_address="127.0.0.1:1", num_processes=4, process_id=3), 1),
    ({"MASTER_ADDR": "127.0.0.1", "RANK": "7", "LOCAL_RANK": "3"}, {}, 3),  # torchrun's env://
    ({"MASTER_ADDR": "127.0.0.1", "RANK": "5"}, {}, 1),  # env:// without LOCAL_RANK: 5 modulo 4
    ({}, {}, 0),  # a world of one
])
def test_init_multihost_binds_the_nccl_card_before_the_group(env, kw, card):
    """The card is made current and handed to the group as its device."""
    cards, inits = _init_calls("nccl", env, **kw)
    assert cards == [card]
    ((args, kwargs),) = inits
    assert args == ("nccl",) and kwargs["device_id"] == torch.device("cuda", card)


@pytest.mark.parametrize("env,kw", [
    ({}, dict(coordinator_address="127.0.0.1:1", num_processes=4, process_id=2)),
    ({"LOCAL_RANK": "1"}, {}),
    ({}, {}),
])
def test_init_multihost_leaves_a_gloo_world_unbound(env, kw):
    """A gloo world (ranks that share one card, the CPU) binds no card and
    makes its group as before."""
    cards, inits = _init_calls("gloo", env, **kw)
    assert cards == []
    ((args, kwargs),) = inits
    assert args == ("gloo",) and kwargs["device_id"] is None


# --- the multicard phase's rank function, on four gloo ranks of the CPU --------------


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def rows(pool):
    return pool.run("multicard_rows", N_ROWS, BLOCK)


def _problem():
    import chip_smoke

    gp, x, y, v0, _ = chip_smoke.large_problem(N_ROWS, torch.float64, torch.device("cpu"))
    theta = torch.exp(v0)
    K = chip_smoke.core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil:], x, None)
    return x.numpy(), y.numpy(), v0.numpy(), K.numpy()


def _shmap(fn, in_specs, out_specs):
    mesh = jmake_mesh(n_chain=1, n_data=4, devices=jax.devices()[:4])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def test_multicard_rows_factor_and_solves_match_jax(rows):
    """Each rank's rows of the row-sharded factor and of alpha = K^-1 y
    against the twin's row-sharded factor and solves on a (1, 4) mesh."""
    _, y, _, K = _problem()
    rowspec = P(DATA_AXIS, None)
    L = np.asarray(_shmap(functools.partial(jdist.cholesky_rowsharded, axis=DATA_AXIS, block=BLOCK, unroll=True),
                          (rowspec,), rowspec)(jnp.asarray(K)))

    def alpha(L_local, y_local):
        z = jdist.solve_lower_rowsharded(L_local, y_local, DATA_AXIS, BLOCK)
        return jdist.solve_upper_rowsharded(L_local, z, DATA_AXIS, BLOCK)

    a = np.asarray(_shmap(alpha, (rowspec, P(DATA_AXIS)), P(DATA_AXIS))(jnp.asarray(L), jnp.asarray(y)))
    np.testing.assert_allclose(np.concatenate([r["out"]["L"] for r in rows]), L, **EXACT)
    np.testing.assert_allclose(np.concatenate([r["out"]["alpha"] for r in rows]), a, **EXACT)


def test_multicard_rows_value_and_gradient_match_jax(rows):
    """The replicated LML and its psum-completed gradient at v0 against the
    twin's make_rowsharded_logp -> make_rowsharded_value_and_grad on a
    (1, 4) mesh; the same on every rank."""
    x, y, v0, _ = _problem()
    jgp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def device_fn(x_local, y_local):
        logp = jlarge.make_rowsharded_logp(jgp, x_local, jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
                                           y_local, jnp.ones_like(y_local), DATA_AXIS, BLOCK)
        return jlarge.make_rowsharded_value_and_grad(logp, DATA_AXIS)(jnp.asarray(v0))

    val, g = _shmap(device_fn, (P(DATA_AXIS, None), P(DATA_AXIS)), (P(), P()))(jnp.asarray(x), jnp.asarray(y))
    for r in rows:
        np.testing.assert_allclose(r["out"]["value"], float(val), **EXACT)
        np.testing.assert_allclose(r["out"]["grad"], np.asarray(g), **GRAD)


def test_multicard_rows_report(rows):
    """The report holds its own checks in f64 with no miss: the errors
    against cuSOLVER's stand-in, the dense path and the dense iterative
    form on rank 0, each rank's the factor's and solves'; run_smc_large_n
    finite on every rank alike, and no kernel launched on the CPU."""
    r0 = rows[0]
    assert [r["failures"] for r in rows] == [[]] * 4
    for name in ("chol_rel", "solve_rel", "value_rel", "grad_rel", "iter_value_rel_rank0", "iter_value_rel_rank32",
                 "iter_grad_rel_rank0", "iter_grad_rel_rank32"):
        assert r0["errors"][name] < 1e-9, name
    assert set(rows[1]["errors"]) == {"chol_rel", "solve_rel"}
    assert all(r["smc_large_n"]["particles"] == r0["smc_large_n"]["particles"] for r in rows)
    assert np.isfinite(r0["smc_large_n"]["particles"]).all() and r0["smc_large_n"]["factorizations"] >= 1
    assert all(v == 0 for r in rows for counts in r["launches"].values() for v in counts.values())


def test_multicard_phase_needs_four_cards():
    """``python chip_smoke.py --phases multicard`` without four cards
    exits non-zero before any result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "multicard"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "multicard phase needs 4 CUDA cards, 0 visible" in proc.stderr
