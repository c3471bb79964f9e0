"""The port's distributed dense linear algebra (gogp_torch.ops.distributed)
against the JAX package's, in float64 on the CPU.

Four gloo ranks (one pool for the file, ``torch_dist_pool``) run the port
on a (1, 4) mesh; the JAX twin runs on a (1, 4) mesh of the test process's
virtual CPU devices.  Each rank returns its rows and the test stacks them.
Tolerance 1e-9 (relative, absolute 1e-9) for the factor, the solves, the
LML value and its backward: the same blocked algorithm, each panel solved
against L_kk as the twin solves it, the sums in other orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torch_dist_pool import RankPool

from gogp_tpu.ops import distributed as jdist
from gogp_tpu.parallel import DATA_AXIS
from gogp_tpu.parallel import make_mesh as jmake_mesh

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(n_chain=1, n_data=4, devices=jax.devices()[:4])


def spd_matrix(n, seed=0):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def stacked(outs, i=None):
    return np.concatenate([o if i is None else o[i] for o in outs])


@pytest.mark.parametrize("n,block", [(64, 8), (128, 16), (256, 32), (128, 4), (64, 256)])
def test_cholesky_matches_jax(pool, jmesh, n, block):
    """(64, 256): the block clamps to n_local = 16."""
    K = spd_matrix(n)
    want = np.asarray(shmap(functools.partial(jdist.cholesky_rowsharded, axis=DATA_AXIS, block=block, unroll=True),
                            jmesh, (P(DATA_AXIS, None),), P(DATA_AXIS, None))(jnp.asarray(K)))
    got = stacked(pool.run("cholesky", K, 4, block))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.linalg.cholesky(K), **TOL)


def test_block_must_divide_the_shard(pool):
    errs = pool.run("cholesky_error", spd_matrix(64), 4, 12)
    assert all("block=12 must divide both n=64 and n_local=16" in e for e in errs)


@pytest.mark.parametrize("m", [0, 5])
def test_solves_match_jax(pool, jmesh, m):
    """Both solves, a vector (m = 0) and a (n, 5) right-hand side."""
    n, block = 128, 16
    L = np.linalg.cholesky(spd_matrix(n, seed=1))
    B = np.random.default_rng(2).normal(size=(n,) if m == 0 else (n, m))
    spec = P(DATA_AXIS) if m == 0 else P(DATA_AXIS, None)
    outs = pool.run("solves", L, B, 4, block)
    for i, fn in enumerate((jdist.solve_lower_rowsharded, jdist.solve_upper_rowsharded)):
        want = np.asarray(shmap(functools.partial(fn, axis=DATA_AXIS, block=block), jmesh,
                                (P(DATA_AXIS, None), spec), spec)(jnp.asarray(L), jnp.asarray(B)))
        np.testing.assert_allclose(stacked(outs, i), want, **TOL)


@pytest.mark.parametrize("n,block", [(64, 8), (256, 32)])
def test_lml_value_and_backward_match_jax(pool, jmesh, n, block):
    """The value, and the backward against ``jax.grad`` inside shard_map:
    each rank's rows of Kbar and of ybar, for a cotangent of 0.7."""
    K = spd_matrix(n, seed=3)
    y = np.random.default_rng(4).normal(size=n)

    def device_fn(K_local, y_local):
        f = lambda K_l, y_l: 0.7 * jdist.lml_rowsharded(K_l, y_l, DATA_AXIS, block)  # noqa: E731
        return jax.value_and_grad(f, argnums=(0, 1))(K_local, y_local)

    val, (gK, gy) = shmap(device_fn, jmesh, (P(DATA_AXIS, None), P(DATA_AXIS)),
                          (P(), (P(DATA_AXIS, None), P(DATA_AXIS))))(jnp.asarray(K), jnp.asarray(y))
    outs = pool.run("lml_value_and_grad", K, y, 4, block, 0.7)
    for o in outs:
        np.testing.assert_allclose(0.7 * o[0], float(val), **TOL)
    np.testing.assert_allclose(stacked(outs, 1), np.asarray(gK), **TOL)
    np.testing.assert_allclose(stacked(outs, 2), np.asarray(gy), **TOL)
    # GPML 5.9 in dense numpy
    Kinv = np.linalg.inv(K)
    a = Kinv @ y
    np.testing.assert_allclose(stacked(outs, 1), 0.7 * 0.5 * (np.outer(a, a) - Kinv), **TOL)


def test_one_rank_and_four_ranks_agree(pool):
    """The same LML value and gradient from a 1x1 mesh (rank 0 alone) and
    a 1x4 mesh."""
    K, y = spd_matrix(128, seed=5), np.random.default_rng(6).normal(size=128)
    four = pool.run("lml_value_and_grad", K, y, 4, 16)
    one = pool.run("lml_value_and_grad", K, y, 1, 16)
    assert one[1:] == [None, None, None]
    np.testing.assert_allclose(four[0][0], one[0][0], **TOL)
    np.testing.assert_allclose(stacked(four, 1), one[0][1], **TOL)
    np.testing.assert_allclose(stacked(four, 2), one[0][2], **TOL)


@pytest.mark.parametrize("n,n_data,block", [(128, 4, 16), (256, 2, 128)])
def test_diagonal_step_takes_the_tile_factor(pool, n, n_data, block):
    """Every rank factors each diagonal block once, n / block calls: on the
    CPU each one K2's plain version (on the card, K2 itself at block 128)."""
    calls = pool.run("diag_step_counts", spd_matrix(n), n_data, block)
    assert calls[:n_data] == [{"kernel": 0, "plain": n // block}] * n_data
    assert calls[n_data:] == [None] * (4 - n_data)
