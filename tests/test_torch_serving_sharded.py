"""The port's sharded serving (gogp_torch.parallel.serving) against the JAX
package's, in float64 on the CPU.

Four gloo ranks (one pool for the file, ``torch_dist_pool``) serve on a (4,
1) mesh, S = 8 mixture draws two a rank, and rank 0 alone on a 1x1 mesh;
the JAX twin serves on a (4, 1) mesh of the test process's virtual CPU
devices.  The mixture comes both compiled rank by rank
(``compile_mixture_sharded``: each rank absorbs and inverts only its
draws), sliced from a whole compiled mixture (``shard_mixture``) and
sliced from the twin's compiled mixture
(``convert.serving_mixture_slab_from_numpy``).
Tolerance 1e-9 (relative, absolute 1e-10): the same per-draw arithmetic,
the two moment sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_dist_pool import RankPool

from gogp_tpu import parallel as jparallel
from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import serve as jserve
from gogp_tpu.kernels import rbf, uniform_noise

TOL = dict(rtol=1e-9, atol=1e-10)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _problem(n=24, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_predictions_match_jax(pool, shape):
    """Draw-sharded mixture moments (both ways of holding the slab) and the
    request-sharded batch (64 rows) against the twin's, from 4 ranks and
    from one."""
    gp = jcore.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x, y = _problem(seed=1)
    vs = 0.3 * np.random.default_rng(2).normal(size=(8, gp.n_theta))
    theta = np.array([1.0, 0.8, 0.2])
    z = np.linspace(-1.0, 11.0, 64)[:, None]
    mesh = jparallel.make_mesh(n_chain=shape[0], n_data=shape[1], devices=jax.devices()[:4])
    sm = jserve.compile_mixture(gp, jnp.asarray(vs), jnp.asarray(x), jnp.asarray(y))
    mix = [np.asarray(a) for a in jparallel.serve_predict_mixture_sharded(gp, sm, jnp.asarray(z), mesh)]
    sp = jserve.fit_serving(gp, jnp.asarray(theta[:2]), jnp.asarray(theta[2:]), jnp.asarray(x), jnp.asarray(y))
    req = [np.asarray(a) for a in jparallel.serve_predict_sharded(gp, sp, jnp.asarray(z), mesh)]
    four = pool.run("serving", shape, x, y, vs, theta, z)
    one = pool.run("serving", (1, 1), x, y, vs, theta, z)[0]
    from_jax = pool.run("serving_from_jax", shape, {k: np.asarray(v) for k, v in sm._asdict().items()}, z)
    for got in from_jax:
        np.testing.assert_allclose(got[0], mix[0], **TOL)
        np.testing.assert_allclose(got[1], mix[1], **TOL)
    for got in four + [one]:
        for i in (0, 1):  # compiled rank by rank, sliced from the whole
            np.testing.assert_allclose(got[i][0], mix[0], **TOL)
            np.testing.assert_allclose(got[i][1], mix[1], **TOL)
        np.testing.assert_allclose(got[2][0], req[0], **TOL)
        np.testing.assert_allclose(got[2][1], req[1], **TOL)
    assert [g[3] for g in four] == [8 // shape[0]] * 4 and one[3] == 8
