"""Parity of the port's streaming appends (gogp_torch.gp.streaming) with
gogp_tpu.gp.streaming, and with one ``absorb`` of all the points.

Float64 on the CPU, the same numpy batches through both packages: the
posterior after every append agrees with JAX's to rtol 1e-9 (atol 1e-12 for
entries near 0), and the stream's end with a fresh absorb of the
concatenated data to rtol 1e-9; on the blocked route (``force_blocked``,
plain tile inverses) too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import streaming as jstream
from gogp_tpu.kernels import rbf as jrbf
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_torch.gp import core, streaming
from gogp_torch.kernels import rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jrbf.scaled(), noise=juniform)
TGP = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
TS, TN = np.array([1.1, 0.8]), np.array([0.05])


def _stream(steps, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (steps, b, 1))
    return x, np.sin(x[..., 0]) + 0.1 * rng.normal(size=(steps, b))


def _t(a):
    return torch.tensor(np.array(a))


def test_each_append_matches_jax():
    xs, ys = _stream(3, 4)
    pj = jstream.streaming_posterior(JGP, TS, TN, 16, dtype=jnp.float64)
    pt = streaming.streaming_posterior(TGP, _t(TS), _t(TN), 16, dtype=torch.float64)
    for xb, yb in zip(xs, ys):
        pj = jstream.absorb_append(JGP, pj, xb, yb)
        pt = streaming.absorb_append(TGP, pt, _t(xb), _t(yb))
        for name in core.Posterior._fields:
            np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), **TOL,
                                       err_msg=name)


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
def test_stream_matches_one_absorb(blocked):
    steps, b, cap = 4, 32, 256
    xs, ys = _stream(steps, b, seed=1)
    with cb.force_blocked(128) if blocked else torch.no_grad():
        post = streaming.absorb_stream(TGP, streaming.streaming_posterior(TGP, _t(TS), _t(TN), cap,
                                                                          dtype=torch.float64), _t(xs), _t(ys))
        mask = np.zeros(cap)
        mask[: steps * b] = 1.0
        x = np.zeros((cap, 1))
        y = np.zeros(cap)
        x[: steps * b], y[: steps * b] = xs.reshape(-1, 1), ys.reshape(-1)
        want = core.absorb(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    np.testing.assert_allclose(post.chol.numpy(), want.chol.numpy(), **TOL)
    np.testing.assert_allclose(post.alpha.numpy(), want.alpha.numpy(), **TOL)
    jpost = jstream.absorb_stream(JGP, jstream.streaming_posterior(JGP, TS, TN, cap, dtype=jnp.float64), xs, ys)
    np.testing.assert_allclose(post.alpha.numpy(), np.asarray(jpost.alpha), **TOL)


def test_append_past_capacity_raises():
    xs, ys = _stream(1, 4)
    post = streaming.streaming_posterior(TGP, _t(TS), _t(TN), 6, dtype=torch.float64)
    post = streaming.absorb_append(TGP, post, _t(xs[0]), _t(ys[0]))
    with pytest.raises(ValueError, match="capacity"):
        streaming.absorb_append(TGP, post, _t(xs[0]), _t(ys[0]))
