"""Parity of the port's exact leave-one-out (gogp_torch.gp.model_selection)
with gogp_tpu.gp.model_selection.

Float64 on the CPU, the same numpy data through both: every LOOResult field
to rtol 1e-9 (atol 1e-12), ``loo_score``'s gradient in both thetas against
``jax.grad`` to rtol 1e-8 of its largest entry, bic and aic exactly; the
blocked ``tril_inv`` route (``force_blocked``) gives the same LOO.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp import core as jcore
from gogp_tpu.gp import model_selection as jms
from gogp_tpu.kernels import matern52 as jmatern52
from gogp_tpu.kernels import uniform_noise as juniform
from gogp_torch.gp import core, model_selection
from gogp_torch.kernels import matern52, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb

TOL = dict(rtol=1e-9, atol=1e-12)
JGP = jcore.GP(ndim=1, simil=jmatern52.scaled(), noise=juniform.scaled_by(0.1))
TGP = core.GP(ndim=1, simil=matern52.scaled(), noise=uniform_noise.scaled_by(0.1))
TS, TN = np.array([1.2, 0.7]), np.array([0.5])


def _data(n=30, pad=4, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 8, n))
    y = np.cos(x) + 0.2 * rng.normal(size=n)
    mask = np.ones(n)
    mask[n - pad :] = 0.0
    return x, y, mask


def _t(a):
    return torch.tensor(np.array(a))


def test_loo_matches_jax():
    x, y, mask = _data()
    want = jms.loo(JGP, TS, TN, x, y, mask)
    got = model_selection.loo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    for name in model_selection.LOOResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **TOL, err_msg=name)
    assert float(got.logp[-1]) == 0.0


def test_loo_blocked_route():
    x, y, _ = _data(n=256, pad=16, seed=1)
    mask = np.ones(256)
    mask[-16:] = 0.0
    want = model_selection.loo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    with cb.force_blocked(128):
        got = model_selection.loo(TGP, _t(TS), _t(TN), _t(x), _t(y), _t(mask))
    np.testing.assert_allclose(got.total.numpy(), want.total.numpy(), rtol=1e-9)
    np.testing.assert_allclose(got.mu.numpy(), want.mu.numpy(), **TOL)


def test_loo_score_value_and_gradient():
    x, y, mask = _data()

    def jscore(ts, tn):
        return jms.loo_score(JGP, ts, tn, x, y, mask)

    want, (gts, gtn) = jax.value_and_grad(jscore, argnums=(0, 1))(jnp.asarray(TS), jnp.asarray(TN))
    ts, tn = _t(TS).requires_grad_(True), _t(TN).requires_grad_(True)
    got = model_selection.loo_score(TGP, ts, tn, _t(x), _t(y), _t(mask))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-9)
    g, w = np.concatenate([ts.grad.numpy(), tn.grad.numpy()]), np.concatenate([np.asarray(gts), np.asarray(gtn)])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-8 * np.abs(w).max())


def test_bic_aic_match_jax():
    lml = -12.375
    assert float(model_selection.bic(torch.tensor(lml, dtype=torch.float64), 3, 40)) == pytest.approx(
        float(jms.bic(jnp.asarray(lml), 3, 40)), rel=1e-15)
    assert model_selection.bic(lml, 3, 40) == pytest.approx(float(jms.bic(jnp.asarray(lml), 3, 40)), rel=1e-15)
    assert float(model_selection.aic(torch.tensor(lml, dtype=torch.float64), 3)) == float(jms.aic(lml, 3))
