"""Parity of the port's kernel search (gogp_torch.search) with
gogp_tpu.search.

Float64 on the CPU, on the JAX tests' trend-plus-periodic data.  The
restarts' starting points are JAX's own draws, handed in through the
pathwise ``PathDraws`` hook (``JaxPathDraws``), so each candidate's batched
Adam fit runs step for step against JAX's ``vmap`` of ``mle.adam``: its best
log-theta vector and LML to rtol 1e-9, on the plain route and on the K7
route (``fused_gp.takes_kernel`` patched to send the CPU batch there, K7's
plain version, one call per Adam step, its gradient by GPML eq. 5.9 where
JAX's is ``jax.grad``: 1e-8).  A whole search at max_depth 2 takes the same
moves with the same optima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import search as jsearch
from gogp_tpu import kernels as jk
from gogp_torch import kernels as tk
from gogp_torch import search
from gogp_torch.gp import core
from gogp_torch.ops import fused_gp
from test_torch_pathwise import JaxPathDraws

TOL = dict(rtol=1e-9, atol=1e-12)


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 8.0, size=(n, 1)), axis=0)
    y = 0.6 * x[:, 0] + 1.5 * np.sin(2.0 * np.pi * x[:, 0] / 1.7) + 0.1 * rng.normal(size=n)
    return x, (y - y.mean()) / y.std()


def _t(a):
    return torch.tensor(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want),
                               **tol, err_msg=msg)


KERNELS = {
    "periodic": (jk.periodic.scaled(), tk.periodic.scaled()),
    "rbf*linear": (jk.rbf.scaled() * jk.linear.scaled(), tk.rbf.scaled() * tk.linear.scaled()),
}


@pytest.mark.parametrize("route", ["plain", "k7"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_fit_candidate_matches_jax(name, route, monkeypatch):
    jkern, tkern = KERNELS[name]
    x, y = _data(24)
    jv, jlml, _ = jsearch._fit_candidate(jkern, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(3), 4, 60, 0.05)
    launches = []
    if route == "k7":
        real = fused_gp.fused_gp_linv
        monkeypatch.setattr(fused_gp, "takes_kernel", lambda K: True)
        monkeypatch.setattr(fused_gp, "fused_gp_linv", lambda K: launches.append(K.shape) or real(K))
    v, lml, gp = search._fit_candidate(tkern, _t(x), _t(y), JaxPathDraws(3), 4, 60, 0.05)
    tol = TOL if route == "plain" else dict(rtol=1e-8, atol=1e-10)
    _close(v, jv, tol)
    _close(lml, jlml, tol)
    assert gp.n_theta == tkern.n_theta + 1
    if route == "k7":
        assert launches and all(s == (4, 24, 24) for s in launches)


@pytest.mark.parametrize("kind", ["bic", "aic", "loo"])
def test_score_matches_jax(kind):
    x, y = _data(24)
    v = np.array([0.2, -0.1, 0.3, -1.5])
    jgp = jsearch.core.GP(ndim=1, simil=jk.periodic.scaled(), noise=jk.uniform_noise)
    tgp = core.GP(ndim=1, simil=tk.periodic.scaled(), noise=tk.uniform_noise)
    want = jsearch._score(kind, jgp, jnp.asarray(v), -12.5, jnp.asarray(x), jnp.asarray(y))
    _close(search._score(kind, tgp, _t(v), -12.5, _t(x), _t(y)), want)
    with pytest.raises(ValueError, match="unknown score"):
        search._score("waic", tgp, _t(v), -12.5, _t(x), _t(y))


def test_search_matches_jax():
    """bases rbf and periodic, max_depth 2, restarts 4, iters 100: the same
    accepted moves, each with JAX's optimum, LML and score."""
    x, y = _data(40)
    kw = dict(bases=("rbf", "periodic"), max_depth=2, restarts=4, iters=100)
    want = jsearch.search(x, y, key=jax.random.PRNGKey(1), **kw)
    got = search.search(_t(x), _t(y), key=JaxPathDraws(jax.random.PRNGKey(1)), **kw)
    assert [c.name for c in got.history] == [c.name for c in want.history]
    assert got.name == want.name and "periodic" in got.name
    for g, w in zip(got.history, want.history):
        _close(g.v_opt, w.v_opt, msg=g.name)
        _close(g.lml, w.lml, msg=g.name)
        _close(g.score, w.score, msg=g.name)
    _close(got.y_mean, want.y_mean)
    _close(got.y_std, want.y_std)
    gp = core.GP(ndim=1, simil=got.kernel, noise=tk.uniform_noise)
    assert gp.n_theta == got.v_opt.shape[0]


def test_search_defaults_and_exports():
    assert set(search.__all__) == set(jsearch.__all__)
    assert set(search.BASE_KERNELS) == set(jsearch.BASE_KERNELS)
    assert all(search.BASE_KERNELS[k].name == jsearch.BASE_KERNELS[k].name for k in search.BASE_KERNELS)
    x, y = _data(16)
    res = search.search(x, y, bases=("rbf",), max_depth=1, restarts=2, iters=5, device="cpu")
    assert res.v_opt.dtype == torch.float64 and res.v_opt.device.type == "cpu" and res.name == "rbf"
    # NaN data: every restart stops at its first step with the optimizer's
    # initial value 0, as in JAX (whose search reports LML -0.0 there)
    nan = search.search(x, np.full(16, np.nan), bases=("rbf",), max_depth=1, restarts=2, iters=2, normalize_y=False,
                        device="cpu")
    assert nan.lml == 0.0
