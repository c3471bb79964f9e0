"""The rolling-forecast driver (gogp_torch.tutorial.evaluate), its five
studies, the batched optimizers (mle.adam_batched, mle.lbfgs_batched) and the
per-row-mask K7 route (ops.fused_gp) against the JAX package, in float64 on
the CPU.

The jitter draws are JAX's own (``jax.random.normal(PRNGKey(seed), (n,
n_theta))``, gogp_tpu/tutorial/evaluate.py:145), handed to the port through
``evaluate(draws=...)``.  Tolerances: Adam row for row against JAX's
``evaluate``, LML rtol 1e-9, mu, sigma and the parameters rtol 1e-8, on the
first 12 points of each study's data (JAX's batched compile stays short);
the per-row-mask value and gradient rtol 1e-9 (values) and 1e-8 of the
largest entry (gradients).  LBFGS is optax's algorithm on both sides, but
for a failed line search, where the port takes no step; it is held to
the committed fixtures (tests/fixtures/forecast_*.csv, JAX's run at lbfgs,
iters 200, seed 0) by LML.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu.gp.core import GP as JGP
from gogp_tpu.infer import mle as jmle
from gogp_tpu.kernels import matern32 as j_matern32
from gogp_tpu.kernels import uniform_noise as j_uniform
from gogp_tpu.models.params import gp_observe as j_gp_observe
from gogp_tpu.ops import fused_gp as jfused
from gogp_tpu.tutorial import anynoise as jan
from gogp_tpu.tutorial import barebones as jbb
from gogp_tpu.tutorial import evaluate as jev
from gogp_tpu.tutorial import events as jevents
from gogp_tpu.tutorial import hyperpriors as jhp
from gogp_tpu.tutorial import warpedtime as jwt
from gogp_torch import GP, matern32, mle, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import fused_gp
from gogp_torch.tutorial import anynoise, barebones, events, hyperpriors, selfcheck, warpedtime
from gogp_torch.tutorial import evaluate as tev
from gogp_torch.tutorial import io as tio

EVENTS = "1.0:1.0:0.5,4.2:6.7:0.25"
STUDIES = {
    # name: (JAX study, port study, port module)
    "barebones": (jbb.make_study, barebones.make_study, barebones),
    "hyperpriors": (jhp.make_study, hyperpriors.make_study, hyperpriors),
    "warpedtime": (jwt.make_study, warpedtime.make_study, warpedtime),
    "anynoise": (jan.make_study, anynoise.make_study, anynoise),
    "events": (lambda: jevents.make_study(jevents.parse_events(EVENTS)),
               lambda: events.make_study(events.parse_events(EVENTS)), events),
}
THETA_ONLY = ("barebones", "hyperpriors", "events")
LML = dict(rtol=1e-9, atol=1e-12)
REST = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many small batched factorizations, which a pool
    of threads slows down on a loaded CPU.  Restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_draws(n, n_theta, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, n_theta), dtype=jnp.float64))


def study_data(name, rows=None):
    x, y = tio.load_csv(STUDIES[name][2].selfcheck_data())
    return (x, y) if rows is None else (x[:rows], y[:rows])


def assert_rows_match(got, want):
    """Forecast rows: x and y exact, the two log-densities at LML, the rest
    (mu, sigma, thetas) at REST."""
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], **LML)
    np.testing.assert_allclose(got[:, [2, 3, *range(6, got.shape[1])]], want[:, [2, 3, *range(6, want.shape[1])]],
                               **REST)


# -- the batched optimizers, row for row -----------------------------------------

TARGETS = np.array([[1.0, -2.0, 0.5], [0.3, 0.1, -0.7], [2.0, 1.0, 1.0], [-1.0, 0.5, 0.0], [0.5, 0.5, 0.5]])
WEIGHTS = np.array([1.0, 10.0, 0.1])


def _quadratic_rows(X):
    """(value, gradient) of -sum w (x - target_row)^2 for each row, NaN where
    row 3 passes x[0] < -0.3 on its way to its target: by hand, so one row alone and the same row in
    the batch take the same arithmetic."""
    T = torch.as_tensor(TARGETS[: X.shape[0]], dtype=X.dtype)
    w = torch.as_tensor(WEIGHTS, dtype=X.dtype)
    diff = X - T
    val = -(w * diff * diff).sum(-1)
    grad = -2.0 * w * diff
    if X.shape[0] > 3:
        nan = (torch.arange(X.shape[0]) == 3) & (X[:, 0] < -0.3)
        val, grad = torch.where(nan, float("nan"), val), torch.where(nan[:, None], 0.0, grad)
    return val, grad


def _row(i):
    """Row i of ``_quadratic_rows`` as a problem of its own."""

    def vg(v):
        X = torch.zeros((len(TARGETS), v.shape[0]), dtype=v.dtype)
        X[i] = v
        val, grad = _quadratic_rows(X)
        return val[i], grad[i]

    return vg


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_adam_batched_matches_adam_row_by_row(threshold):
    """Rows stop at their own thresholds (and row 3 at its NaN): each row of
    the batch equals ``mle.adam`` on that row alone, x and moments frozen
    once it stops."""
    X0 = torch.zeros((5, 3), dtype=torch.float64)
    got = mle.adam_batched(_quadratic_rows, X0, iters=300, rate=0.05, threshold=threshold)
    for i in range(5):
        want = mle.adam(_row(i), X0[i], iters=300, rate=0.05, threshold=threshold)
        np.testing.assert_array_equal(got.x[i].numpy(), want.x.numpy())
        assert float(got.value[i]) == float(want.value)
        assert (int(got.iters[i]), bool(got.converged[i]), bool(got.stalled[i])) == (
            want.iters, want.converged, want.stalled)
    assert bool(got.stalled[3]) and (len(set(got.iters.tolist())) > 1 or not threshold)


def test_lbfgs_batched_matches_lbfgs_row_by_row():
    """Rows of different curvature and targets, one pinned coordinate per row
    and row 3's NaN region: each row of the batch follows ``mle.lbfgs`` on
    that row alone (the same iterations, x to rtol 1e-12)."""
    X0 = torch.tensor(np.random.default_rng(0).normal(size=(5, 3)))
    X0[3, 0] = 0.0  # row 3 starts outside its NaN region
    free = torch.ones((5, 3), dtype=torch.float64)
    free[[0, 2], [1, 2]] = 0.0
    got = mle.lbfgs_batched(_quadratic_rows, X0, iters=100, free=free)
    for i in range(5):
        want = mle.lbfgs(lambda v: _row(i)(v)[0], X0[i], iters=100, free=free[i])
        np.testing.assert_allclose(got.x[i].numpy(), want.x.numpy(), rtol=1e-12, atol=1e-14)
        assert (int(got.iters[i]), bool(got.converged[i]), bool(got.stalled[i])) == (
            want.iters, want.converged, want.stalled)
    assert got.x[0, 1] == X0[0, 1] and got.x[2, 2] == X0[2, 2]
    assert len(set(got.iters.tolist())) > 1


def _prefix_problem(n=40):
    """bench.py's generator at n points, y normalised, the barebones GP on
    both sides, masks of six prefixes and jittered starts."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (n, 1)), axis=0)
    y, _, _ = tio.normalize(np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n))
    ends = np.array([3, 5, 13, 21, 29, 40])
    masks = (np.arange(n)[None, :] < ends[:, None]).astype(float)
    V0 = 0.3 * np.random.default_rng(1).normal(size=(len(ends), 3))
    jgp = JGP(ndim=1, simil=j_matern32.scaled(), noise=j_uniform.scaled_by(0.01))
    tgp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))
    return x, y, masks, V0, jgp, tgp


def test_lbfgs_batched_matches_jax_vmap_on_prefixes():
    """Six prefix fits of a GP, each under its own mask, on the K7 route's
    value and gradient (per-row masks): the same iterations and optimum as
    ``jax.vmap(mle.lbfgs)``, the JAX twin's batched fit (x to 1e-6, LML
    rtol 1e-9)."""
    x, y, masks, V0, jgp, tgp = _prefix_problem()

    def jfit(v0, mask):
        return jmle.lbfgs(lambda v: j_gp_observe(jgp, v, x=x, y=y, mask=mask), v0, iters=200)

    want = jax.jit(jax.vmap(jfit))(jnp.asarray(V0), jnp.asarray(masks))
    vg = fused_gp.make_fused_value_and_grad(tgp, torch.tensor(x), torch.tensor(y), torch.tensor(masks))
    got = mle.lbfgs_batched(vg, torch.tensor(V0), iters=200)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert got.converged.all() and np.asarray(want.converged).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-9)


# -- the per-row-mask value and gradient -------------------------------------------


@pytest.mark.parametrize("name", THETA_ONLY)
def test_per_row_mask_vg_matches_jax_reference(name):
    """One mask per row, the empty and the full prefix among them: the K7
    route and the reference route against JAX's
    ``make_reference_value_and_grad`` called row by row with each row's
    mask."""
    jmake, tmake, _ = STUDIES[name]
    jstudy, tstudy = jmake(), tmake()
    x, y = study_data(name)
    y = tio.normalize(y)[0]
    n, p = x.shape[0], tstudy.gp.n_theta
    ends = np.array([0, 1, 5, n // 2, n - 1, n])
    masks = (np.arange(n)[None, :] < ends[:, None]).astype(float)
    V = 0.3 * np.random.default_rng(2).normal(size=(len(ends), p))
    jpriors = jstudy.make_priors(x, y) if jstudy.make_priors else None
    tpriors = tstudy.make_priors(x, y) if tstudy.make_priors else None
    want_v, want_g = [], []
    for v, mask in zip(V, masks):
        jm = jnp.asarray(mask)
        vg = jfused.make_reference_value_and_grad(
            jstudy.gp, x, y, mask=jm, priors_fn=None if jpriors is None else (lambda v, jm=jm: jpriors(v, jm)))
        val, grad = jax.jit(vg)(jnp.asarray(v))
        want_v.append(float(val))
        want_g.append(np.asarray(grad))
    want_v, want_g = np.array(want_v), np.array(want_g)
    tm = torch.tensor(masks)
    pri = None if tpriors is None else (lambda Vt: tpriors(Vt, tm))
    for make in (fused_gp.make_fused_value_and_grad, fused_gp.make_reference_value_and_grad):
        val, grad = make(tstudy.gp, torch.tensor(x), torch.tensor(y), tm, pri)(torch.tensor(V))
        np.testing.assert_allclose(val.numpy(), want_v, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(grad.numpy(), want_g, rtol=0, atol=1e-8 * np.abs(want_g).max())
    if tpriors is None:
        assert val[0] == 0.0 and (grad[0] == 0.0).all()  # the empty prefix
    with pytest.raises(ValueError, match="per-row masks"):
        fused_gp.make_fused_value_and_grad(tstudy.gp, torch.tensor(x), torch.tensor(y), tm)(torch.tensor(V[:2]))


# -- evaluate against JAX's ------------------------------------------------------

_JAX_ADAM = {}


def _jax_adam(name):
    """JAX's batched ``evaluate`` with Adam on the study's first 12 points."""
    if name not in _JAX_ADAM:
        x, y = study_data(name, 12)
        _JAX_ADAM[name] = jev.evaluate(STUDIES[name][0](), x, y, config=jev.EvalConfig(alg="adam", iters=60, seed=0))
    return _JAX_ADAM[name]


CASES = [(name, mode) for name in STUDIES for mode in ("batched", "sequential")] + [
    (name, "k7 route") for name in THETA_ONLY]


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m.split()[0]}" for n, m in CASES])
def test_adam_matches_jax_evaluate(name, mode, monkeypatch):
    """``evaluate(alg="adam")`` row for row against JAX's: batched (the
    plain route on the CPU), sequential, and, for the theta-only studies,
    batched on the K7 route with its per-row masks (K7's plain version on
    the CPU)."""
    want = _jax_adam(name)
    x, y = study_data(name, 12)
    study = STUDIES[name][1]()
    if mode == "k7 route":
        monkeypatch.setattr(tev, "takes_k7", lambda study, x: True)
    cfg = tev.EvalConfig(alg="adam", iters=60, seed=0, batched=mode != "sequential")
    got = tev.evaluate(study, x, y, config=cfg, device="cpu", draws=jax_draws(12, study.gp.n_theta))
    assert_rows_match(got.rows, want.rows)
    np.testing.assert_allclose(got.v_all, want.v_all, **REST)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert got.iters[0] == 0 and (got.iters[1:] == 60).all()


# Rows whose LBFGS optimum differs from the fixture's (|relative LML
# difference| > 1e-8), pinned at the count measured on this CPU.  anynoise's
# objective has a kink at every latent output equal to its observation (the
# Laplace noise's |y_obs - y|).  At a kink the zoom search often fails.  Where
# it found a point of sufficient decrease, both optax and the port step
# there; where it found none, optax steps to its last trial, even uphill, and
# JAX's fits wander to other optima, sometimes far higher, while the port
# takes no step, restarts its memory and stalls at a second such failure.  On
# rows 8, 5, 6 and 1 the port ends 38.0, 26.3, 19.1 and 1.6 below the
# fixture's LML (-75%, -90%, -75%, -108% of it), on the others within 0.4%
# (0.09 at most), never below the row's starting LML.  The other studies are
# smooth and keep the fixture's optimum on every row.
OTHER_OPTIMA = {"barebones": 0, "hyperpriors": 0, "warpedtime": 0, "anynoise": 16, "events": 0}
# the largest drop of such a row below the fixture's LML, relative (-1.0791
# measured on anynoise's row 1)
OTHER_OPTIMA_FLOOR = -1.1


@pytest.mark.parametrize("name", list(STUDIES))
def test_lbfgs_matches_fixture(name):
    """``evaluate(alg="lbfgs", iters=200, seed 0)`` batched, against the
    committed forecast fixture: the initial log-density (the jitter's
    plumbing) to 1e-8; each row's final LML no lower than the fixture's by
    more than 1e-6 relative, except on rows at another optimum, whose count
    is pinned (``OTHER_OPTIMA``) and whose drop is bounded
    (``OTHER_OPTIMA_FLOOR``); no row's LML below its starting one; mu and
    sigma within 1e-5 on rows whose LML agrees to 1e-8 and which stopped at
    the gradient threshold, 1e-4 on those that ran to the iteration cap
    (they stop anywhere along a flat valley)."""
    want = np.loadtxt(f"tests/fixtures/forecast_{name}.csv", delimiter=",")
    x, y = study_data(name)
    study = STUDIES[name][1]()
    cfg = tev.EvalConfig(alg="lbfgs", iters=200, seed=0)
    res = tev.evaluate(study, x, y, config=cfg, device="cpu", draws=jax_draws(x.shape[0], study.gp.n_theta))
    got = np.asarray(res.rows, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-9)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-8, atol=1e-9)
    rel = (got[:, 5] - want[:, 5]) / np.maximum(np.abs(want[:, 5]), 1e-12)
    other = np.abs(rel) > 1e-8
    assert other.sum() == OTHER_OPTIMA[name], (name, np.flatnonzero(other), rel[other])
    assert (rel[other] >= OTHER_OPTIMA_FLOOR).all(), rel[other]
    assert (got[:, 5] >= got[:, 4]).all(), got[:, 5] - got[:, 4]  # never below the start
    capped = res.iters >= cfg.iters
    for rows, atol in ((~other & ~capped, 1e-5), (~other & capped, 1e-4)):
        np.testing.assert_allclose(got[rows][:, 2:4], want[rows][:, 2:4], rtol=0, atol=atol)


def test_lbfgs_follows_jax_on_anynoise():
    """Until their first failed line search (row 1's seventh step), the
    anynoise fits follow JAX's: every fitted row of the study after 6
    iterations of LBFGS, batched in the port and ``jax.vmap`` in JAX, x to
    1e-9.  Beyond it they part (OTHER_OPTIMA)."""
    x, y = study_data("anynoise")
    yn = tio.normalize(y)[0]
    n = x.shape[0]
    jstudy, tstudy = jan.make_study(), anynoise.make_study()
    V0 = np.concatenate([0.1 * jax_draws(n, 3), np.broadcast_to(np.concatenate([x[:, 0], yn]), (n, 2 * n))], 1)[1:]
    masks = (np.arange(n)[None, :] < np.arange(1, n)[:, None]).astype(float)
    frees = np.stack([tev._padding_free(tstudy, 3, n, 1, e) for e in range(1, n)])
    jpriors, tpriors = jstudy.make_priors(x, yn), tstudy.make_priors(x, yn)

    def jfit(v0, mask, free):
        return jmle.lbfgs(lambda v: j_gp_observe(jstudy.gp, v, mask=mask) + jpriors(v, mask), v0, iters=6, free=free)

    want = jax.jit(jax.vmap(jfit))(jnp.asarray(V0), jnp.asarray(masks), jnp.asarray(frees))
    vg = tev.batched_value_and_grad(tstudy, torch.tensor(x), torch.tensor(yn), torch.tensor(masks), tpriors)
    got = mle.lbfgs_batched(vg, torch.tensor(V0), iters=6, free=torch.tensor(frees))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def _nan_once_moved(where, starts):
    """A barebones study's priors: NaN wherever the first theta is none of
    the fits' starting values, so every LBFGS trial is outside the domain
    and each fit stalls at once."""

    def make_priors(x0, y0):
        def priors(v, mask):
            return where((v[..., :1] != starts).all(-1))

        return priors

    return make_priors


def test_stall_report_matches_jax(capsys):
    """The MINITERS report (tutorial.go:144-155): each fit that stalls
    before min_iters is logged with its iterations, in JAX's words."""
    x, y = study_data("barebones", 6)
    starts = 0.1 * jax_draws(6, 3)[:, 0]
    jstudy = jev.Study("nan", jbb.make_study().gp,
                       make_priors=_nan_once_moved(lambda m: jnp.where(m, jnp.nan, 0.0), jnp.asarray(starts)))
    tstudy = tev.Study("nan", barebones.make_study().gp,
                       make_priors=_nan_once_moved(lambda m: torch.where(m, float("nan"), 0.0), torch.tensor(starts)))
    cfg = dict(alg="lbfgs", iters=50)
    jev.evaluate(jstudy, x, y, config=jev.EvalConfig(**cfg))
    want = [line for line in capsys.readouterr().err.splitlines() if "stuck" in line]
    for batched in (True, False):
        res = tev.evaluate(tstudy, x, y, config=tev.EvalConfig(batched=batched, **cfg), device="cpu",
                           draws=jax_draws(6, 3))
        got = [line for line in capsys.readouterr().err.splitlines() if "stuck" in line]
        # JAX stops at its first failed search; the port restarts its memory
        # once and stops at the second
        assert want == [f"{e}: optimization stuck after 1 iterations (< 10)" for e in range(1, 6)]
        assert got == [f"{e}: optimization stuck after 2 iterations (< 10)" for e in range(1, 6)]
        assert res.stalled[1:].all() and (res.iters[1:] == 2).all()


def _sine(n=8):
    x = np.linspace(0, 3, n)
    return x.reshape(-1, 1), np.sin(x) + 0.05 * np.cos(9 * x)


@pytest.mark.parametrize("option", ["out_of_sample", "no_normalize"])
def test_options_match_jax(option):
    """``-o`` (the whole-horizon rows from the last fit, out_of_sample_rows)
    and ``-n`` (outputs as they are) against JAX's, on tests/test_evaluate.py's
    sine, Adam 40 steps, seed 3."""
    x, y = _sine()
    cfg = dict(iters=40, seed=3, alg="adam", **({"out_of_sample": True} if option == "out_of_sample"
                                                 else {"normalize": False}))
    want = jev.evaluate(jbb.make_study(), x, y, config=jev.EvalConfig(**cfg))
    got = tev.evaluate(barebones.make_study(), x, y, config=tev.EvalConfig(**cfg), device="cpu",
                       draws=jax_draws(8, 3, seed=3))
    assert (got.mean_y, got.std_y) == (want.mean_y, want.std_y)
    assert_rows_match(got.rows[:8], want.rows[:8])
    if option == "out_of_sample":
        assert len(got.rows) == 8 + 7
        np.testing.assert_allclose(np.asarray(got.rows[8:]), np.asarray(want.rows[8:]), rtol=1e-8, equal_nan=True)
        np.testing.assert_array_equal(np.asarray(tev.out_of_sample_rows(barebones.make_study(), got)),
                                      np.asarray(got.rows[8:]))
    else:
        assert (got.mean_y, got.std_y) == (0.0, 1.0)


def test_events_kernel_matches_jax():
    k, jk = events.events_kernel(events.parse_events("1.:2.5:0.3,3:6:0.5")), jevents.events_kernel(
        jevents.parse_events("1.:2.5:0.3,3:6:0.5"))
    x = np.linspace(0, 7, 15)[:, None]
    th = np.array([0.9, 1.1])
    np.testing.assert_allclose(k.matrix(torch.tensor(th), torch.tensor(x), torch.tensor(x)).numpy(),
                               np.asarray(jk.matrix(jnp.asarray(th), x, x)), rtol=1e-14)
    assert events.parse_events("") == [] and events.parse_events("1:2:0.5") == [(1.0, 2.0, 0.5)]
    with pytest.raises(ValueError):
        events.parse_events("1:2")


# -- the command lines -------------------------------------------------------------


@pytest.mark.parametrize("name", list(STUDIES))
def test_main_selfcheck_on_cpu(name, capsys):
    """``main(["--platform", "cpu", "selfcheck"])`` prints one row per data
    point in the reference's schema: x, y, mu, sigma, lml0, lml, the
    thetas (Adam, 20 steps, to keep it short)."""
    mod = STUDIES[name][2]
    argv = ["--platform", "cpu", "-a", "adam", "--iters", "20", "selfcheck"]
    if name == "events":
        argv = ["--events", EVENTS, *argv]
    _, _, study, result = mod.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    rows = np.array([[float(v) for v in line.split(",")] for line in lines])
    assert rows.shape == (result.x.shape[0], 1 + 5 + study.gp.n_theta)
    assert np.isfinite(rows[:, 1:6]).all() and (rows[:, 3] >= 0).all()
    np.testing.assert_allclose(rows[:, 2], np.asarray(result.rows)[:, 2], atol=1e-6)


def test_command_line_needs_cuda_or_cpu(monkeypatch):
    """Without a CUDA device the default platform exits with a message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --platform cpu"):
        barebones.main(["selfcheck"])


def test_warpedtime_show_warp_on_cpu(capsys):
    """``--show-warp`` re-emits the rows at the warped inputs: the first
    n - 1 rows carry the warped x, the last row is the plain one."""
    _, _, study, result = warpedtime.main(["--platform", "cpu", "-a", "adam", "--iters", "20", "--show-warp",
                                           "selfcheck"])
    rows = np.array([[float(v) for v in line.split(",")] for line in capsys.readouterr().out.strip().splitlines()])
    n = result.x.shape[0]
    assert rows.shape == (n, 9)
    np.testing.assert_allclose(rows[:-1, 0], result.v_all[-1, 3 : 3 + n - 1], atol=1e-6)
    np.testing.assert_allclose(rows[-1], np.asarray(result.rows[-1]), atol=1e-6)


def test_selfcheck_runner_on_cpu(capsys):
    """The port's ``make selfcheck``: every study, the five forecasts and
    classify, a ``# <study>`` line before its rows."""
    assert selfcheck.main(["--platform", "cpu", "-a", "adam", "--iters", "10"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line for line in out if line.startswith("#")] == [f"# {name}" for name, _ in selfcheck.RUNS] + [
        "# classify"]
    assert len(out) == 6 + 20 + 44 + 43 + 20 + 43 + 40


def test_cpu_run_launches_no_kernel():
    """On the CPU every route takes the plain versions: no K7 launch."""
    x, y = study_data("barebones", 8)
    cb.reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        tev.evaluate(barebones.make_study(), x, y, config=tev.EvalConfig(alg="adam", iters=5), device="cpu")
    assert all(v == 0 for v in cb.LAUNCHES.values())
