"""The port's graft entry (gogp_torch.graft_entry) against the JAX package's
root ``__graft_entry__.py``, in float64 on the CPU.

``entry``'s value and gradient against ``jax.jit`` of the twin's ``fn``.
Each explicit SPMD form of the twin's GSPMD steps runs on a (2, 2) mesh of
four gloo ranks (one pool for the file, ``torch_dist_pool``) against the
twin's own statements (``__graft_entry__.py``'s lines, copied here) jitted
with the same shardings on ``make_mesh(2, 2)`` over the conftest's virtual
CPU devices, with the twin's draws handed in: values to 1e-9 and gradients
to 1e-8 (relative), SKI's to 1e-7 (CG's tolerance, PR 15's).  The whole dry
run runs on 4 ranks (2 x 2) and on ranks 0-2 (3 x 1), each output finite,
with the twin's shapes (recorded from its ``dryrun_multichip(4)`` and
``(3)``), in its order.  The twin's own dry run takes 83 s on the CPU, so
this file replays its steps one at a time.
"""

import ast
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_pool import RankPool

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import __graft_entry__ as jge  # noqa: E402
from gogp_tpu.gp import laplace as jlaplace  # noqa: E402
from gogp_tpu.gp import pathwise as jpathwise  # noqa: E402
from gogp_tpu.gp import sparse as jsparse  # noqa: E402
from gogp_tpu.gp.core import GP as JGP, absorb as jabsorb  # noqa: E402
from gogp_tpu.gp.likelihoods import bernoulli_logit as jbern  # noqa: E402
from gogp_tpu.gp.streaming import absorb_append as jappend  # noqa: E402
from gogp_tpu.gp import ski as jski  # noqa: E402
from gogp_tpu.infer import mle as jmle  # noqa: E402
from gogp_tpu.infer.advi import run_advi_fullrank as jadvi  # noqa: E402
from gogp_tpu.kernels import matern52_ref, periodic, uniform_noise  # noqa: E402
from gogp_tpu.models.params import gp_observe as jgp_observe  # noqa: E402
from gogp_tpu.parallel import mesh as jpmesh  # noqa: E402

from gogp_torch import graft_entry as ge  # noqa: E402

VALUE = dict(rtol=1e-9, atol=1e-12)
GRAD = dict(rtol=1e-8, atol=1e-11)
SKI = dict(rtol=1e-7, atol=1e-10)
# entry in float32: its error against the twin's float64 value and gradient
# (relative to the largest entry) at most this many times the twin's own
# float32 error (measured: the port's 1.09e-5 / 1.29e-4, the twin's 9.8e-6 /
# 1.19e-4)
F32_RATIO = 2.0
# the SVGP step from a float32 state: 2 float32 roundoffs
F32_STATE = dict(rtol=2.4e-7, atol=1e-12)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return jpmesh.make_mesh(n_chain=2, n_data=2, devices=jax.devices()[:4])


def _flagship():
    gp, make_priors = jge._flagship()
    x, y = ge._series(16, 0, 0.1)
    priors = make_priors(x, y)
    xj, yj, maskj = jnp.asarray(x), jnp.asarray(y), jnp.ones(16)

    def logp(v):
        return jgp_observe(gp, v, x=xj, y=yj, mask=maskj) + priors(v, maskj)

    return gp, x, y, xj, yj, maskj, logp


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- entry ----------------------------------------------------------------------


def test_entry_matches_the_twin():
    """fn's value and gradient at the twin's example arguments, in float64
    and in float32; the arguments are the twin's, in float32."""
    jfn, jargs = jge.entry()
    fn, args = ge.entry("cpu")
    for a, b in zip(args, jargs):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jval, jgrad = jax.jit(jfn)(*(a.astype(jnp.float64) for a in jargs))
    val, grad = fn(*(a.double() for a in args))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), **VALUE)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD)
    jval32, jgrad32 = jax.jit(jfn)(*jargs)
    val32, grad32 = fn(*args)
    assert val32.dtype == torch.float32 and grad32.shape == (6,)
    assert _rel(val32, jval) <= F32_RATIO * _rel(jval32, jval)
    assert _rel(grad32, jgrad) <= F32_RATIO * _rel(jgrad32, jgrad)


def test_entry_and_dryrun_default_to_the_card():
    """No quiet CPU fallback: without a card both refuse."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ge.dryrun_multichip(1)


def test_imports_neither_jax_nor_the_jax_package():
    path = REPO / "gogp_torch" / "graft_entry.py"
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "gogp_tpu", "__graft_entry__")]


# --- the SPMD forms against the twin's statements on make_mesh(2, 2) -------------


def test_chain_adam_step(pool, jmesh):
    """__graft_entry__.py:92-111: C = 8 chains, one Adam step, the mean."""
    _, _, _, _, _, _, logp = _flagship()
    v0 = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (8, 6))
    chain_sh = NamedSharding(jmesh, P((jpmesh.CHAIN_AXIS, jpmesh.DATA_AXIS)))

    def chain_step(v_batch):
        def one(v):
            res = jmle.adam(jax.value_and_grad(logp), v, iters=1)
            return res.x, res.value

        v_new, vals = jax.vmap(one)(v_batch)
        return v_new, jnp.mean(vals)

    step = jax.jit(chain_step, in_shardings=(chain_sh,), out_shardings=(chain_sh, NamedSharding(jmesh, P())))
    jv, jmean = step(jax.device_put(v0, chain_sh))
    for v_new, mean in pool.run("graft_chain_adam", (2, 2), np.asarray(v0)):
        np.testing.assert_allclose(v_new, np.asarray(jv), **VALUE)
        np.testing.assert_allclose(mean, np.asarray(jmean), **VALUE)


def test_data_sharded_value_and_grad(pool, jmesh):
    """:113-126: gp_observe's value and gradient, rows over the data axis."""
    gp, _, _, xj, yj, maskj, _ = _flagship()
    data_sh = NamedSharding(jmesh, P(jpmesh.DATA_AXIS))

    def sharded_lml(v, xs, ys, ms):
        return jax.value_and_grad(lambda v: jgp_observe(gp, v, x=xs, y=ys, mask=ms))(v)

    jval, jgrad = jax.jit(sharded_lml)(jnp.zeros(gp.n_theta), *(jax.device_put(a, data_sh) for a in (xj, yj, maskj)))
    for val, grad in pool.run("graft_data_lml", (2, 2)):
        np.testing.assert_allclose(val, np.asarray(jval), **VALUE)
        np.testing.assert_allclose(grad, np.asarray(jgrad), **GRAD)


@pytest.mark.parametrize("state_dtype", ["float64", "float32"])
def test_svgp_step(pool, jmesh, state_dtype):
    """:328-365: the data-parallel SVGP minibatch step, n_sv = 16, from a
    float64 state and from the float32 one of the twin's dry run
    (svgp_init's default).  There the twin's kernels take Z's distances in
    float32, the port's in float64, so the ELBO, its float64 leaf and the
    float32 leaves are held at float32 rounding (F32_STATE)."""
    gp, _, _, _, _, _, _ = _flagship()
    n_sv = 16
    x, y = ge._series(n_sv, 4, 0.0)
    x_sv, y_sv = jnp.asarray(x), jnp.asarray(y)
    params_sv = jsparse.SVGPParams(jnp.zeros(gp.n_theta), jsparse.svgp_init(gp, x_sv[::2], getattr(jnp, state_dtype)))
    opt = optax.adam(1e-2)

    def svgp_step(params, opt_state, xb, yb):
        def elbo(p):
            theta = jnp.exp(p.log_theta)
            return jsparse.svgp_elbo(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil:], p.state, xb, yb,
                                     n_total=n_sv)

        value, grads = jax.value_and_grad(elbo)(params)
        neg = jax.tree.map(jnp.negative, grads)
        updates, opt_state = opt.update(neg, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    rows = NamedSharding(jmesh, P(jpmesh.DATA_AXIS))
    jparams, _, jelbo = jax.jit(svgp_step)(params_sv, opt.init(params_sv), jax.device_put(x_sv, rows),
                                           jax.device_put(y_sv, rows))
    want = [jparams.log_theta, *jparams.state, jelbo]
    tol = VALUE if state_dtype == "float64" else F32_STATE
    for got in pool.run("graft_svgp", (2, 2), n_sv, state_dtype):
        assert [g.dtype for g in got] == [np.asarray(w).dtype for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_laplace_rowsharded(pool, jmesh, shape):
    """:390-409: five Newton iterations with the rows of K and W over the
    data axis, against the twin's jitted step on (2, 2) and the port's
    replicated laplace_fit / laplace_lml, at n_data 1 and 2."""
    gp, _, y, xj, yj, _, _ = _flagship()
    yb = (yj > 0).astype(xj.dtype)
    rows = NamedSharding(jmesh, P(jpmesh.DATA_AXIS))

    def laplace_step(xs_, ys_):
        post = jlaplace.laplace_fit(gp, jbern, jnp.ones(gp.n_theta_simil), jnp.zeros(0), xs_, ys_,
                                    theta_noise=jnp.ones(gp.n_theta_noise), max_iters=5)
        lml = jlaplace.laplace_lml(gp, jbern, jnp.ones(gp.n_theta_simil), jnp.zeros(0), xs_, ys_,
                                   theta_noise=jnp.ones(gp.n_theta_noise), max_iters=5)
        return post.f_hat, lml

    jf, jlml = jax.jit(laplace_step)(jax.device_put(xj, rows), jax.device_put(yb, rows))
    for (f, lml), (f_rep, lml_rep) in pool.run("graft_laplace", shape, 5):
        np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
        np.testing.assert_allclose(lml, np.asarray(jlml), **VALUE)
        np.testing.assert_allclose(f, f_rep, **VALUE)
        np.testing.assert_allclose(lml, lml_rep, **VALUE)


def test_thompson_step(pool, jmesh):
    """:411-447: 8 paths drawn with the twin's key, the candidate rows over
    both axes, the argmax and the append (past the capacity, as the twin
    appends)."""
    _, _, _, xj, yj, _, _ = _flagship()
    gp_bo = JGP(ndim=1, simil=matern52_ref.scaled() + periodic, noise=uniform_noise)
    post_bo = jabsorb(gp_bo, jnp.ones(gp_bo.n_theta_simil), jnp.ones(gp_bo.n_theta_noise), xj, yj)
    ps_bo = jax.jit(lambda key: jpathwise.sample_paths(gp_bo, post_bo, key, 8, 64))(jax.random.PRNGKey(12))
    cand_sh = NamedSharding(jmesh, P((jpmesh.CHAIN_AXIS, jpmesh.DATA_AXIS)))
    z_cand = jax.device_put(jnp.linspace(0.0, 10.0, 32)[:, None], cand_sh)

    def thompson_step(ps, z):
        scores = jpathwise.eval_paths(gp_bo, ps, z)
        best = jnp.argmax(scores[0])
        return z[best], scores

    x_new, scores = jax.jit(thompson_step)(ps_bo, z_cand)
    post2 = jax.jit(lambda p, xn: jappend(gp_bo, p, xn[None, :], jnp.ones(1)))(post_bo, x_new)
    for got in pool.run("graft_thompson", (2, 2), np.asarray(jax.random.PRNGKey(12))):
        np.testing.assert_array_equal(got[0], np.asarray(x_new))
        for g, w in zip(got[1:], (scores, post2.chol, post2.alpha, post2.x)):
            np.testing.assert_allclose(g, np.asarray(w), **VALUE)


def test_ski_value_and_grad(pool, jmesh):
    """:449-473: lml_ski and its theta_simil gradient, rows over the data
    axis, the twin's probes."""
    gp, _, _, _, _, _, _ = _flagship()
    n_ski = 64
    x, y = ge._series(n_ski, 5, 0.0)
    rows = NamedSharding(jmesh, P(jpmesh.DATA_AXIS))

    def ski_lml_grad(ts, tn, xs_, ys_):
        return jax.value_and_grad(lambda t: jski.lml_ski(gp, t, tn, xs_, ys_, jax.random.PRNGKey(13), grid_size=16,
                                                         num_probes=2, cg_iters=8, lanczos_iters=4))(ts)

    jval, jgrad = jax.jit(ski_lml_grad)(jnp.ones(gp.n_theta_simil), jnp.ones(gp.n_theta_noise),
                                        jax.device_put(jnp.asarray(x), rows), jax.device_put(jnp.asarray(y), rows))
    for val, grad in pool.run("graft_ski", (2, 2), np.asarray(jax.random.PRNGKey(13)), n_ski):
        np.testing.assert_allclose(val, np.asarray(jval), **SKI)
        np.testing.assert_allclose(grad, np.asarray(jgrad), **SKI)


def test_advi_sharded(pool, jmesh):
    """:475-499: b = 8 full-rank ADVI fits over both axes, each with its own
    key's draws."""
    _, _, _, _, _, _, logp = _flagship()
    from test_torch_advi_smc import jax_eps

    b = 8
    v0 = 0.05 * jax.random.normal(jax.random.PRNGKey(14), (b, 6))
    keys = jax.random.split(jax.random.PRNGKey(15), b)
    chain_sh = NamedSharding(jmesh, P((jpmesh.CHAIN_AXIS, jpmesh.DATA_AXIS)))
    fit = jax.jit(jax.vmap(lambda v, k: jadvi(logp, v, k, num_steps=3, num_draws=2)),
                  in_shardings=(chain_sh, chain_sh))
    jmu = fit(jax.device_put(v0, chain_sh), jax.device_put(keys, chain_sh)).mu
    eps = [jax_eps(k, 3, 2, 6) for k in keys]
    for mu in pool.run("graft_advi", (2, 2), np.asarray(v0), eps):
        np.testing.assert_allclose(mu, np.asarray(jmu), **VALUE)


# --- the whole dry run ------------------------------------------------------------

# The twin's outputs' shapes, recorded by wrapping jax.block_until_ready
# around its dryrun_multichip(4) and (3) on the virtual CPU devices, in its
# order (the SVGP state is float32 there, svgp_init's default).
JAX_SHAPES = {
    4: [(8, 6), (), (), (6,), (8, 2, 6), (2, 8, 6), (2, 8, 6), (4, 8, 6), (8, 2, 16), (), (2, 8, 6), (2, 6),
        (2, 4, 6), (8, 6), (2, 4, 6), (2, 4, 6), (6,), (8, 1), (8,), (8, 8), (), (32,), (32,), (16,), (), (8, 32),
        (16, 16), (), (5,), (8, 6)],
    3: [(6, 6), (), (), (6,), (6, 2, 6), (2, 6, 6), (2, 6, 6), (4, 6, 6), (6, 2, 16), (2, 6, 6), (2, 6),
        (2, 4, 6), (12, 6), (2, 6, 6), (2, 6, 6), (6,), (4, 1), (4,), (4, 4), (), (24,), (24,), (16,), (), (6, 24),
        (16, 16), (), (5,), (6, 6)],
}
FLOAT32_OUTPUTS = ("z", "q_mu", "q_sqrt")


@pytest.mark.parametrize("n_devices", [4, 3])
def test_chip_smoke_knows_the_twins_shapes(n_devices):
    """The shapes chip_smoke's graft phase holds the card's runs to."""
    import chip_smoke

    assert chip_smoke.graft_shapes(n_devices) == JAX_SHAPES[n_devices]


# The deterministic steps that chip_smoke holds on four ranks against rank 0
# alone (the same draws' seeds on both).
HELD = ("data_lml", "sharded_lml", "svgp", "serve", "mixture", "laplace", "thompson", "ski")


@pytest.mark.parametrize("n_devices", [4, 3])
def test_dryrun_multichip(pool, n_devices):
    """Every step on 2 x 2, or on ranks 0-2 as 3 x 1 with rank 3 idle:
    finite outputs, the twin's shapes, its order, the same on every rank;
    on 2 x 2 the deterministic steps also on rank 0 alone (a 1x1 mesh,
    ``only`` those steps), equal to the four ranks' (SKI to CG's 1e-7)."""
    got = pool.run("graft_dryrun", n_devices, HELD if n_devices == 4 else ())
    assert got[3] is None if n_devices == 3 else got[3] is not None
    names, outs, ref = got[0]
    assert [n for n, _ in names] == [n for n, _ in ge.steps_for(n_devices)]
    assert [k for _, k in names] == [len(o) for _, o in ge.steps_for(n_devices)]
    labels = [o for _, outs_ in ge.steps_for(n_devices) for o in outs_]
    assert [tuple(np.shape(o)) for o in outs] == JAX_SHAPES[n_devices]
    for label, o in zip(labels, outs):
        assert np.isfinite(o).all(), label
        assert o.dtype == (np.float32 if label in FLOAT32_OUTPUTS else np.float64), label
    for other in got[1:n_devices]:
        assert other[0] == names
        for a, b in zip(other[1], outs):
            np.testing.assert_array_equal(a, b)
    if n_devices == 3:
        return
    held = [(name, o) for (name, _), o in zip([(n, o) for n, outs_ in ge.steps_for(4) for o in outs_], outs)
            if name in HELD]
    assert len(ref) == len(held)
    for (name, o), r in zip(held, ref):
        np.testing.assert_allclose(r, o, **(SKI if name == "ski" else VALUE), err_msg=name)


def test_dryrun_needs_the_devices(pool):
    """A mesh larger than the world raises the twin's ValueError on every
    rank."""
    assert pool.run("graft_dryrun_error", 5) == ["mesh 5x1 needs 5 devices, have 4"] * 4


# The twin's draws reach these steps through the dry run's hook (the
# samplers' key streams are not replayed there).
TWIN_DRAWN = HELD + ("chain_adam", "advi")


@pytest.mark.slow
def test_dryrun_matches_the_twins_own(pool):
    """The port's dry run on 2 x 2 with the twin's draws against the twin's
    own dryrun_multichip(4), recorded by wrapping jax.block_until_ready (the
    twin's run alone takes about 80 s): every deterministic step."""
    recorded = []
    real = jax.block_until_ready

    def record(x):
        recorded.append([np.asarray(leaf) for leaf in jax.tree.leaves(x)])
        return real(x)

    jax.block_until_ready = record
    try:
        jge.dryrun_multichip(4)
    finally:
        jax.block_until_ready = real
    want = [o for step in recorded for o in step]
    got = pool.run("graft_dryrun_twin_draws", 4)[0]
    labels = [(name, o) for name, outs in ge.steps_for(4) for o in outs]
    assert len(got) == len(want) == len(labels)
    for (name, label), g, w in zip(labels, got, want):
        if name in TWIN_DRAWN:
            tol = SKI if name == "ski" else F32_STATE if name == "svgp" else VALUE
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{name} {label}")
