"""The port's large-n path against the JAX package, in float64 on the CPU.

- K4 (the triangular-grid TRSV, both directions) and K6 (the tile
  Cholesky): their plain versions against the Pallas kernels in interpret
  mode, as tests/test_pallas.py runs them (atol 1e-9 on the solves, 1e-10 on
  the factor).
- lml_core's rule between K3 and K4 (``cholesky_blocked.trsv_solvers``) and
  its measured gate (1024: K4 from there on).
- gp_observe's value and gradient through the K4 route (gate lowered) against
  JAX's gp_observe under ``jax.value_and_grad`` (rtol 1e-9 on the value, 1e-8
  on the gradient).  JAX on the CPU takes its XLA path here, so the
  comparison is of results, not of the route.
- The per-call precision: its mapping to TF32, the backward running at the
  forward's setting, and the NaN -> float32 rescue's wiring, mirroring
  tests/test_pallas.py's TestPrecisionRescue.  TF32 changes nothing on the
  CPU, so these check the wiring: values and gradients unchanged, a NaN
  fast path recomputed at "float32", the size gate and the escape hatches.

The CUDA kernels themselves are tested on the card by test_torch_cuda.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import GP as JGP
from gogp_tpu.kernels import rbf as j_rbf
from gogp_tpu.kernels import uniform_noise as j_uniform
from gogp_tpu.models.params import gp_observe as j_gp_observe
from gogp_tpu.ops import cholesky_pallas as cp
from gogp_tpu.ops import linalg as jlinalg
from gogp_torch import GP, make_gp_logp, masked_value_and_grad, rbf, uniform_noise
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

ATOL = 1e-10


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def T(a):
    return torch.tensor(np.asarray(a))


def spy(calls, name, fn):
    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    return wrapped


def boom(*args, **kwargs):
    raise AssertionError("this route must not be taken")


# -- K4 and K6: plain versions against the Pallas kernels ----------------------


@pytest.mark.parametrize("n,block", [(64, 16), (128, 32), (384, 128)])
def test_trsv2d_plain_matches_pallas(n, block):
    L = np.linalg.cholesky(spd(n, seed=40))
    y = np.random.default_rng(41).normal(size=n)
    with cp.force_interpret():
        invs = cp._tile_invs(jnp.asarray(L), block)
        want_z = np.asarray(cp.pallas_trsv2d_lower(jnp.asarray(L), jnp.asarray(y), invs, block))
        want_a = np.asarray(cp.pallas_trsv2d_lower_t(jnp.asarray(L), jnp.asarray(want_z), invs, block))
    z = cb.trsv2d_lower(T(L), T(y), T(invs), block)
    a = cb.trsv2d_lower_t(T(L), z, T(invs), block)
    np.testing.assert_allclose(z.numpy(), want_z, atol=1e-9)
    np.testing.assert_allclose(a.numpy(), want_a, atol=1e-9)


@pytest.mark.parametrize("b", [64, 128])
def test_cholesky_tile_plain_matches_pallas(b):
    A = spd(b, seed=7)
    with cp.force_interpret():
        want = np.asarray(cp.pallas_cholesky_tile(jnp.asarray(A)))
    cb.reset_launch_counts()
    got = cb.cholesky_tile(T(A))  # CPU tensor: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert cb.LAUNCHES["chol_tile"] == 0


# -- lml_core's rule between K3 and K4 ------------------------------------------


def test_trsv_solvers_k3_below_8192_k4_from_there(monkeypatch):
    """K3 below _TRSV2D_MIN_N, K4 at and above it.  The constant is the
    measured crossing on the H100: K4 beat K3 both ways at every n from
    1024 (the smallest the front door sends to the blocked path) to 65536,
    so the gate is 1024 and K3 keeps only the sizes below it.  With the gate
    at the JAX package's 8192 the rule splits the sizes on either side of
    it."""
    assert cb._TRSV2D_MIN_N == 1024
    k3, k4 = (cb.trsv_lower, cb.trsv_lower_t), (cb.trsv2d_lower, cb.trsv2d_lower_t)
    for n in (256, 512, 896):
        assert cb.trsv_solvers(n, 128) == k3, n
    for n in (1024, 4096, 8064, 8192, 16384, 60000):
        assert cb.trsv_solvers(n, 128) == k4, n
    monkeypatch.setattr(cb, "_TRSV2D_MIN_N", 8192)
    for n in (1024, 4096, 8064):
        assert cb.trsv_solvers(n, 128) == k3, n
    for n in (8192, 16384, 60000):
        assert cb.trsv_solvers(n, 128) == k4, n


def large_problem(n):
    """The large-n problem's generator (benchmarks/tpu_round2.py:76-81) at n
    points."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 400, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("v", [[0.0, 0.0, 0.0], [0.3, -0.2, -1.0]])
def test_gp_observe_through_k4_matches_jax(monkeypatch, v):
    """n = 512 under force_blocked(64) and the stepwise driver, the K4 gate
    lowered to 256: the value and gradient take K4 both ways and no K3."""
    x, y = large_problem(512)
    jgp = JGP(ndim=1, simil=j_rbf.scaled(), noise=j_uniform)
    want_v, want_g = jax.value_and_grad(lambda w: j_gp_observe(jgp, w, x=x, y=y))(jnp.asarray(v))
    taken = []
    monkeypatch.setattr(cb, "_TRSV2D_MIN_N", 256)
    monkeypatch.setattr(cb, "trsv_lower", boom)
    monkeypatch.setattr(cb, "trsv_lower_t", boom)
    monkeypatch.setattr(cb, "trsv2d_lower", spy(taken, "K4", cb.trsv2d_lower))
    monkeypatch.setattr(cb, "trsv2d_lower_t", spy(taken, "K4 transpose", cb.trsv2d_lower_t))
    tgp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    with cb.force_blocked(64), cb.no_fused_whole():
        got_v, got_g = masked_value_and_grad(make_gp_logp(tgp, x=T(x), y=T(y)))(T(v))
    assert taken == ["K4", "K4 transpose"]
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-9)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-8)


# -- precision: the mapping, and the backward at the forward's setting ----------


@pytest.mark.parametrize("precision,tf32", [
    ("tensorfloat32", True), ("bfloat16", True), ("default", True), ("fastest", True),
    ("float32", False), ("highest", False),
])
def test_precision_maps_to_tf32(precision, tf32):
    assert cb.uses_tf32(precision) is tf32


def test_precision_none_is_ambient_and_unknown_raises():
    assert torch.backends.cuda.matmul.allow_tf32 is False  # torch's default
    assert cb.uses_tf32(None) is False
    with cb._matmul_tf32(True):
        assert cb.uses_tf32(None) is True
    assert torch.backends.cuda.matmul.allow_tf32 is False  # restored
    with pytest.raises(ValueError, match="unknown precision"):
        cb.uses_tf32("bogus")


@pytest.mark.parametrize("op", ["lml_core", "cholesky"])
def test_backward_runs_at_the_forward_precision(monkeypatch, op):
    """The matmul setting the forward ran under is kept in ctx and set again
    around the backward, whatever the ambient setting is by then; None is
    resolved when the forward runs."""
    seen = []

    def recorder(stage, fn):
        def wrapped(*args, **kwargs):
            seen.append((stage, torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(cb, "blocked_cholesky_invs", recorder("forward", cb.blocked_cholesky_invs))
    bwd = "blocked_tril_inv" if op == "lml_core" else "blocked_trsm_lower_t"
    monkeypatch.setattr(cb, bwd, recorder("backward", getattr(cb, bwd)))
    K0, y = spd(128, seed=50), T(np.random.default_rng(51).normal(size=128))

    def loss(K, precision):
        return cb.lml_core(K, y, 32, precision) if op == "lml_core" else cb.cholesky(K, 32, precision).sum()

    for precision, ambient_fwd, tf32 in [("tensorfloat32", False, True), ("float32", True, False), (None, True, True)]:
        seen.clear()
        K = T(K0).requires_grad_(True)
        with cb._matmul_tf32(ambient_fwd):
            out = loss(K, precision)
        out.backward()  # ambient setting back to its default (off) here
        stages = {s for s, _ in seen}
        assert stages == {"forward", "backward"}, seen
        assert all(flag is tf32 for _, flag in seen), (precision, seen)
    assert torch.backends.cuda.matmul.allow_tf32 is False


# -- the NaN -> float32 rescue ---------------------------------------------------


def test_rescue_size_gate_and_precision():
    """Engaged in TF32 at n >= 8192, as the JAX gate; never at full f32,
    which leaves nothing to escalate into.  (The JAX package engages it at
    its one-pass bf16 default and not at "tensorfloat32", its three-pass
    product; here "tensorfloat32" is TF32 itself.)"""
    assert linalg._RESCUE and linalg._RESCUE_MIN_N == jlinalg._RESCUE_MIN_N == 8192
    assert not linalg._rescue_engaged(4096, "tensorfloat32")
    assert linalg._rescue_engaged(8192, "tensorfloat32")
    assert linalg._rescue_engaged(1 << 20, "default")
    assert not linalg._rescue_engaged(1 << 20)  # the default: ambient TF32 off
    with cb._matmul_tf32(True):
        assert linalg._rescue_engaged(1 << 20)
    with linalg.precision_rescue(min_n=0):
        assert linalg._rescue_engaged(128, "bfloat16")
    assert not linalg._rescue_engaged(4096, "tensorfloat32")


@pytest.fixture
def nan_fast_path(monkeypatch):
    """The forwards of the blocked Cholesky and LML core (inside their
    autograd Functions, where the rescue runs) patched to give NaN on their
    first call and the true result after; returns the precision, as the
    string ``cb.uses_tf32`` maps to the call's TF32 flag, of every call."""
    calls = []
    real = {"lml_core": cb._lml_forward, "cholesky": cb._chol_forward}
    names = {True: "tensorfloat32", False: "float32"}

    def patched(name):
        def fn(*args):
            first = all(c[0] != name for c in calls)
            calls.append((name, names[args[-1]]))
            out = real[name](*args)
            if not first:
                return out
            return (out[0] * float("nan"), *out[1:]) if name == "lml_core" else out * float("nan")

        return fn

    monkeypatch.setattr(cb, "_lml_forward", patched("lml_core"))
    monkeypatch.setattr(cb, "_chol_forward", patched("cholesky"))
    return calls


def test_rescue_recomputes_a_nan_fast_path_at_float32(nan_fast_path):
    K, y = spd(128, seed=30), np.random.default_rng(31).normal(size=128)
    with jlinalg.force_xla():
        want_v, want_g = jax.value_and_grad(lambda A: jlinalg.lml_core(A, jnp.asarray(y)))(jnp.asarray(K))
    Kt = T(K).requires_grad_(True)
    with linalg.precision_rescue(min_n=0), cb.force_blocked(32):
        got = linalg.lml_core(Kt, T(y), precision="tensorfloat32")
        got.backward()
        L = linalg.cholesky(T(K), precision="tensorfloat32")
    assert nan_fast_path == [("lml_core", "tensorfloat32"), ("lml_core", "float32"),
                             ("cholesky", "tensorfloat32"), ("cholesky", "float32")]
    np.testing.assert_allclose(float(got.detach()), float(want_v), rtol=1e-9)
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(want_g), atol=1e-8)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), atol=ATOL)


@pytest.mark.parametrize("how", ["default precision", "float32", "highest", "no_precision_rescue", "below the gate"])
def test_rescue_dormant(nan_fast_path, how):
    """Dormant, the NaN stays and nothing is recomputed (nor read): at the
    default precision (ambient TF32 off), at an explicit full-f32 precision,
    under no_precision_rescue(), and below the size gate."""
    precision, hatch = {
        "default precision": (None, contextlib.nullcontext()),
        "float32": ("float32", contextlib.nullcontext()),
        "highest": ("highest", contextlib.nullcontext()),
        "no_precision_rescue": ("tensorfloat32", linalg.no_precision_rescue()),
        "below the gate": ("tensorfloat32", linalg.precision_rescue(min_n=256)),
    }[how]
    K, y = T(spd(128, seed=32)), T(np.random.default_rng(33).normal(size=128))
    with linalg.precision_rescue(min_n=0), hatch, cb.force_blocked(32):
        out = linalg.lml_core(K, y, precision=precision)
        L = linalg.cholesky(K, precision=precision)
    assert torch.isnan(out) and torch.isnan(L).all()
    ran = "tensorfloat32" if cb.uses_tf32(precision) else "float32"
    assert nan_fast_path == [("lml_core", ran), ("cholesky", ran)]
    assert linalg._RESCUE and linalg._RESCUE_MIN_N == 8192


def test_rescue_value_and_grad_unchanged():
    """Engaged on a finite fast path, values and gradients are those of JAX
    (the flag read, and no recompute)."""
    K, y = spd(128, seed=34), np.random.default_rng(35).normal(size=128)
    with jlinalg.force_xla():
        want_v, want_g = jax.value_and_grad(lambda A: jlinalg.lml_core(A, jnp.asarray(y)))(jnp.asarray(K))
    Kt = T(K).requires_grad_(True)
    with linalg.precision_rescue(min_n=0), cb.force_blocked(32):
        assert linalg._rescue_engaged(128, "tensorfloat32")
        got = linalg.lml_core(Kt, T(y), precision="tensorfloat32")
        got.backward()
        L = linalg.cholesky(T(K), precision="tensorfloat32")
    np.testing.assert_allclose(float(got.detach()), float(want_v), rtol=1e-9)
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(want_g), atol=1e-8)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), atol=ATOL)
