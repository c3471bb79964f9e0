"""Drive the PyTorch port (gogp_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gogp_torch/csrc`` (nvcc, sm_90a, one
process per source) and then runs these phases, each printing JSON lines:

1. device   - torch's device name, nvidia-smi's name and power limit, TF32.
2. build    - the kernels' build time and ptxas resource lines.
3. kernels  - each kernel against its plain PyTorch version on the card, in
              f32, at the shapes each of the three paths below gives it:
              errors and times (CUDA events after a warmup), beside the
              least time the card could take (bytes over 3.35 TB/s or FLOPs
              over 67 TFLOP/s, the larger) and one PyTorch library call
              where one computes the same function.  Serving: K1 on its
              n = 4096 covariance (K2 on one tile where the gate sends
              n = 4096 to the stepwise driver), the gate's solver (K4 as
              measured: K3 below n = 1024) both ways and K5 on the factor.
              Train: K1 at n = 1536 (and at 1024, 1792, 2048, 2560, 3072,
              also timed against the stepwise driver and cholesky_ex, with
              a "gates" line of K1's gate beside these times), the solver
              both ways and K5 on K1's n = 1536 factor.  Large: K2 on one
              tile, K3 and K4 both ways and K5 on the n = 16384 factor; K3
              and K4 also at n = 1024, 1536, 2048, 4096 and 8192 on the same
              factors, and a "gates" line with the gate between them beside
              these times.  K6, which no path calls, on one tile.
   k5       - K5 at each path's count of tiles (12, 32, 128) and at 200, one
              CTA a tile and split over 2 and 4 by block column, against its
              plain version, with a "gates" line of the fastest split at
              each count; K5 on ill-conditioned GP tiles against f64.
4. slice    - serving: the GP problem of ``bench.py``, n = 4096 sorted
              uniform inputs on [0, 100], y = sin(x/3) + 0.1 N(0, 1) from
              numpy seed 0, rbf.scaled() + uniform_noise at log-theta 0,
              forecast at m = 1024 points.  absorb, lml_from_posterior, lml,
              gp_observe, predict_from_posterior and predict_y_from_posterior
              run once through the front door in f32 (the kernel path), and
              are held against the same calls on the plain path in f64 on
              the card.
5. launches - the kernels' launch counts during that one run (K1, or K2
              where the gate sends n = 4096 to the stepwise driver, the
              gate's solver and K5 must each be launched, no transpose
              solve), and wall times of
              the kernel path and of the plain f32 path.
6. train    - training, then serving: the reference's barebones study
              (matern32.scaled() + uniform_noise.scaled_by(0.01)) on the same
              generator at n = 1536, y normalised, from v0 = 0.  The value
              and gradient of gp_observe at v0, Adam for 50 steps, LBFGS
              (at most 100 iterations, threshold 1e-4), then gp_posterior and
              the forecast at m = 512 points at the LBFGS optimum.  The kernel
              path in f32 is held against the plain path in f64 on the card
              (the forecast at the kernel path's own optimum on both);
              K1, the gate's solver both ways and K5 must each be launched,
              K2 not.  Wall
              time per value-and-gradient step and per fit on the kernel path
              and on the plain f32 path.

7. large    - the exact GP at large n: the JAX package's large-n problem
              (benchmarks/tpu_round2.py:76-81), rbf.scaled() + uniform_noise,
              n = 16384 sorted uniform inputs on [0, 400], y = sin(x/3) +
              0.1 N(0, 1) from numpy seed 0, v0 = 0.  The value and gradient
              of gp_observe at v0, Adam for 3 steps, then gp_posterior and
              the forecast at m = 1024 points at Adam's v, held against the
              plain path in f64 on the card; the launch counts of each stage
              (K2 per factorization, the gate's solver, K4 as measured, both
              ways per gradient, none of the other's or of K1, K5 in the
              forecast); wall time of a value-and-gradient step on
              the kernel path and on the plain f32 path; the factorization
              against cuSOLVER; peak device memory; the precision rescue's
              host read, and one step at "tensorfloat32", where it engages.

8. bayes    - Bayesian hyperparameter inference: the hyperpriors study
              (gogp_tpu/tutorial/hyperpriors.py, n = 44 points, 6
              log-thetas) under ChEES-HMC at the protocol of
              benchmarks/ess_nuts.py:729 (64 chains, 512 warmup and 512
              sampling transitions, seed 0).  K7 against its plain version
              at the study's covariances of 16, 64 and 256 positions and, 64
              matrices each, at n = 32, 64, 96 and K7's n limit, with a
              "gates" line of the limit beside K7's and the library's
              times; the value and gradient of the log-joint
              ``bayes.build_logjoint`` gives the sampler (K7 route, f32)
              against the plain route's in f64 at 256 positions; the main
              path, ``bayes.main(["hyperpriors", "--engine", "chees",
              "--chains", "64", "--seed", "0", "--warmup", "512",
              "--samples", "32768", "selfcheck"])`` in process on the K7
              route, whose K7 launches must equal its log-joint's calls
              (counted by wrapping ``chees.run_chees``), with 50 finite
              forecast rows; one transition from its sampler's final state
              on both routes with the same draws; the same command line
              under force_plain at 128 + 128 transitions (none of its calls
              may launch K7).

With ``--phases a,b,...`` (of kernels, k5, k7, gate, stamps, slice, train,
large, bayes; k7 is the bayes phase's kernel checks without its sampler runs,
gate times K3 against K4 at n = 24576 to 65536 and stamps records the stages
of K2, K5 and K4's chain step, both in no whole run) only those phases
run, after device and build, and the script ends with ``{"ok": false,
"partial": [...]}`` and exit code 2: for work on one kernel, never a pass.

With ``--profile``, one more phase follows:

9. profile  - one serving slice run, one train and one large value-and-gradient
              step, and one 64-chain value and gradient of the bayes path, on
              each path under torch.profiler: the device's busy time and idle
              share over the run, and the kernels with the most device time.

Then the peak device memory of each phase, one JSON line with the per-kernel
summary, the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

from gogp_torch import GP, make_gp_logp, masked_value_and_grad, matern32, mle, rbf, uniform_noise
from gogp_torch.gp import core
from gogp_torch.models.params import gp_observe, gp_posterior
from gogp_torch.infer import chees, diagnostics
from gogp_torch.ops import _build, fused_gp, linalg
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.tutorial import bayes
from gogp_torch.tutorial import io as tio

N, M = 4096, 1024
BLOCK = cb.DEFAULT_BLOCK
# Bounds the slice is held to against the f64 plain path on the card (f32
# factor and solves, different summation orders): LML 1e-6 relative, about
# 900 times the 1.1e-9 an H100 measured; mean and std 1e-4 absolute, about 70
# times the 1.4e-6 it measured.
LML_RTOL = 1e-6
PRED_ATOL = 1e-4
# Bound for each kernel against its plain f32 version, relative to the
# largest entry of the plain result (an H100 measured at most 7.1e-7).
KERNEL_RTOL = 1e-5
# K1 against its plain f32 version (cuSOLVER's factor and triangular solves
# of its tiles): the factor of a covariance with noise variance 0.01 carries
# the f32 rounding of K's condition number, about 1e3-1e4.
K1_RTOL = 1e-3
# K1 is held and timed, beside the stepwise driver and cholesky_ex, at these
# n: the measurements that set its gate (cb._FUSED_MAX_N).  Beyond the gate
# the kernel entry is called past the wrapper's range check, here only.
K1_SIZES = (1024, 1536, 1792, 2048, 2560, 3072, 4096)

# The train path: the barebones study at n = 1536, forecast at m = 512.
N_TRAIN, M_TRAIN = 1536, 512
ADAM_STEPS, LBFGS_ITERS, LBFGS_THRESHOLD = 50, 100, 1e-4
# Bounds of the train path (f32 kernel path) against the f64 plain path, 10
# to 30 times what an H100 measured (PERF.md).  The LML at v0 is about 233 on
# a covariance of condition number about 1e4, so its f32 value is off by about
# 1e-3 (4.7e-6 relative) on either f32 path.  The f32 LBFGS stops where the
# LML's f32 rounding hides further gains (a zero step, "stalled"), on a
# stretch where the LML is flat along v[0]: its v lies 0.045 from the f64
# optimum.  So the optimum is held by its LML, not its v: the f64 LML at the
# f32 optimum may lie at most lbfgs_gap_rtol below the f64 optimum's.
TRAIN_BOUNDS = {
    "value_rtol": 1e-4,  # gp_observe at v0, relative (4.7e-6 measured)
    "grad_rtol": 1e-4,  # its gradient, relative to the largest entry (6.0e-6)
    "adam_v_atol": 1e-5,  # v after 50 Adam steps (7.7e-7)
    "lbfgs_lml_rtol": 1e-4,  # the LML each path reports there (3.9e-6)
    "lbfgs_gap_rtol": 1e-4,  # f64 LML at the f32 optimum, below the f64 optimum's (2.8e-6)
    "pred_atol": 5e-3,  # forecast mean and std at the f32 optimum's v (3.2e-4)
}

# The large path: the JAX package's large-n problem (benchmarks/
# tpu_round2.py:76-81) at n = 16384, forecast at m = 1024 points.
N_LARGE, M_LARGE, X_LARGE = 16384, 1024, 400.0
ADAM_LARGE = 3
# Bounds of the large path (f32 kernel path) against the f64 plain path,
# written before its first run on the card.
LARGE_BOUNDS = {
    "value_rtol": 1e-5,  # gp_observe at v0, relative
    "grad_rtol": 1e-3,  # its gradient, relative to the largest entry
    "adam_v_atol": 1e-4,  # v after 3 Adam steps
    "pred_atol": 1e-3,  # forecast mean and std at Adam's v
}
# K3 and K4 against plain and the library call on the same factors at these
# n: the measurements that set the gate between them (cb._TRSV2D_MIN_N).
GATE_SIZES = (1024, 1536, 2048, 4096, 8192, N_LARGE)

# The bayes path: the hyperpriors study under ChEES-HMC at the protocol of
# benchmarks/ess_nuts.py:729 (run_chees_bench: 64 chains, 512 warmup and 512
# sampling transitions, seed 0), through the command line on the K7 route.
# The plain route's run, reported only, is cut to 128 + 128: a transition
# took 0.31-0.48 s on an H100 host (PERF.md), so the protocol's 1024
# transitions on both routes took 961 s of the script's 1200.
BAYES_CHAINS, BAYES_WARMUP, BAYES_SAMPLES, BAYES_SEED = 64, 512, 512, 0
PLAIN_WARMUP, PLAIN_SAMPLES = 128, 128
K7_BATCHES = (16, BAYES_CHAINS, 256)
# K7 against the library pair at these n, 64 matrices each: the measurements
# that set its dispatch limit (fused_gp.K7_MAX_N); the largest is the limit.
K7_SIZES = (32, 64, 96, fused_gp.K7_MAX_N)
# Bounds of the bayes path.  Written before its first run on the card:
# k7 1e-2, value 1e-4, gradient 1e-2, transition 1e-2; k7, the gradient and
# the transition then set to about 10 times what an H100 showed (PERF.md).
BAYES_BOUNDS = {
    "k7_rtol": 5e-4,  # K7 against its plain f32 version, relative to the largest entry of L^-1 (4.1e-5)
    "value_rtol": 1e-4,  # the K7 route's log-joint (f32) against the plain route in f64, relative (8.8e-6)
    "grad_rtol": 4e-4,  # its gradient, relative to the largest entry (3.9e-5)
    "transition_atol": 1e-3,  # positions after one 55-step transition on the two f32 routes, same draws (1.1e-4)
    "accept_lo": 0.5, "accept_hi": 0.95,  # the post-warmup mean acceptance of the K7 route's run
}

# The card's peaks for the least time a kernel could take (NVIDIA's H100 SXM
# data sheet): HBM bytes per second, and f32 FLOPs per second outside the
# tensor cores (every kernel here computes in f32 FMA).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Cycles per second assumed for the spin that event_ms queues calls behind
# (an H100's boost clock; a faster clock only shortens the spin).
SPIN_HZ = 2.0e9

PALLAS = "gogp_tpu/ops/cholesky_pallas.py"
KERNELS = {
    # launch-count key: (name, source, replaces)
    "fused_cholesky_invs": ("K1 fused_cholesky_invs", "gogp_torch/csrc/fused_chol.cu", f"{PALLAS}:456"),
    "chol_inv_tile": ("K2 cholesky_inv_tile", "gogp_torch/csrc/chol_inv_tile.cu", f"{PALLAS}:251"),
    "trsv_lower": ("K3 trsv_lower", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:824"),
    "trsv_lower_t": ("K3 trsv_lower_t", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:850"),
    "trsv2d_lower": ("K4 trsv2d_lower", "gogp_torch/csrc/trsv2d.cu", f"{PALLAS}:946"),
    "trsv2d_lower_t": ("K4 trsv2d_lower_t", "gogp_torch/csrc/trsv2d.cu", f"{PALLAS}:976"),
    "tril_inv_tile": ("K5 tril_inv_tile", "gogp_torch/csrc/tril_inv_tile.cu", f"{PALLAS}:344"),
    "chol_tile": ("K6 cholesky_tile", "gogp_torch/csrc/chol_tile.cu", f"{PALLAS}:161"),
    "fused_gp_linv": ("K7 fused_gp_linv", "gogp_torch/csrc/fused_gp.cu", "gogp_tpu/ops/fused_gp.py:213"),
}


def work(key: str, shape) -> tuple[float, float]:
    """(bytes, FLOPs) a kernel's function needs at ``shape``: each input
    read once, each output written once, only what the function uses (the
    lower triangle of a factor it solves with)."""
    b = BLOCK
    if key == "fused_gp_linv":  # each K's lower triangle in, its dense L^-1 out; n^3/3 for the factor, as much for the inverse
        count, n = shape[0], shape[-1]
        return 4 * count * (n * (n + 1) / 2 + n * n), count * 2 * n**3 / 3
    if key == "fused_cholesky_invs":  # K's block lower triangle in; L and the tile inverses out
        n = shape[0]
        return 4 * (n * (n + b) / 2 + n * n + n * b), n**3 / 3 + (n // b) * b**3 / 3
    if key == "chol_inv_tile":  # the tile in; L and inv(L) out
        return 4 * 3 * b * b, 2 * b**3 / 3
    if key == "chol_tile":
        return 4 * 2 * b * b, b**3 / 3
    if key == "tril_inv_tile":
        count = shape[0] if len(shape) == 3 else 1
        return 4 * 2 * count * b * b, count * b**3 / 3
    # K3 and K4: the strictly lower block triangle and the tile inverses,
    # y in, x out; a multiply-add per float of L and of the inverses
    n = shape[0]
    return 4 * (n * (n - b) / 2 + n * b + 2 * n), n * (n - b) + 2 * n * b


def bound(key: str, shape) -> tuple[float, str]:
    """The least time the card could take (ms), and what sets it."""
    nbytes, flops = work(key, shape)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``reps`` calls.  The
    card first spins for about as long as the host needs to queue the calls
    (measured on the warmup), so that they run back to back and a kernel
    shorter than its host-side launch still shows its device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * reps * host_s * SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time per call, each call ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), in f64."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in a kernel result")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = (lib_path.parent / "build.log").read_text().splitlines()
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(lib_path.name), "ptxas": ptxas_lines(log)})


def ptxas_lines(log: list[str]) -> list[str]:
    """ptxas's per-kernel lines from a build log: each entry function's name,
    then its registers, shared memory and spills."""
    keep = ("Compiling entry", "Used", "spill")
    return [line.replace("ptxas info    : ", "").strip() for line in log if any(k in line for k in keep)]


def problem(dtype: torch.dtype, device):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=N)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    theta = torch.exp(v)
    return gp, t(x), t(y), v, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], t(np.linspace(0, 100, M))


def run_slice(gp, x, y, v, ts, tn, z) -> dict:
    post = core.absorb(gp, ts, tn, x, y)
    return {
        "lml_from_posterior": core.lml_from_posterior(post),
        "lml": core.lml(gp, ts, tn, x, y),
        "gp_observe": gp_observe(gp, v, x=x, y=y),
        "predict": core.predict_from_posterior(gp, post, z),
        "predict_y": core.predict_y_from_posterior(gp, post, z),
    }


def train_problem(n: int, dtype: torch.dtype, device):
    """The barebones study (gogp_tpu/tutorial/barebones.py:23) on bench.py's
    generator at n points, y normalised with the sample std as evaluate
    does, v0 = 0, forecast points on linspace(0, 100)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    y = (y - y.mean()) / y.std(ddof=1)
    gp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    return gp, t(x), t(y), v0, t(np.linspace(0, 100, M_TRAIN))


def train_cov(n: int, dev) -> torch.Tensor:
    """The train path's covariance at v0 (f32), at n points."""
    gp, x, _, v0, _ = train_problem(n, torch.float32, dev)
    theta = torch.exp(v0)
    return core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], x, None)


def value_and_grad_step(gp, x, y, v0, z):
    return masked_value_and_grad(make_gp_logp(gp, x=x, y=y))(v0)


def fit(gp, x, y, v0, z):
    """Adam from v0, LBFGS from v0 (the reference's default), both through
    the front door."""
    logp = make_gp_logp(gp, x=x, y=y)
    adam = mle.adam(masked_value_and_grad(logp), v0, iters=ADAM_STEPS, threshold=0.0)
    lbfgs = mle.lbfgs(logp, v0, iters=LBFGS_ITERS, threshold=LBFGS_THRESHOLD)
    return adam, lbfgs


def forecast(gp, x, y, v, z) -> dict:
    post = gp_posterior(gp, v, x=x, y=y)
    return {"predict": core.predict_from_posterior(gp, post, z),
            "predict_y": core.predict_y_from_posterior(gp, post, z)}


def run_train(gp, x, y, v0, z) -> dict:
    """The train path once: value and gradient at v0, Adam, LBFGS, then the
    forecast at the LBFGS optimum."""
    value, grad = value_and_grad_step(gp, x, y, v0, z)
    adam, lbfgs = fit(gp, x, y, v0, z)
    return {"value": value, "grad": grad, "adam": adam, "lbfgs": lbfgs, **forecast(gp, x, y, lbfgs.x, z)}


def large_problem(n: int, dtype: torch.dtype, device):
    """The JAX package's large-n problem (benchmarks/tpu_round2.py:76-81) at
    n points: rbf.scaled() + uniform_noise, v0 = 0, forecast points on
    linspace(0, 400)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, X_LARGE, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    v0 = torch.zeros(gp.n_theta, dtype=dtype, device=device)
    return gp, t(x), t(y), v0, t(np.linspace(0, X_LARGE, M_LARGE))


def large_cov(n: int, dev) -> torch.Tensor:
    """The large path's covariance at v0 (f32), at n points."""
    gp, x, _, v0, _ = large_problem(n, torch.float32, dev)
    theta = torch.exp(v0)
    return core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], x, None)


def run_large(gp, x, y, v0, z, after=lambda stage: None) -> dict:
    """The large path once: value and gradient at v0, Adam, then the
    forecast at Adam's v; ``after(stage)`` runs after each stage."""
    value, grad = value_and_grad_step(gp, x, y, v0, z)
    after("step")
    adam = mle.adam(masked_value_and_grad(make_gp_logp(gp, x=x, y=y)), v0, iters=ADAM_LARGE, threshold=0.0)
    after("adam")
    out = forecast(gp, x, y, adam.x, z)
    after("forecast")
    return {"value": value, "grad": grad, "adam": adam, **out}


# What the library call beside a kernel computes, where it is more than one
# call or less than the kernel's function.
LIBRARY_NAMES = {
    "chol_inv_tile": "torch.linalg.cholesky + torch.linalg.solve_triangular(L, I)",
    "fused_cholesky_invs": "cholesky_ex, L only (no tile inverses)",
    "fused_gp_linv": "torch.linalg.cholesky + torch.linalg.solve_triangular(L, I)",
}


def check_kernel(path: str, key: str, kernel, plain, shape, reps: int, library=None,
                 rtol: float = KERNEL_RTOL, **extra) -> dict:
    """Hold one kernel against its plain version on the same inputs, then
    time both, ``library`` (one PyTorch call computing the same function, or
    None; LIBRARY_NAMES says which where it is more than one call) and each
    of ``extra``'s calls with CUDA events."""
    library_name = LIBRARY_NAMES.get(key) if library is not None else None
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    errs = [max_err(g, w) for g, w in pairs]
    abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
    bound_ms, bound_by = bound(key, shape)
    row = {
        "kernel": key, "path": path, "shape": list(shape),
        "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_rel": rtol,
        "ms": event_ms(kernel, reps), "plain_ms": event_ms(plain, reps),
        "library_ms": None if library is None else event_ms(library, reps),
        **({"library_name": library_name} if library_name else {}),
        "bound_ms": bound_ms, "bound_by": bound_by,
        **{name: event_ms(fn, reps) for name, fn in extra.items()},
    }
    emit({"phase": "kernels", **row})
    if not rel_err <= rtol:
        raise AssertionError(f"{key} at {list(shape)}: kernel disagrees with its plain version ({rel_err:.3e} > {rtol})")
    return row


def tile_cases(tile: torch.Tensor) -> dict:
    """K2 and K6 on one tile: key -> (kernel call, plain call, shape of the
    main input, reps, library call)."""
    eye = torch.eye(BLOCK, dtype=tile.dtype, device=tile.device)
    return {
        "chol_inv_tile": (lambda: cb.cholesky_inv_tile(tile), lambda: cb.cholesky_inv_tile_plain(tile),
                          tile.shape, 50,
                          lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(tile), eye, upper=False)),
        "chol_tile": (lambda: cb.cholesky_tile(tile), lambda: cb.cholesky_tile_plain(tile),
                      tile.shape, 50, lambda: torch.linalg.cholesky(tile)),
    }


def solves_with_k4(n: int) -> bool:
    """Whether ``lml_core`` solves with K4 (not K3) at size n."""
    return cb.trsv_solvers(n, BLOCK)[0] is cb.trsv2d_lower


def solve_keys(n: int) -> tuple[str, str]:
    """The launch-count keys of the two solves ``lml_core`` takes at size n."""
    return ("trsv2d_lower", "trsv2d_lower_t") if solves_with_k4(n) else ("trsv_lower", "trsv_lower_t")


def solve_cases(L: torch.Tensor, invs: torch.Tensor, y: torch.Tensor, reps: int = 20, k4: bool = False) -> dict:
    """The two solves (K3, or K4 with ``k4``) and K5 on one factor, its tile
    inverses and a right-hand side: key -> (kernel call, plain call, shape of
    the main input, reps, library call)."""
    n = L.shape[0]
    fwd, bwd = (cb.trsv2d_lower, cb.trsv2d_lower_t) if k4 else (cb.trsv_lower, cb.trsv_lower_t)
    key = "trsv2d_lower" if k4 else "trsv_lower"
    z = fwd(L, y, invs, BLOCK)
    tiles = diag_tiles(L)
    eye = torch.eye(BLOCK, dtype=L.dtype, device=L.device)
    return {
        key: (lambda: fwd(L, y, invs, BLOCK), lambda: cb.trsv_lower_plain(L, y), L.shape, reps,
              lambda: torch.linalg.solve_triangular(L, y[:, None], upper=False)),
        f"{key}_t": (lambda: bwd(L, z, invs, BLOCK), lambda: cb.trsv_lower_t_plain(L, z), L.shape, reps,
                     lambda: torch.linalg.solve_triangular(L.mT, z[:, None], upper=True)),
        "tril_inv_tile": (lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape, 20,
                          lambda: torch.linalg.solve_triangular(tiles, eye, upper=False)),
    }


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the shapes each path gives
    it; returns {(path, key): row}."""
    rows = {}
    gp, x, y, v, ts, tn, _ = problem(torch.float32, dev)
    K = core.masked_cov(gp, ts, tn, x, None)
    L, invs = cb.blocked_cholesky_invs(K, BLOCK)  # n = 4096: K1 or the stepwise driver, as the gate says
    tiles = tile_cases(K[:BLOCK, :BLOCK].contiguous())
    # the serving path launches no transpose solve; it is held at n = 4096
    # too.  Its factorization is held with K1's sizes below, or here if the
    # gate sends n = 4096 to the stepwise driver (K2).
    serve = solve_cases(L, invs, y, k4=solves_with_k4(N))
    if SERVE_FACTOR == "chol_inv_tile":
        serve["chol_inv_tile"] = tiles["chol_inv_tile"]
    for key, case in serve.items():
        rows["serve", key] = check_kernel("serve", key, *case)
    # K6, which no path calls, on the same tile
    rows["kernels", "chol_tile"] = check_kernel("kernels", "chol_tile", *tiles["chol_tile"])
    for n in K1_SIZES:
        Kn = K if k1_path(n) == "serve" else train_cov(n, dev)  # serving's own covariance at N

        def stepwise(Kn=Kn):
            with cb.no_fused_whole():
                return cb.blocked_cholesky_invs(Kn)

        path = k1_path(n)
        with unittest.mock.patch.object(cb, "_FUSED_MAX_N", max(K1_SIZES)):  # past the range check
            rows[path, "fused_cholesky_invs"] = check_kernel(
                path, "fused_cholesky_invs",
                lambda: cb.fused_cholesky_invs(Kn), lambda: cb.fused_cholesky_invs_plain(Kn), Kn.shape, 20,
                lambda: torch.linalg.cholesky_ex(Kn), rtol=K1_RTOL, stepwise_ms=stepwise,
            )
        del Kn
    emit(fused_gate(rows))
    # the train path's solves: on K1's factor of its covariance at v0
    y = train_problem(N_TRAIN, torch.float32, dev)[2]
    L, invs = cb.fused_cholesky_invs(train_cov(N_TRAIN, dev))
    for key, case in solve_cases(L, invs, y, k4=solves_with_k4(N_TRAIN)).items():
        rows["train", key] = check_kernel("train", key, *case)
    # Both solves by K3 and by K4 on blocked_cholesky_invs' factor of the large
    # path's covariance at each of GATE_SIZES, beside plain and the library
    # call; at n = N_LARGE also the large path's K2 and K5.
    for n in GATE_SIZES:
        Kn = large_cov(n, dev)
        L, invs = cb.blocked_cholesky_invs(Kn, BLOCK)
        y = large_problem(n, torch.float32, dev)[2]
        path = "large" if n == N_LARGE else f"n={n}"
        cases = {**solve_cases(L, invs, y, reps=10), **solve_cases(L, invs, y, reps=10, k4=True)}
        if n == N_LARGE:
            cases["chol_inv_tile"] = tile_cases(Kn[:BLOCK, :BLOCK].contiguous())["chol_inv_tile"]
        else:
            del cases["tril_inv_tile"]
        for key, case in cases.items():
            rows[path, key] = check_kernel(path, key, *case)
        del Kn, L, invs
    for key in OFF_PATH_SOLVES:  # held at the large path's shape
        rows["kernels", key] = rows["large", key]
    emit(trsv_gate(rows))
    return rows


def k1_path(n: int) -> str:
    """The path whose row K1's check at size n fills: train at N_TRAIN,
    serve at N where the gate sends serving to K1."""
    if n == N_TRAIN:
        return "train"
    return "serve" if n == N and SERVE_FACTOR == "fused_cholesky_invs" else f"n={n}"


def fused_gate(rows: dict) -> dict:
    """K1's gate beside the times that set it: device ms of K1, of the
    stepwise driver and of cholesky_ex (the factor alone) at each of
    K1_SIZES, from this run's rows, and which route the gate gives each n."""
    sizes = {}
    for n in K1_SIZES:
        row = rows[k1_path(n), "fused_cholesky_invs"]
        sizes[n] = {"k1_ms": row["ms"], "stepwise_ms": row["stepwise_ms"], "cholesky_ex_ms": row["library_ms"],
                    "takes": "K1" if n <= cb._FUSED_MAX_N else "stepwise"}
    return {"phase": "gates", "gate": "_FUSED_MAX_N", "value": cb._FUSED_MAX_N, "ms": sizes}


def trsv_gate(rows: dict) -> dict:
    """The gate between K3 and K4 beside the times that set it: device ms of
    both solves by K3, by K4 and by ``solve_triangular`` at each of
    GATE_SIZES, from this run's rows."""
    sizes = {}
    for n in GATE_SIZES:
        path = "large" if n == N_LARGE else f"n={n}"
        sizes[n] = {
            "k3_ms": [rows[path, "trsv_lower"]["ms"], rows[path, "trsv_lower_t"]["ms"]],
            "k4_ms": [rows[path, "trsv2d_lower"]["ms"], rows[path, "trsv2d_lower_t"]["ms"]],
            "library_ms": [rows[path, "trsv_lower"]["library_ms"], rows[path, "trsv_lower_t"]["library_ms"]],
            "takes": "K4" if solves_with_k4(n) else "K3",
        }
    gate = cb._TRSV2D_MIN_N
    return {"phase": "gates", "gate": "_TRSV2D_MIN_N", "value": gate if np.isfinite(gate) else "none: K3 at every n",
            "forward_and_transpose_ms": sizes}


# Beyond N_LARGE the gate is looked for on synthetic factors (no
# factorization: 17 GB of L at the largest), with ``--phases gate`` only.
FAR_GATE_SIZES = (24576, 32768, 49152, 65536)


def synthetic_factor(n: int, dev):
    """A well-conditioned random lower-triangular factor at size n (unit-scale
    diagonal in [1, 2), entries below it 0.5 N(0, 1) / sqrt(n)), its tile
    inverses by K5 and a right-hand side, from a generator seeded with n."""
    g = torch.Generator(device=dev).manual_seed(n)
    L = torch.randn((n, n), generator=g, device=dev).mul_(0.5 / np.sqrt(n)).tril_()
    L.diagonal().copy_(1.0 + torch.rand(n, generator=g, device=dev))
    invs = cb.tril_inv_tile(diag_tiles(L))
    return L, invs, torch.randn(n, generator=g, device=dev)


def diag_tiles(L: torch.Tensor) -> torch.Tensor:
    """The (n/b, b, b) stack of L's diagonal tiles, contiguous."""
    n = L.shape[0]
    return L.view(n // BLOCK, BLOCK, n // BLOCK, BLOCK).diagonal(dim1=0, dim2=2).permute(2, 0, 1).contiguous()


def phase_gate(dev) -> None:
    """K3 and K4 against ``solve_triangular`` beyond the large path's size,
    on synthetic factors (``synthetic_factor``).  Both kernels are held to
    1e-4 of the largest entry of the library's solve, itself f32 here;
    prints device ms of each, forward and transpose."""
    sizes = {}
    for n in FAR_GATE_SIZES:
        L, invs, y = synthetic_factor(n, dev)
        calls = {
            "k3_ms": (lambda: cb.trsv_lower(L, y, invs, BLOCK), lambda: cb.trsv_lower_t(L, y, invs, BLOCK)),
            "k4_ms": (lambda: cb.trsv2d_lower(L, y, invs, BLOCK), lambda: cb.trsv2d_lower_t(L, y, invs, BLOCK)),
            "library_ms": (lambda: cb.trsv_lower_plain(L, y), lambda: cb.trsv_lower_t_plain(L, y)),
        }
        want = [fn() for fn in calls["library_ms"]]
        for name in ("k3_ms", "k4_ms"):
            for got, ref in zip((fn() for fn in calls[name]), want):
                rel = max_err(got, ref)[1]
                if not rel <= 1e-4:
                    raise AssertionError(f"{name[:2]} at n = {n} disagrees with solve_triangular ({rel:.3e})")
        sizes[n] = {name: [event_ms(fn, 5) for fn in fns] for name, fns in calls.items()}
        del L, invs, y, want
    emit({"phase": "gates", "gate": "_TRSV2D_MIN_N", "factors": "synthetic", "forward_and_transpose_ms": sizes})


# K5 one CTA a tile and split over 2 and 4 CTAs by block column, at each
# path's count of tiles and past the card's 132 SMs: the measurements that
# set gogp_tril_inv_tiles' split (tril_inv_tile.cu).
K5_SPLITS = (1, 2, 4)
K5_FAR_COUNT = 200
# K5 on ill-conditioned tiles (diagonal from 1 down to 4e-4-2e-3) against
# f64, column by column: the largest error in a column over that column's
# largest entry.  Written before the first run on the card: 1e-3; then set to
# about 10 times the 3.3e-4 an H100 showed (forward substitution, the plain
# version, 2.7e-4).
K5_ILL_RTOL = 3e-3


def k5_split(tiles: torch.Tensor, split: int) -> torch.Tensor:
    """K5 at the given split (CTAs a tile), past the wrapper: for
    measurement only, counted nowhere."""
    out = torch.empty_like(tiles)
    _build.check(_build.library().gogp_tril_inv_tiles_split(
        tiles.data_ptr(), out.data_ptr(), tiles.shape[0], BLOCK, split, torch.cuda.current_stream().cuda_stream),
        "K5 at a split")
    return out


def ill_conditioned_tiles(count: int, dev) -> torch.Tensor:
    """(count, b, b) Cholesky factors of rbf covariances on b points of [0,
    1] plus jitter 1e-7, the length scale from 0.05 to 1 (log-spaced): their
    diagonals run from 1 down to 4e-4-2e-3, and forward substitution loses
    about 3e-4 of a column's scale on them in f32."""
    x = np.linspace(0, 1, BLOCK)
    tiles = [np.linalg.cholesky(np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / ell**2) + 1e-7 * np.eye(BLOCK))
             for ell in np.logspace(np.log10(0.05), 0, count)]
    return torch.as_tensor(np.stack(tiles), dtype=torch.float32, device=dev)


def col_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error in a column over the column's largest entry, in f64."""
    got, want = got.double(), want.double()
    return float(((got - want).abs().amax(dim=-2) / want.abs().amax(dim=-2).clamp_min(1e-300)).max())


def phase_k5(dev) -> dict:
    """K5 at each path's count of tiles (train 12, serve 32, large 128, on
    each path's own factor) and at K5_FAR_COUNT synthetic tiles, at every
    split of K5_SPLITS against its plain version, with device times of each
    split, of the wrapper, of the plain version and of ``solve_triangular``;
    then K5 on ill-conditioned tiles against f64.  Returns {count: ms by
    split}."""
    gp, x, _, _, ts, tn, _ = problem(torch.float32, dev)
    stacks = {
        "train": diag_tiles(cb.fused_cholesky_invs(train_cov(N_TRAIN, dev))[0]),
        "serve": diag_tiles(cb.blocked_cholesky_invs(core.masked_cov(gp, ts, tn, x, None), BLOCK)[0]),
        "large": diag_tiles(cb.blocked_cholesky_invs(large_cov(N_LARGE, dev), BLOCK)[0]),
        f"count={K5_FAR_COUNT}": diag_tiles(synthetic_factor(K5_FAR_COUNT * BLOCK, dev)[0]),
    }
    eye = torch.eye(BLOCK, device=dev)
    times = {}
    for label, tiles in stacks.items():
        want = cb.tril_inv_tile_plain(tiles)
        errs = {split: max_err(k5_split(tiles, split), want)[1] for split in K5_SPLITS}
        ms = {split: event_ms(lambda split=split: k5_split(tiles, split), 20) for split in K5_SPLITS}
        times[tiles.shape[0]] = ms
        emit({"phase": "k5", "path": label, "count": tiles.shape[0], "max_rel_err": errs, "bound_rel": KERNEL_RTOL,
              "split_ms": ms, "fastest_split": min(ms, key=ms.get),
              "wrapper_ms": event_ms(lambda: cb.tril_inv_tile(tiles), 20),
              "plain_ms": event_ms(lambda: cb.tril_inv_tile_plain(tiles), 20),
              "library_ms": event_ms(lambda: torch.linalg.solve_triangular(tiles, eye, upper=False), 20),
              "bound_ms": bound("tril_inv_tile", tiles.shape)[0]})
        bad = {split: err for split, err in errs.items() if not err <= KERNEL_RTOL}
        if bad:
            raise AssertionError(f"K5 at {label} disagrees with its plain version: {bad}")
    tiles = ill_conditioned_tiles(16, dev)
    want = cb.tril_inv_tile_plain(tiles.double())
    errs = {split: col_rel_err(k5_split(tiles, split), want) for split in K5_SPLITS}
    emit({"phase": "k5", "path": "ill-conditioned", "count": tiles.shape[0],
          "diagonal": [float(tiles.diagonal(dim1=1, dim2=2).min()), float(tiles.diagonal(dim1=1, dim2=2).max())],
          "col_rel_err_vs_f64": errs, "plain_f32_col_rel_err_vs_f64": col_rel_err(cb.tril_inv_tile_plain(tiles), want),
          "wrapper_col_rel_err_vs_f64": col_rel_err(cb.tril_inv_tile(tiles), want), "bound": K5_ILL_RTOL})
    bad = {split: err for split, err in errs.items() if not err <= K5_ILL_RTOL}
    if bad:
        raise AssertionError(f"K5 on ill-conditioned tiles disagrees with f64: {bad}")
    emit({"phase": "gates", "gate": "K5 split (tril_inv_tile.cu)", "ms_by_split": times,
          "fastest": {count: min(ms, key=ms.get) for count, ms in times.items()}})
    return times


def phase_slice(dev) -> tuple[dict, tuple]:
    args32 = problem(torch.float32, dev)
    args64 = problem(torch.float64, dev)

    cb.reset_launch_counts()
    got = run_slice(*args32)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)

    with linalg.force_plain():
        ref = run_slice(*args64)
    torch.cuda.synchronize()

    report = {"phase": "slice", "n": N, "m": M, "block": BLOCK,
              "bounds": {"lml_rtol": LML_RTOL, "pred_atol": PRED_ATOL}}
    failures = []
    for name in ("lml_from_posterior", "lml", "gp_observe"):
        g, r = float(got[name]), float(ref[name])
        rel = abs(g - r) / abs(r)
        report[name] = {"f32_kernels": g, "f64_plain": r, "rel_err": rel}
        if not (np.isfinite(g) and rel <= LML_RTOL):
            failures.append(name)
    for name in ("predict", "predict_y"):
        errs = {}
        for label, g, r in zip(("mu", "sigma"), got[name], ref[name]):
            if g.shape != (M,) or not torch.isfinite(g).all():
                failures.append(f"{name}.{label} shape/finite")
            errs[f"{label}_abs_err"] = float((g.double() - r).abs().max())
            if not errs[f"{label}_abs_err"] <= PRED_ATOL:
                failures.append(f"{name}.{label}")
        report[name] = errs
    emit(report)
    if failures:
        raise AssertionError(f"slice disagrees with the f64 plain path: {failures}")
    return launches, args32


# The serving slice's kernels: n = 4096 factors with K1 below the measured
# gate (cb._FUSED_MAX_N), with the stepwise driver (K2) above it, and no call
# of it asks for a gradient, so lml_core solves no alpha (no transpose solve).
SERVE_FACTOR = "fused_cholesky_invs" if N <= cb._FUSED_MAX_N else "chol_inv_tile"
SERVE_KERNELS = (SERVE_FACTOR, solve_keys(N)[0], "tril_inv_tile")
# The train path's: K1 factors at n = 1536, every gradient solves alpha.
TRAIN_KERNELS = ("fused_cholesky_invs", *solve_keys(N_TRAIN), "tril_inv_tile")
# The large path's: the stepwise factorization (K2), both solves, K5 in the
# forecast.
LARGE_KERNELS = ("chol_inv_tile", *solve_keys(N_LARGE), "tril_inv_tile")
# The bayes path's: K7, once per value-and-gradient of the chain batch.
BAYES_KERNELS = ("fused_gp_linv",)
# K6 is on no path, and neither is the solver the gate leaves no path's size
# to (K3 as measured, K4 from n = 1024 on): their entries count their
# launches in the kernels phase.
OFF_PATH_SOLVES = tuple(k for k in ("trsv_lower", "trsv_lower_t", "trsv2d_lower", "trsv2d_lower_t")
                        if k not in (*SERVE_KERNELS, *TRAIN_KERNELS, *LARGE_KERNELS))
PATH_KERNELS = {"serve": SERVE_KERNELS, "train": TRAIN_KERNELS, "large": LARGE_KERNELS, "bayes": BAYES_KERNELS,
                "kernels": ("chol_tile", *OFF_PATH_SOLVES)}


def phase_launches(launches: dict, args32) -> None:
    missing = [k for k in SERVE_KERNELS if launches[k] < 1]
    kernel_ms = wall_ms(lambda: run_slice(*args32))
    with linalg.force_plain():
        plain_ms = wall_ms(lambda: run_slice(*args32))
    stages = {}
    gp, x, y, v, ts, tn, z = args32
    post = core.absorb(gp, ts, tn, x, y)
    for label, plain in (("kernels", False), ("plain", True)):
        ctx = linalg.force_plain() if plain else contextlib.nullcontext()
        with ctx:
            stages[label] = {
                "absorb": wall_ms(lambda: core.absorb(gp, ts, tn, x, y)),
                "lml": wall_ms(lambda: core.lml(gp, ts, tn, x, y)),
                "predict_from_posterior": wall_ms(lambda: core.predict_from_posterior(gp, post, z)),
                "masked_cov": wall_ms(lambda: core.masked_cov(gp, ts, tn, x, None)),
            }
    emit({"phase": "launches", "launches": launches, "slice_wall_ms": {"kernels_f32": kernel_ms, "plain_f32": plain_ms},
          "stage_wall_ms": stages})
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if launches["trsv_lower_t"] + launches["trsv2d_lower_t"] != 0:
        raise AssertionError("a transpose solve launched on the serving path, where no call asks for a gradient")


def phase_train(dev) -> dict:
    args32 = train_problem(N_TRAIN, torch.float32, dev)
    args64 = train_problem(N_TRAIN, torch.float64, dev)

    cb.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_train(*args32)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)

    gp64, x64, y64, v64, z64 = args64
    v_fit = got["lbfgs"].x.double()
    with linalg.force_plain():
        ref = run_train(*args64)
        # the forecast, and the LML, at the f32 kernel path's optimum
        ref_at_fit = forecast(gp64, x64, y64, v_fit, z64)
        lml_at_fit = float(make_gp_logp(gp64, x=x64, y=y64)(v_fit))
        # f32 itself, reported: the plain path's f32 value, gradient and
        # forecast at the same v
        plain32_v0 = value_and_grad_step(*args32)
        plain32_at_fit = forecast(args32[0], args32[1], args32[2], got["lbfgs"].x, args32[4])
    torch.cuda.synchronize()

    def opt(res):
        return {"x": res.x.tolist(), "value": float(res.value), "iters": res.iters,
                "converged": res.converged, "stalled": res.stalled}

    def value_rel(value):
        return abs(float(value) - float(ref["value"])) / abs(float(ref["value"]))

    def grad_rel(grad):
        return float((grad.double() - ref["grad"]).abs().max() / ref["grad"].abs().max())

    errors = {
        "value_rel": value_rel(got["value"]), "value_rel_plain_f32": value_rel(plain32_v0[0]),
        "grad_rel": grad_rel(got["grad"]), "grad_rel_plain_f32": grad_rel(plain32_v0[1]),
        "adam_v_abs": float((got["adam"].x.double() - ref["adam"].x).abs().max()),
        "lbfgs_v_abs": float((got["lbfgs"].x.double() - ref["lbfgs"].x).abs().max()),
        "lbfgs_lml_rel": abs(float(got["lbfgs"].value) - float(ref["lbfgs"].value)) / abs(float(ref["lbfgs"].value)),
        "lbfgs_gap_rel": (float(ref["lbfgs"].value) - lml_at_fit) / abs(float(ref["lbfgs"].value)),
    }
    failures = []
    for name in ("predict", "predict_y"):
        for label, gt, rt in zip(("mu", "sigma"), got[name], ref_at_fit[name]):
            if gt.shape != (M_TRAIN,) or not torch.isfinite(gt).all():
                failures.append(f"{name}.{label} shape/finite")
            errors[f"{name}_{label}_abs"] = float((gt.double() - rt).abs().max())
        for label, pt, rt in zip(("mu", "sigma"), plain32_at_fit[name], ref_at_fit[name]):
            errors[f"{name}_{label}_abs_plain_f32"] = float((pt.double() - rt).abs().max())
    checks = {
        "value_rel": "value_rtol", "grad_rel": "grad_rtol", "adam_v_abs": "adam_v_atol",
        "lbfgs_lml_rel": "lbfgs_lml_rtol", "lbfgs_gap_rel": "lbfgs_gap_rtol",
        **{f"{a}_{b}_abs": "pred_atol" for a in ("predict", "predict_y") for b in ("mu", "sigma")},
    }
    failures += [k for k, bound in checks.items() if not errors[k] <= TRAIN_BOUNDS[bound]]
    if not all(torch.isfinite(t).all() for t in (got["value"], got["grad"], got["adam"].x, got["lbfgs"].x)):
        failures.append("non-finite fit")

    step_ms, fit_ms = {}, {}
    for label, ctx in (("kernels_f32", contextlib.nullcontext), ("plain_f32", linalg.force_plain)):
        with ctx():
            step_ms[label] = wall_ms(lambda: value_and_grad_step(*args32))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            adam, lbfgs = fit(*args32)
            torch.cuda.synchronize()
            fit_ms[label] = {"adam_and_lbfgs": (time.perf_counter() - t0) * 1e3,
                             "lbfgs_iters": lbfgs.iters, "lbfgs_converged": lbfgs.converged}

    emit({"phase": "train", "n": N_TRAIN, "m": M_TRAIN, "block": BLOCK,
          "bounds": TRAIN_BOUNDS, "errors": errors,
          "gp_observe_v0": {"f32_kernels": float(got["value"]), "f64_plain": float(ref["value"]),
                            "grad_f32_kernels": got["grad"].tolist(), "grad_f64_plain": ref["grad"].tolist()},
          "adam": {"f32_kernels": opt(got["adam"]), "f64_plain": opt(ref["adam"])},
          "lbfgs": {"f32_kernels": opt(got["lbfgs"]), "f64_plain": opt(ref["lbfgs"])},
          "launches": launches, "train_wall_s": train_wall_s,
          "value_and_grad_step_wall_ms": step_ms, "fit_wall_ms": fit_ms})
    if failures:
        raise AssertionError(f"train path disagrees with the f64 plain path: {failures}")
    missing = [k for k in TRAIN_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    if launches["chol_inv_tile"] != 0:
        raise AssertionError(f"K2 launched on the train path, where K1 factors every n <= {cb._FUSED_MAX_N}")
    return {"launches": launches, "args32": args32}


def phase_large(dev) -> dict:
    args32 = large_problem(N_LARGE, torch.float32, dev)
    args64 = large_problem(N_LARGE, torch.float64, dev)
    nb = N_LARGE // BLOCK

    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_large(*args32, after=lambda stage: stages.__setitem__(stage, dict(cb.LAUNCHES)))
    torch.cuda.synchronize()
    large_wall_s = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    peak_kernel_path = torch.cuda.max_memory_allocated()

    gp64, x64, y64, _, z64 = args64
    with linalg.force_plain():
        ref = run_large(*args64)
        ref_at_v = forecast(gp64, x64, y64, got["adam"].x.double(), z64)  # at the kernel path's v
        plain32_v0 = value_and_grad_step(*args32)
    torch.cuda.synchronize()

    def value_rel(value):
        return abs(float(value) - float(ref["value"])) / abs(float(ref["value"]))

    def grad_rel(grad):
        return float((grad.double() - ref["grad"]).abs().max() / ref["grad"].abs().max())

    errors = {
        "value_rel": value_rel(got["value"]), "value_rel_plain_f32": value_rel(plain32_v0[0]),
        "grad_rel": grad_rel(got["grad"]), "grad_rel_plain_f32": grad_rel(plain32_v0[1]),
        "adam_v_abs": float((got["adam"].x.double() - ref["adam"].x).abs().max()),
    }
    failures = []
    for name in ("predict", "predict_y"):
        for label, gt, rt in zip(("mu", "sigma"), got[name], ref_at_v[name]):
            if gt.shape != (M_LARGE,) or not torch.isfinite(gt).all():
                failures.append(f"{name}.{label} shape/finite")
            errors[f"{name}_{label}_abs"] = float((gt.double() - rt).abs().max())
    checks = {"value_rel": "value_rtol", "grad_rel": "grad_rtol", "adam_v_abs": "adam_v_atol",
              **{f"{a}_{b}_abs": "pred_atol" for a in ("predict", "predict_y") for b in ("mu", "sigma")}}
    failures += [k for k, b in checks.items() if not errors[k] <= LARGE_BOUNDS[b]]
    if not all(torch.isfinite(t).all() for t in (got["value"], got["grad"], got["adam"].x)):
        failures.append("non-finite value, gradient or v")

    # launches per stage: K2 per factorization, the gate's solves both ways
    # per gradient step, none of the other solver's or of K1 anywhere, K5 in
    # the forecast
    zero = dict.fromkeys(cb.LAUNCHES, 0)
    per_stage = {}
    for prev, stage in ((zero, "step"), (stages["step"], "adam"), (stages["adam"], "forecast")):
        per_stage[stage] = {k: stages[stage][k] - prev[k] for k in cb.LAUNCHES}
    fwd, bwd = solve_keys(N_LARGE)
    want = {
        "step": {"chol_inv_tile": nb, fwd: 1, bwd: 1},
        "adam": {"chol_inv_tile": ADAM_LARGE * nb, fwd: ADAM_LARGE, bwd: ADAM_LARGE},
        "forecast": {"chol_inv_tile": nb, fwd: 0, bwd: 0},
    }
    for stage, counts in want.items():
        failures += [f"{stage}: {k} {per_stage[stage][k]} != {v}" for k, v in counts.items()
                     if k in LARGE_KERNELS and per_stage[stage][k] != v]
    if "tril_inv_tile" in LARGE_KERNELS and per_stage["forecast"]["tril_inv_tile"] < 1:
        failures.append("forecast: no K5 launch")
    other = [k for k in ("trsv_lower", "trsv_lower_t", "trsv2d_lower", "trsv2d_lower_t") if k not in (fwd, bwd)]
    failures += [f"{k} launched" for k in (*other, "fused_cholesky_invs") if launches[k]]

    # times: a value-and-gradient step on both f32 paths, the factorization
    # against cuSOLVER, the rescue's host read, and one step in TF32
    step_ms = {"kernels_f32": wall_ms(lambda: value_and_grad_step(*args32), reps=3)}
    with linalg.force_plain():
        step_ms["plain_f32"] = wall_ms(lambda: value_and_grad_step(*args32), reps=3)
    K = large_cov(N_LARGE, dev)
    factor_ms = {"stepwise": event_ms(lambda: cb.blocked_cholesky_invs(K, BLOCK), reps=3, warmup=1),
                 "cusolver": event_ms(lambda: cb.plain_cholesky(K), reps=3, warmup=1)}
    L = cb.blocked_cholesky_invs(K, BLOCK)[0]
    del K
    rescue_read_ms = wall_ms(lambda: bool(torch.isfinite(torch.diagonal(L)).all()), reps=21)
    del L
    gp, x, y, v0, z = args32
    tf32_logp = masked_value_and_grad(make_gp_logp(gp, x=x, y=y, precision="tensorfloat32"))
    tf32_value, tf32_grad = tf32_logp(v0)
    step_ms["kernels_tf32_rescue_engaged"] = wall_ms(lambda: tf32_logp(v0), reps=3)

    emit({"phase": "large", "n": N_LARGE, "m": M_LARGE, "block": BLOCK, "adam_steps": ADAM_LARGE,
          "bounds": LARGE_BOUNDS, "errors": errors,
          "gp_observe_v0": {"f32_kernels": float(got["value"]), "f64_plain": float(ref["value"]),
                            "grad_f32_kernels": got["grad"].tolist(), "grad_f64_plain": ref["grad"].tolist()},
          "adam_v": {"f32_kernels": got["adam"].x.tolist(), "f64_plain": ref["adam"].x.tolist()},
          "tf32": {"rescue_engaged": linalg._rescue_engaged(N_LARGE, "tensorfloat32"),
                   "value_rel": value_rel(tf32_value), "grad_rel": grad_rel(tf32_grad)},
          "launches": launches, "launches_per_stage": per_stage, "large_wall_s": large_wall_s,
          "value_and_grad_step_wall_ms": step_ms, "factorization_ms": factor_ms,
          "rescue_flag_read_wall_ms": rescue_read_ms,
          "peak_gib_kernel_path": peak_kernel_path / 2**30})
    if failures:
        raise AssertionError(f"large path disagrees with the f64 plain path or its launch counts: {failures}")
    return {"launches": launches, "args32": args32}


def bayes_problem(dev, dtype=torch.float32, plain: bool = False):
    """The hyperpriors study's log-joint on the K7 route (or, with
    ``plain``, built under force_plain: gp_observe plus priors under
    autograd) as ``bayes.main`` builds it: y normalised, v0 = 0."""
    _, study, data = bayes.get_study("hyperpriors")
    x, y = tio.load_csv(data)
    y_norm = tio.normalize(y)[0]
    with linalg.force_plain() if plain else contextlib.nullcontext():
        logp, observed, v0, free = bayes.build_logjoint(study, x, y_norm, dev, dtype)
    return study, x, y_norm, logp, observed, v0, free


def bayes_step(k7_logp, plain_logp, V):
    """One value and gradient of the chain batch by autograd, as the sampler
    takes it: the plain route inside force_plain, the K7 route outside."""
    q = V.detach().requires_grad_(True)
    lp = (plain_logp if linalg._FORCE_PLAIN else k7_logp)(q)
    return lp.detach(), torch.autograd.grad(lp.sum(), q)[0]


def bayes_positions(count: int, dev, dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    """``count`` positions around v0, 0.1 N(0, 1), as the protocol starts
    its chains (benchmarks/ess_nuts.py:381)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return 0.1 * torch.randn((count, 6), generator=g, dtype=dtype, device=dev)


def bayes_covs(study, x, V: torch.Tensor) -> torch.Tensor:
    """The study's covariance at each position: a (len(V), n, n) batch."""
    nts = study.gp.n_theta_simil
    xt = torch.as_tensor(x, dtype=V.dtype, device=V.device)
    return torch.func.vmap(lambda v: core.masked_cov(study.gp, torch.exp(v[:nts]), torch.exp(v[nts:]), xt, None))(V)


def k7_cases(dev) -> dict:
    """K7 on the hyperpriors covariances at each of K7_BATCHES positions
    (n = 44) and, 64 matrices each, at each n of K7_SIZES up to K7's limit
    (the study's kernel on n points at the data's spacing): path -> (kernel
    call, plain call, shape, reps, library call)."""
    study, x, _, _, _, _, _ = bayes_problem(dev)
    cases = {}
    spacing = float(x[1, 0] - x[0, 0])
    sized = [(f"n={n}", BAYES_CHAINS, spacing * np.arange(n)[:, None]) for n in K7_SIZES]
    for label, count, xs in [*((f"B={b}", b, x) for b in K7_BATCHES), *sized]:
        K = bayes_covs(study, xs, bayes_positions(count, dev, seed=1))
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=dev)
        path = "bayes" if count == BAYES_CHAINS and xs is x else label
        cases[path] = (lambda K=K: fused_gp.fused_gp_linv(K), lambda K=K: fused_gp.linv_plain(K), K.shape, 50,
                       lambda K=K, eye=eye: torch.linalg.solve_triangular(torch.linalg.cholesky(K), eye, upper=False))
    return cases


def phase_k7(dev) -> dict:
    """K7 against its plain version and the library pair at the bayes path's
    shapes and at K7_SIZES; returns {(path, key): row}.  Prints K7's dispatch
    limit beside the times that set it."""
    rows = {(path, "fused_gp_linv"): check_kernel(path, "fused_gp_linv", *case, rtol=BAYES_BOUNDS["k7_rtol"])
            for path, case in k7_cases(dev).items()}
    sizes = {rows[path, key]["shape"][-1]: {"k7_ms": rows[path, key]["ms"], "library_ms": rows[path, key]["library_ms"]}
             for path, key in rows if path == "bayes" or path.startswith("n=")}
    emit({"phase": "gates", "gate": "K7_MAX_N", "value": fused_gp.K7_MAX_N, "batch": BAYES_CHAINS,
          "ms": dict(sorted(sizes.items()))})
    return rows


def run_main(warmup: int, samples: int) -> dict:
    """``bayes.main(["hyperpriors", "--engine", "chees", "--chains", "64",
    "--seed", "0", "--warmup", warmup, "--samples", 64 * samples,
    "selfcheck"])`` in process, its output captured.  Inside it,
    ``chees.run_chees`` is wrapped to count the log-joint's calls and to
    read the host clock (after a synchronize) where sampling begins; the
    sampler runs on the state's own generator, as by default.  Returns the
    output lines, the sampler's Samples, and walls in s and
    value-and-gradient calls, each split into init + warmup and sampling."""
    calls, mark, runs = [0], {}, []
    real_run_chees = chees.run_chees

    def run_chees(logp, *args, **kwargs):
        def counted(V):
            calls[0] += 1
            return logp(V)

        def draws(state):
            if state.step == kwargs["num_warmup"]:  # the first sampling transition
                torch.cuda.synchronize()
                mark.update(t=time.perf_counter(), calls=calls[0])
            return chees.generator_draws(state)

        torch.cuda.synchronize()
        mark.update(t0=time.perf_counter())
        runs.append(real_run_chees(counted, *args, draws=draws, **kwargs))
        torch.cuda.synchronize()
        mark.update(t1=time.perf_counter())
        return runs[-1]

    out = io.StringIO()
    argv = ["hyperpriors", "--engine", "chees", "--chains", str(BAYES_CHAINS), "--seed", str(BAYES_SEED),
            "--warmup", str(warmup), "--samples", str(BAYES_CHAINS * samples), "selfcheck"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), unittest.mock.patch.object(chees, "run_chees", run_chees):
        bayes.main(argv)
    torch.cuda.synchronize()
    return {"argv": argv, "wall_s": time.perf_counter() - t0, "lines": out.getvalue().strip().splitlines(),
            "samples": runs[0],
            "walls": {"init_and_warmup": mark["t"] - mark["t0"], "sampling": mark["t1"] - mark["t"]},
            "calls": {"init_and_warmup": mark["calls"], "sampling": calls[0] - mark["calls"]}}


def _posterior_summary(pos: torch.Tensor) -> dict:
    """Diagnostics of (draws, chains, dim) positions, in f64."""
    by_chain = pos.permute(1, 0, 2).double()
    min_ess, max_rhat, converged = diagnostics.gated_min_ess(by_chain)
    flat = by_chain.reshape(-1, by_chain.shape[-1])
    ess = diagnostics.ess(by_chain)
    return {"mean": flat.mean(0), "mcse": flat.std(0) / torch.sqrt(ess), "min_bulk_ess": min_ess,
            "max_bulk_rhat": max_rhat, "converged_rhat_1.01": converged, **diagnostics.diagnose(by_chain)}


def phase_bayes(dev) -> dict:
    # 1. K7 against its plain version at the path's shapes
    rows = phase_k7(dev)

    # 2. the value and gradient of the log-joint the sampler runs, K7 route
    # (f32), against the plain route's in f64, at 256 positions
    study, x, y, logp, observed, v0, free = bayes_problem(dev)
    plain_logp = bayes_problem(dev, plain=True)[3]
    plain64_logp = bayes_problem(dev, torch.float64, plain=True)[3]
    V = bayes_positions(256, dev, seed=2)
    val, grad = bayes_step(logp, plain64_logp, V)
    with linalg.force_plain():
        want_val, want_grad = bayes_step(logp, plain64_logp, V.double())
    errors = {"value_rel": float(((val.double() - want_val).abs() / want_val.abs()).max()),
              "grad_rel": float((grad.double() - want_grad).abs().max() / want_grad.abs().max())}

    # 4. the main path: the command line on the K7 route at the protocol,
    # its K7 launches counted against its log-joint's calls
    cb.reset_launch_counts()
    k7_run = run_main(BAYES_WARMUP, BAYES_SAMPLES)
    launches = dict(cb.LAUNCHES)
    vg_calls = sum(k7_run["calls"].values())
    pos, acc, final = k7_run["samples"].positions, k7_run["samples"].accept_probs, k7_run["samples"].state
    k7 = _posterior_summary(pos)

    # 3. one transition on both routes from one state, the same draws: the
    # final state one transition on (its halton index, 2^10 + 1, gives a
    # trajectory of about half the adapted length; the final state's own
    # index 2^10 gives a single leapfrog step, whose positions the
    # log-joint cannot change)
    gen = torch.Generator(device=dev).manual_seed(3)
    start = chees.chees_transition(logp, final._replace(rng=gen), free=free)
    fixed = chees.generator_draws(start)
    n_steps = chees.n_leapfrog_steps(start)[0]
    one = {label: chees.chees_transition(lp, start, free=free, draws=lambda s: fixed)
           for label, lp in (("k7", logp), ("plain", plain_logp))}
    accepted = {label: fixed[1] < s.accept_probs for label, s in one.items()}
    errors["transition_abs"] = float((one["k7"].positions - one["plain"].positions).abs().max())
    same_accepts = bool(torch.equal(accepted["k7"], accepted["plain"]))

    # the command line on the plain route, cut to PLAIN_WARMUP +
    # PLAIN_SAMPLES: no K7 launch
    before = cb.LAUNCHES["fused_gp_linv"]
    with linalg.force_plain():
        plain_run = run_main(PLAIN_WARMUP, PLAIN_SAMPLES)
    plain_launches = cb.LAUNCHES["fused_gp_linv"] - before
    ppos, pacc = plain_run["samples"].positions, plain_run["samples"].accept_probs
    plain = _posterior_summary(ppos)
    gap = (k7["mean"] - plain["mean"]) / torch.sqrt(k7["mcse"] ** 2 + plain["mcse"] ** 2)

    def route(run, summ, warmup):
        walls, accepts, lines = run["walls"], run["samples"].accept_probs, run["lines"]
        transitions = warmup + accepts.shape[0]
        rows = np.array([[float(v) for v in line.split(",")] for line in lines[:-1]])
        return {"argv": run["argv"], "main_wall_s": run["wall_s"], "wall_s": walls, "vg_calls": run["calls"],
                "transitions": transitions, "ms_per_transition": 1e3 * sum(walls.values()) / transitions,
                "ms_per_vg": 1e3 * sum(walls.values()) / sum(run["calls"].values()),
                "mean_accept_sampling": float(accepts.mean()),
                **{k: (v.tolist() if isinstance(v, torch.Tensor) else v) for k, v in summ.items()},
                "ess_per_s_sampling": summ["min_bulk_ess"] / walls["sampling"],
                "forecast_rows": list(rows.shape), "theta_mean_line": lines[-1],
                "forecast_ok": bool(rows.shape == (50, 4) and np.isfinite(rows[:, [0, 2, 3]]).all()
                                    and (rows[:, 3] > 0).all() and lines[-1].startswith("# posterior theta mean: "))}

    report = {
        "phase": "bayes", "chains": BAYES_CHAINS, "warmup": BAYES_WARMUP, "samples": BAYES_SAMPLES,
        "seed": BAYES_SEED, "n": x.shape[0], "bounds": BAYES_BOUNDS, "errors": errors,
        "same_accept_decisions": same_accepts, "transition_leapfrog_steps": n_steps,
        "transition_accepted": int(accepted["k7"].sum()), "launches": launches, "vg_calls": vg_calls,
        "plain_route_k7_launches": plain_launches,
        "k7_route": {**route(k7_run, k7, BAYES_WARMUP), "step_size": float(final.step_size),
                     "traj_length": float(torch.exp(final.log_traj)), "inv_mass": final.inv_mass.tolist()},
        "plain_route": route(plain_run, plain, PLAIN_WARMUP),
        "mean_gap_in_mcse": gap.tolist(),
    }
    emit(report)

    failures = [k for k, b in (("value_rel", "value_rtol"), ("grad_rel", "grad_rtol"),
                               ("transition_abs", "transition_atol")) if not errors[k] <= BAYES_BOUNDS[b]]
    if not same_accepts:
        failures.append("the two routes took different accept decisions in one transition")
    if launches["fused_gp_linv"] != vg_calls:
        failures.append(f"K7 launched {launches['fused_gp_linv']} times in {vg_calls} value-and-gradient calls")
    if plain_launches:
        failures.append(f"the plain route launched K7 {plain_launches} times")
    if not (torch.isfinite(pos).all() and torch.isfinite(ppos).all()):
        failures.append("non-finite draws")
    if not BAYES_BOUNDS["accept_lo"] <= float(acc.mean()) <= BAYES_BOUNDS["accept_hi"]:
        failures.append(f"mean acceptance {float(acc.mean()):.3f} outside the bounds")
    failures += [f"bayes.main ({label}): not 50 finite forecast rows with sigma > 0 and the theta-mean line"
                 for label in ("k7_route", "plain_route") if not report[label]["forecast_ok"]]
    if failures:
        raise AssertionError(f"bayes path: {failures}")
    return {"launches": launches, "rows": rows, "logps": (logp, plain_logp)}


def _device_busy_us(events) -> float:
    """Length of the union of the device events' time intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            busy += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (0.0 if end is None else end - start)


def phase_profile(slice_args32, train_args32, large_args32, bayes_logps) -> None:
    from torch.profiler import ProfilerActivity, profile

    report = {"phase": "profile"}
    V = bayes_positions(BAYES_CHAINS, slice_args32[1].device, seed=4)
    runs = {"slice": (run_slice, slice_args32), "train_step": (value_and_grad_step, train_args32),
            "large_step": (value_and_grad_step, large_args32), "bayes_vg": (bayes_step, (*bayes_logps, V))}
    for run, (fn, args) in runs.items():
        for label, ctx in (("kernels", contextlib.nullcontext), ("plain", linalg.force_plain)):
            with ctx():
                fn(*args)  # warm: allocator and library handles
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn(*args)
                    torch.cuda.synchronize()
            events = prof.events()
            device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
            window = max(e.time_range.end for e in host) - min(e.time_range.start for e in host)
            busy = _device_busy_us(device)
            kernels = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
            top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:10]
            report[f"{run}_{label}"] = {
                "window_us": window, "device_busy_us": busy, "idle_share": 1.0 - busy / window,
                "device_launches": len(device),
                "top_us": {a.key[:60]: [a.self_device_time_total, a.count] for a in top},
            }
    emit(report)


# The tile body's stages as tile_common.cuh's TileStage numbers them.
TILE_STAGES = ("start", "load", "diagonal factor (warp 0)", "diagonal step", "diagonal inverse (warp 0)",
               "panel", "panel write", "update", "last inverse rows", "store")


# K5's stages under the same stamps (tril_inv_tile.cu), each with its block
# row as the panel.
K5_STAGES = ("start", "load, block row 0 in place", "-", "solve (warp 0)", "-", "products", "-",
             "right-hand sides", "rest of the solves, last block row stored, next block row in place", "store")


def stage_cycles(stamped, read_stamps, labels, launches: int) -> dict:
    """Runs ``stamped`` ``launches`` times, reading the (stage * 8 + panel,
    clock64()) pairs with ``read_stamps(buf, count)`` after each: the median
    cycles from each stamp to the next, labelled by the stage that ends
    there (``labels``) and its panel, their sums by stage, and the whole
    launch's cycles."""
    buf = torch.zeros(2 * 64, dtype=torch.int64, device="cuda")
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(launches):
        stamped()
        read_stamps(buf, count)
        pairs = buf[: 2 * int(count)].view(-1, 2).tolist()
        runs.append([(f"{labels[code // 8]}/{code % 8}", clock) for code, clock in pairs])
    names = [label for label, _ in runs[0]]
    if any([label for label, _ in run] != names for run in runs):
        raise AssertionError("a stamped kernel passed different stages in different launches")
    deltas = {names[i]: statistics.median(run[i][1] - run[i - 1][1] for run in runs) for i in range(1, len(names))}
    by_stage = {}
    for label, cycles in deltas.items():
        stage = label.split("/")[0]
        by_stage[stage] = by_stage.get(stage, 0) + cycles
    return {"total_cycles": statistics.median(run[-1][1] - run[0][1] for run in runs),
            "cycles_by_stage": by_stage, "cycles_to_each_stamp": deltas}


def phase_stamps(dev, launches: int = 20) -> None:
    """The tile kernels' stages on the serving path's first tile: K2 and K5
    built apart with -DGOGP_TILE_STAMPS (thread 0 records clock64() as it
    passes each stage), ``launches`` launches each, the median cycles from
    each stamp to the next (``stage_cycles``), with the stamped and normal
    kernels' device times; then K4's chain step (``chain_stamps``).  In no
    whole run; the normal build records nothing."""
    import ctypes

    lib_path = _build.build(defines=("GOGP_TILE_STAMPS",), sources=("chol_inv_tile.cu", "tril_inv_tile.cu"))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("gogp_chol_inv_tile", "gogp_chol_inv_tile_stamps", "gogp_tril_inv_tiles_split",
                 "gogp_tril_inv_tiles_stamps"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    gp, x, _, _, ts, tn, _ = problem(torch.float32, dev)
    tile = core.masked_cov(gp, ts, tn, x, None)[:BLOCK, :BLOCK].contiguous()
    L, V, W = torch.empty_like(tile), torch.empty_like(tile), torch.empty_like(tile)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k2_stamped():
        _build.check(lib.gogp_chol_inv_tile(tile.data_ptr(), BLOCK, L.data_ptr(), BLOCK, V.data_ptr(), BLOCK,
                                            BLOCK, stream()), "stamped K2")

    def k5_stamped():  # one CTA, whose thread 0 alone stamps
        _build.check(lib.gogp_tril_inv_tiles_split(L.data_ptr(), W.data_ptr(), 1, BLOCK, 1, stream()), "stamped K5")

    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    ptxas = ptxas_lines((lib_path.parent / "build.log").read_text().splitlines())
    k2 = stage_cycles(k2_stamped, lambda buf, count: _build.check(
        lib.gogp_chol_inv_tile_stamps(buf.data_ptr(), count.data_ptr(), stream()), "K2 stamps"), TILE_STAGES, launches)
    Lp, Vp = cb.cholesky_inv_tile_plain(tile)
    err = max(max_err(L, Lp)[1], max_err(V, Vp)[1])
    emit({"phase": "stamps", "kernel": "K2", "tile": list(tile.shape), "launches": launches, "max_rel_err": err,
          **k2, "max_sm_mhz": float(mhz), "stamped_ms": event_ms(k2_stamped, 50),
          "k2_ms": event_ms(lambda: cb.cholesky_inv_tile(tile), 50), "ptxas": ptxas})
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"the stamped tile body disagrees with its plain version ({err:.3e})")
    k5 = stage_cycles(k5_stamped, lambda buf, count: _build.check(
        lib.gogp_tril_inv_tiles_stamps(buf.data_ptr(), count.data_ptr(), stream()), "K5 stamps"), K5_STAGES, launches)
    err = max_err(W, cb.tril_inv_tile_plain(L))[1]
    emit({"phase": "stamps", "kernel": "K5", "tile": list(tile.shape), "launches": launches, "max_rel_err": err,
          **k5, "max_sm_mhz": float(mhz), "stamped_ms": event_ms(k5_stamped, 50),
          "k5_ms": event_ms(lambda: k5_split(L[None], 1), 50)})
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"the stamped K5 disagrees with its plain version ({err:.3e})")
    chain_stamps(dev)


# The stages of K4's chain item (trsv2d.cu, ChainStage), each named by what
# ends at its stamp.
CHAIN_STAGES = ("start", "partial sums (wait for done, read the slots)", "spin (wait for ready)", "barrier",
                "product", "reduce (resid -= product) and barrier", "diagonal apply and store", "barrier", "release")
MAX_STAMP_ROWS = 512


def chain_stamps(dev, n: int = N_LARGE, launches: int = 5) -> None:
    """K4's chain step on a synthetic factor at size n: trsv2d.cu built apart
    with -DGOGP_TRSV_STAMPS (thread 0 of each chain item records clock64()
    and %globaltimer as it passes each stage), ``launches`` launches each
    way.  Over the step rows 8 <= r < nb - 8 and the launches, the median
    cycles of each stage, the hand-off (release of row r - 1 to ready seen
    in row r) and the chain step (release to release) in ns, with the
    stamped and normal K4's device times."""
    import ctypes

    lib_path = _build.build(defines=("GOGP_TRSV_STAMPS",), sources=("trsv2d.cu",))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("gogp_trsv2d_lower", "gogp_trsv2d_lower_t", "gogp_trsv2d_stamps"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
    L, invs, y = synthetic_factor(n, dev)
    nb = n // BLOCK
    buf = torch.zeros(MAX_STAMP_ROWS * len(CHAIN_STAGES) * 2, dtype=torch.int64, device=dev)
    for direction, entry, plain, wrapper in (
            ("forward", lib.gogp_trsv2d_lower, cb.trsv_lower_plain, cb.trsv2d_lower),
            ("transpose", lib.gogp_trsv2d_lower_t, cb.trsv_lower_t_plain, cb.trsv2d_lower_t)):
        x = torch.empty_like(y)
        counters = torch.empty(1 + 2 * nb, dtype=torch.int32, device=dev)
        partial = torch.empty(nb * (nb + 1) // 2 * BLOCK, device=dev)

        def stamped():
            _build.check(entry(L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(), counters.data_ptr(),
                               partial.data_ptr(), n, BLOCK, torch.cuda.current_stream().cuda_stream), "stamped K4")

        runs = []
        for _ in range(launches):
            stamped()
            _build.check(lib.gogp_trsv2d_stamps(buf.data_ptr(), torch.cuda.current_stream().cuda_stream), "K4 stamps")
            runs.append(buf.view(MAX_STAMP_ROWS, len(CHAIN_STAGES), 2)[:nb].cpu().numpy())
        err = max_err(x, plain(L, y))[1]
        rows = range(8, nb - 8)
        cycles = {f"{s}. {CHAIN_STAGES[s]}": statistics.median(
            float(st[r, s, 0] - st[r, s - 1, 0]) for st in runs for r in rows) for s in range(1, len(CHAIN_STAGES))}
        seen, released = CHAIN_STAGES.index("spin (wait for ready)"), len(CHAIN_STAGES) - 1
        emit({"phase": "stamps", "kernel": "K4 chain step", "direction": direction, "n": n, "launches": launches,
              "rows": [rows.start, rows.stop], "max_rel_err": err, "median_cycles_by_stage": cycles,
              "median_handoff_ns": statistics.median(
                  float(st[r, seen, 1] - st[r - 1, released, 1]) for st in runs for r in rows),
              "median_chain_step_ns": statistics.median(
                  float(st[r, released, 1] - st[r - 1, released, 1]) for st in runs for r in rows),
              "median_step_cycles_in_item": statistics.median(
                  float(st[r, released, 0] - st[r, seen, 0]) for st in runs for r in rows),
              "stamped_ms": event_ms(stamped, 10), "k4_ms": event_ms(lambda: wrapper(L, y, invs, BLOCK), 10),
              "ptxas": ptxas_lines((lib_path.parent / "build.log").read_text().splitlines())})
        if not err <= 1e-4:
            raise AssertionError(f"the stamped K4 ({direction}) disagrees with solve_triangular ({err:.3e})")


def _partial_slice(dev) -> None:
    phase_launches(*phase_slice(dev))


# What ``--phases`` can name; "k7" is the bayes phase's kernel checks without
# its sampler runs, "slice" the serving slice with its launch counts, "gate"
# (in no whole run) K3 against K4 beyond the large path's size, "stamps" (in
# no whole run) the tile body's stage cycles and K4's chain step.
PARTIAL_PHASES = {"kernels": phase_kernels, "k5": phase_k5, "k7": phase_k7, "gate": phase_gate,
                  "slice": _partial_slice,
                  "train": phase_train, "large": phase_large, "bayes": phase_bayes, "stamps": phase_stamps}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="also run phase 9 (torch.profiler)")
    parser.add_argument("--phases", type=lambda v: v.split(","), metavar="a,b,...",
                        help=f"run only these phases ({', '.join(PARTIAL_PHASES)}), for work on one kernel or "
                             "path; such a run ends with {\"ok\": false, \"partial\": [...]} and exit code 2")
    args = parser.parse_args()
    unknown = [name for name in args.phases or () if name not in PARTIAL_PHASES]
    if unknown:
        parser.error(f"unknown phases {unknown}: expected some of {list(PARTIAL_PHASES)}")
    info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    if args.phases:
        for name in args.phases:
            t0 = time.perf_counter()
            PARTIAL_PHASES[name](dev)
            emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3)})
        print(info["nvidia_smi"], flush=True)
        emit({"ok": False, "partial": args.phases})
        return 2
    peak_gib = {}

    def measured(name, fn, *a):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a)
        torch.cuda.synchronize()
        peak_gib[name] = torch.cuda.max_memory_allocated() / 2**30
        return out

    cb.reset_launch_counts()
    kernels = measured("kernels", phase_kernels, dev)
    kernels_launches = dict(cb.LAUNCHES)
    measured("k5", phase_k5, dev)
    serve_launches, slice_args32 = measured("slice", phase_slice, dev)
    measured("launches", phase_launches, serve_launches, slice_args32)
    train = measured("train", phase_train, dev)
    large = measured("large", phase_large, dev)
    bayes_out = measured("bayes", phase_bayes, dev)
    kernels.update(bayes_out["rows"])
    if args.profile:
        measured("profile", phase_profile, slice_args32, train["args32"], large["args32"], bayes_out["logps"])
    emit({"phase": "memory", "peak_gib": peak_gib})
    # one entry per kernel and path that launches it: the path's launch
    # count beside the error and times at the shapes that path gives it
    launches = {"serve": serve_launches, "train": train["launches"], "large": large["launches"],
                "bayes": bayes_out["launches"], "kernels": kernels_launches}
    emit({"kernels": [
        {"name": f"{name} ({path}, {'x'.join(map(str, row['shape']))})", "route": "cuda",
         "source": source, "replaces": replaces, "launches": launches[path][key],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for key, (name, source, replaces) in KERNELS.items()
        for path, keys in PATH_KERNELS.items() if key in keys
        for row in [kernels[path, key]]
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
