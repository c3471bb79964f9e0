"""Drive the PyTorch port (gogp_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gogp_torch/csrc`` (nvcc, sm_90a, one
process per source) and then runs these phases, each printing JSON lines:

1. device   - torch's device name, nvidia-smi's name and power limit, TF32.
2. build    - the kernels' build time and ptxas resource lines.
3. kernels  - each kernel against its plain PyTorch version on the card, in
              f32, at the shapes each of the two paths below gives it:
              errors and times (CUDA events after a warmup).  Serving: K2 on
              one tile, K3 both ways and K5 on the n = 4096 factor.  Train:
              K1 at n = 1536 (and at 1024 and 1792, also timed against the
              stepwise driver), K3 both ways and K5 on K1's n = 1536 factor.
4. slice    - serving: the GP problem of ``bench.py``, n = 4096 sorted
              uniform inputs on [0, 100], y = sin(x/3) + 0.1 N(0, 1) from
              numpy seed 0, rbf.scaled() + uniform_noise at log-theta 0,
              forecast at m = 1024 points.  absorb, lml_from_posterior, lml,
              gp_observe, predict_from_posterior and predict_y_from_posterior
              run once through the front door in f32 (the kernel path), and
              are held against the same calls on the plain path in f64 on
              the card.
5. launches - the kernels' launch counts during that one run (K2, K3 and K5
              must each be launched, the K3 transpose not), and wall times of
              the kernel path and of the plain f32 path.
6. train    - training, then serving: the reference's barebones study
              (matern32.scaled() + uniform_noise.scaled_by(0.01)) on the same
              generator at n = 1536, y normalised, from v0 = 0.  The value
              and gradient of gp_observe at v0, Adam for 50 steps, LBFGS
              (at most 100 iterations, threshold 1e-4), then gp_posterior and
              the forecast at m = 512 points at the LBFGS optimum.  The kernel
              path in f32 is held against the plain path in f64 on the card
              (the forecast at the kernel path's own optimum on both);
              K1, K3, K3 transpose and K5 must each be launched, K2 not.  Wall
              time per value-and-gradient step and per fit on the kernel path
              and on the plain f32 path.

With ``--profile``, one more phase follows:

7. profile  - one serving slice run and one train value-and-gradient step on
              each path under torch.profiler: the device's busy time and idle
              share over the run, and the kernels with the most device time.

Then one JSON line with the per-kernel summary, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gogp_torch import GP, make_gp_logp, masked_value_and_grad, matern32, mle, rbf, uniform_noise
from gogp_torch.gp import core
from gogp_torch.models.params import gp_observe, gp_posterior
from gogp_torch.ops import _build, linalg
from gogp_torch.ops import cholesky_blocked as cb

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
K1_SIZES = (1024, 1536, 1792)

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

PALLAS = "gogp_tpu/ops/cholesky_pallas.py"
KERNELS = {
    # launch-count key: (name, source, replaces)
    "fused_cholesky_invs": ("K1 fused_cholesky_invs", "gogp_torch/csrc/fused_chol.cu", f"{PALLAS}:456"),
    "chol_inv_tile": ("K2 cholesky_inv_tile", "gogp_torch/csrc/chol_inv_tile.cu", f"{PALLAS}:251"),
    "trsv_lower": ("K3 trsv_lower", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:824"),
    "trsv_lower_t": ("K3 trsv_lower_t", "gogp_torch/csrc/trsv.cu", f"{PALLAS}:850"),
    "tril_inv_tile": ("K5 tril_inv_tile", "gogp_torch/csrc/tril_inv_tile.cu", f"{PALLAS}:344"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    emit({"phase": "build", "seconds": round(seconds, 3), "library": str(lib_path.name),
          "ptxas": [line.strip() for line in log if "Used" in line or "spill" in line]})


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


def check_kernel(path: str, key: str, kernel, plain, shape, reps: int, bound: float = KERNEL_RTOL, **extra) -> dict:
    """Hold one kernel against its plain version on the same inputs, then
    time both (and each of ``extra``'s calls) with CUDA events."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    errs = [max_err(g, w) for g, w in pairs]
    abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
    row = {
        "kernel": key, "path": path, "shape": list(shape),
        "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_rel": bound,
        "ms": event_ms(kernel, reps), "plain_ms": event_ms(plain, reps),
        **{name: event_ms(fn, reps) for name, fn in extra.items()},
    }
    emit({"phase": "kernels", **row})
    if not rel_err <= bound:
        raise AssertionError(f"{key} at {list(shape)}: kernel disagrees with its plain version ({rel_err:.3e} > {bound})")
    return row


def solve_cases(L: torch.Tensor, invs: torch.Tensor, y: torch.Tensor) -> dict:
    """K3 both ways and K5 on one factor, its tile inverses and a right-hand
    side: key -> (kernel call, plain call, shape of the main input, reps)."""
    n = L.shape[0]
    z = cb.trsv_lower(L, y, invs, BLOCK)
    tiles = L.view(n // BLOCK, BLOCK, n // BLOCK, BLOCK).diagonal(dim1=0, dim2=2).permute(2, 0, 1).contiguous()
    return {
        "trsv_lower": (lambda: cb.trsv_lower(L, y, invs, BLOCK), lambda: cb.trsv_lower_plain(L, y), L.shape, 20),
        "trsv_lower_t": (lambda: cb.trsv_lower_t(L, z, invs, BLOCK), lambda: cb.trsv_lower_t_plain(L, z), L.shape, 20),
        "tril_inv_tile": (lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape, 20),
    }


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the shapes each path gives
    it; returns {(path, key): row}."""
    rows = {}
    gp, x, y, v, ts, tn, _ = problem(torch.float32, dev)
    K = core.masked_cov(gp, ts, tn, x, None)
    L, invs = cb.blocked_cholesky_invs(K, BLOCK)  # n = 4096: the stepwise driver
    tile = K[:BLOCK, :BLOCK].contiguous()
    serve = {
        "chol_inv_tile": (lambda: cb.cholesky_inv_tile(tile), lambda: cb.cholesky_inv_tile_plain(tile), tile.shape, 50),
        # the serving path launches no K3 transpose; it is held at n = 4096 too
        **solve_cases(L, invs, y),
    }
    for key, case in serve.items():
        rows["serve", key] = check_kernel("serve", key, *case)
    for n in K1_SIZES:
        Kn = train_cov(n, dev)

        def stepwise(Kn=Kn):
            with cb.no_fused_whole():
                return cb.blocked_cholesky_invs(Kn)

        path = "train" if n == N_TRAIN else f"n={n}"
        rows[path, "fused_cholesky_invs"] = check_kernel(
            path, "fused_cholesky_invs",
            lambda: cb.fused_cholesky_invs(Kn), lambda: cb.fused_cholesky_invs_plain(Kn), Kn.shape, 20,
            bound=K1_RTOL, stepwise_ms=stepwise,
        )
    # the train path's solves: on K1's factor of its covariance at v0
    y = train_problem(N_TRAIN, torch.float32, dev)[2]
    L, invs = cb.fused_cholesky_invs(train_cov(N_TRAIN, dev))
    for key, case in solve_cases(L, invs, y).items():
        rows["train", key] = check_kernel("train", key, *case)
    return rows


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


# The serving slice's kernels: n = 4096 takes the stepwise driver (K2), and
# no call of it asks for a gradient, so lml_core solves no alpha (no K3
# transpose).
SERVE_KERNELS = ("chol_inv_tile", "trsv_lower", "tril_inv_tile")
# The train path's: K1 factors at n = 1536, every gradient solves alpha.
TRAIN_KERNELS = ("fused_cholesky_invs", "trsv_lower", "trsv_lower_t", "tril_inv_tile")
PATH_KERNELS = {"serve": SERVE_KERNELS, "train": TRAIN_KERNELS}


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
    if launches["trsv_lower_t"] != 0:
        raise AssertionError("K3 transpose launched on the serving path, where no call asks for a gradient")


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
        raise AssertionError("K2 launched on the train path, where K1 factors every n <= 2047")
    return {"launches": launches, "args32": args32}


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


def phase_profile(slice_args32, train_args32) -> None:
    from torch.profiler import ProfilerActivity, profile

    report = {"phase": "profile"}
    runs = {"slice": (run_slice, slice_args32), "train_step": (value_and_grad_step, train_args32)}
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="also run phase 7 (torch.profiler)")
    args = parser.parse_args()
    info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    serve_launches, slice_args32 = phase_slice(dev)
    phase_launches(serve_launches, slice_args32)
    train = phase_train(dev)
    if args.profile:
        phase_profile(slice_args32, train["args32"])
    # one entry per kernel and path that launches it: the path's launch
    # count beside the error and times at the shapes that path gives it
    launches = {"serve": serve_launches, "train": train["launches"]}
    emit({"kernels": [
        {"name": f"{name} ({path}, {'x'.join(map(str, kernels[path, key]['shape']))})", "route": "cuda",
         "source": source, "replaces": replaces, "launches": launches[path][key],
         "max_abs_err": kernels[path, key]["max_abs_err"],
         "ms": kernels[path, key]["ms"], "plain_ms": kernels[path, key]["plain_ms"]}
        for key, (name, source, replaces) in KERNELS.items()
        for path, keys in PATH_KERNELS.items() if key in keys
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
