"""Drive the PyTorch port (gogp_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gogp_torch/csrc`` (nvcc, sm_90a) and
then runs these phases, each printing one JSON line:

1. device   - torch's device name, nvidia-smi's name and power limit, TF32.
2. build    - the kernels' build time and ptxas resource lines.
3. kernels  - each kernel against its plain PyTorch version on the card, in
              f32, at the shapes of the slice below: errors and times (CUDA
              events after a warmup).
4. slice    - the GP problem of ``bench.py``: n = 4096 sorted uniform inputs
              on [0, 100], y = sin(x/3) + 0.1 N(0, 1) from numpy seed 0,
              rbf.scaled() + uniform_noise at log-theta 0, forecast at
              m = 1024 points.  absorb, lml_from_posterior, lml, gp_observe,
              predict_from_posterior and predict_y_from_posterior run once
              through the front door in f32 (the kernel path), and are held
              against the same calls on the plain path in f64 on the card.
5. launches - the kernels' launch counts during that one run (each must be
              at least 1), and the wall times of the kernel path and of the
              plain f32 path.

With ``--profile``, one more phase follows:

6. profile  - one slice run on each path under torch.profiler: the device's
              busy time and idle share over the run, and the kernels with
              the most device time.

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

from gogp_torch import GP, rbf, uniform_noise
from gogp_torch.gp import core
from gogp_torch.models.params import gp_observe
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

PALLAS = "gogp_tpu/ops/cholesky_pallas.py"
KERNELS = {
    # launch-count key: (name, source, replaces)
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


def phase_kernels(dev) -> dict:
    gp, x, y, v, ts, tn, _ = problem(torch.float32, dev)
    K = core.masked_cov(gp, ts, tn, x, None)
    L, invs = cb.blocked_cholesky_invs(K, BLOCK)
    z = cb.trsv_lower(L, y, invs, BLOCK)
    tiles = L.view(N // BLOCK, BLOCK, N // BLOCK, BLOCK).diagonal(dim1=0, dim2=2).permute(2, 0, 1).contiguous()
    tile = K[:BLOCK, :BLOCK].contiguous()
    cases = {  # key: (kernel call, plain call, shape of the main input, reps)
        "chol_inv_tile": (lambda: cb.cholesky_inv_tile(tile), lambda: cb.cholesky_inv_tile_plain(tile), tile.shape, 50),
        "trsv_lower": (lambda: cb.trsv_lower(L, y, invs, BLOCK), lambda: cb.trsv_lower_plain(L, y), L.shape, 20),
        "trsv_lower_t": (lambda: cb.trsv_lower_t(L, z, invs, BLOCK), lambda: cb.trsv_lower_t_plain(L, z), L.shape, 20),
        "tril_inv_tile": (lambda: cb.tril_inv_tile(tiles), lambda: cb.tril_inv_tile_plain(tiles), tiles.shape, 20),
    }
    out = {}
    for key, (kernel, plain, shape, reps) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        errs = [max_err(g, w) for g, w in pairs]
        abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
        row = {
            "kernel": key, "shape": list(shape),
            "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_rel": KERNEL_RTOL,
            "ms": event_ms(kernel, reps), "plain_ms": event_ms(plain, reps),
        }
        emit({"phase": "kernels", **row})
        if not rel_err <= KERNEL_RTOL:
            raise AssertionError(f"{key}: kernel disagrees with its plain version ({rel_err:.3e} > {KERNEL_RTOL})")
        out[key] = row
    return out


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


def phase_launches(launches: dict, args32) -> None:
    missing = [k for k, n in launches.items() if n < 1]
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


def phase_profile(args32) -> None:
    from torch.profiler import ProfilerActivity, profile

    report = {"phase": "profile"}
    for label, ctx in (("kernels", contextlib.nullcontext), ("plain", linalg.force_plain)):
        with ctx():
            run_slice(*args32)  # warm: allocator and library handles
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_slice(*args32)
                torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        window = max(e.time_range.end for e in host) - min(e.time_range.start for e in host)
        busy = _device_busy_us(device)
        kernels = [a for a in prof.key_averages() if a.device_type == torch.autograd.DeviceType.CUDA]
        top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]
        report[label] = {
            "window_us": window, "device_busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_launches": len(device),
            "top_us": {a.key[:60]: [a.self_device_time_total, a.count] for a in top},
        }
    emit(report)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="also run phase 6 (torch.profiler)")
    args = parser.parse_args()
    info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    launches, args32 = phase_slice(dev)
    phase_launches(launches, args32)
    if args.profile:
        phase_profile(args32)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key], "max_abs_err": kernels[key]["max_abs_err"],
         "ms": kernels[key]["ms"], "plain_ms": kernels[key]["plain_ms"]}
        for key, (name, source, replaces) in KERNELS.items()
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
