"""Run one cell of the benchmark of gogp_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's files by name (``portbench/cells.py``), makes its data on
the card from the seed, loads the port's kernels (built once into
``build/gogp_torch/<hash>/`` inside the checkout), warms up the cell's
shapes, drives its traffic for ``--seconds``, then checks what the window
produced against the plain float64 reference in ``portbench/reference/``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end ones, or with
``--trace 1`` the per-layer ones from a profiled stretch of whole steps),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit (the cell file's ``limits`` name them),
which the last lines of standard error repeat.  The check's other readings
go under ``readings``, and the window's counts (with the process's CPU
time and involuntary context switches in it) under ``counts``, before it.
Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell takes, or where JAX or the JAX package was loaded.

A traffic kind's module (``portbench/traffic/<kind>.py``) gives ``SAMPLER``
(whether a step is a sampler's transition), ``setup``, ``drive``,
``vg_calls``, ``vg_flops``, ``failed``, ``release`` and ``check``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cells, devtrace  # noqa: E402
from portbench.window import Window  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gogp_tpu"})


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    steps: int  # completed in the window
    step_ms: list
    vg_calls: int
    chains: int
    sampler: bool
    trace: devtrace.Trace | None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
             precision: str | None = None, mix_overrides: dict | None = None) -> dict:
    """One run of ``cell`` (``cells.load``'s); returns the result line."""
    config, mix = cell["config_data"], {**cell["mix"], **(mix_overrides or {})}
    kind = cells.traffic_kind(mix)
    state = kind.setup(config, mix, seed, device, precision)
    window = Window(seconds, device, trace_steps=mix["trace_steps"] if trace else 0)
    kind.drive(state, window)
    setup_s = window.t0 - t_start
    traced = breakdown = None
    if window.stretches:
        first = window.stretches[0]
        traced = devtrace.reduce(first["prof"].events(), first["window_s"], first["launches"],
                                 vg_calls=first["vg_calls"], steps=first["steps"],
                                 vg_flops=kind.vg_flops(state), host_vg_s=first["host_vg_s"])
        host = window.stretches[1:]
        breakdown = {"device_ops": traced.device_ops,
                     "idle_gaps": devtrace.idle_by_host(host[0]["prof"].events()) if host else []}
        window.stretches.clear()
    run = RunRecord(setup_s, window.window_s, window.steps, window.step_ms(), kind.vg_calls(state), state.chains,
                    kind.SAMPLER, traced)
    metrics = {}
    for name in cell["metrics"]:
        reader = cells.metric(name)
        if reader.END_TO_END != trace:
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = kind.failed(state)
    kind.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = kind.check(state, config, seed)
    limits = cell["limits"]
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    if traced is not None:
        dev |= {"busy_s": traced.busy_s, "window_s": traced.window_s}
    out = {"correct": correct, "attempted": run.steps, "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["counts"] = {"vg_calls": run.vg_calls, "steps": run.steps, "window_s": run.window_s, **window.host,
                     **({"traced_steps": traced.steps, "traced_vg_calls": traced.vg_calls} if traced else {})}
    out["readings"] = {k: v for k, v in readings.items() if k not in limits}  # reported, not compared
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} takes {cell['chips']} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}, which the benchmark may not", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
