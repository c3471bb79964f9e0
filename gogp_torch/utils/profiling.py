"""Profiling and phase timing.

PyTorch twin of ``gogp_tpu/utils/profiling.py``: ``torch.profiler`` device
traces where the JAX package has ``jax.profiler``, and host-side phase
walltime counters that wait for the card so that the numbers mean what they
say (``torch.cuda.synchronize`` where JAX blocks on its outputs).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class PhaseTimer:
    """Accumulates walltime per named phase; device-synchronized."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: object = None) -> Iterator[None]:
        """Time a phase.  Pass the phase's output tensors as ``sync`` to wait
        until the card has actually finished them."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and _cuda_in_use():
                torch.cuda.synchronize()  # one synchronize covers every tensor of the stream
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name] * 1e3:.2f} ms "
            f"({self.counts[name]} calls, "
            f"{self.totals[name] * 1e3 / max(self.counts[name], 1):.2f} ms/call)"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace of the CPU and, where one is in use, the
    card, written to ``log_dir`` as a Chrome trace (TensorBoard's profiler
    plugin reads it); yields the profiler, whose ``key_averages()`` gives
    the per-operator table."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def timed(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Median time (ms) of ``fn(*args)``.  On a card: CUDA events around
    each call after a synchronize, so the time is the card's from the first
    launch to the last; on the CPU, the host's clock."""
    for _ in range(warmup):
        fn(*args)
    cuda = _cuda_in_use()
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]
