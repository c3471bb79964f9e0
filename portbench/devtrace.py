"""Reduce a ``torch.profiler`` trace of a steady stretch to what the
per-layer readers take: the device's busy time (the union of its
operations' intervals, as ``chip_smoke._device_busy_us`` takes it), each of
the port's kernels' device time beside the least time its launches need
(``work.bound_s`` at the shapes the launches were given), the libraries'
device time, the launches, and the breakdown the result line carries:
the operations with the most device time, and the device's idle gaps by
what the host was doing (from a second stretch that traced the host too).

A kernel's shape is not in the trace (the port launches through ctypes), so
:class:`LaunchRecorder` wraps ``cholesky_blocked._launch`` while the trace
runs and keeps each launch's entry point and size arguments.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

from portbench import work

_IDENT = re.compile(r"([A-Za-z_]\w*)[<(]")


def kernel_of(name: str) -> str | None:
    """K1-K7 for a device event of one of the port's kernels, else None:
    the first identifier of the demangled name that a template argument
    list or a parameter list follows."""
    m = _IDENT.search(name)
    return work.KERNEL_OF_SYMBOL.get(m.group(1)) if m else None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_torch(name: str) -> bool:
    """PyTorch's own device code (elementwise, reductions, copies)."""
    return "at::" in name or "c10::" in name or is_copy(name)


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, start, end = 0.0, None, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (0.0 if end is None else end - start)


def idle_gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    gaps, cursor = [], lo
    for s, e in sorted(spans):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


class LaunchRecorder:
    """Within ``with``: every launch of the port's kernels as (kernel, work
    key, shape), in launch order."""

    def __init__(self):
        self.launches: list[tuple[str, str, tuple]] = []

    def __enter__(self):
        from gogp_torch.ops import cholesky_blocked as cb

        self._cb, self._orig = cb, cb._launch
        orig, launches = self._orig, self.launches

        def recording(t, name, *args):
            import torch

            if t.device.index == torch.cuda.current_device():  # else orig re-enters here on the right device
                kernel, key, shape = work.ENTRY_SHAPES[name]
                launches.append((kernel, key, tuple(int(s) for s in shape(args))))
            return orig(t, name, *args)

        cb._launch = recording
        return self

    def __exit__(self, *exc):
        self._cb._launch = self._orig


@dataclasses.dataclass
class Trace:
    """One traced stretch of the device, reduced.  Times in seconds."""

    window_s: float
    busy_s: float
    device_launches: int  # kernels, not copies
    kernels: dict  # "K1".. -> {"device_s", "events", "launches", "bound_s"}
    library_s: float  # device time of kernels that are neither the port's nor PyTorch's
    vg_calls: int
    steps: int
    vg_flops: float  # of one value-and-gradient call
    host_vg_s: float  # host time inside the value-and-gradient calls of the stretch
    device_ops: list  # [[name, seconds]] of the operations with the most device time


def reduce(events, window_s: float, launches, *, vg_calls: int, steps: int, vg_flops: float, host_vg_s: float,
           top: int = 10) -> Trace:
    """``events``: the profiler's FunctionEvents of a stretch that traced
    the device alone, bracketed by synchronizes ``window_s`` apart."""
    import torch

    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    kernels, library_us, by_name = {}, 0.0, {}
    for e in device:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        k = kernel_of(e.name)
        if k is not None:
            row = kernels.setdefault(k, {"device_s": 0.0, "events": 0, "launches": 0, "bound_s": 0.0})
            row["device_s"] += us * 1e-6
            row["events"] += 1
        elif not is_torch(e.name):
            library_us += us
    for k, key, shape in launches:
        row = kernels.setdefault(k, {"device_s": 0.0, "events": 0, "launches": 0, "bound_s": 0.0})
        row["launches"] += 1
        row["bound_s"] += work.bound_s(key, shape)[0]
    busy_us = union_length((e.time_range.start, e.time_range.end) for e in device)
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6,
                 device_launches=sum(1 for e in device if not is_copy(e.name)), kernels=kernels,
                 library_s=library_us * 1e-6, vg_calls=vg_calls, steps=steps, vg_flops=vg_flops,
                 host_vg_s=host_vg_s,
                 device_ops=[[n[:160], us * 1e-6] for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]])


def idle_by_host(events, top: int = 10) -> list:
    """[[host operation, seconds]]: the device's idle time within the
    ``portbench.traced_window`` annotation of a stretch that traced the host
    too, each gap put to the innermost host operation running at its
    middle, summed by operation, the largest first."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rf = next(e for e in events if e.name == "portbench.traced_window" and e.device_type != cuda)
    lo, hi = rf.time_range.start, rf.time_range.end
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
             if e.device_type == cuda and not e.is_user_annotation and e.time_range.end > lo and e.time_range.start < hi]
    host = sorted((e for e in events if e.device_type != cuda), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_host = {}
    for a, b in sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:1000]:
        label = _host_label(host, starts, (a + b) / 2)
        by_host[label] = by_host.get(label, 0.0) + (b - a)
    return [[n[:160], us * 1e-6] for n, us in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]]


def _host_label(host, starts, t: float, scan: int = 5000) -> str:
    """The innermost host event running at ``t``: of those that started by
    then and had not ended, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - scan):i]):
        if e.time_range.end >= t:
            return e.name
    return "(no host event)"
