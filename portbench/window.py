"""The measured window: step marks, its close, and the traced stretches.

The traffic calls :meth:`Window.step` where each step begins, at a point
where its loop already waits for the card (the fit's host read of Adam's
stop flag, the ChEES transition's read of its step count), so the marks add
no synchronize.  On the card a mark is a CUDA event: a step's time is the
device clock's between two marks.  The window closes at the first step
that begins ``seconds`` after it opened: :meth:`step` then raises
:class:`Closed`, and the steps before it are the window's.

With ``trace_steps`` the profiler runs over two stretches of that many
whole steps each, from the ``trace_from``-th on, each bracketed by
synchronizes (a traced run reports no end-to-end metric).  The first
traces the device alone, with the port's launches recorded beside it: its
kernels, their times and the gaps between them, at the host's own pace.
The second traces the host's operations too, which slows the host; it only
names what the host was doing in each gap of the device's.

While the window is open the harness holds the host still: Python's
collector is off (what set-up left is frozen out of its generations), the
main thread, which makes every launch, is pinned to one core, and the steps
that the check will judge are all the traffic keeps (:class:`Kept`).  The
process's CPU time and involuntary context switches over the window are
recorded (:attr:`Window.host`), to tell the host's own speed from the
harness's.
"""

from __future__ import annotations

import gc
import os
import random
import resource
import time

import torch


class Closed(Exception):
    """The window has closed; raised from :meth:`Window.step`."""


class Kept:
    """The steps a check judges, kept as the window runs: the first
    ``first`` of them, and a uniform sample of ``k`` of the rest, drawn
    from ``seed`` by reservoir sampling (Algorithm R).  So the traffic holds
    a fixed number of steps however many the window runs."""

    def __init__(self, first: int, k: int, seed: int):
        self.first, self.k = first, k
        self._rng = random.Random(seed)
        self.seen = 0
        self._kept: list[tuple[int, object]] = []

    def offer(self, item) -> None:
        i, self.seen = self.seen, self.seen + 1
        j = i - self.first
        if j < self.k:
            self._kept.append((i, item))
        else:
            r = self._rng.randrange(j + 1)
            if r < self.k:
                self._kept[self.first + r] = (i, item)

    def items(self) -> list[tuple[int, object]]:
        """(index, item) of each step kept, in window order."""
        return sorted(self._kept, key=lambda t: t[0])


class Window:
    def __init__(self, seconds: float, device: torch.device, trace_steps: int = 0, trace_from: int = 2):
        self.seconds, self.device = seconds, device
        self.trace_steps, self.trace_from = trace_steps, trace_from
        self.marks: list = []  # one a step start, and one at the close
        self.t0 = self.t_end = None
        self.tracing = self._host = False
        self.stretches: list[dict] = []  # the traced stretches, the device's first
        self.vg_spans: list[tuple[float, float]] = []  # host (enter, exit) of vg calls in the device's stretch
        self.host: dict = {}  # the process's CPU seconds and involuntary switches over the window

    @property
    def steps(self) -> int:
        """Steps begun so far (after the close: completed in the window)."""
        return len(self.marks) - (self.t_end is not None)

    def _mark(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def open(self) -> None:
        if self.trace_steps:  # the profiler's first start takes seconds: pay it before the window
            from torch.profiler import profile

            with profile(activities=self._activities(host=True)):
                torch.ones(1, device=self.device).add_(1)
        self._sync()
        gc.collect()
        gc.freeze()
        gc.disable()
        self._affinity = os.sched_getaffinity(0)
        if self.device.type == "cuda":  # on the CPU the main thread computes, beside torch's own threads
            os.sched_setaffinity(0, {max(self._affinity)})
        self._usage = resource.getrusage(resource.RUSAGE_SELF)
        self.t0 = time.perf_counter()

    def step(self) -> None:
        """Mark the start of a step, or close the window and raise Closed."""
        if self.tracing and self.steps == self._trace_first + self.trace_steps:
            self._stop_trace()
        if time.perf_counter() - self.t0 >= self.seconds:
            self.close()
            raise Closed
        if (self.trace_steps and not self.tracing and len(self.stretches) < 2
                and self.steps == self.trace_from + len(self.stretches) * self.trace_steps):
            self._start_trace(host=bool(self.stretches))
        self._mark()

    def close(self) -> None:
        if self.tracing:
            self._stop_trace()
        self._sync()
        self._mark()
        self.t_end = time.perf_counter()
        u0, u1 = self._usage, resource.getrusage(resource.RUSAGE_SELF)
        if self.device.type == "cuda":
            os.sched_setaffinity(0, self._affinity)
        gc.enable()
        gc.unfreeze()
        self.host = {"cpu_s": (u1.ru_utime + u1.ru_stime) - (u0.ru_utime + u0.ru_stime),
                     "involuntary_switches": u1.ru_nivcsw - u0.ru_nivcsw}

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def step_ms(self) -> list[float]:
        """Each completed step's time, ms."""
        m = self.marks
        if self.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]

    def vg_enter(self) -> float | None:
        return time.perf_counter() if self.tracing and not self._host else None

    def vg_exit(self, t: float | None) -> None:
        if t is not None:
            self.vg_spans.append((t, time.perf_counter()))

    def _activities(self, host: bool) -> list:
        """What a stretch traces: the device, and the host with ``host``
        (on a machine without a card, which only the tests run, the host
        alone)."""
        from torch.profiler import ProfilerActivity

        on_card = self.device.type == "cuda"
        return [ProfilerActivity.CUDA] * on_card + [ProfilerActivity.CPU] * (host or not on_card)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_trace(self, host: bool) -> None:
        from torch.profiler import profile, record_function

        from portbench.devtrace import LaunchRecorder

        self._sync()
        self._prof = profile(activities=self._activities(host))
        self._prof.start()
        self._host = host
        if host:
            self._ctx = record_function("portbench.traced_window")
        else:
            self._ctx = LaunchRecorder()
            self.vg_spans.clear()
        self._ctx.__enter__()
        self.tracing, self._trace_first = True, self.steps
        self._t_trace = time.perf_counter()

    def _stop_trace(self) -> None:
        self._sync()
        t_stop = time.perf_counter()
        self._ctx.__exit__(None, None, None)
        self._prof.stop()
        self.tracing = False
        self.stretches.append({
            "host": self._host, "prof": self._prof, "steps": self.steps - self._trace_first,
            "window_s": t_stop - self._t_trace, "launches": None if self._host else self._ctx.launches,
            "vg_calls": len(self.vg_spans), "host_vg_s": sum(b - a for a, b in self.vg_spans)})
