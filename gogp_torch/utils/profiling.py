"""Profiling, phase timing, and the port's own spans and counters.

PyTorch twin of ``gogp_tpu/utils/profiling.py``: ``torch.profiler`` device
traces where the JAX package has ``jax.profiler``, and host-side phase
walltime counters that wait for the card so that the numbers mean what they
say (``torch.cuda.synchronize`` where JAX blocks on its outputs).

Recording a run.  Inside ``with recording() as rec:`` the port's hot paths
store a :class:`Span` for each stage they enter and add to named counters;
outside one, :func:`span` returns one shared object that does nothing and
:func:`count` returns at once, so the paths carry them at next to no cost.
Each span holds its name, an id and its parent's, its thread, the ids of
the step (``mle.step`` or ``chees.transition``) and of the
value-and-gradient call (``vg``) it belongs to, its host start and end
(``time.perf_counter_ns``, and, once the recording stops, the same instants
on the epoch clock that ``torch.profiler``'s events carry), and, for a
device-timed span on a card, the device milliseconds between two CUDA
events recorded on the current stream at its ends (its kernels and any
device idle between them).  A span opened on another thread than its call's
(the autograd engine's, on a card) takes the call's innermost open span as
its parent.  ``rec.launches`` is the launches of the port's kernels made
inside the recording (:data:`gogp_torch.ops.cholesky_blocked.LAUNCHES`).

The spans (device-timed ones marked *):

    mle.step             an iteration of ``mle.adam_batched`` (``mle.adam`` too)
    chees.transition     ``chees.chees_transition``
    vg*                  the value-and-gradient closures of
                         ``infer.hmc.value_and_grad`` and
                         ``models.masked_value_and_grad``
    vg.backward*         their ``torch.autograd.grad`` call
    gp.cov*              ``gp.core.masked_cov``
    lml.factor*          the LML core's factorization (K1, the stepwise
                         driver, or ``cholesky_ex`` and K5 over a stack)
    lml.solve*           its K3/K4 solves
    lml.backward*        the LML core's whole pullback
    lml.kinv*            K^-1 = W^T W within it
    host_read.<what>     a read of a device value to the host: ``adam_stop``
                         (Adam's stop flag), ``chees_steps`` (a transition's
                         step count), ``rescue`` (the precision rescue's
                         test), ``jitter`` (``cholesky_with_jitter``'s test)
    <phase>              each :meth:`PhaseTimer.phase`

The counters: ``vg_calls``, ``host_reads.<what>`` (one a
``host_read.<what>`` span) and ``rescues`` (each recomputation at full f32
by the precision rescue).  ``rescues`` and ``host_reads.rescue`` and
``.jitter`` stay at 0 on f32 paths: they are for an operator who runs at
TF32 or with ``robust=True``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
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
        with span(name):
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


# -- spans and counters (module docstring) -------------------------------------

_STEP_SPANS = frozenset({"mle.step", "chees.transition"})
_CALL_SPAN = "vg"


@dataclasses.dataclass(eq=False)
class Span:
    """One stage entered while a recording was active.  ``id`` is its index
    in :attr:`Recording.spans`; ``end_ns`` is None for a span still open
    when the recording stopped; ``device_ms`` is None but for a
    device-timed span on a card."""

    name: str
    id: int
    parent: int | None
    thread: int
    step: int | None
    call: int | None
    start_ns: int  # time.perf_counter_ns()
    end_ns: int | None = None
    epoch_start_ns: int | None = None  # time.time_ns()'s clock, as torch.profiler's events
    epoch_end_ns: int | None = None
    device_ms: float | None = None


class Recording:
    """What :func:`recording` stored: ``spans`` in the order they began,
    ``counters``, ``launches`` (each entry of ``cholesky_blocked.LAUNCHES``
    by how much it grew), and the recording's own ``start_ns`` / ``end_ns``
    (perf_counter) and ``epoch_start_ns`` / ``epoch_end_ns``."""

    def __init__(self, launches0: dict):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = defaultdict(int)
        self.launches: dict[str, int] = {}
        self._launches0 = launches0
        self._ids = itertools.count()
        self._stacks: dict[int, list[Span]] = {}
        self._steps: list[Span] = []
        self._calls: list[Span] = []
        self._events: dict[int, list] = {}
        self._cuda = _cuda_in_use()
        self.end_ns = self.epoch_end_ns = None
        self.start_ns, self.epoch_start_ns = time.perf_counter_ns(), time.time_ns()  # the anchor pair

    def epoch_ns(self, perf_ns: int) -> int:
        """A ``time.perf_counter_ns()`` stamp on the epoch clock."""
        return self.epoch_start_ns + (perf_ns - self.start_ns)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, parent: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == parent.id]

    def _open(self, name: str, device: bool) -> Span:
        tid = threading.get_ident()
        own = self._stacks.setdefault(tid, [])
        call = self._calls[-1] if self._calls else None
        # a thread with nothing open (the autograd engine's) nests in its call's thread
        chain = own or (self._stacks[call.thread] if call is not None else [])
        s = Span(name, next(self._ids), chain[-1].id if chain else None, tid,
                 self._steps[-1].id if self._steps else None, call.id if call is not None else None, 0)
        if name in _STEP_SPANS:
            s.step = s.id
            self._steps.append(s)
        elif name == _CALL_SPAN:
            s.call = s.id
            self._calls.append(s)
        own.append(s)
        self.spans.append(s)
        if device and self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[s.id] = [ev, None]
        s.start_ns = time.perf_counter_ns()
        return s

    def _close(self, s: Span) -> None:
        if self.end_ns is not None:  # stopped: the span stays open
            return
        s.end_ns = time.perf_counter_ns()
        if s.id in self._events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[s.id][1] = ev
        self._stacks[s.thread].pop()
        for opened in (self._steps, self._calls):
            if opened and opened[-1] is s:
                opened.pop()

    def _stop(self, launches1: dict) -> None:
        self.end_ns = time.perf_counter_ns()
        self.epoch_end_ns = self.epoch_ns(self.end_ns)
        self.launches = {k: launches1[k] - self._launches0.get(k, 0) for k in launches1}
        self.counters = dict(self.counters)
        if self._events:
            torch.cuda.synchronize()
        for s in self.spans:
            s.epoch_start_ns = self.epoch_ns(s.start_ns)
            if s.end_ns is not None:
                s.epoch_end_ns = self.epoch_ns(s.end_ns)
            start, end = self._events.get(s.id, (None, None))
            if end is not None:
                s.device_ms = start.elapsed_time(end)
        self._events.clear()


class _Off:
    """The span of no recording: shared, it stores nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ACTIVE: Recording | None = None


class _On:
    __slots__ = ("rec", "name", "device", "span")

    def __init__(self, rec: Recording, name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self) -> Span:
        self.span = self.rec._open(self.name, self.device)
        return self.span

    def __exit__(self, *exc):
        self.rec._close(self.span)
        return False


def span(name: str, device: bool = False):
    """A context manager that records the stage ``name`` while a recording
    is active (with ``device``, its device time too), else the shared
    no-op."""
    rec = _ACTIVE
    return _OFF if rec is None else _On(rec, name, device)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the active recording's counter ``name``, if any."""
    rec = _ACTIVE
    if rec is not None:
        rec.counters[name] += k


def host_read(what: str):
    """The span ``host_read.<what>`` around a read of a device value to the
    host, counted in ``host_reads.<what>``."""
    rec = _ACTIVE
    if rec is None:
        return _OFF
    rec.counters["host_reads." + what] += 1
    return _On(rec, "host_read." + what, False)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the port's spans and counters until the ``with`` ends; the
    :class:`Recording` is complete once it has (device times read, one
    synchronize)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already active")
    from gogp_torch.ops import cholesky_blocked as cb

    rec = Recording(dict(cb.LAUNCHES))
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._stop(dict(cb.LAUNCHES))
