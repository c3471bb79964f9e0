"""The port's spans and counters (``gogp_torch.utils.profiling``): the
shared no-op with no recording active, the tree a recording holds over
Adam's steps and over a ChEES transition under ``torch.func.vmap``, with
each span's step and call ids and the counters; values and gradients bit
for bit the same with a recording on and off; the precision rescue's and
the jitter loop's counters; and the host stamps mapped onto
``torch.profiler``'s clock.  All on the CPU, through the blocked route
under ``force_blocked(128)`` at n = 256."""

from __future__ import annotations

import statistics
import time

import pytest
import torch

from gogp_torch import GP, make_gp_logp, masked_value_and_grad, rbf, uniform_noise
from gogp_torch.infer import chees, mle
from gogp_torch.models.params import gp_observe
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg
from gogp_torch.utils import profiling
from gogp_torch.utils.profiling import count, host_read, recording, span

N, BLOCK = 256, 128
VG_CHILDREN = ["gp.cov", "lml.factor", "lml.solve", "vg.backward"]


def _data(n: int = N, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.sort(100.0 * torch.rand(n, generator=gen, dtype=torch.float64)).values
    return x, torch.sin(x / 3.0) + 0.1 * torch.randn(n, generator=gen, dtype=torch.float64)


def _gp():
    return GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)


def _fit_vg():
    x, y = _data()
    return masked_value_and_grad(make_gp_logp(_gp(), x=x[:, None], y=y))


def _chees_logp(chains: int = 4):
    x, y = _data()
    gp = _gp()
    logp = torch.func.vmap(lambda v: gp_observe(gp, v, x=x[:, None], y=y))
    x0 = torch.tensor([0.0, 2.0, -2.0], dtype=torch.float64) + 0.05 * torch.randn(
        (chains, 3), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    return logp, x0


def _transition(logp, x0):
    state = chees.chees_init(logp, x0, torch.Generator().manual_seed(2), 0.05, 0.2)
    return chees.chees_transition(logp, state, max_num_steps=8)


def _check_call(rec, call, step_id):
    """One ``vg`` span: its children, their ids, and the pullback's chain."""
    assert call.call == call.id and call.step == step_id
    kids = rec.children(call)
    assert sorted(s.name for s in kids) == sorted(VG_CHILDREN)
    (back,) = (s for s in kids if s.name == "vg.backward")
    (lml_back,) = rec.children(back)
    assert lml_back.name == "lml.backward"
    assert [s.name for s in rec.children(lml_back)] == ["lml.kinv"]
    inside = [s for s in rec.spans if s.call == call.id]
    assert len(inside) == 1 + len(VG_CHILDREN) + 2
    assert all(s.step == step_id for s in inside)
    assert all(s.end_ns >= s.start_ns and s.device_ms is None for s in inside)  # no device time on the CPU


def test_off_span_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched with no recording active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling._ACTIVE is None
    off = span("a")
    assert off is span("b", device=True) is host_read("adam_stop") is profiling._OFF
    with off as got:
        assert got is None
    count("vg_calls", 3)
    vg = _fit_vg()
    with cb.force_blocked(BLOCK):
        mle.adam(vg, torch.zeros(3, dtype=torch.float64), iters=2)
    assert profiling._ACTIVE is None


def test_recording_over_two_adam_steps():
    vg = _fit_vg()
    with cb.force_blocked(BLOCK), recording() as rec:
        mle.adam(vg, torch.zeros(3, dtype=torch.float64), iters=2)
    steps = rec.named("mle.step")
    assert len(steps) == 2
    for step in steps:
        assert step.parent is None and step.step == step.id and step.call is None
        kids = rec.children(step)
        assert [s.name for s in kids] == ["vg", "host_read.adam_stop"]
        call, read = kids
        _check_call(rec, call, step.id)
        assert read.step == step.id and read.call is None
        assert step.start_ns <= call.start_ns <= call.end_ns <= read.start_ns <= read.end_ns <= step.end_ns
    assert [s.id for s in rec.spans] == list(range(len(rec.spans)))
    assert rec.counters == {"vg_calls": 2, "host_reads.adam_stop": 2}
    assert set(rec.launches) == set(cb.LAUNCHES) and not any(rec.launches.values())
    assert rec.start_ns <= rec.spans[0].start_ns and rec.spans[-1].end_ns <= rec.end_ns
    assert all(s.epoch_start_ns == rec.epoch_ns(s.start_ns) for s in rec.spans)
    assert profiling._ACTIVE is None


def test_recording_over_a_vmapped_chees_transition():
    """4 chains in one vmapped log-joint: the covariance and the LML core's
    spans run once a call, on the physical batch, not once a chain."""
    logp, x0 = _chees_logp()
    with cb.force_blocked(BLOCK):
        state = chees.chees_init(logp, x0, torch.Generator().manual_seed(2), 0.05, 0.2)
        with recording() as rec:
            chees.chees_transition(logp, state, max_num_steps=8)
    (tr,) = rec.named("chees.transition")
    calls = rec.named("vg")
    assert calls and rec.counters["vg_calls"] == len(calls)
    assert rec.counters["host_reads.chees_steps"] == 1
    assert [s.name for s in rec.children(tr)] == ["host_read.chees_steps"] + ["vg"] * len(calls)
    for call in calls:
        assert call.parent == tr.id
        _check_call(rec, call, tr.id)
    for name in ("gp.cov", "lml.factor", "lml.solve", "lml.backward", "lml.kinv"):
        assert len(rec.named(name)) == len(calls), name


def test_values_and_gradients_bit_for_bit_with_a_recording():
    vg = _fit_vg()
    v0 = torch.tensor([0.1, 1.5, -1.0], dtype=torch.float64)
    logp, x0 = _chees_logp()
    with cb.force_blocked(BLOCK):
        off = (vg(v0), mle.adam(vg, v0, iters=3).x, _transition(logp, x0))
        with recording():
            on = (vg(v0), mle.adam(vg, v0, iters=3).x, _transition(logp, x0))
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert torch.equal(off[1], on[1])
    for a, b in zip(off[2][:5], on[2][:5]):  # positions, logps, grads, step size, inverse mass
        assert torch.equal(a, b)


def test_a_span_on_another_thread_joins_its_call():
    """On a card the autograd engine runs the backward on a thread of its
    own: a span opened there, with nothing open on that thread, nests in the
    innermost span open on its call's thread and carries the call's ids."""
    import threading

    with recording() as rec:
        with span("mle.step"), span("vg"), span("vg.backward") as back:
            opened = []

            def backward():
                with span("lml.backward") as s, span("lml.kinv") as k:
                    opened.extend((s, k))

            worker = threading.Thread(target=backward)
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
    step, call = rec.spans[:2]
    lml_back, kinv = opened
    assert lml_back.thread == kinv.thread != back.thread
    assert (lml_back.parent, kinv.parent) == (back.id, lml_back.id)
    assert {s.step for s in rec.spans} == {step.id} and lml_back.call == kinv.call == call.id
    assert all(s.end_ns is not None for s in rec.spans)


def test_rescue_and_jitter_counters(monkeypatch):
    """The precision rescue's read and recomputation, patched to meet a NaN
    on the fast path, and the jitter loop's reads."""
    real = cb._lml_forward
    calls = []

    def nan_first(*args):
        out = real(*args)
        calls.append(args[-1])
        return (out[0] * float("nan"), *out[1:]) if len(calls) == 1 else out

    monkeypatch.setattr(cb, "_lml_forward", nan_first)
    x, y = _data()
    K = rbf.scaled().matrix(torch.ones(2, dtype=torch.float64), x[:, None], x[:, None]) + 0.1 * torch.eye(N)
    with linalg.precision_rescue(min_n=0), cb.force_blocked(BLOCK), recording() as rec:
        value = linalg.lml_core(K, y, precision="tensorfloat32")
        linalg.cholesky_with_jitter(K)
        linalg.cholesky_with_jitter(-K, max_tries=2)
    assert torch.isfinite(value) and calls == [True, False]
    assert rec.counters == {"host_reads.rescue": 1, "rescues": 1, "host_reads.jitter": 3}
    assert [s.name for s in rec.spans] == ["lml.factor", "lml.solve", "host_read.rescue", "lml.factor", "lml.solve",
                                           *["host_read.jitter"] * 3]


def test_phase_timer_opens_a_span_and_recordings_do_not_nest():
    timer = profiling.PhaseTimer()
    with recording() as rec:
        with timer.phase("solve"), span("inner"):
            pass
        with pytest.raises(RuntimeError, match="already active"), recording():
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [("solve", None), ("inner", 0)]
    assert timer.counts["solve"] == 1 and "(1 calls" in timer.report()


def test_host_stamps_on_the_profilers_clock():
    """50 spans, each inside a ``record_function`` of a CPU profile, mapped
    by the recording's anchor pair onto the profiler's clock: every span lies
    inside the profiler's window and within 50 us of its
    ``record_function``'s interval, and their midpoints lie within 50 us of
    the ``record_function``s' at the median.  Midpoints, since the
    profiler's own cost on entry and on exit (under load, tens of us each)
    sits between the two starts and between the two ends alike."""
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.ones(64, 64)
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(50):
                with record_function(f"probe{i}"), span(f"probe{i}"):
                    a @ a
        stop_ns = time.time_ns()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("probe")}
    errors = []
    for s in rec.spans:
        lo, hi = (s.epoch_start_ns - t0) * 1e-3, (s.epoch_end_ns - t0) * 1e-3
        rf = ranges[s.name]
        assert 0.0 <= lo <= hi <= (stop_ns - t0) * 1e-3
        assert rf.start - 50.0 <= lo and hi <= rf.end + 50.0
        errors.append(abs((lo + hi) / 2 - (rf.start + rf.end) / 2))
    assert len(errors) == 50 and statistics.median(errors) < 50.0
