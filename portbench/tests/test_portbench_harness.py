"""The harness on the CPU: cells found by name (a new one from files alone),
BENCHMARK.json against the cells' and metrics' files, each traffic kind
driven end to end at a tiny size, each of a cell's faults planted under the
timed path and caught, and the run refusing to start without a card.

A run here skips the look for a card: ``run.run_cell`` on the CPU, the
data in float64 so that the port's CPU path reads far inside every limit.
"""

import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import cells, run
from portbench.traffic import fit as tfit
from portbench.window import Kept

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CPU = torch.device("cpu")
TINY = {
    "fit": {"n": 64, "trace_steps": 0},
    "chees": {"n": 48, "mle_steps": 30, "trace_steps": 0},
}
SECONDS = {"fit": 1.5, "chees": 4.0}  # enough steps on a CPU that other tests share
torch.set_num_threads(1)  # a worker's tiny operations on many threads stall where workers share the cores


@pytest.fixture
def f64_data(monkeypatch):
    """The traffic's data in float64: the port then runs its CPU path in
    float64 and every reading is rounding."""
    make = tfit.make_data

    def make64(n, seed, device):
        x, y, gen = make(n, seed, device)
        return x.double(), y.double(), gen

    monkeypatch.setattr(tfit, "make_data", make64)
    monkeypatch.setattr("portbench.traffic.chees.make_data", make64)


def _run(name, seed=2**31 + 5, **overrides):
    cell = cells.load(name)
    return run.run_cell(cell, seed, SECONDS[cell["mix"]["kind"]], False, CPU, time.perf_counter(),
                        mix_overrides={**TINY[cell["mix"]["kind"]], **overrides})


def _cells():
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def test_benchmark_json_matches_the_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["portbench"]
    names = {w["name"] for w in bench["workloads"]}
    assert names <= set(_cells())
    for w in bench["workloads"]:
        c = cells.load(w["name"])
        assert (c["config"], c["traffic"], c["chips"], c["why"]) == (w["config"], w["traffic"], w["chips"], w["why"])
        assert c["config_data"]["name"] == w["config"]
    for cfg in bench["configs"]:
        data = json.loads((ROOT / cfg["file"]).read_text())
        assert (data["source"], data["reduced"]) == (cfg["source"], cfg["reduced"])
    everywhere = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = cells.metric(m["name"])
        assert reader.UNIT == m["unit"]
        assert reader.END_TO_END == (m in bench["end_to_end"])
        # a cell's file lists exactly the metrics BENCHMARK.json gives it
        for w in everywhere:
            assert (m["name"] in cells.load(w)["metrics"]) == (w in m.get("workloads", everywhere)), (m, w)
    e2e = {m["name"]: m.get("workloads", everywhere) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= set(e2e[m["moves"]])


@pytest.mark.parametrize("name", _cells())
def test_cell_runs_and_is_correct(name, f64_data):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    e2e = {m for m in cells.load(name)["metrics"] if cells.metric(m).END_TO_END}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checks"
    assert all(c["limit"] is not None for c in out["checks"].values())


@pytest.mark.parametrize("name", _cells())
def test_traced_run(name, f64_data):
    """The traced run's two stretches (the device's, then the host's), their
    reduction and the breakdown, driven on the CPU, where the profiler
    traces the host alone."""
    cell = cells.load(name)
    out = run.run_cell(cell, 3, 2 * SECONDS[cell["mix"]["kind"]], True, CPU, time.perf_counter(),
                       mix_overrides={**TINY[cell["mix"]["kind"]], "trace_steps": 3})
    assert out["correct"] and out["counts"]["traced_steps"] == 3
    assert out["counts"]["traced_vg_calls"] >= 3
    listed = set(cells.load(name)["metrics"])
    assert {m for m in out["metrics"] if m.split(".")[0] in ("idle_pct", "launches_per_vg", "vg_mfu_pct")}
    assert set(out["metrics"]) <= listed and not any(cells.metric(m).END_TO_END for m in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["idle_gaps"]  # the CPU run has no device event: all of it is a gap
    assert out["device"]["window_s"] > 0


def test_a_cell_added_as_files(tmp_path):
    """A copy of the harness with one more cell, mix and configuration (the
    GP with a prior of other parameters, so a MAP fit, and a sampler over
    it), as files only: found by name, run without an edit, the
    configuration's model choosing the program's log-density and the
    reference's."""
    copy = tmp_path / "portbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((HERE / "configs" / "gp_rbf_priors.json").read_text())
    config.update(name="gp_rbf_wide", model={**config["model"], "prior": {"family": "normal", "args": [0.5, 2.0]}})
    (copy / "configs" / "gp_rbf_wide.json").write_text(json.dumps(config))
    (copy / "traffic" / "fit_n96.json").write_text(json.dumps(
        {"kind": "fit", "n": 96, "adam_steps": 5, "rate": 0.02, "trace_steps": 2, "check_steps": 2}))
    for kind, traffic in (("fit", "fit_n96"), ("chees", "chees_c64n1024")):
        cell = json.loads(next((HERE / "workloads").glob(f"*.{kind}.json")).read_text())
        cell.update(config="gp_rbf_wide", traffic=traffic, why="a tiny cell")
        (copy / "workloads" / f"gp_rbf_wide.{kind}.json").write_text(json.dumps(cell))
    code = (f"import sys, time, torch; sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {str(ROOT)!r})\n"
            "import portbench\n"
            f"assert portbench.__file__.startswith({str(tmp_path)!r})\n"
            "from portbench import cells, run\n"
            "from portbench.traffic import fit\n"
            "make = fit.make_data\n"
            "fit.make_data = lambda *a: tuple(t.double() for t in make(*a)[:2]) + (make(*a)[2],)\n"
            "import portbench.traffic.chees as chees; chees.make_data = fit.make_data\n"
            "for name, over in (('gp_rbf_wide.fit', {}), ('gp_rbf_wide.chees', {'n': 48, 'mle_steps': 30})):\n"
            "    out = run.run_cell(cells.load(name), 7, 3.0, False, torch.device('cpu'), time.perf_counter(),\n"
            "                       mix_overrides={**over, 'trace_steps': 0})\n"
            "    print(name, out['attempted'], out['correct'], sorted(out['checks']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [line.split(" ", 3) for line in res.stdout.strip().splitlines()]
    assert [ln[0] for ln in lines] == ["gp_rbf_wide.fit", "gp_rbf_wide.chees"]
    assert int(lines[0][1]) > 5 and int(lines[1][1]) >= 2  # more than one fit of five steps; transitions
    assert all(ln[2] == "True" for ln in lines), res.stdout


def test_prior_moves_both_sides(f64_data, monkeypatch):
    """A prior of other parameters changes what the program computes and
    what the reference expects alike: the fit cell stays correct."""
    cell = cells.load("gp_rbf.n16384.fit")
    model = {**cell["config_data"]["model"], "prior": {"family": "normal", "args": [0.5, 2.0]}}
    cell["config_data"] = {**cell["config_data"], "model": model}
    out = run.run_cell(cell, 11, SECONDS["fit"], False, CPU, time.perf_counter(), mix_overrides=TINY["fit"])
    assert out["correct"], out["checks"]
    plain = cells.load("gp_rbf.n16384.fit")
    # the reference of the plain GP judges the MAP fit's values wrong
    from portbench.reference import gp as ref

    real = ref.log_density
    monkeypatch.setattr(ref, "log_density", lambda config: real(plain["config_data"]))
    out = run.run_cell(cell, 11, SECONDS["fit"], False, CPU, time.perf_counter(), mix_overrides=TINY["fit"])
    assert not out["correct"]


@pytest.mark.parametrize("first, k, n", [(4, 3, 2), (4, 3, 6), (1, 8, 500), (0, 5, 5)])
def test_kept(first, k, n):
    """The reservoir keeps the first steps, and k of the rest drawn from the
    seed: the same seed, the same steps."""
    def keep(seed):
        kp = Kept(first, k, seed)
        for i in range(n):
            kp.offer(-i)
        return kp.items()

    got = keep(7)
    assert [i for i, _ in got][:min(first, n)] == list(range(min(first, n)))
    assert len(got) == min(n, first + k) and all(item == -i for i, item in got)
    assert got == keep(7)
    if n > first + k + 100:
        assert got != keep(8)


def _fault_fit_state_unchanged(monkeypatch):
    from gogp_torch.infer import mle

    real = mle.adam_update
    monkeypatch.setattr(mle, "adam_update", lambda g, s, rate, *a, **k: (
        tuple(torch.zeros_like(u) for u in real(g, s, rate, *a, **k)[0]), real(g, s, rate, *a, **k)[1]))


def _fault_half_the_data(monkeypatch):
    """The log-likelihood of every other point, doubled: half of the batch
    left out, the mean taken over the rest."""
    from gogp_torch.models import params

    real = params.lml

    def half(gp, ts, tn, x, y, mask=None, precision=None):
        return 2.0 * real(gp, ts, tn, x[::2], y[::2], None if mask is None else mask[::2], precision)

    monkeypatch.setattr(params, "lml", half)


def _fault_value_altered(monkeypatch):
    """The value, as the program produces it, off by a part in 1e4."""
    from gogp_torch.models import params

    real = params.lml
    monkeypatch.setattr(params, "lml", lambda *a, **k: real(*a, **k) * (1 + 1e-4))


def _fault_chees_state_unchanged(monkeypatch):
    from gogp_torch.infer import chees

    monkeypatch.setattr(chees, "chees_transition", lambda logp, state, **k: state._replace(step=state.step + 1))


def _fault_chees_half_batch_gradient(monkeypatch):
    """Chains B/2 to B-1 kicked with chains 0 to B/2-1's gradient: a finite
    gradient, of a likely size, wrong in half of the chain batch."""
    from gogp_torch.infer import chees

    real = chees.value_and_grad

    def vg(logp, free):
        f = real(logp, free)

        def wrong(q):
            val, g = f(q)
            half = g.shape[0] // 2
            return val, torch.cat([g[:g.shape[0] - half], g[:half]])

        return wrong

    monkeypatch.setattr(chees, "value_and_grad", vg)


def _fault_chees_position_altered(monkeypatch):
    """One chain's position, as the transition produces it, moved by 1e-4."""
    from gogp_torch.infer import chees

    real = chees.chees_transition

    def moved(logp, state, **k):
        out = real(logp, state, **k)
        return out._replace(positions=out.positions + torch.nn.functional.one_hot(
            torch.tensor(0), out.positions.shape[0])[:, None].to(out.positions) * 1e-4)

    monkeypatch.setattr(chees, "chees_transition", moved)


FAULTS = {
    "gp_rbf.n16384.fit": [_fault_fit_state_unchanged, _fault_half_the_data, _fault_value_altered],
    "gp_rbf_priors.c64n1024.chees": [_fault_chees_state_unchanged, _fault_half_the_data,
                                    _fault_chees_half_batch_gradient, _fault_chees_position_altered],
}


@pytest.mark.parametrize("name, fault", [(n, f) for n, fs in FAULTS.items() for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_caught(name, fault, monkeypatch, f64_data):
    fault(monkeypatch)
    out = _run(name)
    assert not out["correct"]
    assert any(not (math.isfinite(c["value"]) and c["value"] <= c["limit"]) for c in out["checks"].values())


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints no result; so
    does a checkout that holds only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gp_rbf.n16384.fit", "--seed", "1",
                              "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=cwd,
                             timeout=300)
        assert res.returncode != 0
        assert res.stdout.strip() == ""
