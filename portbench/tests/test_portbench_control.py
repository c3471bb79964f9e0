"""The check's control and faults, on the card at each cell's own size.

The control is the program's own TF32 path (``precision="tensorfloat32"``,
the blocked drivers' and pullbacks' cuBLAS matmuls in TF32), the step
below the float32 the configurations state; every cell's check has to find
it not correct, on three seeds.  The fit cells are training: each also has
to find each of its faults not correct, planted in the program at the
cell's size, on three seeds; so does the ChEES cell the half of its chain
batch kicked with the other half's gradient, which a median over chains
would pass.  Each run prints its readings as one JSON line (``pytest
-s``): the control's are the upper readings its limits were set below.
Run on the card:

    python -m pytest -s -p no:cacheprovider portbench/tests/test_portbench_control.py
"""

import json
import time

import pytest
import torch

from portbench import cells, run
from portbench.tests.test_portbench_harness import (_fault_chees_half_batch_gradient, _fault_fit_state_unchanged,
                                                     _fault_half_the_data, _fault_value_altered)

SEEDS = (3141592653, 2718281828, 1618033988)
SECONDS = {"fit": 6.0, "chees": 12.0}  # long enough to check as many steps as a run does


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _run(name, seed, device, precision=None):
    cell = cells.load(name)
    out = run.run_cell(cell, seed, SECONDS[cell["mix"]["kind"]], False, device, time.perf_counter(),
                       precision=precision)
    return out


def _report(tag, name, seed, out):
    print(json.dumps({"tag": tag, "cell": name, "seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                      "checks": {k: c["value"] for k, c in out["checks"].items()}, "readings": out["readings"]}))


CELLS = sorted(p.stem for p in (cells.HERE / "workloads").glob("*.json"))
FAULTS = {"fit": (_fault_fit_state_unchanged, _fault_half_the_data, _fault_value_altered),
          "chees": (_fault_chees_half_batch_gradient,)}
CELL_FAULTS = [(c, f) for c in CELLS for f in FAULTS[cells.load(c)["mix"]["kind"]]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda):
    for seed in SEEDS:
        out = _run(name, seed, cuda, precision="tensorfloat32")
        _report("control_tf32", name, seed, out)
        assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name, fault", CELL_FAULTS, ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_not_correct(name, fault, cuda, monkeypatch):
    fault(monkeypatch)
    for seed in SEEDS:
        out = _run(name, seed, cuda)
        _report(fault.__name__, name, seed, out)
        assert not out["correct"]
