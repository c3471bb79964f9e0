"""Find a cell's files by name.

A cell is ``workloads/<cell>.json``: its configuration's name, its traffic
mix's name, the chips it takes, why it exists, the metrics it reports, and
the limit of each number its check compares.  The configuration is
``configs/<config>.json``; the mix is ``traffic/<traffic>.json``, whose
``kind`` names the generator module ``traffic/<kind>.py`` that reads it;
each metric's reader is ``metrics/<metric>.py``.  A cell, a mix or a metric
is added by adding its files.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _read(folder: str, name: str) -> dict:
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path.relative_to(HERE.parent)})")
    return json.loads(path.read_text())


def load(cell: str) -> dict:
    """The cell's file, with its configuration under ``config_data`` and
    its mix under ``mix``."""
    c = _read("workloads", cell)
    c["config_data"] = _read("configs", c["config"])
    c["mix"] = _read("traffic", c["traffic"])
    return c


def traffic_kind(mix: dict):
    return importlib.import_module(f"portbench.traffic.{mix['kind']}")


def metric(name: str):
    """The reader of a metric: ``metrics/<name>.py``, or for ``<base>.<cells>``
    (one quantity split by the cells that report it, each part with a
    bound of its own) ``metrics/<base>.py``."""
    base = name.split(".")[0]
    if not _NAME.fullmatch(base) or not (HERE / "metrics" / f"{base}.py").is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r}")
    return importlib.import_module(f"portbench.metrics.{base}")
