"""CSV data loading and forecast output.

PyTorch-package twin of ``gogp_tpu/tutorial/io.py`` (the reference's
``load``, tutorial/tutorial.go:234-272, and its per-row forecast output,
:185-197).  Host code on numpy, and the command lines' ``--platform``
device.  ``load_csv`` parses with the native C++ parser
(:mod:`gogp_torch.utils.native`, built at first use) where a C++ compiler
is present, and with Python otherwise or where the native parser rejects the
text, as the twin falls back; a failed build raises.
"""

from __future__ import annotations

import io as _io
import sys
from typing import IO, Iterable

import numpy as np
import torch

from gogp_torch.utils import native


def load_csv(rdr: IO[str] | str) -> tuple[np.ndarray, np.ndarray]:
    """Parse rows of ``x0,...,xk,y`` floats -> (X (n, k), Y (n,)): every
    column but the last is an input coordinate."""
    if isinstance(rdr, str):
        rdr = _io.StringIO(rdr)
    text = rdr.read()
    data = None
    if native.available():
        try:
            data = native.parse_csv(text)
        except ValueError:  # as the twin: the Python parser has the last word
            data = None
    if data is None:
        rows = [[float(f) for f in line.split(",")] for line in map(str.strip, text.splitlines()) if line]
        data = np.asarray(rows, dtype=np.float64) if rows else np.zeros((0, 1))
    if data.size == 0:
        return np.zeros((0, 1)), np.zeros((0,))
    return data[:, :-1], data[:, -1]


def normalize(y: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Zero mean, unit *sample* std (ddof=1), as gonum's stat.MeanStdDev in
    the reference (tutorial.go:78-86)."""
    mean = float(np.mean(y))
    std = float(np.std(y, ddof=1)) if y.size > 1 else 1.0
    return (y - mean) / std, mean, std


def write_forecast_rows(wtr: IO[str], rows: Iterable[Iterable[float]]) -> None:
    """Write forecast rows with the reference's %f formatting ("nan" for
    NaN)."""
    for row in rows:
        wtr.write(",".join(_fmt(v) for v in row) + "\n")


def _fmt(v) -> str:
    fv = float(v)
    return "nan" if np.isnan(fv) else f"{fv:f}"


def progress(msg: str, end: str = "\n") -> None:
    print(msg, file=sys.stderr, end=end, flush=True)


def device_for(platform: str) -> torch.device:
    """``--platform``'s device: the CPU, or the current CUDA card; without
    one, exit with a message (there is no quiet fallback)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --platform cpu")
    return torch.device("cuda", torch.cuda.current_device())
