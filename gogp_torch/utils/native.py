"""ctypes bindings for the native (C++) host helpers.

PyTorch twin of ``gogp_tpu/utils/native.py``: the CSV parser
(``native/csv_parser.cpp``, the reference's ``load``,
tutorial/tutorial.go:234-272) and the streaming minibatch loader
(``native/loader.cpp``, :mod:`gogp_torch.utils.dataio`).  The JAX package
loads the ``native/libgogp_native.so`` that ``make native`` writes; the port
never loads that file.  It builds its own from the same two sources with
g++ and the Makefile's flags (``-O2 -shared -fPIC -pthread``) at first use,
into ``build/gogp_torch/native/<hash>/`` at the root of the checkout, keyed
by a hash of the sources and flags.  Where no C++ compiler is on the PATH the
callers take their pure-Python versions (:func:`available`); a build that
was attempted and failed raises.  Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

_SOURCES = tuple(pathlib.Path(__file__).resolve().parents[2] / "native" / f for f in ("csv_parser.cpp", "loader.cpp"))
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "gogp_torch" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")  # Makefile:18-19


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def available() -> bool:
    """Whether the native helpers can be used: a C++ compiler is on the PATH
    (the library is built at first use)."""
    return _compiler() is not None


def build() -> pathlib.Path:
    """Compile the two sources into one shared library unless one for these
    sources and flags exists; return its path.  Raises if the build fails."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on the PATH (set CXX or install g++)")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libgogp_native.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libgogp_native.so.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, _SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native helpers failed:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.parse_csv.restype = ctypes.c_long
    lib.parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                              ctypes.POINTER(ctypes.c_long)]
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                ctypes.c_long, ctypes.c_uint64]
    lib.loader_next.restype = ctypes.c_long
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.loader_close.restype = None
    lib.loader_close.argtypes = [ctypes.c_void_p]
    return lib


def parse_csv(text: str) -> np.ndarray:
    """Parse comma-separated float rows -> (n_rows, n_cols) float64 array.

    Raises ValueError on ragged rows or non-numeric fields (the reference
    load() errors likewise, tutorial/tutorial.go:252-259)."""
    lib = library()
    raw = text.encode()
    max_vals = len(raw) // 2 + 8
    out = np.empty(max_vals, dtype=np.float64)
    n_cols = ctypes.c_long(0)
    n = lib.parse_csv(raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_vals,
                      ctypes.byref(n_cols))
    if n < 0:
        raise ValueError("malformed CSV (ragged row or non-numeric field)")
    if n == 0 or n_cols.value == 0:
        return np.zeros((0, 1), dtype=np.float64)
    return out[:n].reshape(-1, n_cols.value).copy()
