"""Packed binary datasets and a streaming minibatch input pipeline.

PyTorch twin of ``gogp_tpu/utils/dataio.py`` (numpy and the native C++
loader; no torch needed).  The reference's only data path is a whole-file
CSV read into Go slices (tutorial/tutorial.go:234-272), fine for 20-44 rows.
SVGP training (gp/sparse.py) consumes uniform-with-replacement minibatches
from datasets that need not fit in host RAM; this module provides

- :func:`pack_dataset` / :func:`load_dataset`: an mmap-able on-disk format,
  a 32-byte header and a row-major float64 (n, ndim+1) matrix with the
  targets in the last column (the CSV loader's column convention).  The
  twin's files and the port's are the same bytes.
- :class:`MinibatchStream`: an iterator of (x_batch, y_batch) numpy arrays
  from the native prefetch loader (native/loader.cpp: mmap, a background
  gather thread, a ring buffer), built by :mod:`gogp_torch.utils.native`,
  or from the pure-Python version.  Both draw indices from the same
  xorshift64* generator, so the streams are bit-identical, the twin's
  included.

The sampling semantics (uniform with replacement) match svgp_fit's
in-memory batching, so ``svgp_fit_stream`` is the out-of-core version of the
same estimator.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gogp_torch.utils import native as _native

_MAGIC = b"GGPD"
_VERSION = 1
_HEADER = struct.Struct("<4sIQQQ")  # magic, version, n_rows, n_cols, reserved
HEADER_BYTES = _HEADER.size  # 32


def pack_dataset(path, x, y) -> None:
    """Write (x, y) as a packed dataset: header + float64 rows [x..., y]."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"x rows {x.shape[0]} != y rows {y.shape[0]}")
    rows = np.concatenate([x, y[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, rows.shape[0], rows.shape[1], 0))
        f.write(np.ascontiguousarray(rows).tobytes())


def read_header(path) -> tuple[int, int]:
    """(n_rows, n_cols) of a packed dataset; raises on bad magic/version."""
    with open(path, "rb") as f:
        magic, version, n_rows, n_cols, _ = _HEADER.unpack(f.read(HEADER_BYTES))
    if magic != _MAGIC or version != _VERSION:
        raise ValueError(f"{path}: not a gogp packed dataset")
    return int(n_rows), int(n_cols)


def load_dataset(path) -> tuple[np.ndarray, np.ndarray]:
    """Whole-file read -> (x (n, ndim), y (n,)).  Small-data convenience."""
    n_rows, n_cols = read_header(path)
    rows = np.fromfile(path, dtype=np.float64, count=n_rows * n_cols,
                       offset=HEADER_BYTES).reshape(n_rows, n_cols)
    return rows[:, :-1], rows[:, -1]


# -- shared RNG (must match native/loader.cpp xorshift64star exactly) -------

_M64 = (1 << 64) - 1
_DEFAULT_SEED = 0x9E3779B97F4A7C15


def _xorshift64star(state: int) -> tuple[int, int]:
    """One step of xorshift64*; returns (new_state, output)."""
    s = state & _M64
    s ^= s >> 12
    s ^= (s << 25) & _M64
    s ^= s >> 27
    return s, (s * 0x2545F4914F6CDD1D) & _M64


class MinibatchStream:
    """Endless uniform-with-replacement minibatches from a packed dataset.

    Iterating yields ``(x_batch (batch, ndim), y_batch (batch,))`` float64
    arrays.  ``native=None`` takes the C++ prefetch loader where
    :func:`gogp_torch.utils.native.available` says it can be built (a
    failed build raises); ``native=False`` the Python version (a
    bit-identical stream).  Use as a context manager or call :meth:`close`:
    the native loader owns an mmap and a thread.
    """

    def __init__(self, path, batch: int, seed: int = 0, capacity: int = 4,
                 native: bool | None = None):
        self.path = str(path)
        self.batch = int(batch)
        self.n_rows, self.n_cols = read_header(self.path)
        if self.n_rows < 1 or self.n_cols < 2:
            raise ValueError(f"{path}: need >=1 row and >=2 columns")
        self.seed = int(seed) & _M64 or _DEFAULT_SEED
        self._handle = None
        self._mm = None
        self._state = self.seed
        if native is None:
            native = _native.available()
        if native:
            self._handle = _loader_open(
                self.path, HEADER_BYTES, self.n_rows, self.n_cols,
                self.batch, int(capacity), self.seed,
            )
            if not self._handle:
                raise OSError(f"native loader failed to open {self.path}")
            self._buf = np.empty(self.batch * self.n_cols, dtype=np.float64)
        else:
            self._mm = np.memmap(self.path, dtype=np.float64, mode="r",
                                 offset=HEADER_BYTES,
                                 shape=(self.n_rows, self.n_cols))

    @property
    def ndim(self) -> int:
        return self.n_cols - 1

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._handle is not None:
            lib = _native.library()
            n = lib.loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            if n != self.batch * self.n_cols:
                raise RuntimeError("native loader_next failed")
            rows = self._buf.reshape(self.batch, self.n_cols).copy()
        else:
            idx = np.empty(self.batch, dtype=np.int64)
            s = self._state
            for i in range(self.batch):
                s, out = _xorshift64star(s)
                idx[i] = out % self.n_rows
            self._state = s
            rows = np.asarray(self._mm[idx])
        return rows[:, :-1], rows[:, -1]

    def close(self) -> None:
        if self._handle is not None:
            _native.library().loader_close(self._handle)
            self._handle = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# -- ctypes plumbing ---------------------------------------------------------


def _loader_open(path: str, offset: int, n_rows: int, n_cols: int,
                 batch: int, capacity: int, seed: int):
    return _native.library().loader_open(
        path.encode(), offset, n_rows, n_cols, batch, capacity, seed
    )
