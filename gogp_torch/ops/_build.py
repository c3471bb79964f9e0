"""Build and load the port's CUDA kernels (``gogp_torch/csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface for ``sm_90a`` (Hopper), and ``ctypes`` loads it.  The build runs at
first use, into ``build/gogp_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so an edited source builds anew and
an unchanged one loads in milliseconds.  Nothing here runs at import time: the
CPU tests import every module on a machine with no ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "gogp_torch"
_LIB_NAME = "libgogp_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in build.log
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "gogp_chol_inv_tile": [_P, _I, _P, _I, _P, _I, _I, _P],
    "gogp_tril_inv_tiles": [_P, _P, _I, _I, _P],
    "gogp_trsv_lower": [_P, _P, _P, _P, _I, _I, _P],
    "gogp_trsv_lower_t": [_P, _P, _P, _P, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; return
    its path.  ``build.log`` beside it keeps nvcc's output."""
    out_dir = _BUILD_ROOT / _digest()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        f"$ {' '.join(cmd)}\n# {seconds:.1f} s, exit {proc.returncode}\n"
        + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gogp_error_string.argtypes = [ctypes.c_int]
    lib.gogp_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().gogp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
