"""Build and load the port's CUDA kernels (``gogp_torch/csrc/*.cu``).

``nvcc`` compiles every source for ``sm_90a`` (Hopper), one process per
source, all started together, and links the objects into one shared library
with a plain C interface, which ``ctypes`` loads.  On an H100 host that took
26-32 s, the longest source alone (``fused_gp.cu``, whose warp kernels are
fully unrolled); before that source grew, 10-14 s against 20-25 s for one
``nvcc -shared`` over all the sources.  The build runs at
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
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in build.log
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "gogp_fused_cholesky_invs": [_P, _P, _P, _P, _I, _I, _P],
    "gogp_chol_inv_tile": [_P, _I, _P, _I, _P, _I, _I, _P],
    "gogp_chol_inv_tiles": [_P, _I, _L, _P, _I, _L, _P, _I, _L, _I, _I, _P],
    "gogp_chol_inv_tile_stamps": [_P, _P, _P],  # a GOGP_TILE_STAMPS build's only
    "gogp_tril_inv_tiles": [_P, _P, _I, _I, _P],
    "gogp_tril_inv_tiles_split": [_P, _P, _I, _I, _I, _P],  # K5 at a given split, for measurement
    "gogp_tril_inv_tiles_stamps": [_P, _P, _P],  # a GOGP_TILE_STAMPS build's only
    "gogp_trsv_lower": [_P, _P, _P, _P, _P, _I, _I, _P],
    "gogp_trsv_lower_t": [_P, _P, _P, _P, _P, _I, _I, _P],
    "gogp_trsv2d_lower": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "gogp_trsv2d_lower_t": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "gogp_trsv2d_lower_batched": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gogp_trsv2d_lower_t_batched": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gogp_trsv2d_stamps": [_P, _P],  # a GOGP_TRSV_STAMPS build's only
    "gogp_chol_tile": [_P, _I, _P, _I, _I, _P],
    "gogp_fused_gp_linv": [_P, _P, _I, _I, _P],
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


def _digest(flags: tuple[str, ...], sources: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join((*flags, *(p.name for p in sources))).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(defines: tuple[str, ...] = (), sources: tuple[str, ...] | None = None) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; return
    its path.  ``build.log`` beside it keeps nvcc's output.  ``defines`` adds
    ``-D`` flags and ``sources`` (file names in ``csrc/``) builds a subset:
    for measurement builds such as the tile body's stage stamps
    (``GOGP_TILE_STAMPS``) or K4's chain stamps (``GOGP_TRSV_STAMPS``),
    which :func:`library` never loads."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    srcs = _sources() if sources is None else [_CSRC / s for s in sources]
    out_dir = _BUILD_ROOT / _digest(flags, srcs)
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = []
    for src in srcs:
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        compiles.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in compiles:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}")
        if proc.returncode != 0:
            failed.append(out)
    tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(proc.stderr)
    for _, obj, _ in compiles:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(f"# {seconds:.1f} s\n" + "\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
