"""Blocked Cholesky, streaming solves, tile inverses and their pullbacks,
for Hopper.

PyTorch twin of ``gogp_tpu/ops/cholesky_pallas.py``.  The hand-written CUDA
kernels (sources in ``gogp_torch/csrc/``, built by ``_build.py``) replace the
TPU's Pallas kernels one for one:

    K1  fused_cholesky_invs <- _fused_chol_kernel / fused_cholesky_invs
    K2  cholesky_inv_tile   <- _chol_inv_kernel / pallas_cholesky_inv_tile
    K3  trsv_lower          <- _trsv_kernel / pallas_trsv_lower
        trsv_lower_t        <- _trsv_t_kernel / pallas_trsv_lower_t
    K4  trsv2d_lower        <- _trsv2d_kernel / pallas_trsv2d_lower
        trsv2d_lower_t      <- _trsv2d_t_kernel / pallas_trsv2d_lower_t
    K5  tril_inv_tile       <- _tril_inv_kernel / pallas_tril_inv_tile
    K6  cholesky_tile       <- _chol_kernel / pallas_cholesky_tile

(K7, the batched small-GP L^-1, lives in ``ops/fused_gp.py`` and counts its
launches in :data:`LAUNCHES` too.)

Each wrapper has a plain PyTorch version beside it (``*_plain``).  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or raises.
There is no fallback between the two.  Each launch adds one to its entry in
:data:`LAUNCHES`.

``blocked_cholesky_invs`` dispatches as the JAX twin does: K1 for a 2-D
matrix with n <= ``_FUSED_MAX_N`` unless :func:`no_fused_whole` is set, the
stepwise driver (K2 per diagonal tile, cuBLAS panels and trailing updates)
otherwise.  ``lml_core`` solves with K3 below ``_TRSV2D_MIN_N`` and with K4
from there on (:func:`trsv_solvers`); as measured on the H100 the gate is
1024, the smallest n the front door sends to the blocked path, so every path
solves with K4 and K3 is on none.  No path calls K6, as no path of the JAX
package calls ``pallas_cholesky_tile``.

Gradients: the kernels write through raw pointers, which autograd neither
records nor sees, so the raw kernel wrappers run inside :class:`_ForwardOnly`,
whose backward raises (a JAX ``pallas_call`` has no VJP of its own either).
What differentiates are the analytic pullbacks of the JAX package, as
``torch.autograd.Function``s on both devices, their backwards plain
``torch.matmul`` plus K5:

    lml_core        GPML 5.9: Kbar = g/2 (alpha alpha^T - K^-1), ybar = -g alpha,
                    K^-1 = W^T W with W = blocked_tril_inv(L), syrk_lower_t
    cholesky        Murray's pullback (_chol_bwd), two blocked_trsm_lower_t
    trsm_lower_ad   Bbar = L^-T Xbar, Lbar = -tril(Bbar X^T)
    trsm_lower_t_ad Bbar = L^-1 Xbar, Lbar = -tril(X Bbar^T)

On the CPU (under ``force_blocked``) the same Functions run with the plain
tile versions, which is how the tests hold them against ``jax.grad``.

Around the kernels, the panel products and trailing updates of the stepwise
driver are ``torch.matmul``, as the JAX package leaves them to XLA.  The
per-call ``precision`` of the JAX twin sets those cuBLAS matmuls to TF32 or
full f32 (:func:`uses_tf32`), in the forward and, kept in ``ctx``, in the
backward, as the JAX twin threads it as a static argument into both.  The
hand-written kernels compute in f32 FMA whatever ``precision`` says.

Tile size: ``DEFAULT_BLOCK = 128``, where the TPU uses 256.  A 128 x 128 f32
tile is 64 KB, so K2 and K5 hold a tile and its inverse (128 KB) in one
block's shared memory (227 KB on Hopper); a 256-tile alone would not fit.
"""

from __future__ import annotations

import contextlib

import torch

from gogp_torch.ops import _build

Tensor = torch.Tensor

DEFAULT_BLOCK = 128  # the only tile size K1, K2 and K5 are built for
_MIN_N = 1024  # below this the front door runs torch.linalg, as JAX runs XLA
# K1 takes n <= _FUSED_MAX_N (and n >= _MIN_N): the largest n measured at
# which K1 is no slower than the stepwise driver, on an NVIDIA H100 80GB HBM3
# (700 W) by chip_smoke.py (PERF.md), where the JAX twin has 2047, a VMEM
# limit.  K1 against the stepwise driver (and cholesky_ex, the factor alone),
# in ms: n = 1024 0.389 / 0.350 (0.351), 1536 0.583 / 0.578 (0.532), 1792
# 0.678 / 0.735 (0.627), 2048 0.775 / 0.889 (0.741), 2560 0.968 / 1.262
# (0.954), 3072 1.163 / 2.085 (1.172), 4096 1.775 / 3.014 (1.850).  K1 wins
# from 1792 on, ties at 1536 and loses by 5-11% at 1024 (two runs); larger n
# are not measured.
_FUSED_MAX_N = 4096

LAUNCHES = {
    "fused_cholesky_invs": 0,
    "chol_inv_tile": 0,
    "trsv_lower": 0,
    "trsv_lower_t": 0,
    "trsv2d_lower": 0,
    "trsv2d_lower_t": 0,
    "tril_inv_tile": 0,
    "chol_tile": 0,
    "fused_gp_linv": 0,  # K7, launched from ops/fused_gp.py
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_FORCED_BLOCK: int | None = None


@contextlib.contextmanager
def force_blocked(block: int):
    """Send every square matrix whose size ``block`` divides through the
    blocked driver, whatever its device, dtype and size.  The counterpart of
    ``cp.force_interpret()``: on the CPU the driver then runs the plain tile
    functions, so tests exercise the blocked path at small n."""
    global _FORCED_BLOCK
    prev, _FORCED_BLOCK = _FORCED_BLOCK, block
    try:
        yield
    finally:
        _FORCED_BLOCK = prev


_FUSED_WHOLE = True


@contextlib.contextmanager
def no_fused_whole():
    """Send ``blocked_cholesky_invs`` through the stepwise driver at every n
    (the twin of ``cp.no_fused_whole()``): for timing K1 against it, and for
    tests of the stepwise driver."""
    global _FUSED_WHOLE
    prev, _FUSED_WHOLE = _FUSED_WHOLE, False
    try:
        yield
    finally:
        _FUSED_WHOLE = prev


# The JAX package's per-call precision names, and whether each runs the
# blocked drivers' cuBLAS matmuls in TF32 (about three decimal digits) or at
# full f32.
_TF32 = {
    "tensorfloat32": True, "bfloat16": True, "default": True, "fastest": True,
    "float32": False, "highest": False,
}


def uses_tf32(precision: str | None) -> bool:
    """Whether ``precision`` runs the blocked drivers' matmuls in TF32;
    ``None`` is torch's ambient ``torch.backends.cuda.matmul.allow_tf32``
    (off by default)."""
    if precision is None:
        return torch.backends.cuda.matmul.allow_tf32
    if precision not in _TF32:
        raise ValueError(f"unknown precision {precision!r}: expected None or one of {sorted(_TF32)}")
    return _TF32[precision]


@contextlib.contextmanager
def _matmul_tf32(tf32: bool):
    """cuBLAS f32 matmuls in TF32 (or not) inside, the setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_precision(precision: str | None):
    """torch matmuls inside at the JAX package's per-call ``precision``
    (TF32 or full f32 on the card, :func:`uses_tf32`); ``None`` leaves
    torch's ambient setting.  The CPU ignores it."""
    return contextlib.nullcontext() if precision is None else _matmul_tf32(uses_tf32(precision))


def _eligible_block(K: Tensor) -> int | None:
    """Block size if the blocked path should handle this matrix: a CUDA f32
    square matrix with n >= _MIN_N that the block divides (the JAX twin's
    TPU + f32 rule), or anything the block divides under force_blocked."""
    if K.dim() != 2 or K.shape[0] != K.shape[1]:
        return None
    n = K.shape[-1]
    if _FORCED_BLOCK is not None:
        return _FORCED_BLOCK if n % _FORCED_BLOCK == 0 else None
    if not K.is_cuda or K.dtype != torch.float32 or n < _MIN_N:
        return None
    return DEFAULT_BLOCK if n % DEFAULT_BLOCK == 0 else None


# ---------------------------------------------------------------------------
# Dispatch helpers
# ---------------------------------------------------------------------------


def _is_cuda(*ts: Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_kernel_inputs(what: str, *ts: Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")


class _ForwardOnly(torch.autograd.Function):
    """``fn(*args)`` with a backward that raises: the raw kernel wrappers'
    guard (see the module docstring)."""

    @staticmethod
    def forward(ctx, what, fn, *args):
        ctx.what = what
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.what}: a raw CUDA kernel wrapper has no gradient of its own; "
            "differentiate through the front door (gogp_torch.ops.linalg) or the "
            "pullbacks lml_core, cholesky, trsm_lower_ad and trsm_lower_t_ad"
        )


def _launch(t: Tensor, name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream of ``t``'s device."""
    if t.device.index != torch.cuda.current_device():
        with torch.cuda.device(t.device):
            return _launch(t, name, *args)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(getattr(_build.library(), name)(*args, stream), name)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def plain_cholesky(K: Tensor) -> Tensor:
    """torch.linalg Cholesky with the JAX failure contract: a matrix that is
    not positive definite gives NaN instead of raising, so callers can test
    the factor (``cholesky_with_jitter``) without a host round trip."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def _eye_like(A: Tensor) -> Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _diag_tiles(L: Tensor, block: int) -> Tensor:
    """The (nb, block, block) diagonal tiles of L, as a view."""
    nb = L.shape[-1] // block
    return L.view(nb, block, nb, block).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def fused_cholesky_invs_plain(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """(L, invs) of K1: the whole factor, then each diagonal tile's inverse
    by a triangular solve against I."""
    _check_block(K.shape[-1], block)
    L = plain_cholesky(K)
    return L, tril_inv_tile_plain(_diag_tiles(L, block))


def cholesky_inv_tile_plain(A: Tensor) -> tuple[Tensor, Tensor]:
    """(L, inv(L)) of one tile: Cholesky, then a triangular solve against I."""
    L = plain_cholesky(A)
    return L, torch.linalg.solve_triangular(L, _eye_like(L), upper=False)


def tril_inv_tile_plain(L: Tensor) -> Tensor:
    """inv(L) of one lower-triangular tile or of a (count, b, b) stack."""
    return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)


def trsv_lower_plain(L: Tensor, y: Tensor) -> Tensor:
    """z = L^{-1} y for a vector y."""
    return torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]


def trsv_lower_t_plain(L: Tensor, y: Tensor) -> Tensor:
    """x = L^{-T} y for a vector y."""
    return torch.linalg.solve_triangular(L.mT, y[:, None], upper=True)[:, 0]


# K4 solves what K3 solves; only the kernels' schedules differ.
trsv2d_lower_plain = trsv_lower_plain
trsv2d_lower_t_plain = trsv_lower_t_plain
# K6 factors one tile: plain_cholesky is its plain version.
cholesky_tile_plain = plain_cholesky


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def fused_cholesky_invs(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """(L, invs) of an n x n SPD matrix in one launch (K1): the whole lower
    factor and the (nb, block, block) diagonal-tile inverses.
    The kernel takes f32, contiguous, block 128 and n a multiple of 128 in
    [_MIN_N, _FUSED_MAX_N] (1024 to 4096).  A non-positive pivot gives NaN, as on the TPU."""
    if not _is_cuda(K):
        return fused_cholesky_invs_plain(K, block)
    return _ForwardOnly.apply("fused_cholesky_invs", _fused_cholesky_invs_cuda, K, block)


def _fused_cholesky_invs_cuda(K: Tensor, block: int) -> tuple[Tensor, Tensor]:
    n = K.shape[-1]
    if K.dim() != 2 or K.shape[0] != n:
        raise ValueError(f"fused_cholesky_invs: expected a square matrix, got {tuple(K.shape)}")
    _check_kernel_inputs("fused_cholesky_invs", K)
    if block != DEFAULT_BLOCK or n % block != 0 or not _MIN_N <= n <= _FUSED_MAX_N:
        raise ValueError(
            f"fused_cholesky_invs: the CUDA kernel takes block {DEFAULT_BLOCK} and n a multiple "
            f"of it in [{_MIN_N}, {_FUSED_MAX_N}], got n={n}, block={block}"
        )
    nb = n // block
    L = torch.empty_like(K)
    invs = torch.empty((nb, block, block), dtype=K.dtype, device=K.device)
    work = torch.empty(1 + 2 * nb + nb * nb, dtype=torch.int32, device=K.device)  # zeroed by the C side
    _launch(K, "gogp_fused_cholesky_invs", K.data_ptr(), L.data_ptr(), invs.data_ptr(), work.data_ptr(), n, block)
    LAUNCHES["fused_cholesky_invs"] += 1
    return L, invs


def cholesky_inv_tile(A: Tensor) -> tuple[Tensor, Tensor]:
    """(L, inv(L)) of one (b, b) SPD tile (K2).  A non-positive pivot gives
    NaN, as on the TPU."""
    if not _is_cuda(A):
        return cholesky_inv_tile_plain(A)
    return _ForwardOnly.apply("cholesky_inv_tile", _cholesky_inv_tile_cuda, A)


def _cholesky_inv_tile_cuda(A: Tensor) -> tuple[Tensor, Tensor]:
    L, V = torch.empty_like(A), torch.empty_like(A)
    _cholesky_inv_tile_into(A, L, V)
    return L, V


def _cholesky_inv_tile_into(A: Tensor, L: Tensor, V: Tensor) -> None:
    """K2 writing into views: L (which may be A itself) and V = inv(L).  The
    three (b, b) tiles may be views into larger matrices; each needs
    contiguous rows (unit column stride), any row stride."""
    if not _is_cuda(A, L, V):
        L_, V_ = cholesky_inv_tile_plain(A)
        L.copy_(L_)
        V.copy_(V_)
        return
    if torch.is_grad_enabled() and any(t.requires_grad for t in (A, L, V)):
        raise RuntimeError(
            "cholesky_inv_tile: the in-place kernel cannot be recorded by autograd; "
            "differentiate through cholesky_blocked.cholesky or lml_core"
        )
    b = A.shape[-1]
    for t in (A, L, V):
        if t.shape != (b, b):
            raise ValueError(f"cholesky_inv_tile: expected ({b}, {b}) tiles, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"cholesky_inv_tile: the CUDA kernel takes float32, got {t.dtype}")
        if t.stride(1) != 1:
            raise ValueError("cholesky_inv_tile: the CUDA kernel takes tiles with contiguous rows")
    _launch(A, "gogp_chol_inv_tile", A.data_ptr(), A.stride(0), L.data_ptr(), L.stride(0),
            V.data_ptr(), V.stride(0), b)
    LAUNCHES["chol_inv_tile"] += 1


def cholesky_tile(A: Tensor) -> Tensor:
    """L of one (b, b) SPD tile (K6: K2 without the inverse).  A
    non-positive pivot gives NaN, as on the TPU.  No path of the port calls
    it, as no path of the JAX package calls ``pallas_cholesky_tile``."""
    if not _is_cuda(A):
        return cholesky_tile_plain(A)
    return _ForwardOnly.apply("cholesky_tile", _cholesky_tile_cuda, A)


def _cholesky_tile_cuda(A: Tensor) -> Tensor:
    b = A.shape[-1]
    if A.shape != (b, b):
        raise ValueError(f"cholesky_tile: expected a (b, b) tile, got {tuple(A.shape)}")
    _check_kernel_inputs("cholesky_tile", A)
    L = torch.empty_like(A)
    _launch(A, "gogp_chol_tile", A.data_ptr(), b, L.data_ptr(), b, b)
    LAUNCHES["chol_tile"] += 1
    return L


def tril_inv_tile(L: Tensor) -> Tensor:
    """inv(L) of a (b, b) lower-triangular tile or of a (count, b, b) stack,
    the stack in one launch (K5)."""
    if not _is_cuda(L):
        return tril_inv_tile_plain(L)
    return _ForwardOnly.apply("tril_inv_tile", _tril_inv_tile_cuda, L)


def _tril_inv_tile_cuda(L: Tensor) -> Tensor:
    b = L.shape[-1]
    if L.dim() not in (2, 3) or L.shape[-2] != b:
        raise ValueError(f"tril_inv_tile: expected (b, b) or (count, b, b), got {tuple(L.shape)}")
    _check_kernel_inputs("tril_inv_tile", L)
    count = 1 if L.dim() == 2 else L.shape[0]
    V = torch.empty_like(L)
    if count:
        _launch(L, "gogp_tril_inv_tiles", L.data_ptr(), V.data_ptr(), count, b)
        LAUNCHES["tril_inv_tile"] += 1
    return V


def _check_trsv(what: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> None:
    n = L.shape[-1]
    if L.shape != (n, n) or y.shape != (n,) or n % block != 0:
        raise ValueError(f"{what}: L {tuple(L.shape)}, y {tuple(y.shape)}, block {block}")
    if invs.shape != (n // block, block, block):
        raise ValueError(f"{what}: invs {tuple(invs.shape)}, expected {(n // block, block, block)}")
    _check_kernel_inputs(what, L, y, invs)
    if L.data_ptr() % 16 != 0 or invs.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: L and invs must be 16-byte aligned")


# From this n on, lml_core solves with K4; below it with K3.  Both are
# hand-written kernels that take any n the tile divides.  The JAX package's
# gate (8192, cholesky_pallas.py:1447-1448, 1504-1510) is a VMEM limit with no
# counterpart here, so this one is the crossing measured on an NVIDIA H100
# 80GB HBM3 (700 W) by chip_smoke.py.  K4's persistent grid, with a shorter
# chain step than K3's, beat K3 at every n measured, from 1024 (the smallest
# the front door sends to the blocked path) to 65536: forward / transpose,
# K4 against K3, in ms, at n = 1024 0.0191 / 0.0183 against 0.0254 /
# 0.0195, at 4096 0.0612 / 0.0601 against 0.0878 / 0.0647, at 16384 0.2760 /
# 0.2649 against 0.3533 / 0.2756, and on synthetic factors at 65536 2.87 /
# 2.92 against 3.08 / 3.02 (PERF.md has more sizes).  Below 1024 nothing was
# measured, and K3 stays.
_TRSV2D_MIN_N = 1024


def trsv_solvers(n: int, block: int):
    """The (forward, transpose) solves ``lml_core`` takes at size n: K3
    below ``_TRSV2D_MIN_N``, K4 from there on."""
    if n < _TRSV2D_MIN_N:
        return trsv_lower, trsv_lower_t
    return trsv2d_lower, trsv2d_lower_t


def _trsv(what: str, entry: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    return _ForwardOnly.apply(what, _trsv_cuda, what, entry, L, y, invs, block)


def _trsv_cuda(what: str, entry: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    _check_trsv(what, L, y, invs, block)
    x = torch.empty_like(y)
    counters = torch.empty(1 + L.shape[-1] // block, dtype=torch.int32, device=L.device)  # zeroed by the C side
    _launch(L, entry, L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(), counters.data_ptr(),
            L.shape[-1], block)
    LAUNCHES[what] += 1
    return x


def trsv_lower(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """z = L^{-1} y as a wavefront over block rows, one CTA per row, diagonal
    tiles applied through ``invs`` (nb, block, block) (K3).  Reads only the
    strictly lower block triangle of L; any n that the tile (128) divides."""
    if not _is_cuda(L, y, invs):
        return trsv_lower_plain(L, y)
    return _trsv("trsv_lower", "gogp_trsv_lower", L, y, invs, block)


def trsv_lower_t(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """x = L^{-T} y as a wavefront over column panels, bottom-up (K3,
    transpose)."""
    if not _is_cuda(L, y, invs):
        return trsv_lower_t_plain(L, y)
    return _trsv("trsv_lower_t", "gogp_trsv_lower_t", L, y, invs, block)


def _trsv2d_cuda(what: str, entry: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    _check_trsv(what, L, y, invs, block)
    nb = L.shape[-1] // block
    x = torch.empty_like(y)
    counters = torch.empty(1 + 2 * nb, dtype=torch.int32, device=L.device)  # zeroed by the C side
    partial = torch.empty(nb * (nb + 1) // 2 * block, dtype=L.dtype, device=L.device)
    _launch(L, entry, L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(),
            counters.data_ptr(), partial.data_ptr(), L.shape[-1], block)
    LAUNCHES[what] += 1
    return x


def trsv2d_lower(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """z = L^{-1} y over the triangular grid of (block, block) tiles by a
    persistent grid of one CTA per SM: each block row's tiles but the last
    summed off the chain in segments, the last one and ``invs``' diagonal
    tile applied on it (K4).  Reads only the strictly lower block triangle
    of L; any n that the tile (128) divides."""
    if not _is_cuda(L, y, invs):
        return trsv2d_lower_plain(L, y)
    return _ForwardOnly.apply("trsv2d_lower", _trsv2d_cuda, "trsv2d_lower", "gogp_trsv2d_lower",
                              L, y, invs, block)


def trsv2d_lower_t(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """x = L^{-T} y over the triangular tile grid, bottom-up (K4, transpose)."""
    if not _is_cuda(L, y, invs):
        return trsv2d_lower_t_plain(L, y)
    return _ForwardOnly.apply("trsv2d_lower_t", _trsv2d_cuda, "trsv2d_lower_t", "gogp_trsv2d_lower_t",
                              L, y, invs, block)


# ---------------------------------------------------------------------------
# Blocked drivers
# ---------------------------------------------------------------------------


def _check_block(n: int, block: int) -> None:
    if n % block != 0:
        raise ValueError(f"n={n} must be a multiple of block={block}")


def _tile_invs(L: Tensor, block: int) -> Tensor:
    """(nb, block, block) stack of inv(L_kk), one K5 launch over all tiles."""
    return tril_inv_tile(_diag_tiles(L, block).contiguous())


def _takes_fused(K: Tensor, block: int) -> bool:
    """The JAX twin's rule (cholesky_pallas.py:624-645): K1 for a 2-D matrix
    with n <= _FUSED_MAX_N unless no_fused_whole() is set.  On CUDA, K1 is
    built for block 128 and n >= _MIN_N, the front door's own gate; smaller
    matrices that reach the driver directly take the stepwise one."""
    n = K.shape[-1]
    if not _FUSED_WHOLE or K.dim() != 2 or n > _FUSED_MAX_N:
        return False
    return not _is_cuda(K) or (block == DEFAULT_BLOCK and n >= _MIN_N)


def blocked_cholesky_invs(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """Blocked Cholesky; returns ``(L, invs)`` with ``invs`` the
    (nb, block, block) diagonal-tile inverses, a by-product of K1 and K2.
    K1 where :func:`_takes_fused` says so, else the stepwise driver."""
    if _takes_fused(K, block):
        return fused_cholesky_invs(K, block)
    return _stepwise_cholesky_invs(K, block)


def _stepwise_cholesky_invs(K: Tensor, block: int) -> tuple[Tensor, Tensor]:
    """Right-looking blocked Cholesky, twin of ``_stepwise_cholesky_invs``:
    per block column, K2 factors the diagonal tile, the panel is
    ``A[c1:, c0:c1] @ inv^T`` and the trailing update is one matmul.
    Everything runs in place on one copy of K, whose lower triangle becomes
    L; K2 reads and writes its diagonal tile there."""
    n = K.shape[-1]
    _check_block(n, block)
    nb = n // block
    A = K.clone()  # becomes L: every block column is overwritten in place
    invs = torch.empty((nb, block, block), dtype=K.dtype, device=K.device)
    for k in range(nb):
        c0, c1 = k * block, (k + 1) * block
        diag = A[c0:c1, c0:c1]
        _cholesky_inv_tile_into(diag, diag, invs[k])
        if c1 == n:
            break
        panel = A[c1:, c0:c1] @ invs[k].T
        A[c1:, c0:c1] = panel
        A[c1:, c1:].addmm_(panel, panel.T, alpha=-1.0)
    return A.tril_(), invs


def blocked_trsm_lower(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK) -> Tensor:
    """X = L^{-1} B, blocked: X[k] = inv(L_kk) @ (B[k] - L[k, :k] @ X[:k]),
    with every tile inverse from one batched K5 launch."""
    if B.dim() == 1:
        return blocked_trsm_lower(L, B[:, None], block)[:, 0]
    n = L.shape[-1]
    _check_block(n, block)
    invs = _tile_invs(L, block)
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in range(n // block):
        c0, c1 = k * block, (k + 1) * block
        rhs = torch.addmm(B[c0:c1], L[c0:c1, :c0], X[:c0], alpha=-1.0) if k else B[c0:c1]
        torch.mm(invs[k], rhs, out=X[c0:c1])
    return X


def blocked_trsm_lower_t(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK) -> Tensor:
    """X = L^{-T} B, bottom-up: X[k] = inv(L_kk)^T @ (B[k] - L[k+1:, k]^T @
    X[k+1:]), with every tile inverse from one batched K5 launch.  Twin of
    ``blocked_trsm_lower_t`` (cholesky_pallas.py:1190-1211)."""
    if B.dim() == 1:
        return blocked_trsm_lower_t(L, B[:, None], block)[:, 0]
    n = L.shape[-1]
    _check_block(n, block)
    invs = _tile_invs(L, block)
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in reversed(range(n // block)):
        c0, c1 = k * block, (k + 1) * block
        rhs = torch.addmm(B[c0:c1], L[c1:, c0:c1].T, X[c1:], alpha=-1.0) if c1 < n else B[c0:c1]
        torch.mm(invs[k].T, rhs, out=X[c0:c1])
    return X


def blocked_tril_inv(L: Tensor, block: int = DEFAULT_BLOCK, invs: Tensor | None = None,
                     precision: str | None = None) -> Tensor:
    """W = inv(L) for lower-triangular L, down block rows:
    W[k, :k] = -inv(L_kk) (L[k, :k] W[:k, :k]), W[k, k] = inv(L_kk).  The
    trailing product runs only over W's nonzero (c0, c0) corner, about
    2n^3/3 FLOPs.  ``invs``: the factorization's tile inverses; one K5 launch
    when omitted.  ``precision``: the GEMMs' (:func:`uses_tf32`); None keeps
    the ambient setting.  It writes with ``out=``, which autograd cannot
    record: the front door (``linalg.tril_inv``) runs it forward-only.  Twin
    of ``blocked_tril_inv`` (cholesky_pallas.py:1305-1338)."""
    n = L.shape[-1]
    _check_block(n, block)
    if invs is None:
        invs = _tile_invs(L, block)
    W = torch.zeros_like(L)
    with matmul_precision(precision):
        for k in range(n // block):
            c0, c1 = k * block, (k + 1) * block
            if k:
                torch.mm(invs[k], L[c0:c1, :c0] @ W[:c0, :c0], out=W[c0:c1, :c0]).neg_()
            W[c0:c1, c0:c1] = invs[k]
    return W


def syrk_lower_t(W: Tensor, min_size: int = 1024) -> Tensor:
    """W^T W for lower-triangular W by the 2 x 2 recursion
    [W1 0; W2 W3]^T [W1 0; W2 W3] = [W1^T W1 + W2^T W2, W2^T W3; ., W3^T W3],
    dense products only for the dense W2 quarter, down to ``min_size``:
    about a third of the FLOPs of a dense W^T W.  Twin of ``syrk_lower_t``
    (cholesky_pallas.py:1341-1378)."""
    n = W.shape[-1]
    if n <= min_size or n % 2 != 0 or (n // 2) % 8 != 0:
        return W.T @ W
    h = n // 2
    W1, W2, W3 = W[:h, :h], W[h:, :h], W[h:, h:]
    out = torch.empty_like(W)
    torch.addmm(syrk_lower_t(W1, min_size), W2.T, W2, out=out[:h, :h])
    torch.mm(W2.T, W3, out=out[:h, h:])
    out[h:, :h] = out[:h, h:].T
    out[h:, h:] = syrk_lower_t(W3, min_size)
    return out


# ---------------------------------------------------------------------------
# Analytic pullbacks (autograd Functions on both devices)
# ---------------------------------------------------------------------------


def _phi(A: Tensor) -> Tensor:
    """tril(A) with the diagonal halved: the Cholesky pullback's projector."""
    P = torch.tril(A)
    P.diagonal().mul_(0.5)
    return P


class _Cholesky(torch.autograd.Function):
    """L = blocked_cholesky_invs(K)[0] with Murray's (2016) pullback
    Kbar = sym(L^-T Phi(L^T Lbar) L^-1), twin of ``cholesky`` / ``_chol_bwd``
    (cholesky_pallas.py:1394-1420).  ``tf32``: the matmuls' setting in
    forward and backward (:func:`uses_tf32`)."""

    @staticmethod
    def forward(ctx, K, block, tf32):
        with _matmul_tf32(tf32):
            L = blocked_cholesky_invs(K, block)[0]
        ctx.block, ctx.tf32 = block, tf32
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        with _matmul_tf32(ctx.tf32):
            P = _phi(L.T @ Lbar)
            S = blocked_trsm_lower_t(L, P, ctx.block)  # L^-T P
            Kbar = blocked_trsm_lower_t(L, S.T, ctx.block).T  # S L^-1
        return 0.5 * (Kbar + Kbar.T), None, None


def cholesky(K: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """Lower Cholesky factor through the blocked drivers, differentiable;
    ``precision`` sets their matmuls, forward and backward."""
    return _Cholesky.apply(K, block, uses_tf32(precision))


class _TrsmLower(torch.autograd.Function):
    """X = L^-1 B; Bbar = L^-T Xbar, Lbar = -tril(Bbar X^T)."""

    @staticmethod
    def forward(ctx, L, B, block, tf32):
        with _matmul_tf32(tf32):
            X = blocked_trsm_lower(L, B, block)
        ctx.block, ctx.tf32 = block, tf32
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        with _matmul_tf32(ctx.tf32):
            Bbar = blocked_trsm_lower_t(L, Xbar, ctx.block)
            Lbar = torch.tril(Bbar @ X.T).neg_() if ctx.needs_input_grad[0] else None
        return Lbar, Bbar, None, None


class _TrsmLowerT(torch.autograd.Function):
    """X = L^-T B; Bbar = L^-1 Xbar, Lbar = -tril(X Bbar^T)."""

    @staticmethod
    def forward(ctx, L, B, block, tf32):
        with _matmul_tf32(tf32):
            X = blocked_trsm_lower_t(L, B, block)
        ctx.block, ctx.tf32 = block, tf32
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        with _matmul_tf32(ctx.tf32):
            Bbar = blocked_trsm_lower(L, Xbar, ctx.block)
            Lbar = torch.tril(X @ Bbar.T).neg_() if ctx.needs_input_grad[0] else None
        return Lbar, Bbar, None, None


def trsm_lower_ad(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """X = L^-1 B (2-D B) with the analytic pullback, twin of
    ``trsm_lower_ad`` (cholesky_pallas.py:1221-1251)."""
    return _TrsmLower.apply(L, B, block, uses_tf32(precision))


def trsm_lower_t_ad(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """X = L^-T B (2-D B) with the analytic pullback, twin of
    ``trsm_lower_t_ad`` (cholesky_pallas.py:1254-1277)."""
    return _TrsmLowerT.apply(L, B, block, uses_tf32(precision))


class _LmlCore(torch.autograd.Function):
    """-(log|K| + y^T K^-1 y)/2 with the GPML-5.9 pullback, twin of
    ``lml_core`` / ``_lml_core_bwd`` (cholesky_pallas.py:1496-1546).

    The forward factors (K1 or the stepwise driver) and solves z = L^-1 y
    (K3 or K4, :func:`trsv_solvers`).  alpha = L^-T z (the transpose solve),
    the residual the backward reads, is solved only when ``needs_grad``: a
    value-only call launches no transpose solve.  ``tf32``: the matmuls'
    setting in forward and backward."""

    @staticmethod
    def forward(ctx, K, y, block, needs_grad, tf32):
        with _matmul_tf32(tf32):
            L, invs = blocked_cholesky_invs(K, block)
        solve, solve_t = trsv_solvers(K.shape[-1], block)
        z = solve(L, y, invs, block)
        alpha = solve_t(L, z, invs, block) if needs_grad else None
        ctx.block, ctx.tf32 = block, tf32
        ctx.save_for_backward(L, alpha, invs)
        logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
        return -0.5 * (logdet + z @ z)

    @staticmethod
    def backward(ctx, g):
        L, alpha, invs = ctx.saved_tensors
        Kbar = ybar = None
        if ctx.needs_input_grad[0]:
            # K^-1 = W^T W, W = inv(L) from the factorization's tile inverses
            with _matmul_tf32(ctx.tf32):
                Kinv = syrk_lower_t(blocked_tril_inv(L, ctx.block, invs))
            Kbar = (0.5 * g) * (torch.outer(alpha, alpha) - Kinv)
        if ctx.needs_input_grad[1]:
            ybar = -g * alpha
        return Kbar, ybar, None, None, None


def lml_core(K: Tensor, y: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """-(log|K| + y^T K^-1 y)/2 through the blocked driver and K3 or K4, with
    the analytic GPML-5.9 backward, on both devices; ``precision`` sets the
    drivers' matmuls, forward and backward."""
    needs_grad = torch.is_grad_enabled() and (K.requires_grad or y.requires_grad)
    return _LmlCore.apply(K, y, block, needs_grad, uses_tf32(precision))
