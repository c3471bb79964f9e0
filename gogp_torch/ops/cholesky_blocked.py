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

Batches.  Every driver, Function and kernel wrapper also takes a stack: one
leading batch axis, (B, n, n) matrices with (B, n) or shared (n,) vectors.
The routes are the JAX twin's ``custom_vmap`` reroutes
(cholesky_pallas.py:633-644, 1474-1493): a stack never takes K1; its
Cholesky is the stepwise driver with one K2 launch over the B diagonal tiles
of each block column; its LML core factors with the library's batched
Cholesky (``cholesky_ex``), inverts all B * nb diagonal tiles in one K5
launch and solves with K4 over the batch (one launch each way).
``torch.func.vmap`` reaches the same routes: each ``autograd.Function``
here has a ``vmap`` staticmethod, the counterpart of ``def_vmap``, which
moves the batch axis to the front and applies the same Function to the
physical (B, ...) tensors, whose backward is then the batched pullback.  A
tensor that is not batched is broadcast over the batch, except a TRSM's
shared factor, which solves the batch's right-hand sides side by side.

The precision rescue (``ops/linalg.py``) runs inside ``_Cholesky`` and
``_LmlCore``, on the physical batch: where it is engaged and any element's
result is not finite (one host read), the whole batch is recomputed at full
f32 and each element takes that result where its own was not finite, and
its backward at that precision, as the twin's ``lax.cond`` does under
``vmap``, where it becomes a select.

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
from gogp_torch.utils.profiling import count, host_read, span

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
    """Block size if the blocked path should handle this matrix or (B, n, n)
    stack: a CUDA f32 square matrix with n >= _MIN_N that the block divides
    (the JAX twin's TPU + f32 rule), or anything the block divides under
    force_blocked."""
    if K.dim() not in (2, 3) or K.shape[-2] != K.shape[-1]:
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


def _physical(info, in_dims, *args) -> tuple:
    """A vmap rule's arguments with the batch axis in front; a tensor that is
    not batched is broadcast over the batch (a view)."""
    return tuple(
        a if not isinstance(a, Tensor) else a.movedim(d, 0) if d is not None else a.expand(info.batch_size, *a.shape)
        for a, d in zip(args, in_dims)
    )


def _out_dims(out):
    return tuple(None if o is None else 0 for o in out) if isinstance(out, tuple) else 0


def _select(bad: Tensor, a: Tensor | None, b: Tensor | None) -> Tensor | None:
    """``b`` for the leading elements where ``bad`` holds, ``a`` elsewhere
    (``bad`` 0-d for one matrix)."""
    if a is None:
        return None
    return torch.where(bad.reshape(bad.shape + (1,) * (a.dim() - bad.dim())), b, a)


class _ForwardOnly(torch.autograd.Function):
    """``fn(*args)`` with a backward that raises: the raw kernel wrappers'
    guard (see the module docstring).  Under ``torch.func.vmap`` it runs
    ``fn`` on the physical batch (every wrapped function takes one leading
    batch axis), K1's as the twin does: a batch takes the stepwise driver."""

    @staticmethod
    def forward(what, fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.what = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.what}: a raw CUDA kernel wrapper has no gradient of its own; "
            "differentiate through the front door (gogp_torch.ops.linalg) or the "
            "pullbacks lml_core, cholesky, trsm_lower_ad and trsm_lower_t_ad"
        )

    @staticmethod
    def vmap(info, in_dims, what, fn, *args):
        if what == "fused_cholesky_invs":
            fn = _stepwise_cholesky_invs
        out = _ForwardOnly.apply(what, fn, *_physical(info, in_dims[2:], *args))
        return out, _out_dims(out)


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
    """The (..., nb, block, block) diagonal tiles of L (..., n, n), as a
    view."""
    nb = L.shape[-1] // block
    lead = L.shape[:-2]
    tiles = L.view(*lead, nb, block, nb, block).diagonal(dim1=-4, dim2=-2)
    return tiles.permute(*range(len(lead)), -1, -3, -2)


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
    """z = L^{-1} y for a vector y (a batch: (B, n, n) and (B, n))."""
    return torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]


def trsv_lower_t_plain(L: Tensor, y: Tensor) -> Tensor:
    """x = L^{-T} y for a vector y (a batch: (B, n, n) and (B, n))."""
    return torch.linalg.solve_triangular(L.mT, y[..., None], upper=True)[..., 0]


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
    """(L, inv(L)) of one (b, b) SPD tile, or of each tile of a (B, b, b)
    stack in one launch (K2).  A non-positive pivot gives NaN, as on the
    TPU."""
    if not _is_cuda(A):
        return cholesky_inv_tile_plain(A)
    return _ForwardOnly.apply("cholesky_inv_tile", _cholesky_inv_tile_cuda, A)


def _cholesky_inv_tile_cuda(A: Tensor) -> tuple[Tensor, Tensor]:
    L, V = torch.empty_like(A), torch.empty_like(A)
    _cholesky_inv_tile_into(A, L, V)
    return L, V


def _cholesky_inv_tile_into(A: Tensor, L: Tensor, V: Tensor) -> None:
    """K2 writing into views: L (which may be A itself) and V = inv(L).  The
    (b, b) tiles, or (B, b, b) stacks of them, may be views into larger
    tensors; each tile needs contiguous rows (unit column stride), any row
    and batch stride.  A stack is one launch, a CTA a tile."""
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
    shape = A.shape if A.dim() == 3 else (b, b)
    for t in (A, L, V):
        if t.shape != shape or t.shape[-2:] != (b, b):
            raise ValueError(f"cholesky_inv_tile: expected {tuple(shape)} tiles, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"cholesky_inv_tile: the CUDA kernel takes float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("cholesky_inv_tile: the CUDA kernel takes tiles with contiguous rows")
    count = A.shape[0] if A.dim() == 3 else 1
    if not count:
        return

    def strides(t):
        return t.stride(-2), t.stride(0) if t.dim() == 3 else 0

    _launch(A, "gogp_chol_inv_tiles", A.data_ptr(), *strides(A), L.data_ptr(), *strides(L),
            V.data_ptr(), *strides(V), b, count)
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
    if A.dim() == 3:  # no path calls K6: a stack is a launch a tile
        return torch.stack([_cholesky_tile_cuda(a) for a in A])
    if A.shape != (b, b):
        raise ValueError(f"cholesky_tile: expected a (b, b) tile, got {tuple(A.shape)}")
    _check_kernel_inputs("cholesky_tile", A)
    L = torch.empty_like(A)
    _launch(A, "gogp_chol_tile", A.data_ptr(), b, L.data_ptr(), b, b)
    LAUNCHES["chol_tile"] += 1
    return L


def tril_inv_tile(L: Tensor) -> Tensor:
    """inv(L) of a (b, b) lower-triangular tile or of a (..., b, b) stack,
    the stack in one launch (K5)."""
    if not _is_cuda(L):
        return tril_inv_tile_plain(L)
    return _ForwardOnly.apply("tril_inv_tile", _tril_inv_tile_cuda, L)


def _tril_inv_tile_cuda(L: Tensor) -> Tensor:
    b = L.shape[-1]
    if L.dim() < 2 or L.shape[-2] != b:
        raise ValueError(f"tril_inv_tile: expected (b, b) or (..., b, b), got {tuple(L.shape)}")
    _check_kernel_inputs("tril_inv_tile", L)
    count = L.numel() // (b * b)
    V = torch.empty_like(L)
    if count:
        _launch(L, "gogp_tril_inv_tiles", L.data_ptr(), V.data_ptr(), count, b)
        LAUNCHES["tril_inv_tile"] += 1
    return V


def _check_trsv(what: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> None:
    n = L.shape[-1]
    lead = L.shape[:-2]
    if len(lead) > 1 or L.shape[-2:] != (n, n) or y.shape != (*lead, n) or n % block != 0:
        raise ValueError(f"{what}: L {tuple(L.shape)}, y {tuple(y.shape)}, block {block}")
    if invs.shape != (*lead, n // block, block, block):
        raise ValueError(f"{what}: invs {tuple(invs.shape)}, expected {(*lead, n // block, block, block)}")
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
    if L.dim() == 3:  # K3 has no batch axis and is on no path: a launch an element
        return torch.stack([_trsv_cuda(what, entry, *t, block) for t in zip(L, y, invs)])
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
    batch = L.shape[0] if L.dim() == 3 else 1
    x = torch.empty_like(y)
    if not batch:
        return x
    counters = torch.empty(1 + 2 * nb * batch, dtype=torch.int32, device=L.device)  # zeroed by the C side
    partial = torch.empty(batch * nb * (nb + 1) // 2 * block, dtype=L.dtype, device=L.device)
    _launch(L, entry, L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(),
            counters.data_ptr(), partial.data_ptr(), L.shape[-1], block, batch)
    LAUNCHES[what] += 1
    return x


def trsv2d_lower(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """z = L^{-1} y over the triangular grid of (block, block) tiles by a
    persistent grid of one CTA per SM: each block row's tiles but the last
    summed off the chain in segments, the last one and ``invs``' diagonal
    tile applied on it (K4).  Reads only the strictly lower block triangle
    of L; any n that the tile (128) divides.  A batch ((B, n, n), (B, n),
    (B, nb, block, block)) is one launch, its B solves' items interleaved
    row by row."""
    if not _is_cuda(L, y, invs):
        return trsv2d_lower_plain(L, y)
    return _ForwardOnly.apply("trsv2d_lower", _trsv2d_cuda, "trsv2d_lower", "gogp_trsv2d_lower_batched",
                              L, y, invs, block)


def trsv2d_lower_t(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """x = L^{-T} y over the triangular tile grid, bottom-up (K4, transpose)."""
    if not _is_cuda(L, y, invs):
        return trsv2d_lower_t_plain(L, y)
    return _ForwardOnly.apply("trsv2d_lower_t", _trsv2d_cuda, "trsv2d_lower_t", "gogp_trsv2d_lower_t_batched",
                              L, y, invs, block)


# ---------------------------------------------------------------------------
# Blocked drivers
# ---------------------------------------------------------------------------


def _check_block(n: int, block: int) -> None:
    if n % block != 0:
        raise ValueError(f"n={n} must be a multiple of block={block}")


def _tile_invs(L: Tensor, block: int) -> Tensor:
    """(..., nb, block, block) stack of inv(L_kk), one K5 launch over all
    tiles (of every matrix of a stack)."""
    return tril_inv_tile(_diag_tiles(L, block).contiguous())


def _takes_fused(K: Tensor, block: int) -> bool:
    """The JAX twin's rule (cholesky_pallas.py:624-645): K1 for a 2-D matrix
    with n <= _FUSED_MAX_N unless no_fused_whole() is set; a stack takes the
    stepwise driver, as the twin's custom_vmap reroutes a batch.  On CUDA,
    K1 is built for block 128 and n >= _MIN_N, the front door's own gate;
    smaller matrices that reach the driver directly take the stepwise one."""
    n = K.shape[-1]
    if not _FUSED_WHOLE or K.dim() != 2 or n > _FUSED_MAX_N:
        return False
    return not _is_cuda(K) or (block == DEFAULT_BLOCK and n >= _MIN_N)


def blocked_cholesky_invs(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """Blocked Cholesky of a matrix or a (B, n, n) stack; returns ``(L,
    invs)`` with ``invs`` the (..., nb, block, block) diagonal-tile inverses,
    a by-product of K1 and K2.  K1 where :func:`_takes_fused` says so, else
    the stepwise driver."""
    if _takes_fused(K, block):
        return fused_cholesky_invs(K, block)
    return _stepwise_cholesky_invs(K, block)


def _stepwise_cholesky_invs(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """Right-looking blocked Cholesky, twin of ``_stepwise_cholesky_invs``:
    per block column, K2 factors the diagonal tile (of every matrix of a
    stack, one launch) and writes its inverse into ``invs``, the panel
    solves ``X L_kk^T = A[c1:, c0:c1]`` by substitution (a triangular
    solve, as the twin's row-sharded Cholesky forms it: the product with
    inv(L_kk) that the twin's driver takes gave NaN on rbf covariances
    with jitter 1e-5 where LAPACK's f32 factor is finite) and the trailing
    update is one (batched) matmul.  Everything runs in place on one copy
    of K, whose lower triangle becomes L; K2 reads and writes its diagonal
    tile there."""
    n = K.shape[-1]
    _check_block(n, block)
    nb = n // block
    A = K.clone(memory_format=torch.contiguous_format)  # becomes L: every block column is overwritten in place
    invs = torch.empty((*K.shape[:-2], nb, block, block), dtype=K.dtype, device=K.device)
    for k in range(nb):
        c0, c1 = k * block, (k + 1) * block
        diag = A[..., c0:c1, c0:c1]
        _cholesky_inv_tile_into(diag, diag, invs[..., k, :, :])
        if c1 == n:
            break
        panel = torch.linalg.solve_triangular(diag.mT, A[..., c1:, c0:c1], upper=True, left=False)
        A[..., c1:, c0:c1] = panel
        trailing = A[..., c1:, c1:]
        (trailing.addmm_ if A.dim() == 2 else trailing.baddbmm_)(panel, panel.mT, alpha=-1.0)
    return A.tril_(), invs


def _chol_invs_for_lml(K: Tensor, block: int) -> tuple[Tensor, Tensor]:
    """(L, invs) for the LML core, twin of ``_chol_invs_for_lml``: one
    matrix through :func:`blocked_cholesky_invs`; a stack (the twin's
    ``def_vmap``) through the library's batched Cholesky and one K5 launch
    over all B * nb diagonal tiles."""
    if K.dim() == 2:
        return blocked_cholesky_invs(K, block)
    _check_block(K.shape[-1], block)
    L = plain_cholesky(K).contiguous()
    return L, _tile_invs(L, block)


def _addmm(C: Tensor, A: Tensor, B: Tensor, **kw) -> Tensor:
    """``torch.addmm``, or ``torch.baddbmm`` over a stack."""
    return (torch.addmm if C.dim() == 2 else torch.baddbmm)(C, A, B, **kw)


def blocked_trsm_lower(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK) -> Tensor:
    """X = L^{-1} B, blocked: X[k] = inv(L_kk) @ (B[k] - L[k, :k] @ X[:k]),
    with every tile inverse from one batched K5 launch.  L (n, n) or a
    (B, n, n) stack, B (..., n, m) or (..., n)."""
    if B.dim() == L.dim() - 1:
        return blocked_trsm_lower(L, B[..., None], block)[..., 0]
    n = L.shape[-1]
    _check_block(n, block)
    invs = _tile_invs(L, block)
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in range(n // block):
        c0, c1 = k * block, (k + 1) * block
        rhs = _addmm(B[..., c0:c1, :], L[..., c0:c1, :c0], X[..., :c0, :], alpha=-1.0) if k else B[..., c0:c1, :]
        torch.matmul(invs[..., k, :, :], rhs, out=X[..., c0:c1, :])
    return X


def blocked_trsm_lower_t(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK) -> Tensor:
    """X = L^{-T} B, bottom-up: X[k] = inv(L_kk)^T @ (B[k] - L[k+1:, k]^T @
    X[k+1:]), with every tile inverse from one batched K5 launch.  Twin of
    ``blocked_trsm_lower_t`` (cholesky_pallas.py:1190-1211); shapes as
    :func:`blocked_trsm_lower`."""
    if B.dim() == L.dim() - 1:
        return blocked_trsm_lower_t(L, B[..., None], block)[..., 0]
    n = L.shape[-1]
    _check_block(n, block)
    invs = _tile_invs(L, block)
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in reversed(range(n // block)):
        c0, c1 = k * block, (k + 1) * block
        rhs = _addmm(B[..., c0:c1, :], L[..., c1:, c0:c1].mT, X[..., c1:, :], alpha=-1.0) if c1 < n else B[..., c0:c1, :]
        torch.matmul(invs[..., k, :, :].mT, rhs, out=X[..., c0:c1, :])
    return X


def blocked_tril_inv(L: Tensor, block: int = DEFAULT_BLOCK, invs: Tensor | None = None,
                     precision: str | None = None) -> Tensor:
    """W = inv(L) for lower-triangular L (or a (B, n, n) stack), down block
    rows: W[k, :k] = -inv(L_kk) (L[k, :k] W[:k, :k]), W[k, k] = inv(L_kk).
    The trailing product runs only over W's nonzero (c0, c0) corner, about
    2n^3/3 FLOPs.  ``invs``: the factorization's tile inverses; one K5
    launch when omitted.  ``precision``: the GEMMs' (:func:`uses_tf32`); None
    keeps the ambient setting.  It writes with ``out=``, which autograd
    cannot record: the front door (``linalg.tril_inv``) runs it
    forward-only.  Twin of ``blocked_tril_inv`` (cholesky_pallas.py:1305-1338)."""
    n = L.shape[-1]
    _check_block(n, block)
    if invs is None:
        invs = _tile_invs(L, block)
    W = torch.zeros_like(L, memory_format=torch.contiguous_format)
    with matmul_precision(precision):
        for k in range(n // block):
            c0, c1 = k * block, (k + 1) * block
            if k:
                torch.matmul(invs[..., k, :, :], L[..., c0:c1, :c0] @ W[..., :c0, :c0],
                             out=W[..., c0:c1, :c0]).neg_()
            W[..., c0:c1, c0:c1] = invs[..., k, :, :]
    return W


def syrk_lower_t(W: Tensor, min_size: int = 1024) -> Tensor:
    """W^T W for lower-triangular W (or a (B, n, n) stack) by the 2 x 2
    recursion [W1 0; W2 W3]^T [W1 0; W2 W3] = [W1^T W1 + W2^T W2, W2^T W3;
    ., W3^T W3], dense products only for the dense W2 quarter, down to
    ``min_size``: about a third of the FLOPs of a dense W^T W.  Twin of
    ``syrk_lower_t`` (cholesky_pallas.py:1341-1378)."""
    n = W.shape[-1]
    if n <= min_size or n % 2 != 0 or (n // 2) % 8 != 0:
        return W.mT @ W
    h = n // 2
    W1, W2, W3 = W[..., :h, :h], W[..., h:, :h], W[..., h:, h:]
    out = torch.empty_like(W, memory_format=torch.contiguous_format)
    _addmm(syrk_lower_t(W1, min_size), W2.mT, W2, out=out[..., :h, :h])
    torch.matmul(W2.mT, W3, out=out[..., :h, h:])
    out[..., h:, :h] = out[..., :h, h:].mT
    out[..., h:, h:] = syrk_lower_t(W3, min_size)
    return out


# ---------------------------------------------------------------------------
# Analytic pullbacks (autograd Functions on both devices)
# ---------------------------------------------------------------------------


def _phi(A: Tensor) -> Tensor:
    """tril(A) with the diagonal halved: the Cholesky pullback's projector."""
    P = torch.tril(A)
    P.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    return P


def _per_precision(fn, tf32: bool, rescued: Tensor | None):
    """A backward's ``fn(tf32)`` where its forward ran at ``tf32``, and
    ``fn(False)`` for the elements the precision rescue recomputed at full
    f32 (``rescued``: None, or which elements)."""
    if rescued is None:
        return fn(tf32)
    if rescued.dim() == 0:  # one matrix, rescued whole
        return fn(False)
    return _select(rescued, fn(tf32), fn(False))


def _chol_forward(K: Tensor, block: int, tf32: bool) -> Tensor:
    with _matmul_tf32(tf32):
        return blocked_cholesky_invs(K, block)[0]


def _chol_backward(L: Tensor, Lbar: Tensor, block: int, tf32: bool) -> Tensor:
    """Murray's Kbar = sym(L^-T Phi(L^T Lbar) L^-1)."""
    with _matmul_tf32(tf32):
        P = _phi(L.mT @ Lbar)
        S = blocked_trsm_lower_t(L, P, block)  # L^-T P
        Kbar = blocked_trsm_lower_t(L, S.mT, block).mT  # S L^-1
    return 0.5 * (Kbar + Kbar.mT)


class _Cholesky(torch.autograd.Function):
    """L = blocked_cholesky_invs(K)[0] with Murray's (2016) pullback
    Kbar = sym(L^-T Phi(L^T Lbar) L^-1), twin of ``cholesky`` / ``_chol_bwd``
    (cholesky_pallas.py:1394-1420), for a matrix or a stack.  ``tf32``: the
    matmuls' setting in forward and backward (:func:`uses_tf32`);
    ``rescue``: the precision rescue (module docstring).  Returns (L, which
    elements were rescued or None)."""

    @staticmethod
    def forward(K, block, tf32, rescue):
        L = _chol_forward(K, block, tf32)
        if rescue and tf32:
            bad = ~torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
            with host_read("rescue"):
                any_bad = bool(bad.any())
            if any_bad:
                count("rescues")
                return _select(bad, L, _chol_forward(K, block, False)), bad
        return L, None

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.block, ctx.tf32, _ = inputs
        L, rescued = output
        ctx.mark_non_differentiable(*(t for t in (rescued,) if t is not None))
        ctx.save_for_backward(L, rescued)

    @staticmethod
    def backward(ctx, Lbar, _):
        L, rescued = ctx.saved_tensors
        return _per_precision(lambda tf32: _chol_backward(L, Lbar, ctx.block, tf32), ctx.tf32, rescued), None, None, None

    @staticmethod
    def vmap(info, in_dims, K, block, tf32, rescue):
        (K,) = _physical(info, in_dims[:1], K)
        out = _Cholesky.apply(K, block, tf32, rescue)
        return out, _out_dims(out)


def cholesky(K: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None, rescue: bool = False) -> Tensor:
    """Lower Cholesky factor of a matrix or a (B, n, n) stack through the
    blocked drivers, differentiable; ``precision`` sets their matmuls,
    forward and backward; ``rescue`` engages the precision rescue."""
    return _Cholesky.apply(K, block, uses_tf32(precision), rescue)[0]


class _TrsmLower(torch.autograd.Function):
    """X = L^-1 B; Bbar = L^-T Xbar, Lbar = -tril(Bbar X^T)."""

    @staticmethod
    def forward(L, B, block, tf32):
        with _matmul_tf32(tf32):
            return blocked_trsm_lower(L, B, block)

    @staticmethod
    def setup_context(ctx, inputs, output):
        L, _, ctx.block, ctx.tf32 = inputs
        ctx.save_for_backward(L, output)

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        with _matmul_tf32(ctx.tf32):
            Bbar = blocked_trsm_lower_t(L, Xbar, ctx.block)
            Lbar = torch.tril(Bbar @ X.mT).neg_() if ctx.needs_input_grad[0] else None
        return Lbar, Bbar, None, None

    @staticmethod
    def vmap(info, in_dims, L, B, block, tf32):
        return _trsm_vmap(_TrsmLower, info, in_dims, L, B, block, tf32)


class _TrsmLowerT(torch.autograd.Function):
    """X = L^-T B; Bbar = L^-1 Xbar, Lbar = -tril(X Bbar^T)."""

    @staticmethod
    def forward(L, B, block, tf32):
        with _matmul_tf32(tf32):
            return blocked_trsm_lower_t(L, B, block)

    @staticmethod
    def setup_context(ctx, inputs, output):
        L, _, ctx.block, ctx.tf32 = inputs
        ctx.save_for_backward(L, output)

    @staticmethod
    def backward(ctx, Xbar):
        L, X = ctx.saved_tensors
        with _matmul_tf32(ctx.tf32):
            Bbar = blocked_trsm_lower(L, Xbar, ctx.block)
            Lbar = torch.tril(X @ Bbar.mT).neg_() if ctx.needs_input_grad[0] else None
        return Lbar, Bbar, None, None

    @staticmethod
    def vmap(info, in_dims, L, B, block, tf32):
        return _trsm_vmap(_TrsmLowerT, info, in_dims, L, B, block, tf32)


def _trsm_vmap(fn, info, in_dims, L, B, block, tf32):
    """The TRSMs' vmap rule: a batched factor solves a stack; one factor for
    the whole batch solves the batch's right-hand sides side by side, as
    columns of one (n, m * batch) right-hand side."""
    if in_dims[0] is None:
        Bp = B.movedim(in_dims[1], -1)
        X = fn.apply(L, Bp.reshape(Bp.shape[0], -1), block, tf32).reshape(Bp.shape)
        return X, X.dim() - 1
    L, B = _physical(info, in_dims, L, B)
    return fn.apply(L, B, block, tf32), 0


def trsm_lower_ad(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """X = L^-1 B (B (..., n, m) beside L (..., n, n)) with the analytic
    pullback, twin of ``trsm_lower_ad`` (cholesky_pallas.py:1221-1251)."""
    return _TrsmLower.apply(L, B, block, uses_tf32(precision))


def trsm_lower_t_ad(L: Tensor, B: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None) -> Tensor:
    """X = L^-T B (B (..., n, m) beside L (..., n, n)) with the analytic
    pullback, twin of ``trsm_lower_t_ad`` (cholesky_pallas.py:1254-1277)."""
    return _TrsmLowerT.apply(L, B, block, uses_tf32(precision))


def _lml_forward(K: Tensor, y: Tensor, block: int, needs_grad: bool, tf32: bool):
    """(value, L, alpha or None, invs) of one matrix or a stack (y (n,)
    shared by the stack, or (B, n))."""
    with span("lml.factor", device=True), _matmul_tf32(tf32):
        L, invs = _chol_invs_for_lml(K, block)
    with span("lml.solve", device=True):
        y = y.expand(L.shape[:-1]).contiguous()
        solve, solve_t = trsv_solvers(K.shape[-1], block)
        z = solve(L, y, invs, block)
        alpha = solve_t(L, z, invs, block) if needs_grad else None
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (logdet + (z * z).sum(-1)), L, alpha, invs


def _lml_kinv(L: Tensor, invs: Tensor, block: int, tf32: bool) -> Tensor:
    """K^-1 = W^T W, W = inv(L) from the factorization's tile inverses."""
    with span("lml.kinv", device=True), _matmul_tf32(tf32):
        return syrk_lower_t(blocked_tril_inv(L, block, invs))


class _LmlCore(torch.autograd.Function):
    """-(log|K| + y^T K^-1 y)/2 with the GPML-5.9 pullback, twin of
    ``lml_core`` / ``_lml_core_bwd`` (cholesky_pallas.py:1496-1546).

    The forward factors (K1 or the stepwise driver; a stack the library's
    batched Cholesky and K5) and solves z = L^-1 y (K3 or K4,
    :func:`trsv_solvers`).  alpha = L^-T z (the transpose solve), the
    residual the backward reads, is solved only when ``needs_grad``: a
    value-only call launches no transpose solve.  ``tf32``: the matmuls'
    setting in forward and backward; ``rescue``: the precision rescue.
    Returns (value, L, alpha, invs, rescued elements or None)."""

    @staticmethod
    def forward(K, y, block, needs_grad, tf32, rescue):
        out = _lml_forward(K, y, block, needs_grad, tf32)
        if rescue and tf32:
            bad = ~torch.isfinite(out[0])
            with host_read("rescue"):
                any_bad = bool(bad.any())
            if any_bad:
                count("rescues")
                out32 = _lml_forward(K, y, block, needs_grad, False)
                return (*(_select(bad, a, b) for a, b in zip(out, out32)), bad)
        return (*out, None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.block, ctx.tf32 = inputs[2], inputs[4]
        _, L, alpha, invs, rescued = output
        ctx.mark_non_differentiable(*(t for t in output[1:] if t is not None))
        ctx.save_for_backward(L, alpha, invs, rescued)

    @staticmethod
    def backward(ctx, g, *_):
        L, alpha, invs, rescued = ctx.saved_tensors
        Kbar = ybar = None
        with span("lml.backward", device=True):
            if ctx.needs_input_grad[0]:
                Kinv = _per_precision(lambda tf32: _lml_kinv(L, invs, ctx.block, tf32), ctx.tf32, rescued)
                Kbar = (0.5 * g[..., None, None]) * (alpha[..., :, None] * alpha[..., None, :] - Kinv)
            if ctx.needs_input_grad[1]:
                ybar = -g[..., None] * alpha
        return Kbar, ybar, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, K, y, block, needs_grad, tf32, rescue):
        K, y = _physical(info, in_dims[:2], K, y)
        needs_grad = needs_grad or (torch.is_grad_enabled() and (K.requires_grad or y.requires_grad))
        out = _LmlCore.apply(K, y, block, needs_grad, tf32, rescue)
        return out, _out_dims(out)


def lml_core(K: Tensor, y: Tensor, block: int = DEFAULT_BLOCK, precision: str | None = None,
             rescue: bool = False) -> Tensor:
    """-(log|K| + y^T K^-1 y)/2 through the blocked driver and K3 or K4, with
    the analytic GPML-5.9 backward, on both devices; a (B, n, n) stack with
    y (n,) or (B, n) gives (B,).  ``precision`` sets the drivers' matmuls,
    forward and backward; ``rescue`` engages the precision rescue."""
    needs_grad = torch.is_grad_enabled() and (K.requires_grad or y.requires_grad)
    return _LmlCore.apply(K, y, block, needs_grad, uses_tf32(precision), rescue)[0]
