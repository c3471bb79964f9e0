"""Blocked Cholesky, streaming solves and tile inverses for Hopper.

PyTorch twin of ``gogp_tpu/ops/cholesky_pallas.py``, forward parts.  The
hand-written CUDA kernels (sources in ``gogp_torch/csrc/``, built by
``_build.py``) replace the TPU's Pallas kernels one for one:

    K2  cholesky_inv_tile   <- _chol_inv_kernel / pallas_cholesky_inv_tile
    K3  trsv_lower          <- _trsv_kernel / pallas_trsv_lower
        trsv_lower_t        <- _trsv_t_kernel / pallas_trsv_lower_t
    K5  tril_inv_tile       <- _tril_inv_kernel / pallas_tril_inv_tile

Each wrapper has a plain PyTorch version beside it (``*_plain``).  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or raises.
There is no fallback between the two.  Each launch adds one to its entry in
:data:`LAUNCHES`.

Gradients: on the CPU the plain versions run under ordinary autograd.  On
CUDA the kernels write their outputs through raw pointers, which autograd
neither records nor sees, so every CUDA entry point here (the four kernel
wrappers, both drivers and ``lml_core``) runs inside :class:`_ForwardOnly`,
whose backward raises ``NotImplementedError``: a gradient through the kernel
path fails loudly instead of coming out wrong.  The analytic backward is the
next item of ROADMAP.md queue 1.

Around the kernels, the panel products and trailing updates of the blocked
driver are ``torch.matmul``, as the JAX package leaves them to XLA.  On CUDA
every f32 matmul runs at full f32 precision: the ``precision`` arguments of
the front door are accepted for parity with the JAX twin and not mapped to
TF32.

Tile size: ``DEFAULT_BLOCK = 128``, where the TPU uses 256.  A 128 x 128 f32
tile is 64 KB, so K2 and K5 hold a tile and its inverse (128 KB) in one
block's shared memory (227 KB on Hopper); a 256-tile alone would not fit.
"""

from __future__ import annotations

import contextlib

import torch

from gogp_torch.ops import _build

Tensor = torch.Tensor

DEFAULT_BLOCK = 128  # the only tile size K2 and K5 are built for
_MIN_N = 1024  # below this the front door runs torch.linalg, as JAX runs XLA

LAUNCHES = {"chol_inv_tile": 0, "trsv_lower": 0, "trsv_lower_t": 0, "tril_inv_tile": 0}


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
    """``fn(*args)`` with a backward that raises (see the module docstring)."""

    @staticmethod
    def forward(ctx, what, fn, *args):
        ctx.what = what
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.what}: no gradient through the CUDA kernels yet (the GPML 5.9 "
            "pullback through blocked_tril_inv and syrk_lower_t, and the Cholesky "
            "and TRSM pullbacks, are not ported); see ROADMAP.md queue 1"
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


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
    if L.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: L must be 16-byte aligned")


def trsv_fits(n: int, block: int) -> bool:
    """Whether K3 takes an n-vector: trsv.cu keeps the solution (n floats),
    one tile's residual (block floats) and 4 x 1024 partial sums in one
    block's shared memory, at most 227 KB on Hopper; n <= 53888 at block
    128.  Beyond that the kernel refuses to launch, and the front door's
    ``lml_core`` takes torch.linalg (the JAX package takes K4 there, which is
    not ported)."""
    return (n + block + 4 * 1024) * 4 <= 232448


def _trsv(what: str, entry: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    return _ForwardOnly.apply(what, _trsv_cuda, what, entry, L, y, invs, block)


def _trsv_cuda(what: str, entry: str, L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    _check_trsv(what, L, y, invs, block)
    x = torch.empty_like(y)
    _launch(L, entry, L.data_ptr(), y.data_ptr(), invs.data_ptr(), x.data_ptr(), L.shape[-1], block)
    LAUNCHES[what] += 1
    return x


def trsv_lower(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """z = L^{-1} y streamed over block rows, diagonal tiles applied through
    ``invs`` (nb, block, block) (K3)."""
    if not _is_cuda(L, y, invs):
        return trsv_lower_plain(L, y)
    return _trsv("trsv_lower", "gogp_trsv_lower", L, y, invs, block)


def trsv_lower_t(L: Tensor, y: Tensor, invs: Tensor, block: int) -> Tensor:
    """x = L^{-T} y streamed bottom-up over column panels (K3, transpose)."""
    if not _is_cuda(L, y, invs):
        return trsv_lower_t_plain(L, y)
    return _trsv("trsv_lower_t", "gogp_trsv_lower_t", L, y, invs, block)


# ---------------------------------------------------------------------------
# Blocked drivers
# ---------------------------------------------------------------------------


def _check_block(n: int, block: int) -> None:
    if n % block != 0:
        raise ValueError(f"n={n} must be a multiple of block={block}")


def _tile_invs(L: Tensor, block: int) -> Tensor:
    """(nb, block, block) stack of inv(L_kk), one K5 launch over all tiles."""
    nb = L.shape[-1] // block
    tiles = L.view(nb, block, nb, block).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    return tril_inv_tile(tiles.contiguous())


def blocked_cholesky_invs(K: Tensor, block: int = DEFAULT_BLOCK) -> tuple[Tensor, Tensor]:
    """Right-looking blocked Cholesky; returns ``(L, invs)`` with ``invs`` the
    (nb, block, block) diagonal-tile inverses that K2 yields as a by-product.

    Twin of ``_stepwise_cholesky_invs``: per block column, K2 factors the
    diagonal tile, the panel is ``A[c1:, c0:c1] @ inv^T`` and the trailing
    update is one matmul.  Everything runs in place on one copy of K, whose
    lower triangle becomes L; K2 reads and writes its diagonal tile there.
    The JAX package takes its fused whole-matrix kernel (K1) for n <= 2047;
    K1 is not ported, so every n takes this driver, which computes the same
    factor.
    """
    if _is_cuda(K):
        return _ForwardOnly.apply("blocked_cholesky_invs", _blocked_cholesky_invs, K, block)
    return _blocked_cholesky_invs(K, block)


def _blocked_cholesky_invs(K: Tensor, block: int) -> tuple[Tensor, Tensor]:
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
    if _is_cuda(L, B):
        return _ForwardOnly.apply("blocked_trsm_lower", _blocked_trsm_lower, L, B, block)
    return _blocked_trsm_lower(L, B, block)


def _blocked_trsm_lower(L: Tensor, B: Tensor, block: int) -> Tensor:
    n = L.shape[-1]
    _check_block(n, block)
    invs = _tile_invs(L, block)
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in range(n // block):
        c0, c1 = k * block, (k + 1) * block
        rhs = torch.addmm(B[c0:c1], L[c0:c1, :c0], X[:c0], alpha=-1.0) if k else B[c0:c1]
        torch.mm(invs[k], rhs, out=X[c0:c1])
    return X


def _lml_core_forward(K: Tensor, y: Tensor, block: int) -> Tensor:
    """-(log|K| + y^T K^-1 y)/2.  Twin of ``_lml_core_impl``.  Like the JAX
    twin it also solves alpha = L^-T z, the residual that the GPML-5.9
    backward (Kbar = g/2 (alpha alpha^T - K^-1), ybar = -g alpha) will read;
    the value does not use it."""
    L, invs = blocked_cholesky_invs(K, block)
    z = trsv_lower(L, y, invs, block)
    trsv_lower_t(L, z, invs, block)  # alpha, for the backward to come
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return -0.5 * (logdet + z @ z)


def lml_core(K: Tensor, y: Tensor, block: int = DEFAULT_BLOCK) -> Tensor:
    """-(log|K| + y^T K^-1 y)/2 through the blocked driver and K3.

    On CUDA the kernels run forward only: the backward raises (see the module
    docstring).  On the CPU (under ``force_blocked``) the plain tile functions
    run under ordinary autograd."""
    if _is_cuda(K, y):
        return _ForwardOnly.apply("lml_core", _lml_core_forward, K, y, block)
    return _lml_core_forward(K, y, block)
