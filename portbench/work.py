"""The yardstick's arithmetic: the card's peaks, the bytes and FLOPs each of
the port's kernels needs at a shape, the least time the card could take,
and the FLOPs of one value-and-gradient call of the exact GP.

The kernel counts are a frozen copy of ``chip_smoke.work`` and
``chip_smoke.bound``: each input read once, each output written once, only
what the kernel's function uses (the lower triangle of a factor it solves
with).  They live here so that the benchmark's rooflines stay fixed while
the program changes.
"""

from __future__ import annotations

import math

# The card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes per second, and
# f32 FLOPs per second outside the tensor cores (every kernel of the port
# computes in f32 FMA).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BLOCK = 128  # the one tile size K1, K2 and K5 are built for

# Each __global__ symbol of gogp_torch/csrc/*.cu -> the kernel it belongs to.
KERNEL_OF_SYMBOL = {
    "fused_chol_kernel": "K1",
    "chol_inv_tile_kernel": "K2",
    "trsv_wave_kernel": "K3",
    "trsv2d_kernel": "K4",
    "tril_inv_tiles_kernel": "K5",
    "chol_tile_kernel": "K6",
    "linv_warp_kernel": "K7",
    "linv_block_kernel": "K7",
}

# Each C entry point -> (kernel, work key, shape from the entry's arguments).
# The arguments are those the port passes to ``cholesky_blocked._launch``
# (pointers, then sizes; ``gogp_torch/ops/_build.py``'s SIGNATURES).
ENTRY_SHAPES = {
    "gogp_fused_cholesky_invs": ("K1", "fused_cholesky_invs", lambda a: (a[4], a[4])),
    "gogp_chol_inv_tiles": ("K2", "chol_inv_tile", lambda a: (a[10], a[9], a[9])),
    "gogp_trsv_lower": ("K3", "trsv_lower", lambda a: (a[5], a[5])),
    "gogp_trsv_lower_t": ("K3", "trsv_lower", lambda a: (a[5], a[5])),
    "gogp_trsv2d_lower_batched": ("K4", "trsv2d_lower", lambda a: (a[8], a[6], a[6])),
    "gogp_trsv2d_lower_t_batched": ("K4", "trsv2d_lower", lambda a: (a[8], a[6], a[6])),
    "gogp_tril_inv_tiles": ("K5", "tril_inv_tile", lambda a: (a[2], a[3], a[3])),
    "gogp_chol_tile": ("K6", "chol_tile", lambda a: (a[4], a[4])),
    "gogp_fused_gp_linv": ("K7", "fused_gp_linv", lambda a: (a[2], a[3], a[3])),
}


def work(key: str, shape) -> tuple[float, float]:
    """(bytes, FLOPs) a kernel's function needs at ``shape``."""
    b = BLOCK
    # K7: each K's lower triangle in, its dense L^-1 out; n^3/3 for the
    # factor, as much for the inverse
    if key == "fused_gp_linv":
        count, n = shape[0], shape[-1]
        return 4 * count * (n * (n + 1) / 2 + n * n), count * 2 * n**3 / 3
    if key == "fused_cholesky_invs":  # K's block lower triangle in; L and the tile inverses out
        n = shape[0]
        return 4 * (n * (n + b) / 2 + n * n + n * b), n**3 / 3 + (n // b) * b**3 / 3
    count = math.prod(shape[:-2])  # a stack's matrices or tiles (1 for one)
    if key == "chol_inv_tile":  # each tile in; L and inv(L) out
        return count * 4 * 3 * b * b, count * 2 * b**3 / 3
    if key == "chol_tile":
        return 4 * 2 * b * b, b**3 / 3
    if key == "tril_inv_tile":
        return 4 * 2 * count * b * b, count * b**3 / 3
    # K3 and K4: the strictly lower block triangle and the tile inverses,
    # y in, x out; a multiply-add per float of L and of the inverses; a
    # batch of solves that many times
    n = shape[-1]
    return count * 4 * (n * (n - b) / 2 + n * b + 2 * n), count * (n * (n - b) + 2 * n * b)


def bound_s(key: str, shape) -> tuple[float, str]:
    """The least time the card could take (s), and what sets it."""
    nbytes, flops = work(key, shape)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vg_flops(chains: int, n: int, p: int) -> float:
    """FLOPs of one value and gradient of the exact GP log-likelihood over
    ``chains`` problems of ``n`` points and ``p`` hyperparameters, whatever
    implements it: n^3/3 each for the factor, the triangular inverse and
    K^-1 = W^T W; 2 n^2 for the two triangular solves; 6 n^2 for the
    covariance and as many for its pullback (difference, square, scale,
    exp, output scale, noise); 2 p n^2 for the contractions
    tr((alpha alpha^T - K^-1) dK/dtheta_j)."""
    return chains * (n**3 + (2 + 12 + 2 * p) * n * n)
