"""Distributed dense linear algebra over the process mesh: blocked
Cholesky, triangular solves, and the large-N GP marginal likelihood.

PyTorch twin of ``gogp_tpu/ops/distributed.py``.  Layout: the n x n matrix
is sharded by block-rows over one mesh axis (``data``); each rank owns
n / D contiguous rows, rank r rows r * n_local .. (r + 1) * n_local.  Every
function is SPMD: every rank of the axis calls it on its rows, under
``with mesh:`` (``gogp_torch.parallel.mesh``).

Right-looking blocked Cholesky, one host-loop step per block column k:

1. the b x b diagonal block is broadcast from its owner (the twin
   psum-broadcasts it: the owner contributes, the others send zeros) and
   factored redundantly on every rank: K2
   (``cholesky_blocked.cholesky_inv_tile``) at b = 128 on the card, its
   plain version at any other block or on the CPU.  The JAX twin factors
   the block with XLA's Cholesky; both solve the local panel against
   L_kk by substitution (X L_kk^T = A_col), as the port's stepwise driver
   does;
2. the panel (n x b) is all-gathered, the only O(n b) collective;
3. the trailing update A -= L[:, k] L[:, k]^T is one local matmul, sliced to
   the rows and columns still to factor.  The block loop is a host loop, so
   k is always static: this is the twin's ``unroll`` branch, with the rows
   above the trailing block (which the twin masks to zero) left out of the
   product.  Results agree with the twin to rounding.

The solves reuse the layout with per-block psum pipelining, and
:func:`lml_rowsharded` is a ``torch.autograd.Function`` whose backward
issues the collectives (GPML 5.9 through the distributed solves): no
autograd runs through a collective.
"""

from __future__ import annotations

import math

import torch

from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import collectives as coll

Tensor = torch.Tensor

DEFAULT_BLOCK = cb.DEFAULT_BLOCK  # K2's tile; the JAX twin's default is 256


def _diag_factor(diag: Tensor, block: int) -> tuple[Tensor, Tensor]:
    """(L_kk, L_kk^-1) of the diagonal block: K2 at its tile size on the
    card, the plain version elsewhere."""
    if diag.is_cuda and block == cb.DEFAULT_BLOCK:
        return cb.cholesky_inv_tile(diag)
    return cb.cholesky_inv_tile_plain(diag)


def _owner_block(parts: list, c0: int, block: int, row0: int, axis, partial: Tensor | None = None) -> list:
    """Global rows c0 .. c0 + block of each row-sharded (n_local, k) tensor
    of ``parts`` on every rank, in ONE collective: a broadcast from the
    owner, or, with ``partial`` (block, k0), a per-rank term to sum over the
    ranks, one psum to which the owner adds its rows and the others zeros
    (the twin's psum-broadcast); ``partial``'s sum comes back first."""
    n_local = parts[0].shape[0]
    owner = row0 <= c0 < row0 + n_local
    slabs = [p[c0 - row0:c0 - row0 + block] if owner else p.new_zeros((block, p.shape[1])) for p in parts]
    if partial is None:
        joined = coll.broadcast(torch.cat(slabs, 1), axis, c0 // n_local)
    else:
        slabs.insert(0, partial)
        joined = coll.psum(torch.cat(slabs, 1), axis)
    return list(torch.split(joined, [t.shape[1] for t in slabs], 1))


def _check_block(n_local: int, n: int, block: int) -> int:
    block = min(block, n_local)
    if n % block != 0 or n_local % block != 0:
        raise ValueError(
            f"block={block} must divide both n={n} and n_local={n_local} "
            "(each b x b diagonal block must live on one device)"
        )
    return block


def cholesky_rowsharded(A_local: Tensor, axis=coll.DATA_AXIS, block: int = DEFAULT_BLOCK) -> Tensor:
    """Blocked right-looking Cholesky of a block-row-sharded SPD matrix.

    ``A_local``: (n_local, n), this rank's contiguous rows.  Returns the same
    rows of the lower factor L (upper triangle zeroed)."""
    n_local, n = A_local.shape
    block = _check_block(n_local, n, block)
    row0 = coll.axis_index(axis) * n_local
    A = A_local.clone()
    rows = torch.arange(n_local, device=A.device) + row0
    for k in range(n // block):
        c0, c1 = k * block, (k + 1) * block
        # 1. the diagonal block from its owner, factored everywhere
        (diag,) = _owner_block([A[:, c0:c1]], c0, block, row0, axis)
        Lkk, _ = _diag_factor(diag, block)
        # 2. the local panel: below the block, L[i, k] solves X L_kk^T =
        # A[i, k] by substitution; L_kk's rows inside it, zero above
        r1 = min(max(c1 - row0, 0), n_local)  # first local row below the block
        panel_local = A.new_zeros((n_local, block))
        panel_local[r1:] = torch.linalg.solve_triangular(Lkk.mT, A[r1:, c0:c1], upper=True, left=False)
        if row0 <= c0 < row0 + n_local:
            panel_local[c0 - row0:c1 - row0] = Lkk
        # 3. gather the panel; the trailing update, sliced
        panel = coll.all_gather(panel_local, axis)  # (n, block)
        if r1 < n_local:
            A[r1:, c1:] -= panel_local[r1:] @ panel[c1:].mT
        A[:, c0:c1] = panel_local
    return torch.where(torch.arange(n, device=A.device)[None, :] <= rows[:, None], A, 0.0)


def _as_cols(b_local: Tensor) -> tuple[Tensor, bool]:
    vec = b_local.dim() == 1
    return (b_local[:, None] if vec else b_local), vec


def solve_lower_rowsharded(L_local: Tensor, b_local: Tensor, axis=coll.DATA_AXIS,
                           block: int = DEFAULT_BLOCK) -> Tensor:
    """Solve L Y = B with L block-row-sharded; B row-sharded (n_local,) or
    (n_local, m).

    Trailing-update block substitution: the residual already equals b -
    L[:, :c0] y[:c0], so each step communicates only the solved block's
    rows and its diagonal tile (one broadcast of both), never the partial
    solution."""
    b, vec = _as_cols(b_local)
    n_local, n = L_local.shape
    block = min(block, n_local)
    row0 = coll.axis_index(axis) * n_local
    resid = b.clone()
    y = torch.zeros_like(b)
    for k in range(n // block):
        c0, c1 = k * block, (k + 1) * block
        r_blk, L_blk = _owner_block([resid, L_local[:, c0:c1]], c0, block, row0, axis)
        y_blk = torch.linalg.solve_triangular(L_blk, r_blk, upper=False)
        # rows at or above the block have zero L columns here: skip them
        r1 = min(max(c1 - row0, 0), n_local)
        if r1 < n_local:
            resid[r1:] -= L_local[r1:, c0:c1] @ y_blk
        if row0 <= c0 < row0 + n_local:
            y[c0 - row0:c1 - row0] = y_blk
    return y[:, 0] if vec else y


def solve_upper_rowsharded(L_local: Tensor, b_local: Tensor, axis=coll.DATA_AXIS,
                           block: int = DEFAULT_BLOCK) -> Tensor:
    """Solve L^T Y = B with L block-row-sharded (its transpose is
    column-sharded, so each step's off-diagonal contribution is a psum of
    local L-column-slab^T @ x products, in the same psum as the owner's
    right-hand side rows and diagonal tile); B row-sharded (n_local,) or
    (n_local, m).  Proceeds bottom-up over block rows."""
    b, vec = _as_cols(b_local)
    n_local, n = L_local.shape
    block = min(block, n_local)
    row0 = coll.axis_index(axis) * n_local
    x = torch.zeros_like(b)
    for k in reversed(range(n // block)):
        c0, c1 = k * block, (k + 1) * block
        # sum_{j > k} L[j, k]^T x_j over this rank's solved rows
        r1 = min(max(c1 - row0, 0), n_local)
        S, b_blk, L_blk = _owner_block([b, L_local[:, c0:c1]], c0, block, row0, axis,
                                       partial=L_local[r1:, c0:c1].mT @ x[r1:])
        x_blk = torch.linalg.solve_triangular(L_blk.mT, b_blk - S, upper=True)
        if row0 <= c0 < row0 + n_local:
            x[c0 - row0:c1 - row0] = x_blk
    return x[:, 0] if vec else x


def _lml_forward(K_local: Tensor, y_local: Tensor, axis, block: int):
    n_local, n = K_local.shape
    row0 = coll.axis_index(axis) * n_local
    L_local = cholesky_rowsharded(K_local, axis, block)
    z_local = solve_lower_rowsharded(L_local, y_local, axis, block)
    my_diag = L_local[torch.arange(n_local, device=L_local.device), torch.arange(n_local, device=L_local.device) + row0]
    logdet_half = coll.psum(torch.log(my_diag).sum(), axis)
    quad = coll.psum((z_local * z_local).sum(), axis)
    lml = -0.5 * n * math.log(2.0 * math.pi) - logdet_half - 0.5 * quad
    return lml, L_local, z_local


class _LmlRowSharded(torch.autograd.Function):
    """The value and its analytic backward (GPML 5.9): dL/dK = 1/2 (alpha
    alpha^T - K^-1), dL/dy = -alpha, with alpha and this rank's rows of
    K^-1 from the distributed solves (two O(n^3 / D) solves a rank)."""

    @staticmethod
    def forward(ctx, K_local, y_local, axis, block):
        lml, L_local, z_local = _lml_forward(K_local, y_local, axis, block)
        ctx.save_for_backward(L_local, z_local)
        ctx.axis, ctx.block, ctx.mesh = axis, block, coll.current()
        return lml

    @staticmethod
    def backward(ctx, cot):
        L_local, z_local = ctx.saved_tensors
        axis, block = ctx.axis, ctx.block
        with ctx.mesh:
            n_local, n = L_local.shape
            row0 = coll.axis_index(axis) * n_local
            # Convention: each rank receives the full scalar cotangent and
            # returns its rows' share of the gradient; parameter gradients
            # downstream need one psum (parallel.large_n.psum_grads).
            alpha_local = solve_upper_rowsharded(L_local, z_local, axis, block)
            alpha_full = coll.all_gather(alpha_local, axis)
            # this rank's rows of K^-1: K X = I for its one-hot columns,
            # transposed by symmetry
            eye_local = torch.zeros((n_local, n), dtype=L_local.dtype, device=L_local.device)
            eye_local[:, row0:row0 + n_local] = torch.eye(n_local, dtype=L_local.dtype, device=L_local.device)
            Z = solve_lower_rowsharded(L_local, eye_local, axis, block)
            Kinv_rows = solve_upper_rowsharded(L_local, Z, axis, block)
            Kbar = (cot * 0.5) * (alpha_local[:, None] * alpha_full[None, :] - Kinv_rows)
            ybar = -cot * alpha_local
        return Kbar, ybar, None, None


def lml_rowsharded(K_local: Tensor, y_local: Tensor, axis=coll.DATA_AXIS, block: int = DEFAULT_BLOCK) -> Tensor:
    """Large-N GP log marginal likelihood with K block-row-sharded.

    L = -(n/2) log 2pi - sum(log diag L) - 1/2 ||L^-1 y||^2 (GPML eq. 5.8):
    1/2 log|K| = sum log diag L and y^T K^-1 y = ||L^-1 y||^2, so the
    forward needs one solve.  Returns the replicated scalar on every rank;
    differentiable through its analytic backward."""
    return _LmlRowSharded.apply(K_local, y_local, axis, block)


def make_sharded_lml(mesh, axis=coll.DATA_AXIS, block: int = DEFAULT_BLOCK):
    """Entry point: (this rank's K rows (n_local, n), its y rows (n_local,))
    -> the replicated lml, run under ``mesh`` (a ``parallel.mesh.Mesh``)."""

    def fn(K_local: Tensor, y_local: Tensor) -> Tensor:
        with mesh:
            return lml_rowsharded(K_local, y_local, axis, block)

    return fn


__all__ = [
    "cholesky_rowsharded",
    "lml_rowsharded",
    "make_sharded_lml",
    "solve_lower_rowsharded",
    "solve_upper_rowsharded",
]
