"""Toeplitz fast path: O(n log n) covariance matvecs for gridded inputs.

PyTorch twin of ``gogp_tpu/ops/toeplitz.py``.  On a regular 1-D grid a
stationary kernel's covariance is symmetric Toeplitz, K[i, j] = c(|i - j|):
the whole matrix is one length-n column, and K v is a circulant embedding
plus ``torch.fft.rfft``/``irfft`` of length 2n.  Plugged into the iterative
engine (``ops.iterative``: CG, SLQ, the frozen-solution gradient) it gives
the LML and its gradient at n log n a CG step and O(n) memory.

A leading batch axis on the first column, (B, n), is B Toeplitz operators
applied to (B, n, k) blocks in one FFT.

Constraints (checked in ``gp.core.lml_toeplitz``): a regular 1-D grid,
homoscedastic noise, no padding mask.
"""

from __future__ import annotations

import torch

from gogp_torch.ops import iterative
from gogp_torch.ops.draws import as_draws

Tensor = torch.Tensor


def circulant_spectrum(c: Tensor) -> Tensor:
    """rfft of the 2n circulant embedding [c_0..c_{n-1}, 0, c_{n-1}..c_1] of
    the symmetric-Toeplitz first column ``c`` (..., n)."""
    circ = torch.cat([c, c.new_zeros(c.shape[:-1] + (1,)), c[..., 1:].flip(-1)], -1)
    return torch.fft.rfft(circ, dim=-1)


def toeplitz_matvec_fn(c: Tensor):
    """Batched matvec V -> K V for K = SymToeplitz(c); V: (n,) or (..., n, k).
    One rfft of the zero-padded operand, a product with the cached spectrum,
    one irfft."""
    n = c.shape[-1]
    fc = circulant_spectrum(c)[..., :, None]

    def mv(V):
        squeeze = V.dim() == 1
        Vm = V[:, None] if squeeze else V
        fv = torch.fft.rfft(Vm, n=2 * n, dim=-2)
        out = torch.fft.irfft(fv * fc, n=2 * n, dim=-2)[..., :n, :].to(V.dtype)
        return out[:, 0] if squeeze else out

    return mv


def toeplitz_col_fn(c: Tensor):
    """Column accessor for the pivoted-Cholesky preconditioner: col_j[i] =
    c[|i - j|], one gather per column (``j`` one index per batch element)."""
    n = c.shape[-1]
    idx = torch.arange(n, device=c.device)

    def col(j: Tensor) -> Tensor:
        return torch.take_along_dim(c, (idx - j[..., None]).abs(), -1)

    return col


def lml_toeplitz_core(c_fn, y: Tensor, draws, num_probes: int = 16, cg_iters: int = 100, lanczos_iters: int = 32,
                      precond_rank: int = 0, noise_var=None):
    """-1/2 (log|K| + y^T K^-1 y) for K = SymToeplitz(c_fn()) and the
    frozen-solution aux: (value, (alpha, Z, S)), for a backward through
    :func:`toeplitz_quadratic_forms` (``gp.core.lml_toeplitz``).
    ``precond_rank > 0``: PCG and preconditioned SLQ with the pivoted-Cholesky
    preconditioner from O(rank) column gathers (``noise_var``, the constant
    noise variance on the diagonal, required)."""
    c = c_fn()
    n = y.shape[-1]
    mv = toeplitz_matvec_fn(c)
    k1, k2 = as_draws(draws, y).split(2)
    pc = None
    if precond_rank > 0:
        if noise_var is None:
            raise ValueError("precond_rank > 0 needs noise_var")
        c_sg = c.detach()
        nv = torch.as_tensor(noise_var, dtype=y.dtype, device=y.device).detach()
        pc = iterative.pivoted_precond_cols(toeplitz_col_fn(c_sg), c_sg[..., :1].expand(c.shape), precond_rank,
                                            nv[..., None])
        probes_slq = k1.normal((num_probes, n + precond_rank), y)
    else:
        probes_slq = iterative.rademacher(k1, (num_probes, n), y)
    probes_tr = iterative.rademacher(k2, (n, num_probes), y)
    X, _ = iterative.cg_solve(mv, iterative._solve_block(y, probes_tr), cg_iters, precond=pc)
    alpha, S = X[..., 0], X[..., 1:]
    if pc is not None:
        logdet = iterative.slq_logdet_pcg(mv, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters)
    else:
        logdet = iterative.slq_logdet(mv, probes_slq, lanczos_iters)
    value = -0.5 * (logdet + (y * alpha).sum(-1))
    return value, (alpha, probes_tr, S)


def _quadratic_forms(mv, alpha: Tensor, Z: Tensor, S: Tensor) -> Tensor:
    """alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K) through a matvec:
    K [alpha | S | Z] in one application."""
    p = Z.shape[-1]
    Z = Z.expand(S.shape)
    prod = mv(torch.cat([alpha[..., None], S, Z], -1))
    quad = (alpha * prod[..., 0]).sum(-1)
    tr = 0.5 * ((Z * prod[..., 1 : 1 + p]).sum((-2, -1)) + (S * prod[..., 1 + p :]).sum((-2, -1)))
    return quad - tr / p


def toeplitz_quadratic_forms(c_fn, alpha: Tensor, Z: Tensor, S: Tensor) -> Tensor:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K) by FFT matvecs:
    d lml = g/2 dh/dtheta with (alpha, Z, S) frozen; gradients flow through
    the FFT of the first column."""
    return _quadratic_forms(toeplitz_matvec_fn(c_fn()), alpha, Z, S)


__all__ = [
    "circulant_spectrum",
    "lml_toeplitz_core",
    "toeplitz_col_fn",
    "toeplitz_matvec_fn",
    "toeplitz_quadratic_forms",
]
