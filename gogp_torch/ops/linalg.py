"""Dense linear algebra for the GP core: the dispatching front door.

PyTorch twin of ``gogp_tpu/ops/linalg.py``.  Each function sends CUDA f32
matrices with n >= 1024 through the blocked driver and its CUDA kernels
(``cholesky_blocked``), exactly where the JAX package sends TPU f32 matrices
to Pallas, and runs ``torch.linalg`` everywhere else.  Inside
:func:`force_plain` every call takes ``torch.linalg``: the reference path that
the kernels are held against, and the baseline they are timed against.

``precision`` arguments are accepted for parity with the JAX twin.  Every f32
matmul of the port runs at full f32 precision; TF32 is not mapped.

The blocked path differentiates on both devices through the JAX package's
analytic pullbacks (``cholesky_blocked``): ``cholesky`` through Murray's
Cholesky pullback, ``lml_core`` through GPML 5.9, ``trsm_lower`` and
``cho_solve_mat`` through the TRSM pullbacks.  So ``absorb``, ``lml``,
``gp_observe`` and the forecasts give gradients on the kernel path.

Not on this path yet: the JAX package's NaN -> float32 precision rescue
(``_RESCUE_MIN_N = 8192``) and ``tril_inv``.
"""

from __future__ import annotations

import contextlib

import torch

from gogp_torch.ops import cholesky_blocked as cb

Tensor = torch.Tensor

_FORCE_PLAIN = False


@contextlib.contextmanager
def force_plain():
    """Run every op on the plain ``torch.linalg`` path (the counterpart of
    ``gogp_tpu.ops.linalg.force_xla``)."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def _block(K: Tensor) -> int | None:
    return None if _FORCE_PLAIN else cb._eligible_block(K)


def cholesky(K: Tensor, precision: str | None = None) -> Tensor:
    """Lower Cholesky factor; NaN (not an exception) where K is not
    positive definite, as in the JAX package."""
    block = _block(K)
    if block is not None:
        return cb.cholesky(K, block)
    return cb.plain_cholesky(K)


def cholesky_with_jitter(
    K: Tensor,
    max_tries: int = 5,
    initial_jitter: float = 1e-8,
    precision: str | None = None,
) -> tuple[Tensor, Tensor]:
    """Cholesky with escalating diagonal jitter.

    While the factor's diagonal holds a non-finite entry, retry with
    ``initial_jitter * mean(diag K) * 10^t`` added to the diagonal, for
    t = 0 .. max_tries-1.  Returns ``(L, jitter_used)``; with the tries
    exhausted the factor still carries NaNs.  Each test of the factor reads
    one flag back to the host.
    """
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    scale = torch.diagonal(K).mean() * initial_jitter
    L = cholesky(K, precision)
    jitter = torch.zeros((), dtype=K.dtype, device=K.device)
    for t in range(max_tries):
        if bool(torch.isfinite(torch.diagonal(L)).all()):
            break
        jitter = scale * 10.0**t
        L = cholesky(K + jitter * eye, precision)
    return L, jitter


def lml_core(K: Tensor, y: Tensor, precision: str | None = None) -> Tensor:
    """-1/2 (log|K| + y^T K^-1 y), the data part of the GP log marginal
    likelihood (GPML eq. 5.8).  Blocked kernels with the analytic GPML-5.9
    backward where eligible and where K3 takes the size (``cb.trsv_fits``:
    n <= 53888 on CUDA, above which the JAX package takes K4, not ported);
    otherwise torch.linalg under ordinary autograd."""
    if y.dim() == 1:
        block = _block(K)
        if block is not None and cb.trsv_fits(K.shape[-1], block):
            return cb.lml_core(K, y, block)
    L = cb.plain_cholesky(K)
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    return -torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1) - 0.5 * (z * z).sum(-1)


def cho_solve_vec(L: Tensor, y: Tensor) -> Tensor:
    """alpha = K^{-1} y given the lower factor L.  Always torch.linalg: the
    JAX package computes it with XLA outside any Pallas kernel."""
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[:, 0]


def cho_solve_mat(L: Tensor, B: Tensor) -> Tensor:
    """K^{-1} B given the lower factor L: two blocked TRSMs with their
    analytic pullbacks where eligible (2-D B), torch.linalg otherwise."""
    block = _block(L)
    if block is not None and B.dim() == 2:
        return cb.trsm_lower_t_ad(L, cb.trsm_lower_ad(L, B, block), block)
    Z = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Z, upper=True)


def trsm_lower(L: Tensor, B: Tensor) -> Tensor:
    """L^{-1} B, the half-solve of the predictive variance."""
    block = _block(L)
    if block is not None and B.dim() == 2:
        return cb.trsm_lower_ad(L, B, block)
    if B.dim() == 1:
        return torch.linalg.solve_triangular(L, B[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, B, upper=False)


def logdet_from_chol(L: Tensor, mask: Tensor | None = None) -> Tensor:
    """log|K| = 2 sum log diag(L); with ``mask``, padded entries (L_ii = 1
    under the masked-covariance convention) are left out."""
    d = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    if mask is not None:
        d = d * mask
    return 2.0 * d.sum(-1)
