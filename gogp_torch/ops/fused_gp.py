"""The small-GP value and gradient of a whole chain population, with K7.

PyTorch twin of ``gogp_tpu/ops/fused_gp.py``.  A sampler on GP
hyperparameters (ChEES-HMC on the hyperpriors study) evaluates the log-joint
and its gradient once per leapfrog step, for every chain at once.  For a
theta-only model (x, y fixed) that evaluation is

- the covariance K(v) of each chain, built by the study's own kernel
  functions (``torch.func.vmap`` over ``gp.core.masked_cov``);
- L^-1 of each K, K = L L^T: K7 (``fused_gp_linv``, hand-written CUDA in
  ``gogp_torch/csrc/fused_gp.cu``: one warp per chain for n <= 64, one CTA
  per chain above), the one kernel;
- the LML and W = alpha alpha^T - K^-1 from L^-1 (``_lml_and_w_from_linv``,
  batched ``torch.matmul``; the JAX package keeps it in XLA outside the
  Pallas kernel too);
- the gradient by GPML eq. 5.9, dLML/dv_k = 1/2 <W, dK/dv_k>, as one
  vector-Jacobian product of the batched covariance with cotangent W/2
  (exact, where the JAX twin takes ``jax.jacfwd``);
- the priors and their gradient by autograd.

``make_fused_value_and_grad`` and ``make_reference_value_and_grad`` return
``vg(V) -> (logp, grad)`` for V of shape (chains, p) or (p,).  The fused one
sends L^-1 through the dispatch rule below; the reference takes the plain
version every time.  The mask is one (n,) mask for every row, or one mask
per row, (rows, n), with V (rows, p): the rolling forecast's prefix fits
(``tutorial.evaluate``), every prefix of a series in one batch.

Dispatch (:func:`linv`): a CUDA float32 batch with n <= ``K7_MAX_N`` goes to
K7, outside :func:`gogp_torch.ops.linalg.force_plain`; everything else takes
the plain version, ``torch.linalg.cholesky`` then ``solve_triangular``
against I.  The wrapper :func:`fused_gp_linv` itself takes the plain version
only for a CPU tensor; on a CUDA tensor it launches K7 or raises.

Padding: none.  The JAX twin pads n to a multiple of 64 for Mosaic's compile
time; K7 takes any n up to its limit.  The mask convention is kept exactly: a
0/1 ``mask`` makes padded rows identity rows of K and zeros of y, so the LML
and its gradient are those of the unpadded problem.

Priors see V with the chain axis leading and index ``v[..., k]``, so they
return one value per chain.  A prior that reads the mask closes over it:
``lambda V: priors(V, masks)`` pairs each row of V with its own mask.
"""

from __future__ import annotations

import torch

from gogp_torch.gp.core import masked_cov
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453

# The largest n K7 takes: its blocked class pads to 128, K2's tile.  Measured
# on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py, 64 matrices: K7
# against ``cholesky`` + ``solve_triangular(L, I)`` 0.009 / 0.146 ms at n =
# 32, 0.019 / 0.187 at 44, 0.036 / 0.147 at 64, 0.043 / 0.276 at 96, 0.069 /
# 0.290 at 128: K7 wins at every n up to the limit, so the limit stays.
K7_MAX_N = 128


def linv_plain(K: Tensor) -> Tensor:
    """L^-1 of each SPD matrix of a (..., n, n) batch: ``torch.linalg``'s
    Cholesky (NaN where K is not positive definite), then a triangular solve
    against I."""
    L = cb.plain_cholesky(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def fused_gp_linv(K: Tensor) -> Tensor:
    """L^-1 of each SPD matrix of an (n, n) or (..., n, n) tensor, the
    batch in one launch of K7 (under ``torch.func.vmap`` too).  The kernel
    takes float32, contiguous, 1 <= n <= ``K7_MAX_N``.  A non-positive pivot
    gives NaN, as on the TPU."""
    if not cb._is_cuda(K):
        return linv_plain(K)
    return cb._ForwardOnly.apply("fused_gp_linv", _fused_gp_linv_cuda, K)


def _fused_gp_linv_cuda(K: Tensor) -> Tensor:
    n = K.shape[-1]
    if K.dim() < 2 or K.shape[-2] != n:
        raise ValueError(f"fused_gp_linv: expected (n, n) or (..., n, n), got {tuple(K.shape)}")
    cb._check_kernel_inputs("fused_gp_linv", K)
    if not 1 <= n <= K7_MAX_N:
        raise ValueError(f"fused_gp_linv: the CUDA kernel takes 1 <= n <= {K7_MAX_N}, got n={n}")
    batch = K.numel() // (n * n)  # every leading axis one batch (a vmapped call's too)
    out = torch.empty_like(K)
    if batch:
        cb._launch(K, "gogp_fused_gp_linv", K.data_ptr(), out.data_ptr(), batch, n)
        cb.LAUNCHES["fused_gp_linv"] += 1
    return out


def takes_kernel(K: Tensor) -> bool:
    """The dispatch rule: K7 for a CUDA float32 batch with n <= K7_MAX_N,
    outside ``linalg.force_plain()``."""
    return (not linalg._FORCE_PLAIN and K.is_cuda and K.dtype == torch.float32
            and K.shape[-1] <= K7_MAX_N)


def linv(K: Tensor) -> Tensor:
    """L^-1 of each matrix of the batch, by :func:`takes_kernel`'s rule."""
    return fused_gp_linv(K.contiguous()) if takes_kernel(K) else linv_plain(K)


def _lml_and_w_from_linv(Linv: Tensor, yv: Tensor, n_eff: Tensor) -> tuple[Tensor, Tensor]:
    """(lml, W) from L^-1, batched over the leading axes.

    diag(L) = 1/diag(L^-1);  z = L^-1 y;  alpha = L^-T z;  K^-1 = L^-T L^-1.
    """
    diag_linv = torch.diagonal(Linv, dim1=-2, dim2=-1)
    logdet = -2.0 * torch.log(diag_linv.abs() + 1e-30).sum(-1)
    z = torch.einsum("...ij,...j->...i", Linv, yv)
    quad = (z * z).sum(-1)
    alpha = torch.einsum("...ki,...k->...i", Linv, z)
    Kinv = Linv.mT @ Linv
    lml = -0.5 * (n_eff * _LOG_2PI + logdet + quad)
    W = alpha[..., :, None] * alpha[..., None, :] - Kinv
    return lml, W


def _make_vg(gp, x, y, mask, priors_fn, linv_fn):
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[:, None]
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    mask = (torch.ones(n, dtype=x.dtype, device=x.device) if mask is None
            else torch.as_tensor(mask, dtype=x.dtype, device=x.device))
    yv = y * mask
    n_eff = mask.sum(-1)
    nts = gp.n_theta_simil

    def cov_from_v(v, m):
        theta = torch.exp(v)
        return masked_cov(gp, theta[:nts], theta[nts:], x, m)

    batched_cov = torch.func.vmap(cov_from_v, in_dims=(0, 0 if mask.dim() == 2 else None))

    def vg(V):
        V = torch.as_tensor(V, dtype=x.dtype, device=x.device)
        single = V.dim() == 1
        if mask.dim() == 2 and (single or V.shape[0] != mask.shape[0]):
            raise ValueError(f"{mask.shape[0]} per-row masks need V of shape ({mask.shape[0]}, p), got {tuple(V.shape)}")
        V = (V[None] if single else V).detach().requires_grad_(True)
        with torch.enable_grad():
            K = batched_cov(V, mask)
            lml, W = _lml_and_w_from_linv(linv_fn(K.detach()), yv, n_eff)
            outputs, cotangents = [K], [0.5 * W]
            if priors_fn is not None:
                pv = priors_fn(V)
                outputs.append(pv)
                cotangents.append(torch.ones_like(pv))
                lml = lml + pv.detach()
            (grad,) = torch.autograd.grad(outputs, V, cotangents)
        return (lml[0], grad[0]) if single else (lml, grad)

    return vg


def make_fused_value_and_grad(gp, x, y, mask=None, priors_fn=None):
    """``vg(V) -> (logp, grad)``, with L^-1 on K7 where :func:`takes_kernel`
    says so.

    ``gp``: the GP spec (theta-only: x, y fixed here, on the device and in
    the dtype ``x`` has); ``mask``: None, (n,), or (rows, n), one per row of
    V; ``priors_fn``: optional ``priors(V) -> (chains,)`` on log-thetas.  V
    is (chains, p) or (p,); with per-row masks, (rows, p).
    """
    return _make_vg(gp, x, y, mask, priors_fn, linv)


def make_reference_value_and_grad(gp, x, y, mask=None, priors_fn=None):
    """The same math with the plain L^-1: the oracle for the fused route."""
    return _make_vg(gp, x, y, mask, priors_fn, linv_plain)
