"""Streaming conditioning: O(n^2 b) posterior updates, no refits.

PyTorch twin of ``gogp_tpu/gp/streaming.py``.  At fixed hyperparameters,
conditioning on b new points needs only the new block row of the factor:

    L' = [ L     0   ]      w  = L^{-1} k_new          (one blocked TRSM)
         [ w^T  Lbb  ],     Lbb = chol(Kbb - w^T w)    (b x b)

The posterior lives at a fixed *capacity* under the masked-padding
convention of ``gp.core`` (padded rows are identity rows of K and zeros of
y): appended points claim the next padded slots, and the insertion offset
is the mask's sum, a tensor, so an append has the same shapes whatever the
fill.  ``linalg.trsm_lower`` runs the TRSM (K5 and GEMMs at n >= 1024 on
the card), ``cb.plain_cholesky`` the b x b block (plain in the JAX twin
too) and ``linalg.cho_solve_vec`` the new alpha.

Hyperparameters stay fixed across appends; no downdate is provided
(re-absorb without the point instead).  Appending past the capacity is an
error here, where the JAX twin's ``dynamic_update_slice`` clamps silently.
"""

from __future__ import annotations

import torch

from gogp_torch.gp.core import GP, Posterior, _like, _points
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

Tensor = torch.Tensor


def streaming_posterior(gp: GP, theta_simil, theta_noise, capacity: int, dtype=torch.float32,
                        device=None) -> Posterior:
    """An empty posterior with ``capacity`` padded slots: chol = I, zero
    y and alpha, an all-zero mask (what absorb gives all-padding data).
    ``device``: that of ``theta_simil`` when it is a tensor, else the CUDA
    card (pass ``device="cpu"`` for the CPU)."""
    if device is None:
        device = theta_simil.device if isinstance(theta_simil, Tensor) else torch.device("cuda")

    def t(v, k):
        return torch.as_tensor(v, dtype=dtype, device=device).reshape(k)

    n = capacity
    zeros = torch.zeros(n, dtype=dtype, device=device)
    return Posterior(
        theta_simil=t(theta_simil, gp.n_theta_simil),
        theta_noise=t(theta_noise, gp.n_theta_noise),
        x=torch.zeros((n, gp.ndim), dtype=dtype, device=device),
        y=zeros,
        chol=torch.eye(n, dtype=dtype, device=device),
        alpha=zeros.clone(),
        mask=zeros.clone(),
    )


def absorb_append(gp: GP, post: Posterior, x_new, y_new) -> Posterior:
    """Condition on ``b`` new observations in O(n^2 b).

    ``x_new``: (b, ndim) (or (b,) for 1-D); ``y_new``: (b,).  The points
    claim the next ``b`` padded slots.  The result equals (up to rounding) a
    fresh ``absorb`` on the concatenated data.  One host read: the offset."""
    x_new = _points(_like(x_new, post.x))
    b = x_new.shape[0]
    y_new = _like(y_new, post.y).reshape(b)
    n = post.x.shape[0]
    c = int(post.mask.sum())
    if c + b > n:
        raise ValueError(f"absorb_append: {c} + {b} points exceed the capacity {n}")

    # cross-covariance of the new block against the live rows; padded rows
    # of knew are zero and L is identity there, so w is zero there too
    knew = gp.simil.matrix(post.theta_simil, post.x, x_new) * post.mask[:, None]  # (n, b)
    w = linalg.trsm_lower(post.chol, knew)  # (n, b)

    kbb = gp.simil.matrix(post.theta_simil, x_new, x_new)
    kbb = kbb + torch.diag_embed(gp.noise.vector(post.theta_noise, x_new))
    lbb = cb.plain_cholesky(kbb - w.T @ w)  # b x b; NaN, as in the JAX twin, where not positive definite

    chol = post.chol.clone()
    chol[c : c + b] = w.T  # zero at columns >= c
    chol[c : c + b, c : c + b] = lbb
    x, y, mask = post.x.clone(), post.y.clone(), post.mask.clone()
    x[c : c + b] = x_new
    y[c : c + b] = y_new
    mask[c : c + b] = 1.0
    alpha = linalg.cho_solve_vec(chol, y * mask)
    return Posterior(post.theta_simil, post.theta_noise, x, y, chol, alpha, mask)


def absorb_stream(gp: GP, post: Posterior, xs, ys) -> Posterior:
    """Fold a stream of batches through :func:`absorb_append`, in order.
    ``xs``: (steps, b, ndim); ``ys``: (steps, b)."""
    for xb, yb in zip(xs, ys):
        post = absorb_append(gp, post, xb, yb)
    return post


__all__ = ["absorb_append", "absorb_stream", "streaming_posterior"]
