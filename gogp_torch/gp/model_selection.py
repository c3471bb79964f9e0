"""Model selection: exact leave-one-out cross-validation and scoring.

PyTorch twin of ``gogp_tpu/gp/model_selection.py``.  Once K is factored, the
exact LOO posterior costs one diagonal of K^{-1} (GPML §5.4.2, eqs.
5.10-5.12):

    mu_i      = y_i - alpha_i / [K^{-1}]_ii
    sigma_i^2 = 1 / [K^{-1}]_ii
    log p_LOO = sum_i log N(y_i | mu_i, sigma_i^2)

with diag(K^{-1}) the squared column norms of inv(L) (``linalg.tril_inv``:
K5 and GEMMs at n >= 1024 on the card, forward only there; differentiable
by autograd on the plain route).  These predict the NOISY y_i.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gogp_torch.gp.core import GP, Posterior, absorb
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453


class LOOResult(NamedTuple):
    """Per-point exact leave-one-out predictive state."""

    mu: Tensor  # (n,) LOO predictive means of y_i
    sigma: Tensor  # (n,) LOO predictive stds (noise included)
    logp: Tensor  # (n,) log N(y_i | mu_i, sigma_i^2), 0 at padded rows
    total: Tensor  # () masked sum: the LOO pseudo-log-likelihood


def loo_from_posterior(post: Posterior) -> LOOResult:
    """Exact LOO residuals from a fitted posterior; padded rows (identity
    rows of K, zero y) are masked out of ``logp``."""
    w = linalg.tril_inv(post.chol)
    kinv_diag = (w * w).sum(0)
    var = 1.0 / kinv_diag
    resid = post.alpha * var  # y_i - mu_i
    mu = post.y - resid
    logp = -0.5 * (torch.log(var) + resid * resid / var + _LOG_2PI) * post.mask
    return LOOResult(mu, torch.sqrt(var), logp, logp.sum())


def loo(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> LOOResult:
    """absorb, then :func:`loo_from_posterior`."""
    return loo_from_posterior(absorb(gp, theta_simil, theta_noise, x, y, mask))


def loo_score(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> Tensor:
    """The LOO pseudo-likelihood as a differentiable scalar (GPML §5.4.3),
    an alternative MLE objective to ``gp.lml``."""
    return loo(gp, theta_simil, theta_noise, x, y, mask).total


def bic(lml_value, n_params: int, n_obs):
    """Bayesian information criterion (lower is better): -2 LML + p log n."""
    log_n = torch.log(torch.as_tensor(n_obs, dtype=lml_value.dtype, device=lml_value.device)) \
        if isinstance(lml_value, Tensor) else math.log(n_obs)
    return -2.0 * lml_value + n_params * log_n


def aic(lml_value, n_params: int):
    """Akaike information criterion (lower is better): -2 LML + 2p."""
    return -2.0 * lml_value + 2.0 * n_params


__all__ = ["LOOResult", "aic", "bic", "loo", "loo_from_posterior", "loo_score"]
