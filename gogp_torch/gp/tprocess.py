"""Student-t process regression: the heavy-tailed analogue of the exact GP.

PyTorch twin of ``gogp_tpu/gp/tprocess.py``.  y ~ MVT_nu(0, K), the
multivariate Student-t with nu degrees of freedom and scale matrix K (the
exact core's K, noise on the diagonal).  The same factorization and the same
:class:`~gogp_torch.gp.core.Posterior` as the GP, but the predictive variance
scales with the data's quadratic form (Shah, Wilson & Ghahramani, AISTATS
2014).  As nu -> inf every quantity tends to the exact GP's.

``tp_lml`` factors through ``linalg.cholesky`` (K1 on the card for f32 with
1024 <= n <= 4096, differentiated by Murray's pullback) and ``tp_predict``
solves through ``linalg.trsm_lower`` (K5 and GEMMs there).  Masks follow the
exact core's padding convention; in the flat-vector protocol nu is
2 + exp(v_nu), so the predictive variance (finite for nu > 2) exists.
"""

from __future__ import annotations

import torch

from gogp_torch.gp.core import GP, Posterior, _like, _prepare, absorb, masked_cov
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_LOG_PI = 1.1447298858494002


def tp_lml(gp: GP, nu, theta_simil, theta_noise, x, y, mask=None) -> Tensor:
    """Log marginal likelihood of the Student-t process:

      lgamma((nu+n)/2) - lgamma(nu/2) - (n/2) log(nu pi) - 1/2 log|K|
      - ((nu+n)/2) log(1 + y^T K^{-1} y / nu)

    with n the count of unmasked rows.  Differentiable in nu and every
    theta."""
    ts, tn, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    nu = _like(nu, x)
    L = linalg.cholesky(masked_cov(gp, ts, tn, x, mask))
    beta = y @ linalg.cho_solve_vec(L, y)
    logdet = linalg.logdet_from_chol(L, mask)
    n_eff = mask.sum()
    return (
        torch.lgamma(0.5 * (nu + n_eff))
        - torch.lgamma(0.5 * nu)
        - 0.5 * n_eff * (torch.log(nu) + _LOG_PI)
        - 0.5 * logdet
        - 0.5 * (nu + n_eff) * torch.log1p(beta / nu)
    )


def tp_absorb(gp: GP, nu, theta_simil, theta_noise, x, y, mask=None) -> Posterior:
    """Condition the TP: the GP's factorization and Posterior (nu matters
    only at lml and predict time)."""
    return absorb(gp, theta_simil, theta_noise, x, y, mask=mask)


def tp_predict(gp: GP, nu, post: Posterior, z) -> tuple[Tensor, Tensor]:
    """Predictive mean and std of the noise-free latent at test inputs z.

    The mean is the GP's; the variance is the GP's noise-free band scaled by
    (nu + beta) / (nu + n - 2), beta = y^T K^{-1} y: residuals larger than
    the kernel expects widen the bands.  Needs nu + n > 2."""
    nu = _like(nu, post.x)
    z = _like(z, post.x)
    z = z.reshape(1, -1) if z.dim() < 2 else z
    if z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z) * post.mask[:, None]
    mu = kstar.T @ post.alpha
    v = linalg.trsm_lower(post.chol, kstar)
    var_gp = torch.clamp(gp.simil.diag_matrix(post.theta_simil, z) - (v * v).sum(0), min=0.0)
    beta = post.y @ post.alpha
    scale = (nu + beta) / (nu + post.mask.sum() - 2.0)
    return mu, torch.sqrt(scale * var_gp)


def make_tp_logp(gp: GP, x, y, mask=None):
    """Flat-vector log-density v = [v_nu, log theta_simil..., log
    theta_noise...], nu = 2 + exp(v_nu).  Returns (logp, n_params)."""
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise

    def logp(v):
        v = torch.as_tensor(v)
        nu = 2.0 + torch.exp(v[0])
        theta = torch.exp(v[1:])
        return tp_lml(gp, nu, theta[:nts], theta[nts:], x, y, mask=mask)

    return logp, 1 + nts + ntn


__all__ = ["make_tp_logp", "tp_absorb", "tp_lml", "tp_predict"]
