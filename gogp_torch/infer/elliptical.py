"""Elliptical slice sampling: exact latent posteriors for non-Gaussian GPs.

PyTorch twin of ``gogp_tpu/infer/elliptical.py`` (Murray, Adams & MacKay
2010).  For f ~ N(0, K_theta), y_i ~ p(y_i | f_i, theta_lik), ESS samples the
exact latent posterior that ``gp.laplace`` and ``gp.ep`` approximate: each
update draws nu = chol @ eps from the prior, sets a slice threshold and
shrinks a bracket of angles until a proposal f cos t + nu sin t lies above
it.  No gradients, step sizes or tuning.

Chains run in lockstep: ``f`` may carry any leading axes (chains, or rows of
problems times chains), and every chain's bracket shrinks in the same host
loop, a chain whose slice is met frozen while the others go on (at most
``_MAX_SHRINKS`` rounds, then the chain stays put, as in the JAX twin).

Draws come from a hook, for parity with the JAX twin's keys: an
:class:`ESSDraws` maps the state's batch shape to one update's draws: the
normal vector for nu, u (the threshold's uniform), t0's unit uniform and up
to ``_MAX_SHRINKS`` unit uniforms for the shrinks, mapped to
lo + u (hi - lo) as ``jax.random.uniform(minval, maxval)`` maps them.
:func:`generator_draws` draws them from a ``torch.Generator``.

Prediction from draws is the exact GP conditional averaged over samples:

    mu*(z)  = E_s[k(z, X) K^{-1} f_s]
    var*(z) = [k(z, z) - k(z, X) K^{-1} k(X, z)] + Var_s[k(z, X) K^{-1} f_s]
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.gp.core import GP
from gogp_torch.gp.laplace import _cov, _cross, _prep, _prior, _test_points, _zeros_noise, class_prob
from gogp_torch.gp.likelihoods import Likelihood
from gogp_torch.ops import linalg

Tensor = torch.Tensor

_TWO_PI = 6.283185307179586
_MAX_SHRINKS = 64  # the bracket halves to ~1e-19 rad by then; a safety bound


class ESSDraws(NamedTuple):
    """One update's draws for a batch of chains of state shape (*batch, n)."""

    eps: Tensor  # (*batch, n) standard normals: nu = chol @ eps
    u: Tensor  # (*batch,) unit uniform: the slice threshold ll + log u
    t0: Tensor  # (*batch,) unit uniform: the first angle 2 pi t0
    shrinks: Tensor  # (*batch, _MAX_SHRINKS) unit uniforms, one per shrink


DrawsFn = Callable[[tuple, torch.dtype, torch.device], ESSDraws]


def generator_draws(generator: torch.Generator | None = None) -> DrawsFn:
    """The default draws: from ``generator`` (torch's default one when
    None), shaped by the state ``(*batch, n)``, drawn in float64 and cast to
    the state's dtype, so that a float32 and a float64 run from one seed
    share their draws."""

    def draws(shape, dtype, device):
        batch = tuple(shape[:-1])

        def draw(fn, s):
            return fn(s, generator=generator, dtype=torch.float64, device=device).to(dtype)

        return ESSDraws(draw(torch.randn, tuple(shape)), draw(torch.rand, batch), draw(torch.rand, batch),
                        draw(torch.rand, batch + (_MAX_SHRINKS,)))

    return draws


def _uniform(u: Tensor, lo, hi) -> Tensor:
    """``jax.random.uniform``'s map of a unit uniform into [lo, hi)."""
    return torch.maximum(torch.as_tensor(lo, dtype=u.dtype, device=u.device), u * (hi - lo) + lo)


def ess_update(loglik_fn: Callable[[Tensor], Tensor], chol: Tensor, f: Tensor, ll: Tensor, d: ESSDraws):
    """One elliptical slice update of every chain: (f_new, ll_new,
    n_shrinks).  ``f`` (*batch, n), ``chol`` (n, n) or broadcasting
    (*batch, n, n); ``ll`` must equal ``loglik_fn(f)`` (*batch,)."""
    nu = (chol @ d.eps[..., None])[..., 0]
    logy = ll + torch.log(d.u)
    t = _uniform(d.t0, 0.0, _TWO_PI)
    lo, hi = t - _TWO_PI, t

    def propose(t):
        fp = f * torch.cos(t)[..., None] + nu * torch.sin(t)[..., None]
        return fp, loglik_fn(fp)

    fp, llp = propose(t)
    shrinks = torch.zeros(ll.shape, dtype=torch.int64, device=f.device)
    for i in range(_MAX_SHRINKS):
        active = llp < logy
        if not bool(active.any()):
            break
        lo = torch.where(active & (t < 0.0), t, lo)
        hi = torch.where(active & (t >= 0.0), t, hi)
        t = torch.where(active, _uniform(d.shrinks[..., i], lo, hi), t)
        fp_new, llp_new = propose(t)
        fp = torch.where(active[..., None], fp_new, fp)
        llp = torch.where(active, llp_new, llp)
        shrinks = shrinks + active
    # the safety bound fires only on pathological likelihoods; such a chain
    # stays where it was
    bad = llp < logy
    return torch.where(bad[..., None], f, fp), torch.where(bad, ll, llp), shrinks


class ESSResult(NamedTuple):
    """Latent draws and everything the GP-conditional prediction needs
    (leading rows axes where :func:`run_ess_gp` was batched)."""

    f: Tensor  # (C, S, n) latent posterior draws
    loglik: Tensor  # (C, S)
    shrinks: Tensor  # (C, S) bracket-shrink counts
    theta_simil: Tensor
    theta_lik: Tensor
    x: Tensor  # (n, ndim)
    mask: Tensor  # (n,)
    chol: Tensor  # (n, n) prior factor chol(K)


def run_ess_chain(loglik_fn, chol, f0c, draws: DrawsFn, num_warmup: int, num_samples: int, thin: int = 1):
    """Chains from (*batch, n) initial states: ((*batch, S, n) draws,
    (*batch, S) logliks, (*batch, S) shrink counts); ``draws`` is called
    once per update."""
    steps = num_warmup + num_samples * thin
    f, ll = f0c, loglik_fn(f0c)
    fs, lls, shr = [], [], []
    for _ in range(steps):
        f, ll, i = ess_update(loglik_fn, chol, f, ll, draws(tuple(f.shape), f.dtype, f.device))
        fs.append(f)
        lls.append(ll)
        shr.append(i)
    sel = slice(num_warmup + thin - 1, None, thin)
    return (torch.stack(fs[sel], -2), torch.stack(lls[sel], -1), torch.stack(shr[sel], -1))


def run_ess(loglik_fn, chol, f0, draws: DrawsFn, num_warmup: int, num_samples: int, thin: int = 1):
    """ESS over (C, n) initial states (or any leading axes), all chains in
    lockstep: ((C, S, n) draws, (C, S) logliks, (C, S) shrink counts)."""
    f0 = f0[None] if f0.dim() == 1 else f0
    return run_ess_chain(loglik_fn, chol, f0, draws, num_warmup, num_samples, thin)


def run_ess_gp(gp: GP, lik: Likelihood, theta_simil, theta_lik, x, y, draws: DrawsFn | None = None,
               theta_noise=None, mask=None, num_chains: int = 4, num_warmup: int = 256, num_samples: int = 256,
               thin: int = 1, generator: torch.Generator | None = None) -> ESSResult:
    """Sample the exact latent posterior of a latent-GP model.

    Conventions of ``gp.laplace.laplace_fit``: the noise kernel is only
    diagonal jitter on the prior K (``theta_noise`` defaults to zeros),
    padded rows are identity rows of K and masked out of the likelihood.
    Thetas (rows, n_theta) and masks (rows, n) run every row's chains in
    one lockstep batch (rows, C, n).  ``draws``: the hook, by default
    :func:`generator_draws` of ``generator``.

    K is factored by ``linalg.cholesky`` (K1 at 1024 <= n <= 4096 on the
    card), as in the JAX twin: where K is not positive definite in the
    working precision the factor, and so that row's chains, are NaN.  A
    jitter-only covariance of close inputs is often not positive definite
    in f32 (the classify study's prefixes have condition numbers near
    1e11)."""
    theta_noise = _zeros_noise(gp, theta_noise)
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = _cov(gp, ts, tn, x, mask)
    chol = linalg.cholesky(K)
    rows = chol.shape[:-2]
    tl_c = tl if tl.dim() == 1 else tl[..., None, :]  # a rows theta, one per chain
    mask_c = mask if mask.dim() == 1 else mask[..., None, :]

    def loglik_fn(f):
        return lik.sum_logp(tl_c, f, y, mask_c)

    f0 = torch.zeros(rows + (num_chains, x.shape[0]), dtype=x.dtype, device=x.device)
    fs, lls, shr = run_ess(loglik_fn, chol[..., None, :, :], f0, draws or generator_draws(generator),
                           num_warmup, num_samples, thin)
    return ESSResult(fs, lls, shr, ts, tl, x, mask, chol)


def ess_predict(gp: GP, res: ESSResult, z) -> tuple[Tensor, Tensor]:
    """Latent predictive mean and std at ``z`` from the exact draws; ``z``
    (rows, m, ndim) gives each row of a batched result its own inputs."""
    z = _test_points(gp, z, res.x)
    kstar = _cross(gp, res.theta_simil, res.x, z) * res.mask[..., :, None]  # (..., n, m)
    a = linalg.cho_solve_mat(res.chol, kstar)  # K^{-1} K*
    draws = res.f.reshape(res.f.shape[:-3] + (-1, res.f.shape[-1]))  # (..., C*S, n)
    mus = draws @ a  # (..., C*S, m)
    v = linalg.trsm_lower(res.chol, kstar)
    cond_var = _prior(gp, res.theta_simil, z) - (v * v).sum(-2)
    mu = mus.mean(-2)
    var = torch.clamp(cond_var, min=0.0) + mus.var(-2, correction=0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def ess_predict_prob(gp: GP, lik: Likelihood, res: ESSResult, z, order: int = 32) -> Tensor:
    """Predictive p(y=1 | z) from the exact draws (probit analytic, other
    links by Gauss-Hermite, as ``laplace_predict_prob``)."""
    mu, sd = ess_predict(gp, res, z)
    return class_prob(lik, res.theta_lik, mu, sd, order)


__all__ = [
    "ESSDraws",
    "ESSResult",
    "ess_predict",
    "ess_predict_prob",
    "ess_update",
    "generator_draws",
    "run_ess",
    "run_ess_chain",
    "run_ess_gp",
]
