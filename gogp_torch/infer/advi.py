"""Automatic differentiation variational inference: mean-field and full-rank
Gaussian families.

PyTorch twin of ``gogp_tpu/infer/advi.py`` (Kucukelbir et al. 2017).  The
ELBO is estimated from ``num_draws`` reparameterized draws, which go through
``logp`` as one (draws, dim) batch: on a theta-only GP study one K7 launch
per step (``tutorial/bayes.py``).  Its gradient with respect to the
variational parameters is taken by autograd and the parameters move by the
port's Adam (``mle.adam_update``, optax's arithmetic, the twin of
``optax.adam``).

Randomness: the JAX twin draws each step's eps from ``split(rng,
num_steps)``, which torch cannot reproduce.  Each step takes its eps
(num_draws, dim) from one place, ``eps_draws(step)``: by default
:func:`generator_eps`, from a ``torch.Generator``; tests hand in JAX's own.

The 0/1 ``free`` mask pins coordinates: their q is a point mass at the
initialization (mu frozen, sigma zero in the draws).  Full-rank q is
N(mu, L L^T) with L lower triangular, parametrized by a raw (d, d) matrix
whose strict lower triangle is L's and whose diagonal is log L_ii, so
H(q) = d/2 (1 + log 2 pi) + sum_i raw_ii.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer import mle
from gogp_torch.infer.hmc import LogDensity, as_free

Tensor = torch.Tensor
EpsDraws = Callable[[int], Tensor]

_LOG_2PI = 1.8378770664093453


class ADVIResult(NamedTuple):
    mu: Tensor  # (dim,) variational mean
    log_sigma: Tensor  # (dim,) variational log-std
    elbos: Tensor  # (num_steps,) ELBO trace
    final_elbo: Tensor


class FullRankADVIResult(NamedTuple):
    mu: Tensor  # (dim,)
    chol_raw: Tensor  # (dim, dim) strict lower = L, diagonal = log L_ii
    elbos: Tensor
    final_elbo: Tensor


def generator_eps(rng: torch.Generator, num_draws: int, like: Tensor) -> EpsDraws:
    """Each step's standard normal eps (num_draws, dim) from ``rng``."""
    return lambda step: torch.randn((num_draws, like.shape[-1]), dtype=like.dtype, device=like.device,
                                    generator=rng)


def _entropy(log_sigma: Tensor, free: Tensor | None) -> Tensor:
    ls = log_sigma if free is None else log_sigma * free
    dim = free.sum() if free is not None else log_sigma.shape[0]
    return 0.5 * dim * (1.0 + _LOG_2PI) + ls.sum()


def elbo(logp: LogDensity, mu: Tensor, log_sigma: Tensor, eps: Tensor, free: Tensor | None = None) -> Tensor:
    """Monte Carlo ELBO at the draws ``mu + eps sigma``: E_q[logp] + H(q)."""
    sigma = torch.exp(log_sigma)
    if free is not None:
        sigma = sigma * free
    draws = mu[None, :] + eps * sigma[None, :]
    return logp(draws).mean() + _entropy(log_sigma, free)


def _chol_of(raw: Tensor) -> Tensor:
    return torch.tril(raw, -1) + torch.diag(torch.exp(torch.diagonal(raw)))


def _masked_chol(raw: Tensor, free: Tensor | None) -> Tensor:
    """L with pinned rows and pinned columns zeroed: the masked family is
    exactly the free block's triangle, whose entropy ``_entropy_fullrank``
    counts."""
    L = _chol_of(raw)
    return L if free is None else L * free[:, None] * free[None, :]


def _entropy_fullrank(raw: Tensor, free: Tensor | None) -> Tensor:
    d = torch.diagonal(raw)
    if free is not None:
        d = d * free
        dim = free.sum()
    else:
        dim = raw.shape[0]
    return 0.5 * dim * (1.0 + _LOG_2PI) + d.sum()


def elbo_fullrank(logp: LogDensity, mu: Tensor, chol_raw: Tensor, eps: Tensor, free: Tensor | None = None) -> Tensor:
    """Monte Carlo ELBO of the full-rank family at the draws ``mu + L eps``."""
    draws = mu[None, :] + eps @ _masked_chol(chol_raw, free).T
    return logp(draws).mean() + _entropy_fullrank(chol_raw, free)


def _run(objective, params, num_steps: int, learning_rate: float, eps_draws: EpsDraws, masks) -> tuple:
    """Adam ascent of ``objective(*params, eps)``, the gradient of each
    parameter times its mask; returns the parameters and the ELBO trace."""
    state = mle.adam_init(params)
    elbos = []
    for step in range(num_steps):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            value = objective(*leaves, eps_draws(step))
            grads = torch.autograd.grad(-value, leaves)
        grads = [g if m is None else g * m for g, m in zip(grads, masks)]
        updates, state = mle.adam_update(grads, state, learning_rate)
        params = [p.detach() + u for p, u in zip(params, updates)]
        elbos.append(value.detach())
    return params, torch.stack(elbos)


def run_advi(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    num_steps: int = 2000,
    num_draws: int = 8,
    learning_rate: float = 0.01,
    init_log_sigma: float = -2.0,
    free: Tensor | None = None,
    eps_draws: EpsDraws | None = None,
) -> ADVIResult:
    """Optimize the mean-field ELBO; returns the variational parameters."""
    position0 = torch.as_tensor(position0)
    freea = as_free(free, position0)
    eps_draws = eps_draws or generator_eps(rng, num_draws, position0)
    params0 = [position0, torch.full_like(position0, init_log_sigma)]
    (mu, ls), elbos = _run(lambda m, s, eps: elbo(logp, m, s, eps, freea), params0, num_steps, learning_rate,
                           eps_draws, (freea, freea))
    return ADVIResult(mu, ls, elbos, elbos[-1])


def run_advi_fullrank(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    num_steps: int = 2000,
    num_draws: int = 8,
    learning_rate: float = 0.01,
    init_log_sigma: float = -2.0,
    free: Tensor | None = None,
    eps_draws: EpsDraws | None = None,
) -> FullRankADVIResult:
    """Optimize the full-rank ELBO; the driving of :func:`run_advi`."""
    position0 = torch.as_tensor(position0)
    dim = position0.shape[0]
    freea = as_free(free, position0)
    eps_draws = eps_draws or generator_eps(rng, num_draws, position0)
    raw0 = torch.diag(torch.full((dim,), init_log_sigma, dtype=position0.dtype, device=position0.device))
    (mu, raw), elbos = _run(lambda m, r, eps: elbo_fullrank(logp, m, r, eps, freea), [position0, raw0], num_steps,
                            learning_rate, eps_draws, (freea, None if freea is None else freea[:, None]))
    return FullRankADVIResult(mu, raw, elbos, elbos[-1])


def _eps(rng: torch.Generator, num_samples: int, like: Tensor, eps: Tensor | None) -> Tensor:
    if eps is not None:
        return eps
    return torch.randn((num_samples, like.shape[-1]), dtype=like.dtype, device=like.device, generator=rng)


def sample_posterior(result: ADVIResult, rng: torch.Generator, num_samples: int, free: Tensor | None = None,
                     eps: Tensor | None = None) -> Tensor:
    """``num_samples`` draws from the fitted mean-field Gaussian, at the
    standard normal ``eps`` (num_samples, dim) if given, else from ``rng``."""
    sigma = torch.exp(result.log_sigma)
    if free is not None:
        sigma = sigma * as_free(free, sigma)
    return result.mu[None, :] + _eps(rng, num_samples, result.mu, eps) * sigma[None, :]


def sample_posterior_fullrank(result: FullRankADVIResult, rng: torch.Generator, num_samples: int,
                              free: Tensor | None = None, eps: Tensor | None = None) -> Tensor:
    """``num_samples`` draws from the fitted full-rank Gaussian (``eps`` as
    in :func:`sample_posterior`)."""
    L = _masked_chol(result.chol_raw, as_free(free, result.mu))
    return result.mu[None, :] + _eps(rng, num_samples, result.mu, eps) @ L.T
