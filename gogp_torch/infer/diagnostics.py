"""MCMC diagnostics: effective sample size and split-R-hat.

PyTorch twin of ``gogp_tpu/infer/diagnostics.py``: the Stan / Vehtari et al.
(2021) definitions, split chains, ESS from Geyer's initial monotone positive
sequence of autocorrelations (FFT autocovariance, ``torch.fft``), and the
rank-normalised ("bulk") forms Stan reports.  Samples are (chains, draws) or
(draws,) for one parameter, (chains, draws, dim) for several; everything runs
on the samples' device and dtype.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _autocovariance(x: Tensor) -> Tensor:
    """Biased autocovariance per chain via FFT; x: (chains, draws)."""
    n = x.shape[-1]
    xc = x - x.mean(-1, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=-1)  # zero-padded: no circular wrap
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=-1)[..., :n]
    return acov / n


def _split(x: Tensor) -> Tensor:
    """(m, n) -> (2m, n//2): the first and second halves as separate chains."""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half : 2 * half]], dim=0)


def ess(samples: Tensor, split: bool = True) -> Tensor:
    """Effective sample size; per dim for (chains, draws, dim).  ``split``
    (the default) halves each chain first, so within-chain drift shows as
    between-chain variance."""
    x = torch.as_tensor(samples)
    if x.dim() == 1:
        x = x[None, :]
    if x.dim() == 3:
        return torch.stack([ess(x[:, :, d], split) for d in range(x.shape[2])])
    if split:
        x = _split(x)
    m, n = x.shape

    acov = _autocovariance(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(x.mean(1), correction=1)

    rho = 1.0 - (mean_var - acov.mean(0)) / var_plus

    # Geyer: sum consecutive pairs, make them monotone nonincreasing, keep
    # the initial positive sequence
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(1)
    pair_mono = torch.cummin(pair, dim=0).values
    positive = torch.cumprod((pair_mono > 0.0).to(torch.int64), dim=0) > 0
    tau = -1.0 + 2.0 * torch.where(positive, pair_mono, 0.0).sum()
    tau = torch.clamp(tau, min=1.0 / math.log10(float(n)) if n > 10 else 1e-8)
    return m * n / tau


def split_rhat(samples: Tensor) -> Tensor:
    """Split-R-hat of (chains, draws) samples; per dim for (chains, draws,
    dim)."""
    x = torch.as_tensor(samples)
    if x.dim() == 1:
        x = x[None, :]
    if x.dim() == 3:
        return torch.stack([split_rhat(x[:, :, d]) for d in range(x.shape[2])])
    x = _split(x)
    chain_means = x.mean(1)
    chain_vars = torch.var(x, dim=1, correction=1)
    half = x.shape[1]
    w = chain_vars.mean()
    b = torch.var(chain_means, correction=1) * half
    var_plus = (half - 1.0) / half * w + b / half
    return torch.sqrt(var_plus / w)


def rank_normalize(samples: Tensor) -> Tensor:
    """Rank-normalise (chains, draws[, dim]) draws per parameter (Vehtari et
    al. 2021, section 4.1): pooled ranks through the normal quantile,
    z = Phi^-1((r - 3/8) / (S + 1/4))."""
    x = torch.as_tensor(samples)
    if x.dim() == 3:
        return torch.stack([rank_normalize(x[:, :, d]) for d in range(x.shape[2])], dim=2)
    m, n = x.shape
    flat = x.reshape(-1)
    s = flat.shape[0]
    ranks = torch.empty_like(flat)
    ranks[torch.argsort(flat, stable=True)] = torch.arange(1, s + 1, dtype=x.dtype, device=x.device)
    return torch.special.ndtri((ranks - 0.375) / (s + 0.25)).reshape(m, n)


def bulk_ess(samples: Tensor) -> Tensor:
    """Rank-normalised split-chain ESS (Stan's "bulk ESS")."""
    return ess(rank_normalize(samples))


def bulk_rhat(samples: Tensor) -> Tensor:
    """Rank-normalised split-R-hat (Stan's reported R-hat)."""
    return split_rhat(rank_normalize(samples))


def gated_min_ess(positions, rhat_threshold: float = 1.01):
    """(min bulk ESS, max bulk R-hat, whether every R-hat clears the
    threshold) of (chains, draws, dim) draws: no ESS/s may be reported from a
    run that has not converged."""
    e = bulk_ess(positions)
    r = bulk_rhat(positions)
    max_rhat = float(r.max())
    return float(e.min()), max_rhat, bool(max_rhat <= rhat_threshold)


def diagnose(positions) -> dict:
    """Raw and rank-normalised split diagnostics of (chains, draws, dim)."""
    x = torch.as_tensor(positions)
    z = rank_normalize(x)
    return {
        "min_ess_raw": float(ess(x).min()),
        "max_rhat_raw": float(split_rhat(x).max()),
        "min_ess_bulk": float(ess(z).min()),
        "max_rhat_bulk": float(split_rhat(z).max()),
    }
