"""Noise kernels: variance added on the covariance diagonal only.

PyTorch twin of ``gogp_tpu/kernels/noise.py``.  ``diag(theta, x)`` sees inputs
with the coordinates on the last axis and returns a variance that broadcasts
over the leading axes.
"""

from __future__ import annotations

import torch

from gogp_torch.kernels.base import NoiseKernel


def constant_noise(std: float) -> NoiseKernel:
    """Fixed noise: variance = std² for every point, no hyperparameters."""
    var = float(std) * float(std)

    def diag(theta, x):
        return torch.full(x.shape[:-1], var, dtype=x.dtype, device=x.device)

    return NoiseKernel(0, diag, f"constant_noise({std})")


def _uniform_diag(theta, x):
    # variance = std², std = theta[0]
    return theta[0] * theta[0]


uniform_noise = NoiseKernel(1, _uniform_diag, "uniform_noise")


def jitter_only_noise(jitter: float = 1e-5) -> NoiseKernel:
    """Allocates one hyperparameter but contributes only a fixed jitter."""

    def diag(theta, x):
        return torch.full(x.shape[:-1], jitter, dtype=x.dtype, device=x.device)

    return NoiseKernel(1, diag, f"jitter_only_noise({jitter})")
