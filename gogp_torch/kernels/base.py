"""Kernel protocol: pure pair functions on tensors, differentiated by autograd.

PyTorch twin of ``gogp_tpu/kernels/base.py``.  A kernel is an immutable spec
around a pure pair function

    pair(theta, xa, xb) -> covariance          (similarity kernels)
    diag(theta, x)      -> noise variance      (noise kernels)

written in broadcast form: ``xa`` and ``xb`` carry the ``ndim`` input
coordinates on their LAST axis and any leading axes broadcast against each
other, and the pair function reduces over the last axis.  ``.matrix`` calls it
once on ``(theta, xa[:, None, :], xb[None, :, :])`` where the JAX twin nests
two ``vmap``s; on a single pair of 1-D points it returns a scalar, exactly as
the JAX pair function does.  ``theta`` is a 1-D tensor of ``n_theta``
hyperparameters in natural scale.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


def _atleast_2d(x: Tensor) -> Tensor:
    return x.reshape(1, -1) if x.dim() < 2 else x


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A similarity kernel: ``pair(theta, xa, xb)`` reducing over the last
    axis of the (broadcast) inputs."""

    n_theta: int
    pair: Callable[[Tensor, Tensor, Tensor], Tensor]
    name: str = "kernel"
    # Structural tag, as in the JAX twin: ("rbf",), ("matern", 3),
    # ("scaled", inner), ("sum", a, b), ("prod", a, b), ("ard", inner, ndim),
    # ("sm", q, ndim), ...; None where the kernel is opaque.
    spec: tuple | None = None

    def __call__(self, theta, xa, xb):
        return self.pair(theta, xa, xb)

    def matrix(self, theta: Tensor, xa: Tensor, xb: Tensor) -> Tensor:
        """Cross-covariance K[i, j] = pair(theta, xa[i], xb[j]).

        ``xa``: (n, d); ``xb``: (m, d); returns (n, m) from one broadcast
        evaluation of the pair function.
        """
        xa, xb = _atleast_2d(xa), _atleast_2d(xb)
        return self.pair(theta, xa[:, None, :], xb[None, :, :])

    def diag_matrix(self, theta: Tensor, x: Tensor) -> Tensor:
        """k(theta, x[i], x[i]) for each row: the prior variances."""
        x = _atleast_2d(x)
        return self.pair(theta, x, x)

    # -- combinators ----------------------------------------------------

    def scaled(self) -> "Kernel":
        """Prepend an output-scale hyperparameter: ``theta[0] * k(theta[1:])``."""
        inner = self

        def pair(theta, xa, xb):
            return theta[0] * inner.pair(theta[1:], xa, xb)

        return Kernel(inner.n_theta + 1, pair, f"scaled({inner.name})", ("scaled", inner))

    def __add__(self, other: "Kernel") -> "Kernel":
        """Sum kernel; thetas concatenate (self first)."""
        a, b = self, other

        def pair(theta, xa, xb):
            return a.pair(theta[: a.n_theta], xa, xb) + b.pair(theta[a.n_theta :], xa, xb)

        return Kernel(a.n_theta + b.n_theta, pair, f"({a.name}+{b.name})", ("sum", a, b))

    def __mul__(self, other: "Kernel") -> "Kernel":
        """Product kernel; thetas concatenate (self first)."""
        a, b = self, other

        def pair(theta, xa, xb):
            return a.pair(theta[: a.n_theta], xa, xb) * b.pair(theta[a.n_theta :], xa, xb)

        return Kernel(a.n_theta + b.n_theta, pair, f"({a.name}*{b.name})", ("prod", a, b))

    def ard(self, ndim: int) -> "Kernel":
        """Automatic relevance determination: prepends ``ndim`` lengthscales
        and evaluates the kernel on x / l."""
        k = self.warp_inputs(lambda w, x: x / w, extra_theta=ndim)
        return dataclasses.replace(k, spec=("ard", self, ndim))

    def warp_inputs(self, warp: Callable, extra_theta: int = 0) -> "Kernel":
        """Apply ``warp(x)`` (or ``warp(theta[:extra_theta], x)``) to both
        inputs before the kernel.  ``warp`` sees inputs with the coordinates
        on the last axis and must broadcast over the leading ones."""
        inner = self

        if extra_theta:

            def pair(theta, xa, xb):
                w, rest = theta[:extra_theta], theta[extra_theta:]
                return inner.pair(rest, warp(w, xa), warp(w, xb))

        else:

            def pair(theta, xa, xb):
                return inner.pair(theta, warp(xa), warp(xb))

        return Kernel(inner.n_theta + extra_theta, pair, f"warped({inner.name})")


@dataclasses.dataclass(frozen=True)
class NoiseKernel:
    """A noise kernel: ``diag(theta, x)`` is the variance added on the
    covariance diagonal, for inputs ``x`` with coordinates on the last axis."""

    n_theta: int
    diag: Callable[[Tensor, Tensor], Tensor]
    name: str = "noise"

    def __call__(self, theta, x):
        return self.diag(theta, x)

    def vector(self, theta: Tensor, x: Tensor) -> Tensor:
        """Noise variance for each input row; x: (n, d) -> (n,)."""
        x = _atleast_2d(x)
        return torch.broadcast_to(self.diag(theta, x), x.shape[:-1])

    def scaled_by(self, factor: float) -> "NoiseKernel":
        """Multiply the variance by a fixed factor."""
        inner = self

        def diag(theta, x):
            return factor * inner.diag(theta, x)

        return NoiseKernel(inner.n_theta, diag, f"{factor}*{inner.name}")
