"""The draws hook: randomness in the place of the JAX twin's PRNG key.

The JAX package draws from a key that it splits down a call tree.  Here a
function takes a :class:`PathDraws` in the key's place: an object that
splits as the key does (``split``) and draws the same primitives (normal,
uniform, gamma, bernoulli, categorical, rademacher, a choice without
replacement).  :class:`GeneratorDraws` draws from a ``torch.Generator`` (in
float64, cast to the caller's dtype, so that f32 and f64 runs from one seed
share their draws); the CPU tests hand in JAX's own draws through the same
interface.  The pathwise sampler, BO, kernel search and the iterative
engines (``ops.iterative``, ``ops.toeplitz``, ``ops.ski``) all take it.
"""

from __future__ import annotations

import math
from typing import Protocol

import torch

Tensor = torch.Tensor


class PathDraws(Protocol):
    """The draws hook: the JAX twin's key, split and drawn from alike.  Each
    draw is made on ``ref``'s device in ``ref``'s dtype."""

    def split(self, num: int) -> tuple["PathDraws", ...]: ...

    def normal(self, shape, ref: Tensor) -> Tensor: ...

    def uniform(self, shape, ref: Tensor) -> Tensor: ...  # on [0, 1)

    def gamma(self, a: Tensor, shape, ref: Tensor) -> Tensor: ...  # unit rate, ``a`` broadcasting to shape

    def bernoulli(self, p: float, shape, ref: Tensor) -> Tensor: ...  # bool

    def categorical(self, logits: Tensor, shape) -> Tensor: ...  # int64 indices into logits

    def rademacher(self, shape, ref: Tensor) -> Tensor: ...

    def choice(self, n: int, k: int, ref: Tensor) -> Tensor: ...  # k of range(n), without replacement


class GeneratorDraws:
    """:class:`PathDraws` from one ``torch.Generator``: every split shares
    it, each draw made when asked for, in float64 on the generator's device
    (best the inputs' own) and cast to ``ref``'s device and dtype."""

    def __init__(self, rng: torch.Generator):
        self.rng = rng

    def split(self, num: int) -> tuple["GeneratorDraws", ...]:
        return (self,) * num

    def _f64(self) -> dict:
        return dict(generator=self.rng, dtype=torch.float64, device=self.rng.device)

    def normal(self, shape, ref: Tensor) -> Tensor:
        return torch.randn(shape, **self._f64()).to(ref.device, ref.dtype)

    def uniform(self, shape, ref: Tensor) -> Tensor:
        return torch.rand(shape, **self._f64()).to(ref.device, ref.dtype)

    def gamma(self, a: Tensor, shape, ref: Tensor) -> Tensor:
        a = torch.broadcast_to(torch.as_tensor(a, dtype=torch.float64, device=self.rng.device), shape)
        return torch._standard_gamma(a.contiguous(), generator=self.rng).to(ref.device, ref.dtype)

    def bernoulli(self, p: float, shape, ref: Tensor) -> Tensor:
        return (torch.rand(shape, **self._f64()) < p).to(ref.device)

    def categorical(self, logits: Tensor, shape) -> Tensor:
        probs = torch.softmax(logits.to(torch.float64), dim=-1)
        return torch.multinomial(probs, math.prod(shape), replacement=True, generator=self.rng).reshape(shape)

    def rademacher(self, shape, ref: Tensor) -> Tensor:
        bits = torch.randint(0, 2, shape, generator=self.rng, device=self.rng.device)
        return (2 * bits - 1).to(ref.device, ref.dtype)

    def choice(self, n: int, k: int, ref: Tensor) -> Tensor:
        return torch.randperm(n, generator=self.rng, device=self.rng.device)[:k].to(ref.device)


def as_draws(draws, ref: Tensor) -> PathDraws:
    """``draws`` as a :class:`PathDraws`: a ``torch.Generator`` wrapped in
    :class:`GeneratorDraws`, None a generator on ``ref``'s device seeded 0."""
    if draws is None:
        draws = torch.Generator(device=ref.device).manual_seed(0)
    return GeneratorDraws(draws) if isinstance(draws, torch.Generator) else draws


__all__ = ["GeneratorDraws", "PathDraws", "as_draws"]
