"""Deep kernel learning: a tanh MLP feature extractor in front of any kernel.

PyTorch twin of ``gogp_tpu/kernels/deep.py``.  k_deep(x, x') =
k_base(phi_w(x), phi_w(x')) with phi_w a small tanh MLP (Wilson et al.,
AISTATS 2016).  The warped kernel is another
:class:`~gogp_torch.kernels.base.Kernel`, so every GP entry point takes it,
and the MLP weights are kernel thetas that the same optimizers train.

Signed weights under the exp-transforming parameter protocol: the weight
slots take ``log`` of the natural-scale theta, so the protocol's log-scale
parameter is the raw, signed weight (:func:`init_deep_v` builds that vector).

Cost: the pair function is in broadcast form (``base.py``), so
``.matrix`` applies phi_w once to each row of ``xa`` (n, 1, d) and of ``xb``
(1, m, d), n + m evaluations, where the JAX twin's pair function under two
``vmap``s evaluates it for each of the n m pairs.  ``warp_features``
evaluates it once over rows for the features-then-GP pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from gogp_torch.kernels.base import Kernel

Tensor = torch.Tensor


def _layer_sizes(ndim: int, hidden: tuple[int, ...], out_dim: int):
    dims = (ndim, *hidden, out_dim)
    shapes = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    return shapes, sum(a * b + b for a, b in shapes)


def _apply_mlp(w_flat: Tensor, x: Tensor, shapes) -> Tensor:
    """phi_w(x) over the last axis of x: (..., ndim) -> (..., out_dim)."""
    h = x
    off = 0
    last = len(shapes) - 1
    for i, (a, b) in enumerate(shapes):
        W = w_flat[off : off + a * b].reshape(a, b)
        off += a * b
        bias = w_flat[off : off + b]
        off += b
        h = h @ W + bias
        if i != last:
            h = torch.tanh(h)
    return h


def deep(base: Kernel, ndim: int, hidden: tuple[int, ...] = (8, 8), out_dim: int | None = None) -> Kernel:
    """``base`` behind a tanh-MLP input warp.

    Theta layout (natural scale): [exp(weights) (n_w) | base thetas...].
    ``out_dim`` defaults to ``ndim``.  The last layer is linear, so identity
    weights (``hidden=()``) reproduce ``base``."""
    out_dim = ndim if out_dim is None else out_dim
    shapes, n_w = _layer_sizes(ndim, tuple(hidden), out_dim)

    def pair(theta, xa, xb):
        w = torch.log(theta[:n_w])  # the protocol's log-scale parameter is the weight
        rest = theta[n_w:]
        return base.pair(rest, _apply_mlp(w, xa, shapes), _apply_mlp(w, xb, shapes))

    return Kernel(n_w + base.n_theta, pair, f"deep({base.name},{hidden})")


def n_weights(ndim: int, hidden: tuple[int, ...] = (8, 8), out_dim: int | None = None) -> int:
    out_dim = ndim if out_dim is None else out_dim
    return _layer_sizes(ndim, tuple(hidden), out_dim)[1]


def init_deep_v(rng: np.random.Generator, base_log_theta, ndim: int, hidden: tuple[int, ...] = (8, 8),
                out_dim: int | None = None, scale: float = 0.3, dtype: torch.dtype = torch.float64,
                device=None) -> Tensor:
    """Flat protocol vector [raw weights | log base thetas] with random
    weights N(0, scale^2 / fan_in) and zero biases, drawn from the numpy
    generator ``rng`` (host-side, in the JAX twin's order)."""
    out_dim = ndim if out_dim is None else out_dim
    shapes, _ = _layer_sizes(ndim, tuple(hidden), out_dim)
    ws = []
    for a, b in shapes:
        ws.append((rng.normal(size=(a, b)) * scale / np.sqrt(a)).reshape(-1))
        ws.append(np.zeros(b))
    return torch.as_tensor(np.concatenate(ws + [np.asarray(base_log_theta)]), dtype=dtype, device=device)


def identity_weights(ndim: int, hidden: tuple[int, ...] = (8, 8)) -> np.ndarray:
    """Raw weights that make phi_w the identity: square layers only, and the
    exact identity needs ``hidden=()`` (tanh is linear only near 0)."""
    shapes, _ = _layer_sizes(ndim, tuple(hidden), ndim)
    ws = []
    for a, b in shapes:
        if a != b:
            raise ValueError("identity_weights needs square layers")
        ws.append(np.eye(a).reshape(-1))
        ws.append(np.zeros(b))
    return np.concatenate(ws)


def warp_features(v_or_theta, x, ndim: int, hidden: tuple[int, ...] = (8, 8), out_dim: int | None = None,
                  raw: bool = True) -> Tensor:
    """phi_w over the rows of x once, O(n): features for any GP entry point.
    ``raw=True`` takes raw weights (the protocol's log scale), False the
    natural-scale theta exp(weights)."""
    out_dim = ndim if out_dim is None else out_dim
    shapes, n_w = _layer_sizes(ndim, tuple(hidden), out_dim)
    v = torch.as_tensor(v_or_theta)[:n_w]
    w = v if raw else torch.log(v)
    x = torch.as_tensor(x, dtype=w.dtype, device=w.device)
    return _apply_mlp(w, x.reshape(1, -1) if x.dim() < 2 else x, shapes)


__all__ = ["deep", "identity_weights", "init_deep_v", "n_weights", "warp_features"]
