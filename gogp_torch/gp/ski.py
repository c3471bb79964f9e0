"""GP layer over the SKI operator: LML and prediction for irregular inputs.

PyTorch twin of ``gogp_tpu/gp/ski.py``.  ``core.lml_toeplitz`` needs a
regular 1-D grid; :func:`lml_ski` interpolates arbitrary inputs onto an
inducing grid (``ops.ski``, KISS-GP): in 1-D a symmetric-Toeplitz grid
covariance, in d dimensions tensor-product taps (4^d a point) onto a d-level
block-Toeplitz grid covariance applied by one fftn.  Any stationary kernel
qualifies, and the noise may be heteroscedastic.  The grid is placed on the
device from the inputs' range (no host read).

The ``core.lml_iterative`` estimator contract (value and gradient noise
about 1/sqrt(probes), the gradient from the frozen solutions' quadratic
forms), plus the interpolation's O(h^4) bias.  Hyperparameters may carry a
leading batch axis (B, n_theta): B grid covariances and noise diagonals on
shared taps and probes, one lockstep solve, (B,) values.
"""

from __future__ import annotations

import torch

from gogp_torch.gp.core import GP, _LOG_2PI, _cg_predict, _FrozenSolution, _like, _per_theta, _points, _thetas
from gogp_torch.ops import ski

Tensor = torch.Tensor


def _axis_grid(x_col: Tensor, g: int) -> tuple[Tensor, Tensor]:
    """One axis's grid origin and spacing: 3 cells of margin each side keep
    every point's 4 taps interior."""
    xmin, xmax = x_col.min(), x_col.max()
    h = (xmax - xmin) / (g - 7)
    return xmin - 3.0 * h, h


def _grid_geometry(x: Tensor, dims: tuple) -> tuple[Tensor, Tensor]:
    g0, hs = zip(*(_axis_grid(x[:, a], dims[a]) for a in range(x.shape[1])))
    return torch.stack(g0), torch.stack(hs)


def _toeplitz_col(gp: GP, ts: Tensor, grid0: Tensor, h: Tensor, g: int) -> Tensor:
    grid = grid0 + h * torch.arange(g, dtype=h.dtype, device=h.device)
    return gp.simil.matrix(ts, grid[:, None], grid[:1, None])[:, 0]


def _grid_lags(gp: GP, ts: Tensor, hs: Tensor, dims: tuple, dtype) -> Tensor:
    """The d-dim lag array lags[i1..id] = k((i1 h1, .., id hd), 0), valid for
    stationary kernels."""
    axes = [hs[a] * torch.arange(dims[a], dtype=dtype, device=hs.device) for a in range(len(dims))]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(dims))
    zero = pts.new_zeros(1, len(dims))
    return gp.simil.matrix(ts, pts, zero)[:, 0].reshape(dims)


def _resolve_dims(grid_size, d: int) -> tuple:
    if isinstance(grid_size, int):
        return (grid_size,) * d
    dims = tuple(int(g) for g in grid_size)
    if len(dims) != d:
        raise ValueError(f"grid_size has {len(dims)} axes for {d}-D inputs")
    return dims


def _grid_cov(gp: GP, ts: Tensor, g0: Tensor, hs: Tensor, dims: tuple) -> Tensor:
    """The grid covariance's Toeplitz column (1-D) or lag array."""
    if len(dims) == 1:
        return _toeplitz_col(gp, ts, g0[0], hs[0], dims[0])
    return _grid_lags(gp, ts, hs, dims, hs.dtype)


def lml_ski(gp: GP, theta_simil, theta_noise, x, y, draws, grid_size: int | tuple = 2048, num_probes: int = 16,
            cg_iters: int = 100, lanczos_iters: int = 32, method: str = "matmul") -> Tensor:
    """Log marginal likelihood through the SKI operator (irregular inputs,
    any dimension; ``grid_size`` per axis, an int replicated).  No padding
    mask.  ``method``: the W^T apply (``ops.ski``): "matmul" (the twin's
    default, the one-hot form), "scatter" (any dimension) or "sorted" (1-D).
    1-D inputs are sorted first (a stable argsort; the LML is invariant),
    y's gradient landing back in the caller's order.
    """
    x = _points(x)
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    if d > 1 and method == "sorted":
        raise ValueError('method="sorted" is 1-D only; use scatter/matmul')
    ts, tn, batched = _thetas(gp, theta_simil, theta_noise, x)
    y = _like(y, x)
    if d == 1:
        order = torch.argsort(x[:, 0], stable=True)
        x, y = x[order], y[order]
    if batched:
        y = y.expand(ts.shape[0], n)
    xs = x.detach()
    g0, hs = _grid_geometry(xs, dims)
    idx, w = ski.cubic_interp_nd(xs, g0, hs, dims)

    def c_of(a):
        return _per_theta(lambda t: _grid_cov(gp, t, g0, hs, dims), a, batched=batched)

    def noise_of(b):
        return _per_theta(lambda t: gp.noise.vector(t, x), b, batched=batched)

    def value_fn(a, b, yv):
        return ski.lml_ski_core(lambda: c_of(a), lambda: noise_of(b), idx, w, yv, draws, num_probes, cg_iters,
                                lanczos_iters, method)

    def forms_fn(a, b, alpha, Z, S):
        return ski.ski_quadratic_forms(lambda: c_of(a), lambda: noise_of(b), idx, w, alpha, Z, S, method)

    return -0.5 * n * _LOG_2PI + _FrozenSolution.apply(value_fn, forms_fn, ts, tn, y)


def _ski_operator(gp: GP, ts: Tensor, tn: Tensor, x: Tensor, dims: tuple, method: str):
    """The SKI matvec of one problem: its grid placed on x."""
    g0, hs = _grid_geometry(x, dims)
    idx, w = ski.cubic_interp_nd(x, g0, hs, dims)
    return ski.ski_matvec_fn(_grid_cov(gp, ts, g0, hs, dims), idx, w, gp.noise.vector(tn, x), method)


def predict_ski(gp: GP, theta_simil, theta_noise, x, y, z, grid_size: int | tuple = 2048, cg_iters: int = 200,
                tol: float = 1e-6, method: str | None = None) -> tuple[Tensor, Tensor]:
    """The exact predict (noise-free latent bands) with every training solve
    a batched CG of [y | Kstar] against the SKI matvec; the cross-covariances
    to ``z`` exact.  Deterministic.  ``method`` defaults to the exact form:
    "sorted" in 1-D, "scatter" otherwise."""
    x = _points(x)
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    ts, tn, _ = _thetas(gp, theta_simil, theta_noise, x)
    y = _like(y, x)
    z = _points(_like(z, x))
    if method is None:
        method = "sorted" if d == 1 else "scatter"
    if d == 1:
        order = torch.argsort(x[:, 0], stable=True)
        x, y = x[order], y[order]
    return _cg_predict(gp, ts, _ski_operator(gp, ts, tn, x, dims, method), x, y, z, cg_iters, tol)


__all__ = ["lml_ski", "predict_ski"]
