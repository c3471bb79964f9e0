"""SKI / KISS-GP: structured kernel interpolation for irregular inputs.

PyTorch twin of ``gogp_tpu/ops/ski.py`` (Wilson & Nickisch 2015).  An
inducing grid of g regular points sits under the data and

    K  ~=  W K_g W^T  +  noise_diag

with ``K_g`` the grid covariance (symmetric Toeplitz in 1-D, d-level
block-Toeplitz in d dimensions) and ``W`` (n, g) sparse cubic interpolation
(4 taps a row, 4^d in d dimensions; Keys' kernel, an exact partition of
unity).  A matvec is a gather, an FFT circulant product and a scatter, and
the iterative engine (``ops.iterative``) runs on it unchanged.  The noise
diagonal lives in data space, so heteroscedastic noise works.

Indices are int64 (the twin's int32).  The three forms of W^T V:

- :func:`interp_t`: ``index_add``, any input order.  On the card the
  additions are atomic, so their order, and the result's last bits, change
  from run to run.
- :func:`interp_t_sorted`: sorted 1-D inputs, each grid cell's points a
  contiguous range: a ``cumsum`` and ``torch.searchsorted`` (the twin's
  ``jnp.searchsorted``, side "left").  The f32 cumsum carries about
  sqrt(n) eps relative error.
- :func:`interp_t_matmul`: the twin's one-hot matmul.  XLA fuses the one-hot
  into the dot; torch materialises it, so each tap's (rows, g) one-hot is
  built a row chunk at a time.  Its ``precision`` is
  ``linalg.matmul_precision``'s (None: torch's ambient setting, full f32
  with TF32 off).

XLA fuses the twin's gathers and scatters with their products; here
:func:`interp` and :func:`interp_t` form each point's 4^d taps, a block 4^d
times the size of V, so they and the one-hot form go a row chunk at a time
with no transient block above ``TRANSIENT_BYTES`` (one chunk, and the
fewest launches, at the solvers' widths; many for predict_ski's thousands
of columns).

A leading batch axis on the grid covariance and the noise (one per
hyperparameter setting) applies B operators to (B, n, k) blocks, with the
taps shared.
"""

from __future__ import annotations

import itertools
import math

import torch

from gogp_torch.ops import iterative, linalg
from gogp_torch.ops.draws import as_draws
from gogp_torch.ops.toeplitz import _quadratic_forms, toeplitz_matvec_fn

Tensor = torch.Tensor

# The largest transient block of interp, interp_t and interp_t_matmul, in
# bytes.
TRANSIENT_BYTES = 256 * 2**20


def _row_chunks(n: int, row_bytes: int):
    """Slices of n rows, each at most ``TRANSIENT_BYTES`` at ``row_bytes``
    a row."""
    chunk = max(1, TRANSIENT_BYTES // row_bytes)
    return [slice(r0, min(r0 + chunk, n)) for r0 in range(0, n, chunk)]


def cubic_interp(x: Tensor, grid0, h, g: int) -> tuple[Tensor, Tensor]:
    """Keys cubic-convolution interpolation of points ``x`` (n,) onto the
    grid grid0 + j h: (idx (n, 4) int64, w (n, 4)), rows of w summing to 1
    for interior points (taps clamp at the edges: keep 2 cells of margin)."""
    u = (x - grid0) / h
    base = torch.floor(u)
    frac = u - base
    # tap j sits at grid index base - 1 + j, signed distance frac + 1 - j
    offs = torch.arange(4, dtype=u.dtype, device=u.device)
    s = (frac[:, None] + 1.0 - offs[None, :]).abs()
    near = 1.5 * s**3 - 2.5 * s**2 + 1.0
    far = -0.5 * s**3 + 2.5 * s**2 - 4.0 * s + 2.0
    w = torch.where(s <= 1.0, near, torch.where(s < 2.0, far, 0.0))
    taps = torch.arange(4, device=x.device)
    idx = torch.clamp(base.to(torch.int64)[:, None] - 1 + taps[None, :], 0, g - 1)
    return idx, w


def cubic_interp_nd(x: Tensor, grid0, h, dims: tuple) -> tuple[Tensor, Tensor]:
    """Tensor-product Keys interpolation onto a d-dimensional grid: x (n, d),
    ``grid0`` and ``h`` length d, ``dims`` points per axis; (idx (n, 4^d)
    flat row-major indices, w (n, 4^d) products of the axes' weights)."""
    d = x.shape[1]
    per = [cubic_interp(x[:, a], grid0[a], h[a], dims[a]) for a in range(d)]
    idxs, ws = [], []
    for combo in itertools.product(range(4), repeat=d):
        flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        wprod = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        for a, t in enumerate(combo):
            flat = flat * dims[a] + per[a][0][:, t]
            wprod = wprod * per[a][1][:, t]
        idxs.append(flat)
        ws.append(wprod)
    return torch.stack(idxs, 1), torch.stack(ws, 1)


def bttb_matvec_fn(lags: Tensor, d: int | None = None):
    """Batched matvec for the d-level block-Toeplitz grid covariance.

    ``lags`` (..., g1, .., gd): lags[i1..id] = k((i1 h1, .., id hd), 0), the
    d-dim form of a stationary kernel's Toeplitz column; ``d`` its grid axes
    (default all).  Embeds into a (2 g1, .., 2 gd) circulant: one fftn, a
    product, one ifftn an apply.  V: (N,) or (..., N, k), row-major grid
    order.
    """
    d = lags.dim() if d is None else d
    dims = lags.shape[lags.dim() - d :]
    axes = tuple(range(-d, 0))
    emb = lags
    for a, g in zip(axes, dims):
        zshape = list(emb.shape)
        zshape[a] = 1
        tail = emb.narrow(a, 1, g - 1).flip(a)
        emb = torch.cat([emb, emb.new_zeros(zshape), tail], a)
    spec = torch.fft.fftn(emb, dim=axes)[..., None]  # (..., 2g1, .., 2gd, 1)

    def mv(V):
        squeeze = V.dim() == 1
        Vm = V[:, None] if squeeze else V
        k = Vm.shape[-1]
        X = Vm.reshape(Vm.shape[:-2] + tuple(dims) + (k,))
        grid_axes = tuple(a - 1 for a in axes)  # before the column axis
        F = torch.fft.fftn(X, s=tuple(2 * g for g in dims), dim=grid_axes)
        out = torch.fft.ifftn(F * spec, dim=grid_axes).real
        for a, g in zip(grid_axes, dims):
            out = out.narrow(a, 0, g)
        out = out.to(Vm.dtype).reshape(Vm.shape[:-2] + (-1, k))
        return out[:, 0] if squeeze else out

    return mv


def interp_t(idx: Tensor, w: Tensor, g: int, V: Tensor) -> Tensor:
    """W^T V by scatter-add of each point's taps into grid space: idx, w (n,
    T); V (..., n, k) -> (..., g, k).  Any input order."""
    n, taps = idx.shape
    out = V.new_zeros(V.shape[:-2] + (g, V.shape[-1]))
    for rows in _row_chunks(n, V[..., :1, :].numel() * taps * V.element_size()):
        contrib = w[rows, :, None] * V[..., rows, None, :]  # (..., rows, T, k)
        out = out.index_add(-2, idx[rows].reshape(-1), contrib.flatten(-3, -2))
    return out


def interp_t_sorted(idx: Tensor, w: Tensor, g: int, V: Tensor) -> Tensor:
    """W^T V for sorted 1-D inputs, without a scatter: each tap column of
    ``idx`` is nondecreasing, so a grid cell's points are a contiguous range
    and the scatter is segment sums, an inclusive cumsum read at the
    ``searchsorted`` boundaries.  The sums run along the contiguous last
    axis of V^T, (..., k, n): a scan along V's own row axis has only k
    columns to spread over the card's threads."""
    Vt = V.mT.contiguous()  # (..., k, n)
    out = Vt.new_zeros(Vt.shape[:-1] + (g,))
    edges = torch.arange(g + 1, dtype=idx.dtype, device=idx.device)
    zero = Vt.new_zeros(Vt.shape[:-1] + (1,))
    for j in range(4):
        s = torch.cat([zero, torch.cumsum(w[:, j] * Vt, -1)], -1)  # (..., k, n + 1)
        b = torch.searchsorted(idx[:, j].contiguous(), edges, right=False)  # (g + 1,)
        out = out + (s.index_select(-1, b[1:]) - s.index_select(-1, b[:-1]))
    return out.mT


def interp_t_matmul(idx: Tensor, w: Tensor, g: int, V: Tensor, precision: str | None = None) -> Tensor:
    """W^T V as per-tap one-hot matmuls, the twin's MXU form: each tap's
    (rows, g) one-hot times its weights, built a row chunk at a time, then
    one matmul per chunk."""
    cols = torch.arange(g, dtype=idx.dtype, device=idx.device)
    out = V.new_zeros(V.shape[:-2] + (g, V.shape[-1]))
    with linalg.matmul_precision(precision):
        for j in range(idx.shape[1]):
            for rows in _row_chunks(idx.shape[0], g * V.element_size()):
                Mj = (idx[rows, j : j + 1] == cols[None, :]).to(V.dtype) * w[rows, j : j + 1]
                out = out + Mj.mT @ V[..., rows, :]
    return out


def interp(idx: Tensor, w: Tensor, U: Tensor) -> Tensor:
    """W U: each point's taps gathered from grid space, U (..., g, k) ->
    (..., n, k)."""
    n, taps = idx.shape
    chunks = _row_chunks(n, U[..., :1, :].numel() * taps * U.element_size())
    if len(chunks) == 1:
        return (w[:, :, None] * U[..., idx, :]).sum(-2)
    out = U.new_empty(U.shape[:-2] + (n, U.shape[-1]))
    for rows in chunks:
        out[..., rows, :] = (w[rows, :, None] * U[..., idx[rows], :]).sum(-2)
    return out


def _grid_ndim(idx: Tensor) -> int:
    """d from the 4^d taps a point."""
    return round(math.log(idx.shape[1], 4))


def ski_matvec_fn(c_grid: Tensor, idx: Tensor, w: Tensor, noise_diag: Tensor, method: str = "scatter",
                  precision: str | None = None):
    """Batched matvec V -> (W K_g W^T + diag(noise)) V; V: (n,) or (..., n, k).

    ``c_grid``: in 1-D the symmetric-Toeplitz first column (g,), in d
    dimensions the block-Toeplitz lag array (g1, .., gd), either with
    leading batch axes; d is read from the taps (4^d a point).  ``method``
    selects the W^T apply: "scatter", "sorted" (1-D, sorted inputs) or
    "matmul" (``precision`` its matmul precision).
    """
    d = _grid_ndim(idx)
    g = math.prod(c_grid.shape[c_grid.dim() - d :])
    tmv = toeplitz_matvec_fn(c_grid) if d == 1 else bttb_matvec_fn(c_grid, d)
    if method == "scatter":
        wt = interp_t
    elif method == "sorted":
        wt = interp_t_sorted
    elif method == "matmul":
        def wt(i, w_, g_, v):
            return interp_t_matmul(i, w_, g_, v, precision)
    else:
        raise ValueError(f"unknown SKI matvec method {method!r}")

    def mv(V):
        squeeze = V.dim() == 1
        Vm = V[:, None] if squeeze else V
        out = interp(idx, w, tmv(wt(idx, w, g, Vm))) + noise_diag[..., :, None] * Vm
        return out[:, 0] if squeeze else out

    return mv


def lml_ski_core(c_fn, noise_fn, idx: Tensor, w: Tensor, y: Tensor, draws, num_probes: int = 16,
                 cg_iters: int = 100, lanczos_iters: int = 32, method: str = "scatter"):
    """-1/2 (log|K| + y^T K^-1 y) for the SKI operator and the frozen-solution
    aux (value, (alpha, Z, S)), the analogue of
    ``ops.toeplitz.lml_toeplitz_core``; ``c_fn()`` the grid column or lags,
    ``noise_fn()`` the (..., n) noise diagonal."""
    mv = ski_matvec_fn(c_fn(), idx, w, noise_fn(), method)
    n = y.shape[-1]
    k1, k2 = as_draws(draws, y).split(2)
    probes_slq = iterative.rademacher(k1, (num_probes, n), y)
    probes_tr = iterative.rademacher(k2, (n, num_probes), y)
    X, _ = iterative.cg_solve(mv, iterative._solve_block(y, probes_tr), cg_iters)
    alpha, S = X[..., 0], X[..., 1:]
    logdet = iterative.slq_logdet(mv, probes_slq, lanczos_iters)
    value = -0.5 * (logdet + (y * alpha).sum(-1))
    return value, (alpha, probes_tr, S)


def ski_quadratic_forms(c_fn, noise_fn, idx: Tensor, w: Tensor, alpha: Tensor, Z: Tensor, S: Tensor,
                        method: str = "scatter") -> Tensor:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K) through the SKI
    matvec, (alpha, Z, S) frozen."""
    return _quadratic_forms(ski_matvec_fn(c_fn(), idx, w, noise_fn(), method), alpha, Z, S)


__all__ = [
    "bttb_matvec_fn",
    "cubic_interp",
    "cubic_interp_nd",
    "interp",
    "interp_t",
    "interp_t_matmul",
    "interp_t_sorted",
    "lml_ski_core",
    "ski_matvec_fn",
    "ski_quadratic_forms",
]
