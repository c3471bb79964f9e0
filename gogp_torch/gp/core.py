"""GP core: covariance assembly, log marginal likelihood, prediction.

PyTorch twin of the exact subset of ``gogp_tpu/gp/core.py``: an immutable
:class:`GP` spec, an immutable :class:`Posterior` of tensors, and pure
functions on them.  Gradients come from autograd.

Padding: a 0/1 ``mask`` marks which of the n rows are real observations.
Padded rows become identity rows of K and zeros of y, so the log marginal
likelihood and the predictions are exactly those of the unpadded problem.

Devices: everything runs on the device of the inputs ``x`` (or of the
posterior).  Python numbers and lists are created there; a tensor on another
device is an error, never a silent copy.

The large-n engines (``ops.iterative``, ``ops.toeplitz``): ``lml_iterative``
(CG and stochastic Lanczos quadrature on the dense K), ``lml_iterative_matfree``
(K rebuilt a panel at a time), ``lml_toeplitz`` (a regular 1-D grid, FFT
matvecs) and their predictions.  They take a ``PathDraws``
(``gp.pathwise``) where the JAX twin takes a key.  ``lml_iterative`` and
``lml_toeplitz`` (and ``gp.ski.lml_ski``) also take hyperparameters with a
leading batch axis, (B, n_theta), and return (B,) values: one lockstep
solve for B problems on shared data and probes, the port's layout for the
twin's ``jax.vmap`` (a data-dependent CG loop cannot go under
``torch.func.vmap``).  The frozen-solution engines differentiate the
quadratic forms of their CG solutions (:class:`_FrozenSolution`), the
twin's ``custom_vjp``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gogp_torch.kernels.base import Kernel, NoiseKernel
from gogp_torch.kernels.noise import constant_noise
from gogp_torch.ops import iterative, linalg
from gogp_torch.ops import toeplitz as tz

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453

# Default noise std, present for numerical stability (variance 1e-10); zero
# it by passing constant_noise(0.) explicitly.
DEFAULT_NOISE_STD = 1e-5


@dataclasses.dataclass(frozen=True)
class GP:
    """GP spec: input dimensionality plus similarity and noise kernels."""

    ndim: int
    simil: Kernel
    noise: NoiseKernel | None = None

    def __post_init__(self):
        if self.noise is None:
            object.__setattr__(self, "noise", constant_noise(DEFAULT_NOISE_STD))

    @property
    def n_theta_simil(self) -> int:
        return self.simil.n_theta

    @property
    def n_theta_noise(self) -> int:
        return self.noise.n_theta

    @property
    def n_theta(self) -> int:
        return self.simil.n_theta + self.noise.n_theta


class Posterior(NamedTuple):
    """Immutable fitted-GP state: everything ``predict`` needs."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    x: Tensor  # (n, ndim)
    y: Tensor  # (n,)
    chol: Tensor  # (n, n) lower Cholesky factor of K
    alpha: Tensor  # (n,) K^{-1} y
    mask: Tensor  # (n,) 1.0 for real observations, 0.0 for padding


def _like(v, ref: Tensor) -> Tensor:
    """``v`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    if isinstance(v, Tensor):
        if v.device != ref.device:
            raise ValueError(f"tensor on {v.device}, expected {ref.device}")
        return v.to(ref.dtype)
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _points(x) -> Tensor:
    x = torch.as_tensor(x)
    return x[:, None] if x.dim() == 1 else x


def _prepare(gp: GP, theta_simil, theta_noise, x, y, mask):
    x = _points(x)
    n = x.shape[0]
    theta_simil = _like(theta_simil, x).reshape(gp.n_theta_simil)
    theta_noise = _like(theta_noise, x).reshape(gp.n_theta_noise)
    if mask is None:
        mask = torch.ones(n, dtype=x.dtype, device=x.device)
    else:
        mask = _like(mask, x)
    y = _like(y, x) * mask
    return theta_simil, theta_noise, x, y, mask


def masked_cov(gp: GP, theta_simil, theta_noise, x: Tensor, mask: Tensor | None) -> Tensor:
    """Covariance with noise on the diagonal,
    K[i, j] = simil(x_i, x_j) + delta_ij noise(x_j); padded rows and columns
    are replaced by identity rows."""
    k = gp.simil.matrix(theta_simil, x, x)
    k = k + torch.diag_embed(gp.noise.vector(theta_noise, x))
    if mask is not None:
        m = mask.to(k.dtype)
        k = k * (m[:, None] * m[None, :]) + torch.diag_embed(1.0 - m)
    return k


def absorb(gp: GP, theta_simil, theta_noise, x, y, mask=None, robust: bool = False) -> Posterior:
    """Factorize K and solve for alpha.  ``robust=True`` retries a failed
    factorization with escalating diagonal jitter instead of returning
    NaNs."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    L = linalg.cholesky_with_jitter(K)[0] if robust else linalg.cholesky(K)
    alpha = linalg.cho_solve_vec(L, y)
    return Posterior(theta_simil, theta_noise, x, y, L, alpha, mask)


def lml_from_posterior(post: Posterior) -> Tensor:
    """GPML eq. 5.8: -(n/2) log 2pi - 1/2 log|K| - 1/2 y^T alpha; 0 with no
    data."""
    n_eff = post.mask.sum()
    logdet = linalg.logdet_from_chol(post.chol, post.mask)
    return -0.5 * (n_eff * _LOG_2PI + logdet + post.y @ post.alpha)


def lml(gp: GP, theta_simil, theta_noise, x, y, mask=None, precision: str | None = None) -> Tensor:
    """Log marginal likelihood at natural-scale hyperparameters, through
    ``linalg.lml_core`` (the blocked kernels on CUDA f32 at n >= 1024).
    ``precision``: the blocked drivers' matmul precision (``ops.linalg``)."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    return -0.5 * mask.sum() * _LOG_2PI + linalg.lml_core(K, y, precision)


def predict_from_posterior(gp: GP, post: Posterior, z) -> tuple[Tensor, Tensor]:
    """Posterior mean and std of the noise-free latent f at test inputs z.

    mu = Kstar^T alpha; sigma_i^2 = k(z_i, z_i) - |L^{-1} Kstar[:, i]|^2,
    clamped at 0, so sigma at an observed point of a noise-free GP is 0.
    """
    z = _points(_like(z, post.x))
    prior_var = gp.simil.diag_matrix(post.theta_simil, z)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z) * post.mask[:, None]  # (n, m)
    mu = kstar.T @ post.alpha
    v = linalg.trsm_lower(post.chol, kstar)
    var = prior_var - (v * v).sum(0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def predict_y_from_posterior(gp: GP, post: Posterior, z) -> tuple[Tensor, Tensor]:
    """Predictive mean and std of an observation y*: the latent bands plus
    the noise kernel's variance at the test inputs."""
    z = _points(_like(z, post.x))
    mu, sigma = predict_from_posterior(gp, post, z)
    nv = gp.noise.vector(post.theta_noise, z)
    return mu, torch.sqrt(sigma * sigma + nv)


def predict(gp: GP, theta_simil, theta_noise, x, y, z, mask=None) -> tuple[Tensor, Tensor]:
    """Fit and predict: absorb, then predict_from_posterior."""
    post = absorb(gp, theta_simil, theta_noise, x, y, mask)
    return predict_from_posterior(gp, post, z)


def predict_mixture(gp: GP, vs, x, y, z, mask=None) -> tuple[Tensor, Tensor]:
    """Bayesian posterior predictive: the moment-matched mixture over sampled
    hyperparameters.

    ``vs``: (S, n_theta) log-scale draws.  Each draw conditions the GP and
    predicts the noise-free latent at ``z``; the result is the mixture's
    mean and std, mu = E[mu_s], var = E[sigma_s^2 + mu_s^2] - mu^2.  All S
    draws go at once: one batched covariance build, one batched
    ``torch.linalg`` factorization and solve (the JAX twin vmaps absorb and
    predict_from_posterior, which XLA batches the same way).
    """
    x = _points(x)
    n = x.shape[0]
    mask = torch.ones(n, dtype=x.dtype, device=x.device) if mask is None else _like(mask, x)
    y = _like(y, x) * mask
    z = _points(_like(z, x))
    theta = torch.exp(_like(vs, x))
    nts = gp.n_theta_simil

    def one(t):
        ts, tn = t[:nts], t[nts:]
        kstar = gp.simil.matrix(ts, x, z) * mask[:, None]
        return masked_cov(gp, ts, tn, x, mask), kstar, gp.simil.diag_matrix(ts, z)

    K, kstar, prior_var = torch.func.vmap(one)(theta)  # (S, n, n), (S, n, m), (S, m)
    L = linalg.cholesky(K)  # a batch: torch.linalg
    z1 = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    alpha = torch.linalg.solve_triangular(L.mT, z1, upper=True)  # (S, n, 1)
    mus = (kstar * alpha).sum(-2)
    v = torch.linalg.solve_triangular(L, kstar, upper=False)
    sigmas = torch.sqrt(torch.clamp(prior_var - (v * v).sum(-2), min=0.0))
    mu = mus.mean(0)
    var = (sigmas * sigmas + mus * mus).mean(0) - mu * mu
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


# ---------------------------------------------------------------------------
# The large-n engines: iterative, matrix-free and Toeplitz.
# ---------------------------------------------------------------------------


def _thetas(gp: GP, theta_simil, theta_noise, x: Tensor) -> tuple[Tensor, Tensor, bool]:
    """Natural-scale hyperparameters on x's device and dtype: (n_theta,)
    each, or (B, n_theta) with a leading batch axis (then ``True``)."""
    ts, tn = _like(theta_simil, x), _like(theta_noise, x)
    batched = ts.dim() == 2
    if batched:
        return ts.reshape(ts.shape[0], gp.n_theta_simil), tn.reshape(ts.shape[0], gp.n_theta_noise), True
    return ts.reshape(gp.n_theta_simil), tn.reshape(gp.n_theta_noise), False


def _per_theta(fn, *thetas: Tensor, batched: bool):
    """``fn(*thetas)``, mapped over their batch axis where there is one."""
    return torch.func.vmap(fn)(*thetas) if batched else fn(*thetas)


class _FrozenSolution(torch.autograd.Function):
    """The twin's custom VJP of the frozen-solution engines: the value from
    ``value_fn(ts, tn, y) -> (value, (alpha, Z, S))``; the backward
    differentiates ``forms_fn(ts, tn, alpha, Z, S)`` (alpha^T K alpha minus
    the probes' trace form) with the solutions held fixed, and ybar = -g
    alpha."""

    @staticmethod
    def forward(ctx, value_fn, forms_fn, ts, tn, y):
        value, (alpha, Z, S) = value_fn(ts, tn, y)
        ctx.forms_fn = forms_fn
        ctx.save_for_backward(ts, tn, alpha, Z, S)
        return value

    @staticmethod
    def backward(ctx, g):
        ts, tn, alpha, Z, S = ctx.saved_tensors
        with torch.enable_grad():
            a, b = ts.detach().requires_grad_(True), tn.detach().requires_grad_(True)
            h = ctx.forms_fn(a, b, alpha, Z, S)
            ga, gb = torch.autograd.grad(h.sum(), (a, b), allow_unused=True)
        half = (0.5 * g)[..., None]
        ga = torch.zeros_like(ts) if ga is None else half * ga
        gb = torch.zeros_like(tn) if gb is None else half * gb
        return None, None, ga, gb, -g[..., None] * alpha


def lml_iterative(gp: GP, theta_simil, theta_noise, x, y, draws, mask=None, num_probes: int = 16,
                  cg_iters: int = 100, lanczos_iters: int = 32, precond_rank: int = 0) -> Tensor:
    """The :func:`lml` protocol through CG solves and a stochastic Lanczos
    quadrature logdet on the dense K (``ops.iterative``: O(n^2) a CG step,
    about 0.5% value and 1-3% theta-gradient error at the default probes).
    Padded rows are identity rows of K and zeros of y, as for :func:`lml`.

    ``precond_rank > 0``: pivoted-Cholesky PCG with the noise diagonal from
    the GP's own noise kernel (1 on padded rows, as K has there).  Batched
    hyperparameters (B, n_theta) give (B,) values from one lockstep solve
    with shared probes.  No kernel of the port's runs here: the solves are
    matmuls, the preconditioner's factor ``torch.linalg.cholesky``.
    """
    x = _points(x)
    n = x.shape[0]
    ts, tn, batched = _thetas(gp, theta_simil, theta_noise, x)
    mask = torch.ones(n, dtype=x.dtype, device=x.device) if mask is None else _like(mask, x)
    y = _like(y, x) * mask
    K = _per_theta(lambda a, b: masked_cov(gp, a, b, x, mask), ts, tn, batched=batched)
    noise_diag = None
    if precond_rank > 0:
        # padded rows carry identity diagonals in K; the preconditioner's D
        # must match what the matrix has there
        noise_diag = _per_theta(lambda a, b: gp.noise.vector(b, x) * mask + (1.0 - mask), ts, tn, batched=batched)
    return -0.5 * mask.sum() * _LOG_2PI + iterative.lml_core_iterative(
        K, y, draws, num_probes, cg_iters, lanczos_iters, precond_rank, noise_diag)


def _cov_rows_fn(gp: GP, theta_simil, theta_noise, x: Tensor, mask: Tensor, panel: int):
    """Rows [row0, row0 + panel) of :func:`masked_cov`, built on the fly."""
    n = x.shape[0]

    def rows_at(row0: int) -> Tensor:
        x_p, m_p = x[row0 : row0 + panel], mask[row0 : row0 + panel]
        rows = gp.simil.matrix(theta_simil, x_p, x)  # (panel, n)
        eye = torch.arange(n, device=x.device)[None, :] == torch.arange(row0, row0 + panel, device=x.device)[:, None]
        rows = torch.where(eye, rows + gp.noise.vector(theta_noise, x_p)[:, None], rows)
        rows = rows * (m_p[:, None] * mask[None, :])
        return torch.where(eye, rows + (1.0 - m_p[:, None]), rows)

    return rows_at


def _cov_col_fn(gp: GP, theta_simil, theta_noise, x: Tensor, mask: Tensor):
    """Column i of :func:`masked_cov` (``i`` a 0-d index tensor): one (n,)
    kernel-column evaluation, the matrix-free preconditioner's unit of work."""
    n = x.shape[0]

    def col_at(i: Tensor) -> Tensor:
        xi = x[i][None]  # (1, d)
        col = gp.simil.matrix(theta_simil, x, xi)[:, 0]
        ei = (torch.arange(n, device=x.device) == i).to(col.dtype)
        col = col + gp.noise.vector(theta_noise, xi)[0] * ei
        mi = mask[i]
        return col * (mask * mi) + (1.0 - mi) * ei

    return col_at


def _cov_diag(gp: GP, theta_simil, theta_noise, x: Tensor, mask: Tensor) -> Tensor:
    """Diagonal of :func:`masked_cov`: 1 on padded rows."""
    d = gp.simil.diag_matrix(theta_simil, x) + gp.noise.vector(theta_noise, x)
    return d * mask + (1.0 - mask)


def lml_iterative_matfree(gp: GP, theta_simil, theta_noise, x, y, draws, mask=None, panel: int = 1024,
                          num_probes: int = 16, cg_iters: int = 100, lanczos_iters: int = 32,
                          precond_rank: int = 0) -> Tensor:
    """:func:`lml_iterative` with K never materialised: each matvec rebuilds
    K a (panel, n) block at a time, so memory is O(panel * n), and the theta
    gradient differentiates the frozen solutions' quadratic forms panel by
    panel (``ops.iterative.matfree_quadratic_forms``).  The same probes as
    :func:`lml_iterative` from the same draws.  ``precond_rank > 0`` builds
    the preconditioner from ``precond_rank`` kernel columns."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    n = x.shape[0]

    def pc_kwargs(ts, tn):
        if precond_rank <= 0:
            return {}
        return dict(precond_rank=precond_rank, cov_col_fn=_cov_col_fn(gp, ts, tn, x, mask),
                    cov_diag=_cov_diag(gp, ts, tn, x, mask),
                    noise_diag=gp.noise.vector(tn, x) * mask + (1.0 - mask))

    def value_fn(ts, tn, yv):
        return iterative.lml_matfree(_cov_rows_fn(gp, ts, tn, x, mask, panel), yv, draws, panel, num_probes,
                                     cg_iters, lanczos_iters, **pc_kwargs(ts, tn))

    def forms_fn(ts, tn, alpha, Z, S):
        return iterative.matfree_quadratic_forms(_cov_rows_fn(gp, ts, tn, x, mask, panel), n, panel, alpha, Z, S)

    return -0.5 * mask.sum() * _LOG_2PI + _FrozenSolution.apply(value_fn, forms_fn, theta_simil, theta_noise, y)


def _check_regular_grid(x: Tensor, grid_rtol: float) -> None:
    """Raise unless the 1-D inputs are equally spaced up to ``grid_rtol`` of
    the mean step (floored at the grid's own resolution, 8 eps max|x|): the
    twin's host check, computed on the device with one read."""
    xs = x[:, 0]
    if xs.shape[0] < 2:
        return
    steps = torch.diff(xs)
    tol = torch.clamp(torch.maximum(grid_rtol * steps.abs().mean(), 8.0 * torch.finfo(xs.dtype).eps * xs.abs().max()),
                      min=1e-30)
    lo, hi = steps.min(), steps.max()
    bad, lo, hi = torch.stack([(hi - lo > tol).to(xs.dtype), lo, hi]).tolist()
    if bad:
        raise ValueError("lml_toeplitz needs equally spaced inputs "
                         f"(spacing range [{lo:.3g}, {hi:.3g}]); use lml_iterative/lml for irregular designs")


def _toeplitz_col(gp: GP, x: Tensor, ts: Tensor, tn: Tensor) -> Tensor:
    """First column of the Toeplitz covariance: k(x_0, x_i) plus the noise
    variance at lag 0."""
    col = gp.simil.matrix(ts, x, x[:1])[:, 0]
    e0 = (torch.arange(x.shape[0], device=x.device) == 0).to(col.dtype)
    return col + gp.noise.vector(tn, x[:1])[0] * e0


def lml_toeplitz(gp: GP, theta_simil, theta_noise, x, y, draws, num_probes: int = 16, cg_iters: int = 100,
                 lanczos_iters: int = 32, precond_rank: int = 0, grid_rtol: float = 1e-4) -> Tensor:
    """LML for 1-D inputs on a regular grid: the covariance is symmetric
    Toeplitz, every matvec an FFT circulant product, O(n log n) a CG step
    (``ops.toeplitz``).  The :func:`lml_iterative` estimator contract, with
    the theta gradient from the frozen solutions' quadratic forms;
    ``precond_rank > 0`` builds the preconditioner from Toeplitz column
    gathers.  Batched hyperparameters as for :func:`lml_iterative`.

    Constraints: 1-D inputs on a regular grid (checked on the device, one
    host read a call; pass presorted x), homoscedastic noise (the noise
    kernel is read at x[0]), no padding mask.
    """
    x = _points(x)
    n = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError("lml_toeplitz needs 1-D inputs on a regular grid")
    _check_regular_grid(x, grid_rtol)
    ts, tn, batched = _thetas(gp, theta_simil, theta_noise, x)
    y = _like(y, x)
    if batched:
        y = y.expand(ts.shape[0], n)

    def c_of(a, b):
        return _per_theta(lambda a_, b_: _toeplitz_col(gp, x, a_, b_), a, b, batched=batched)

    noise_var = None
    if precond_rank > 0:
        noise_var = _per_theta(lambda a, b: gp.noise.vector(b, x[:1])[0], ts, tn, batched=batched)

    def value_fn(a, b, yv):
        return tz.lml_toeplitz_core(lambda: c_of(a, b), yv, draws, num_probes, cg_iters, lanczos_iters,
                                    precond_rank, noise_var)

    def forms_fn(a, b, alpha, Z, S):
        return tz.toeplitz_quadratic_forms(lambda: c_of(a, b), alpha, Z, S)

    return -0.5 * n * _LOG_2PI + _FrozenSolution.apply(value_fn, forms_fn, ts, tn, y)


def _cg_predict(gp: GP, ts: Tensor, mv, x: Tensor, y: Tensor, z: Tensor, cg_iters: int, tol: float, pc=None,
                mask: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The exact predict's semantics with every solve one batched CG of
    [y | Kstar] against the matvec ``mv``: mu = Kstar^T alpha, sigma^2 =
    k(z, z) - Kstar . K^-1 Kstar, clamped at 0."""
    kstar = gp.simil.matrix(ts, x, z)  # (n, m)
    if mask is not None:
        kstar = kstar * mask[:, None]
    X, _ = iterative.cg_solve(mv, torch.cat([y[:, None], kstar], 1), cg_iters, tol, precond=pc)
    alpha, W = X[:, 0], X[:, 1:]
    var = gp.simil.diag_matrix(ts, z) - (kstar * W).sum(0)
    return kstar.T @ alpha, torch.sqrt(torch.clamp(var, min=0.0))


def predict_iterative(gp: GP, theta_simil, theta_noise, x, y, z, mask=None, panel: int = 1024,
                      cg_iters: int = 200, tol: float = 1e-6) -> tuple[Tensor, Tensor]:
    """The exact predict (noise-free latent bands) with every solve a CG
    over panel-rebuilt covariance matvecs: no factor, O(panel n + n m)
    memory, deterministic.  One batched CG solves [y | Kstar]."""
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    z = _points(_like(z, x))
    mv = iterative.matfree_matvec(_cov_rows_fn(gp, theta_simil, theta_noise, x, mask, panel), x.shape[0], panel)
    return _cg_predict(gp, theta_simil, mv, x, y, z, cg_iters, tol, mask=mask)


def predict_toeplitz(gp: GP, theta_simil, theta_noise, x, y, z, cg_iters: int = 200, tol: float = 1e-6,
                     precond_rank: int = 0) -> tuple[Tensor, Tensor]:
    """The exact predict for regular-grid time series: every solve a batched
    CG over O(n log n) Toeplitz matvecs (the :func:`lml_toeplitz`
    constraints on x; ``z`` anywhere).  Deterministic."""
    x = _points(x)
    n = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError("predict_toeplitz needs 1-D inputs on a regular grid")
    theta_simil, theta_noise, _ = _thetas(gp, theta_simil, theta_noise, x)
    y = _like(y, x)
    z = _points(_like(z, x))
    c = _toeplitz_col(gp, x, theta_simil, theta_noise)
    pc = None
    if precond_rank > 0:
        noise_var = gp.noise.vector(theta_noise, x[:1])[0]
        pc = iterative.pivoted_precond_cols(tz.toeplitz_col_fn(c), c[:1].expand(n), precond_rank, noise_var[None])
    return _cg_predict(gp, theta_simil, tz.toeplitz_matvec_fn(c), x, y, z, cg_iters, tol, pc=pc)


def predict_prior(gp: GP, theta_simil, z) -> tuple[Tensor, Tensor]:
    """Prediction with no observations: mu = 0, sigma = prior std."""
    z = _points(z)
    prior_var = gp.simil.diag_matrix(_like(theta_simil, z), z)
    return torch.zeros_like(prior_var), torch.sqrt(prior_var)
