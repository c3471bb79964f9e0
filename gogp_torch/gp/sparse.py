"""Sparse (inducing-point) GPs: SGPR and SVGP, with natural gradients.

PyTorch twin of ``gogp_tpu/gp/sparse.py``, the JAX package's production
serving path: approximate inference with m << n inducing points, where
training is O(n m^2) and a fitted model predicts in O(m^2) per test point.

- **SGPR** (Titsias 2009): the collapsed evidence lower bound, q(u) optimal
  in closed form; the parameters are the hyperparameters and the inducing
  inputs Z.  With Z = X the bound equals the exact log marginal likelihood.
- **SVGP** (Hensman et al. 2013): a whitened q(u) = N(L v | ...) with
  v ~ N(q_mu, q_sqrt q_sqrt^T); the ELBO is a sum over data points, so a
  minibatch rescaled to ``n_total`` is unbiased.  A Gaussian likelihood has
  its expected log-density in closed form; any other integrates by
  Gauss-Hermite quadrature (``Likelihood.for_svgp``).
- **Natural gradients** on q(u) (:func:`svgp_natgrad_step`), with Adam on
  the hyperparameters and Z (:func:`svgp_fit_natgrad`).

Every factorization and triangular solve of an m x m factor goes through
the front door ``ops.linalg``, as in the JAX twin: on the card, f32 with
m >= 1024 (a multiple of 128) factors with K1 and solves with the blocked
TRSM (one K5 launch for its tile inverses), differentiated by the analytic
pullbacks of ``cholesky_blocked``; elsewhere ``torch.linalg``.
``svgp_optimal_state``'s last factor is the plain one, as the JAX twin's
``jnp.linalg.cholesky`` is.

Conventions are the exact core's (``gp.core``): noise is the noise kernel's
per-point variance; predictions are noise-free latent bands; a 0/1 ``mask``
drops rows (their inverse-noise weight is 0).  A 1-D ``z`` or ``t`` is a
column of 1-D points, as everywhere in the port (the JAX twin's
``atleast_2d`` makes it one point).

The fits run as Python loops (the JAX twin's ``lax.scan``), with Adam in
optax's arithmetic (``infer.mle.adam_update``) over the parameter leaves.
Their random numbers come from an :class:`SVGPDraws` hook: the permutation
whose first m rows start Z, and each step's minibatch indices.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from gogp_torch.gp.core import _LOG_2PI, GP, _like, _points, _prepare
from gogp_torch.infer import mle
from gogp_torch.ops import cholesky_blocked as cb
from gogp_torch.ops import linalg

Tensor = torch.Tensor
LogLik = Callable[[Tensor, Tensor], Tensor]

# Relative jitter added to Kuu before factorization: Kuu is a prior
# covariance of m inducing points with no noise on its diagonal.
DEFAULT_JITTER = 1e-6


def _eye(m: int, ref: Tensor) -> Tensor:
    return torch.eye(m, dtype=ref.dtype, device=ref.device)


def _chol_kuu(gp: GP, theta_simil: Tensor, z: Tensor, jitter: float) -> Tensor:
    kuu = gp.simil.matrix(theta_simil, z, z)
    scale = torch.diagonal(kuu).mean()
    return linalg.cholesky(kuu + (jitter * scale) * _eye(z.shape[0], kuu))


def _noise_weights(gp: GP, theta_noise: Tensor, x: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
    """(s, w): per-point noise variance and masked inverse-noise weight."""
    s = gp.noise.vector(theta_noise, x)
    return s, mask / s


def _nonneg(v: Tensor) -> Tensor:
    """max(v, 0), a tie's gradient split in half as ``jnp.maximum`` splits it."""
    return torch.maximum(v, torch.zeros_like(v))


class SGPRPosterior(NamedTuple):
    """Serving cache of a fitted SGPR, all O(m^2)."""

    theta_simil: Tensor  # (n_theta_simil,) natural scale
    theta_noise: Tensor  # (n_theta_noise,) natural scale
    z: Tensor  # (m, ndim) inducing inputs
    chol_kuu: Tensor  # (m, m) lower Cholesky of Kuu (+ jitter)
    chol_b: Tensor  # (m, m) lower Cholesky of B = I + A A^T
    c: Tensor  # (m,) LB^{-1} A ytilde


def _sgpr_core(gp: GP, theta_simil, theta_noise, x, y, z, mask, jitter):
    """Shared SGPR assembly; returns (elbo, L, LB, c).

    V = L^{-1} Kuf, A = V sqrt(w), B = I + A A^T, LB = chol(B),
    ytilde = y sqrt(w), c = LB^{-1} A ytilde, and

      elbo = -1/2 [ sum_i mask_i log(2 pi s_i) + log|B| + |ytilde|^2 - |c|^2
                    + sum_i w_i kff_i - (tr(B) - m) ]

    the last line being Titsias's trace term, sum_i w_i qff_i = tr(B) - m.
    """
    m = z.shape[0]
    L = _chol_kuu(gp, theta_simil, z, jitter)
    kuf = gp.simil.matrix(theta_simil, z, x)  # (m, n)
    s, w = _noise_weights(gp, theta_noise, x, mask)
    sqw = torch.sqrt(w)
    A = linalg.trsm_lower(L, kuf) * sqw[None, :]
    B = _eye(m, A) + A @ A.T
    LB = linalg.cholesky(B)
    ytil = y * sqw
    c = linalg.trsm_lower(LB, (A @ ytil)[:, None])[:, 0]
    kff = gp.simil.diag_matrix(theta_simil, x)  # the latent prior variance, no noise
    logdet_b = 2.0 * torch.log(torch.diagonal(LB)).sum()
    elbo = -0.5 * (
        mask.sum() * _LOG_2PI
        + (mask * torch.log(s)).sum()
        + logdet_b
        + ytil @ ytil
        - c @ c
        + (w * kff).sum()
        - (torch.trace(B) - m)
    )
    return elbo, L, LB, c


def _prep_z(gp: GP, theta_simil, theta_noise, x, y, z, mask):
    theta_simil, theta_noise, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    return theta_simil, theta_noise, x, y, _points(_like(z, x)), mask


def sgpr_elbo(gp: GP, theta_simil, theta_noise, x, y, z, mask=None, jitter: float = DEFAULT_JITTER) -> Tensor:
    """Titsias's collapsed bound on the log marginal likelihood, O(n m^2);
    ``elbo <= lml``, equal at Z = X.  Differentiable in the hyperparameters
    and in ``z``."""
    ts, tn, x, y, z, mask = _prep_z(gp, theta_simil, theta_noise, x, y, z, mask)
    return _sgpr_core(gp, ts, tn, x, y, z, mask, jitter)[0]


def sgpr_fit(gp: GP, theta_simil, theta_noise, x, y, z, mask=None,
             jitter: float = DEFAULT_JITTER) -> SGPRPosterior:
    """Condition on data at fixed hyperparameters (the sparse ``absorb``):
    the O(m^2) serving cache."""
    ts, tn, x, y, z, mask = _prep_z(gp, theta_simil, theta_noise, x, y, z, mask)
    _, L, LB, c = _sgpr_core(gp, ts, tn, x, y, z, mask, jitter)
    return SGPRPosterior(ts, tn, z, L, LB, c)


def sgpr_predict(gp: GP, post: SGPRPosterior, t) -> tuple[Tensor, Tensor]:
    """Mean and std of the noise-free latent f at test inputs, O(m^2) per
    point: tmp1 = L^{-1} Kut, tmp2 = LB^{-1} tmp1, mu = tmp2^T c,
    var = ktt - |tmp1|^2 + |tmp2|^2 by column."""
    t = _points(_like(t, post.z))
    kut = gp.simil.matrix(post.theta_simil, post.z, t)  # (m, t)
    tmp1 = linalg.trsm_lower(post.chol_kuu, kut)
    tmp2 = linalg.trsm_lower(post.chol_b, tmp1)
    mu = tmp2.T @ post.c
    prior = gp.simil.diag_matrix(post.theta_simil, t)
    var = prior - (tmp1 * tmp1).sum(0) + (tmp2 * tmp2).sum(0)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


# ---------------------------------------------------------------------------
# SVGP: the whitened variational posterior and its minibatch ELBO
# ---------------------------------------------------------------------------


class SVGPState(NamedTuple):
    """Whitened variational state: u = L_uu v, v ~ N(q_mu, q_sqrt q_sqrt^T),
    ``q_sqrt`` lower triangular (``tril`` at every use)."""

    z: Tensor  # (m, ndim)
    q_mu: Tensor  # (m,)
    q_sqrt: Tensor  # (m, m)


def svgp_init(gp: GP, z, dtype: torch.dtype | None = None, device=None) -> SVGPState:
    """q = N(0, I), the KL-zero start.  ``dtype`` and ``device``: ``z``'s
    unless given."""
    z = _points(torch.as_tensor(z, dtype=dtype, device=device))
    m = z.shape[0]
    return SVGPState(z, torch.zeros(m, dtype=z.dtype, device=z.device), _eye(m, z))


def kl_whitened(q_mu: Tensor, q_sqrt: Tensor) -> Tensor:
    """KL( N(q_mu, S S^T) || N(0, I) ) with S = tril(q_sqrt)."""
    S = torch.tril(q_sqrt)
    m = q_mu.shape[0]
    return 0.5 * (q_mu @ q_mu + (S * S).sum() - m - 2.0 * torch.log(torch.abs(torch.diagonal(S))).sum())


def _latent_moments(gp: GP, theta_simil: Tensor, state: SVGPState, x: Tensor, jitter: float):
    """Mean and variance of q(f_i) at inputs x under the whitened q(u)."""
    L = _chol_kuu(gp, theta_simil, state.z, jitter)
    A = linalg.trsm_lower(L, gp.simil.matrix(theta_simil, state.z, x))  # (m, n)
    mean = A.T @ state.q_mu
    SA = torch.tril(state.q_sqrt).T @ A
    var = gp.simil.diag_matrix(theta_simil, x) - (A * A).sum(0) + (SA * SA).sum(0)
    return mean, _nonneg(var)


def _gh_nodes(order: int, dtype: torch.dtype, device) -> tuple[Tensor, Tensor]:
    """Gauss-Hermite nodes and weights over sqrt(pi) (physicists'
    convention; f = mean + sqrt(2 var) x absorbs the normalization)."""
    xs, ws = np.polynomial.hermite.hermgauss(order)
    return (torch.as_tensor(xs, dtype=dtype, device=device),
            torch.as_tensor(ws / np.sqrt(np.pi), dtype=dtype, device=device))


def _data_term(gp: GP, theta_noise, x, y, mask, mean, var, n_total, likelihood: LogLik | None,
               quad_order: int) -> Tensor:
    """sum_i mask_i E_q[log p(y_i | f_i)], rescaled to ``n_total`` points.
    Gaussian (the noise kernel's variance s): log N(y_i | mean_i, s_i) -
    var_i / (2 s_i); else ``quad_order``-point Gauss-Hermite."""
    if likelihood is None:
        s = gp.noise.vector(theta_noise, x)
        point = -0.5 * (_LOG_2PI + torch.log(s) + (y - mean) ** 2 / s) - 0.5 * var / s
    else:
        xs, ws = _gh_nodes(quad_order, x.dtype, x.device)
        f = mean[:, None] + torch.sqrt(2.0 * var)[:, None] * xs[None, :]
        point = (likelihood(y[:, None].expand(f.shape), f) * ws[None, :]).sum(1)
    data = (point * mask).sum()
    if n_total is not None:
        data = data * (_like(n_total, x) / torch.clamp(mask.sum(), min=1.0))
    return data


def svgp_elbo(gp: GP, theta_simil, theta_noise, state: SVGPState, x, y, n_total=None, mask=None,
              likelihood: LogLik | None = None, quad_order: int = 20, jitter: float = DEFAULT_JITTER) -> Tensor:
    """Hensman et al.'s minibatch evidence lower bound.

    ``x``/``y`` may be a minibatch; ``n_total`` is the dataset size the data
    term is rescaled to (None: this batch is the whole dataset).
    ``likelihood(y, f) -> log p`` takes tensors of one shape and works
    elementwise (``Likelihood.for_svgp``); None is the noise kernel's
    Gaussian, in closed form.  A sum over points: shards of the data, each
    with the KL added once, sum to the whole ELBO."""
    ts, tn, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    mean, var = _latent_moments(gp, ts, state, x, jitter)
    data = _data_term(gp, tn, x, y, mask, mean, var, n_total, likelihood, quad_order)
    return data - kl_whitened(state.q_mu, state.q_sqrt)


def svgp_predict(gp: GP, theta_simil, state: SVGPState, t, jitter: float = DEFAULT_JITTER) -> tuple[Tensor, Tensor]:
    """Latent posterior mean and std at test inputs, O(m^2) per point."""
    t = _points(_like(t, state.z))
    mean, var = _latent_moments(gp, _like(theta_simil, t).reshape(gp.n_theta_simil), state, t, jitter)
    return mean, torch.sqrt(var)


def svgp_optimal_state(gp: GP, theta_simil, theta_noise, x, y, z, mask=None,
                       jitter: float = DEFAULT_JITTER) -> SVGPState:
    """The optimal whitened q for a Gaussian likelihood, in closed form:
    cov(v) = B^{-1} = LB^{-T} LB^{-1}, q_mu = LB^{-T} c.  Its ELBO is
    SGPR's bound.  ``q_sqrt`` is the lower factor of B^{-1} (the plain
    factor, as the JAX twin's ``jnp.linalg.cholesky``)."""
    ts, tn, x, y, z, mask = _prep_z(gp, theta_simil, theta_noise, x, y, z, mask)
    _, _, LB, c = _sgpr_core(gp, ts, tn, x, y, z, mask, jitter)
    lb_inv = linalg.trsm_lower(LB, _eye(z.shape[0], x))
    return SVGPState(z, lb_inv.T @ c, cb.plain_cholesky(lb_inv.T @ lb_inv))


# ---------------------------------------------------------------------------
# The flat-vector protocol: [log thetas | Z], for infer.mle and the samplers
# ---------------------------------------------------------------------------


def split_sparse_params(gp: GP, v: Tensor, m: int) -> tuple[Tensor, Tensor, Tensor]:
    """v = [log theta_simil..., log theta_noise..., z_11 ... z_m,ndim] ->
    (theta_simil, theta_noise, z), thetas exp-transformed."""
    v = torch.as_tensor(v)
    nt = gp.n_theta
    if v.shape[0] != nt + m * gp.ndim:
        raise ValueError(f"sparse parameter vector length {v.shape[0]} != n_theta + m*ndim = {nt + m * gp.ndim}")
    theta = torch.exp(v[:nt])
    return theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], v[nt:].reshape(m, gp.ndim)


def join_sparse_params(gp: GP, log_theta, z) -> Tensor:
    return torch.cat([torch.as_tensor(log_theta).reshape(-1), torch.as_tensor(z).reshape(-1)])


def make_sgpr_logp(gp: GP, x, y, m: int, mask=None, jitter: float = DEFAULT_JITTER):
    """``logp(v) -> collapsed ELBO`` over [log thetas | Z], for infer.mle or
    any sampler, like ``make_gp_logp``."""

    def logp(v):
        ts, tn, z = split_sparse_params(gp, v, m)
        return sgpr_elbo(gp, ts, tn, x, y, z, mask, jitter)

    return logp


# ---------------------------------------------------------------------------
# Natural gradients
# ---------------------------------------------------------------------------


def _elbo_mS(gp: GP, theta_simil, theta_noise, z, q_mu, S_cov, x, y, n_total, mask, likelihood, quad_order,
             jitter) -> Tensor:
    """svgp_elbo in the full covariance S of q(v) instead of its factor."""
    ts, tn, x, y, mask = _prepare(gp, theta_simil, theta_noise, x, y, mask)
    L = _chol_kuu(gp, ts, z, jitter)
    A = linalg.trsm_lower(L, gp.simil.matrix(ts, z, x))
    mean = A.T @ q_mu
    var = _nonneg(gp.simil.diag_matrix(ts, x) - (A * A).sum(0) + (A * (S_cov @ A)).sum(0))
    data = _data_term(gp, tn, x, y, mask, mean, var, n_total, likelihood, quad_order)
    Ls = linalg.cholesky(S_cov)
    m = q_mu.shape[0]
    kl = 0.5 * (q_mu @ q_mu + torch.trace(S_cov) - m - 2.0 * torch.log(torch.diagonal(Ls)).sum())
    return data - kl


def svgp_natgrad_step(gp: GP, theta_simil, theta_noise, state: SVGPState, x, y, gamma, n_total=None, mask=None,
                      likelihood: LogLik | None = None, quad_order: int = 20,
                      jitter: float = DEFAULT_JITTER) -> SVGPState:
    """One natural-gradient step on the whitened q(u).

    With natural parameters Lambda1 = S^{-1} m and Lambda2 = -S^{-1}/2, the
    natural gradient is the ordinary gradient in the expectation parameters
    (m, S + m m^T):

        Lambda1 <- Lambda1 + gamma (g_m - 2 g_S m),  Lambda2 <- Lambda2 + gamma g_S

    For a Gaussian likelihood on the whole batch, gamma = 1 lands on the
    optimal q in one step from any start (``svgp_optimal_state``).  A P_new
    that is not positive definite factors with escalating jitter
    (``linalg.cholesky_with_jitter``, one host read per try).  The step
    reads no gradient of the hyperparameters or of Z."""
    S0 = torch.tril(state.q_sqrt)
    S_cov = (S0 @ S0.T).detach()
    q_mu = state.q_mu.detach()
    with torch.enable_grad():
        mm, SS = q_mu.clone().requires_grad_(True), S_cov.clone().requires_grad_(True)
        value = _elbo_mS(gp, theta_simil, theta_noise, state.z, mm, SS, x, y, n_total, mask, likelihood, quad_order,
                         jitter)
        g_m, g_S = torch.autograd.grad(value, (mm, SS))
    with torch.no_grad():
        g_S = 0.5 * (g_S + g_S.T)
        eye = _eye(q_mu.shape[0], S_cov)
        Ls = linalg.cholesky(S_cov)
        P = linalg.cho_solve_mat(Ls, eye)  # S^{-1}
        lam1 = linalg.cho_solve_vec(Ls, q_mu)  # S^{-1} m
        gamma = _like(gamma, S_cov)
        P_new = P - 2.0 * gamma * g_S
        lam1_new = lam1 + gamma * (g_m - 2.0 * (g_S @ q_mu))
        Lp, _ = linalg.cholesky_with_jitter(0.5 * (P_new + P_new.T))
        S_new = linalg.cho_solve_mat(Lp, eye)
        S_new = 0.5 * (S_new + S_new.T)
        return SVGPState(state.z, S_new @ lam1_new, linalg.cholesky(S_new))


# ---------------------------------------------------------------------------
# The fits
# ---------------------------------------------------------------------------


class SVGPParams(NamedTuple):
    """Trainable SVGP parameters: log-scale thetas and the variational state."""

    log_theta: Tensor  # (n_theta,)
    state: SVGPState


class SVGPDraws(NamedTuple):
    """Where a fit's random numbers come from."""

    perm: Callable[[int], Tensor]  # n -> a permutation of range(n); its first m rows start Z
    batch: Callable[[int, int, int], Tensor]  # (step, n, batch) -> (batch,) indices in [0, n), with replacement


def generator_draws(rng: torch.Generator) -> SVGPDraws:
    """Draws from ``rng``, on its device, each made when first asked for."""
    return SVGPDraws(
        perm=lambda n: torch.randperm(n, generator=rng, device=rng.device),
        batch=lambda step, n, batch: torch.randint(0, n, (batch,), generator=rng, device=rng.device),
    )


def _split_theta(gp: GP, log_theta: Tensor) -> tuple[Tensor, Tensor]:
    theta = torch.exp(log_theta)
    return theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]


def _value_and_grads(fn, leaves: list[Tensor]) -> tuple[Tensor, list[Tensor]]:
    """fn(*leaves) and its gradient in each leaf."""
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        value = fn(*leaves)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), list(grads)


def _adam_ascent(params: list[Tensor], grads: list[Tensor], opt: mle.AdamState, rate: float):
    """One optax Adam step on -ELBO: the new leaves and Adam state."""
    updates, opt = mle.adam_update(tuple(-g for g in grads), opt, rate)
    return [p + u for p, u in zip(params, updates)], opt


class _SVGPTrainer:
    """svgp_fit's step, shared with svgp_fit_stream: Adam on [log_theta, z,
    q_mu, q_sqrt] ascending the ELBO rescaled to ``n_total``."""

    def __init__(self, gp, n_total, likelihood, quad_order, jitter, train_theta, rate):
        self.gp, self.n_total, self.likelihood = gp, n_total, likelihood
        self.quad_order, self.jitter, self.train_theta, self.rate = quad_order, jitter, train_theta, rate

    def elbo(self, log_theta, z, q_mu, q_sqrt, xb, yb):
        ts, tn = _split_theta(self.gp, log_theta)
        return svgp_elbo(self.gp, ts, tn, SVGPState(z, q_mu, q_sqrt), xb, yb, n_total=self.n_total,
                         likelihood=self.likelihood, quad_order=self.quad_order, jitter=self.jitter)

    def step(self, params, opt, xb, yb):
        value, grads = _value_and_grads(lambda *p: self.elbo(*p, xb, yb), params)
        if not self.train_theta:
            grads[0] = torch.zeros_like(grads[0])
        params, opt = _adam_ascent(params, grads, opt, self.rate)
        return params, opt, value


def _start(gp: GP, x, y, m: int, rng, draws: SVGPDraws | None, log_theta0):
    """(x, y, draws, Z's start, log_theta's start) of an in-memory fit."""
    x = _points(torch.as_tensor(x))
    y = _like(y, x)
    if draws is None:
        draws = generator_draws(rng if rng is not None else torch.Generator(device=x.device).manual_seed(0))
    z0 = x[draws.perm(x.shape[0]).to(x.device)[:m]]
    lt0 = torch.zeros(gp.n_theta, dtype=x.dtype, device=x.device) if log_theta0 is None else _like(log_theta0, x)
    return x, y, draws, z0, lt0


def _minibatch(draws: SVGPDraws, step: int, x: Tensor, y: Tensor, batch: int):
    n = x.shape[0]
    if batch == n:
        return x, y
    idx = draws.batch(step, n, batch).to(x.device)
    return x[idx], y[idx]


def svgp_fit(gp: GP, x, y, m: int, rng: torch.Generator | None = None, iters: int = 500, batch: int | None = None,
             rate: float = 0.01, likelihood: LogLik | None = None, quad_order: int = 20,
             jitter: float = DEFAULT_JITTER, log_theta0=None, train_theta: bool = True,
             draws: SVGPDraws | None = None) -> tuple[SVGPParams, Tensor]:
    """Minibatch Adam training of an SVGP.

    Z starts at m points of the data drawn without replacement, q at
    N(0, I).  Each step takes ``batch`` points uniformly with replacement
    (all n, in order, when ``batch`` is None or >= n) and ascends the ELBO
    rescaled to n in (log_theta, Z, q_mu, q_sqrt) jointly;
    ``train_theta=False`` holds the hyperparameters.  Random numbers from
    ``draws``, by default :func:`generator_draws` of ``rng`` (a generator
    on x's device seeded 0 when None).  Returns ``(params, elbo_trace)``,
    one minibatch ELBO a step, each at the parameters before its step."""
    x, y, draws, z0, lt0 = _start(gp, x, y, m, rng, draws, log_theta0)
    n = x.shape[0]
    batch = n if batch is None or batch >= n else batch
    state0 = svgp_init(gp, z0)
    params = [lt0, *state0]
    opt = mle.adam_init(params)
    trainer = _SVGPTrainer(gp, n, likelihood, quad_order, jitter, train_theta, rate)
    trace = []
    for step in range(iters):
        xb, yb = _minibatch(draws, step, x, y, batch)
        params, opt, value = trainer.step(params, opt, xb, yb)
        trace.append(value)
    return SVGPParams(params[0], SVGPState(*params[1:])), torch.stack(trace)


def svgp_fit_natgrad(gp: GP, x, y, m: int, rng: torch.Generator | None = None, iters: int = 300,
                     batch: int | None = None, gamma: float = 0.3, rate: float = 0.01,
                     likelihood: LogLik | None = None, quad_order: int = 20, jitter: float = DEFAULT_JITTER,
                     log_theta0=None, train_theta: bool = True,
                     draws: SVGPDraws | None = None) -> tuple[SVGPParams, Tensor]:
    """SVGP training with natural gradients on q(u) and Adam on (log_theta,
    Z): each step first moves (log_theta, Z) by Adam (unless
    ``train_theta`` is False, which holds both), then takes
    :func:`svgp_natgrad_step` at the new values.  Same start, minibatches
    and trace as :func:`svgp_fit`."""
    x, y, draws, z0, lt0 = _start(gp, x, y, m, rng, draws, log_theta0)
    n = x.shape[0]
    batch = n if batch is None or batch >= n else batch
    state = svgp_init(gp, z0)
    hyper = [lt0, state.z]
    opt = mle.adam_init(hyper)
    q_mu, q_sqrt = state.q_mu, state.q_sqrt

    def elbo_of(log_theta, z, xb, yb):
        ts, tn = _split_theta(gp, log_theta)
        return svgp_elbo(gp, ts, tn, SVGPState(z, q_mu, q_sqrt), xb, yb, n_total=n, likelihood=likelihood,
                         quad_order=quad_order, jitter=jitter)

    trace = []
    for step in range(iters):
        xb, yb = _minibatch(draws, step, x, y, batch)
        if train_theta:
            value, grads = _value_and_grads(lambda lt, z: elbo_of(lt, z, xb, yb), hyper)
            hyper, opt = _adam_ascent(hyper, grads, opt, rate)
        else:
            with torch.no_grad():
                value = elbo_of(*hyper, xb, yb)
        ts, tn = _split_theta(gp, hyper[0])
        new = svgp_natgrad_step(gp, ts, tn, SVGPState(hyper[1], q_mu, q_sqrt), xb, yb, gamma, n_total=n,
                                likelihood=likelihood, quad_order=quad_order, jitter=jitter)
        q_mu, q_sqrt = new.q_mu, new.q_sqrt
        trace.append(value)
    return SVGPParams(hyper[0], SVGPState(hyper[1], q_mu, q_sqrt)), torch.stack(trace)


def svgp_fit_stream(gp: GP, batches: Iterable, n_total: int, m: int, z0, iters: int = 500, rate: float = 0.01,
                    likelihood: LogLik | None = None, quad_order: int = 20, jitter: float = DEFAULT_JITTER,
                    log_theta0=None, train_theta: bool = True, dtype: torch.dtype | None = None,
                    device=None) -> tuple[SVGPParams, Tensor]:
    """Out-of-core SVGP training: :func:`svgp_fit`'s step on minibatches
    from a host iterator of ``(xb, yb)`` (the sampling lives in the stream),
    ``iters`` of them.  ``z0``: the (m, ndim) starting inducing inputs.
    ``device``: ``z0``'s when it is a tensor, else the CUDA card (pass
    ``device="cpu"`` for the CPU); ``dtype``: float32 on the card and
    float64 on the CPU unless given."""
    if device is None:
        device = z0.device if isinstance(z0, Tensor) else torch.device("cuda")
    device = torch.device(device)
    dtype = dtype or (torch.float32 if device.type == "cuda" else torch.float64)
    state0 = svgp_init(gp, z0, dtype=dtype, device=device)
    if state0.z.shape[0] != m:
        raise ValueError(f"z0 rows {state0.z.shape[0]} != m {m}")
    lt0 = (torch.zeros(gp.n_theta, dtype=dtype, device=device) if log_theta0 is None
           else torch.as_tensor(log_theta0, dtype=dtype, device=device))
    params = [lt0, *state0]
    opt = mle.adam_init(params)
    trainer = _SVGPTrainer(gp, n_total, likelihood, quad_order, jitter, train_theta, rate)
    trace = []
    it = iter(batches)
    for _ in range(iters):
        xb, yb = next(it)
        xb = _points(torch.as_tensor(xb, dtype=dtype, device=device))
        params, opt, value = trainer.step(params, opt, xb, torch.as_tensor(yb, dtype=dtype, device=device))
        trace.append(value)
    return SVGPParams(params[0], SVGPState(*params[1:])), torch.stack(trace)


__all__ = [
    "DEFAULT_JITTER",
    "SGPRPosterior",
    "SVGPDraws",
    "SVGPParams",
    "SVGPState",
    "generator_draws",
    "join_sparse_params",
    "kl_whitened",
    "make_sgpr_logp",
    "sgpr_elbo",
    "sgpr_fit",
    "sgpr_predict",
    "split_sparse_params",
    "svgp_elbo",
    "svgp_fit",
    "svgp_fit_natgrad",
    "svgp_fit_stream",
    "svgp_init",
    "svgp_natgrad_step",
    "svgp_optimal_state",
    "svgp_predict",
]
