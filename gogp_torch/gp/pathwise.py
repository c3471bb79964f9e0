"""Pathwise posterior sampling: random-feature priors + Matheron update.

PyTorch twin of ``gogp_tpu/gp/pathwise.py``.  Decoupled sampling (Wilson et al. 2020) compiles S
posterior sample-FUNCTIONS that evaluate anywhere in O(F + n) per point:

    f_post(z) = f_prior(z) + k(z, X) K^{-1} (y - f_prior(X) - eps)

with ``f_prior`` a random-Fourier-feature draw from the kernel's spectral
measure (Bochner) and ``eps ~ N(0, noise)``.  Conditioning reuses the
posterior's cached factor: one ``linalg.cho_solve_mat`` (two blocked TRSMs,
K5 for their tile inverses, on the card in f32 at n >= 1024), no new
factorization; every evaluation is two matmuls.  :func:`sample_paths_ski`
conditions without a factor: one batched CG against the SKI operator
(``gp.ski``), for n where no dense K exists.

Spectral measures come from the kernel's ``spec`` tag (kernels/base.py), as
in the JAX twin: ``rbf``, ``matern`` (a chi^2 scale mixture), the
reference's ``matern52_ref`` (0.4 matern32(l sqrt(3/5)) + 0.6 matern52(l),
a Bernoulli(0.6) choice of the chi^2 degrees), ``periodic`` (1-D only: a
categorical over 64 harmonics weighted by exp(-z) I_k(z), z = 1/l^2),
``rq`` (a Gamma scale mixture), ``sm`` (the Gaussian spectral mixture),
``scaled``, ``ard``, ``sum`` (features split), ``prod`` (frequencies add)
and ``icm`` leaves under sums (LMC) and ``scaled``.  A kernel without a
spec raises; use ``gp.serve.serve_sample`` for those.

Random numbers: the JAX twin draws from a key that it splits down the spec
tree.  Here every function takes a ``PathDraws`` (``ops.draws``, re-exported
here) in the key's place; a ``torch.Generator`` may stand in for one, and
None means a generator on the inputs' device seeded 0.

Inputs: a 1-D ``z`` is a column of 1-D points, as everywhere in the port
(the JAX twin's ``atleast_2d`` makes it one point).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gogp_torch.gp.core import GP, Posterior, _like, _points
from gogp_torch.gp.ski import _resolve_dims, _ski_operator
from gogp_torch.gp.sparse import DEFAULT_JITTER, _chol_kuu
from gogp_torch.kernels.base import Kernel
from gogp_torch.ops import iterative, linalg
from gogp_torch.ops.draws import GeneratorDraws, PathDraws, as_draws

Tensor = torch.Tensor

_TWO_PI = 6.283185307179586

# Periodic-kernel spectral series: harmonics kept and quadrature resolution
# for the exponentially-scaled Bessel weights exp(-z) I_k(z).
_PERIODIC_HARMONICS = 64
_BESSEL_QUAD_POINTS = 256


def _bessel_ive(orders: int, z: Tensor) -> Tensor:
    """exp(-z) I_k(z) for k = 0..orders-1 from the integral
    I_k(z) = (1/pi) int_0^pi exp(z cos t) cos(k t) dt, by the trapezoid on
    256 points (``torch.special`` has orders 0 and 1 only)."""
    t = torch.linspace(0.0, math.pi, _BESSEL_QUAD_POINTS, dtype=z.dtype, device=z.device)
    w = torch.ones_like(t)
    w[0] = w[-1] = 0.5
    w = w * (math.pi / (_BESSEL_QUAD_POINTS - 1)) / math.pi
    k = torch.arange(orders, dtype=z.dtype, device=z.device)
    # exp(z (cos t - 1)): bounded in (0, 1], no overflow for any z >= 0
    e = torch.exp(z * (torch.cos(t) - 1.0))  # (T,)
    c = torch.cos(k[:, None] * t[None, :])  # (K, T)
    return torch.sum(e[None, :] * c * w[None, :], dim=1)


class PathFeatures(NamedTuple):
    """A sampled random-feature expansion of the kernel:
    khat(x, x') = sum_j a_j * 2 cos(omega_j.x + b_j) cos(omega_j.x' + b_j).

    ``task_load`` (multi-output ICM/LMC kernels only, else None): (T, F)
    per-task loadings; the task id rides as the LAST input coordinate, whose
    omega column is zero."""

    omega: Tensor  # (F, ndim) frequencies
    phase: Tensor  # (F,) uniform phases b
    a: Tensor  # (F,) per-feature variance weights
    task_load: Tensor | None = None  # (T, F) or None


def _uniform_weights(f: int, ref: Tensor) -> Tensor:
    return torch.full((f,), 1.0 / f, dtype=ref.dtype, device=ref.device)


def _sample(kernel: Kernel, theta: Tensor, draws: PathDraws, f: int, ndim: int):
    """Walk the spec tree; return (omega (f, ndim), a (f,))."""
    spec = kernel.spec
    if spec is None:
        raise ValueError(
            f"kernel {kernel.name!r} has no spectral structure tag; "
            "pathwise sampling supports the stationary built-ins and their "
            "scaled/ard/sum/product compositions (gp/pathwise.py docstring)"
        )
    tag = spec[0]

    if tag == "rbf":
        z = draws.normal((f, ndim), theta)
        return z / theta[0], _uniform_weights(f, theta)

    if tag == "matern":
        dof = spec[1]  # 2*nu: 1, 3, 5
        kz, kg = draws.split(2)
        z = kz.normal((f, ndim), theta)
        g = 2.0 * kg.gamma(torch.tensor(0.5 * dof, dtype=theta.dtype, device=theta.device), (f,), theta)  # chi^2_dof
        omega = z * torch.sqrt(dof / g)[:, None] / theta[0]
        return omega, _uniform_weights(f, theta)

    if tag == "matern52_ref":
        # 0.4 matern32 at lengthscale l*sqrt(3/5) + 0.6 matern52 at l: both
        # components are omega = z * sqrt(5 / chi2_nu) / l, nu in {3, 5}
        kc, kz, kg = draws.split(3)
        nu = torch.where(kc.bernoulli(0.6, (f,), theta), 5.0, 3.0).to(theta.dtype)
        z = kz.normal((f, ndim), theta)
        g = 2.0 * kg.gamma(0.5 * nu, (f,), theta)  # chi2_nu
        omega = z * torch.sqrt(5.0 / g)[:, None] / theta[0]
        return omega, _uniform_weights(f, theta)

    if tag == "periodic":
        if ndim != 1:
            raise ValueError("periodic kernel pathwise sampling is 1-D only")
        l, p = theta[0], theta[1]
        w = _bessel_ive(_PERIODIC_HARMONICS, 1.0 / (l * l))  # exp(-z) I_k(z)
        w = w * torch.cat([w.new_ones(1), 2.0 * w.new_ones(_PERIODIC_HARMONICS - 1)])
        # truncated series sums to ~k(0)=1; renormalize the sampling dist
        idx = draws.categorical(torch.log(torch.clamp(w, min=1e-30)), (f,))
        omega = (_TWO_PI / p) * idx.to(theta.dtype)[:, None]
        return omega, _uniform_weights(f, theta) * torch.sum(w)

    if tag == "rq":
        l, alpha = theta[0], theta[1]
        kz, kg = draws.split(2)
        z = kz.normal((f, ndim), theta)
        s = kg.gamma(alpha, (f,), theta) / (alpha * l * l)
        return z * torch.sqrt(s)[:, None], _uniform_weights(f, theta)

    if tag == "sm":
        q, kdim = spec[1], spec[2]
        if kdim != ndim:
            raise ValueError(f"spectral_mixture built for ndim={kdim}, got {ndim}")
        w = theta[:q]
        mu = theta[q : q + q * ndim].reshape(q, ndim)
        v = theta[q + q * ndim :].reshape(q, ndim)
        kq, ks, kz = draws.split(3)
        comp = kq.categorical(torch.log(torch.clamp(w, min=1e-30)), (f,))
        sign = ks.rademacher((f, ndim), theta)
        z = kz.normal((f, ndim), theta)
        xi = sign * mu[comp] + torch.sqrt(v[comp]) * z
        return _TWO_PI * xi, _uniform_weights(f, theta) * torch.sum(w)

    if tag == "scaled":
        omega, a = _sample(spec[1], theta[1:], draws, f, ndim)
        return omega, a * theta[0]

    if tag == "ard":
        inner, d = spec[1], spec[2]
        omega, a = _sample(inner, theta[d:], draws, f, ndim)
        return omega / theta[:d][None, :], a

    if tag == "sum":
        ka, kb = spec[1], spec[2]
        fa = f // 2
        k1, k2 = draws.split(2)
        oa, aa = _sample(ka, theta[: ka.n_theta], k1, fa, ndim)
        ob, ab = _sample(kb, theta[ka.n_theta :], k2, f - fa, ndim)
        return torch.cat([oa, ob]), torch.cat([aa, ab])

    if tag == "prod":
        ka, kb = spec[1], spec[2]
        k1, k2 = draws.split(2)
        oa, aa = _sample(ka, theta[: ka.n_theta], k1, f, ndim)
        ob, ab = _sample(kb, theta[ka.n_theta :], k2, f, ndim)
        # spectral densities convolve: frequencies add, per-feature weights
        # pair up (sum_j f * a_aj * a_bj -> k_a(0) k_b(0))
        return oa + ob, aa * ab * f

    raise ValueError(f"unknown kernel spec tag {tag!r}")


def _contains_icm(spec) -> bool:
    if spec is None:
        return False
    tag = spec[0]
    if tag == "icm":
        return True
    if tag in ("sum", "prod"):
        return _contains_icm(spec[1].spec) or _contains_icm(spec[2].spec)
    if tag in ("scaled", "ard"):
        return _contains_icm(spec[1].spec)
    return False


def _sample_mo(kernel: Kernel, theta: Tensor, draws: PathDraws, f: int, ndim: int):
    """Multi-output spec walk: (omega (f, ndim), a (f,), load (T, f)) for
    icm leaves, sums of them (LMC) and scaled wrappers; an icm under a
    product has no random-feature form here."""
    spec = kernel.spec
    tag = spec[0]

    if tag == "icm":
        base, T, R = spec[1], spec[2], spec[3]
        nb = base.n_theta
        W = torch.log(theta[nb : nb + T * R]).reshape(T, R)
        kappa = theta[nb + T * R :]
        A = torch.cat([W, torch.diag(torch.sqrt(kappa))], dim=1)  # (T, L)
        L = R + T
        omega_s, a = _sample(base, theta[:nb], draws, f, ndim - 1)
        omega = torch.cat([omega_s, omega_s.new_zeros(f, 1)], dim=1)
        # feature j drives latent r_j = j mod L; sqrt(L) renormalizes the
        # per-latent feature budget so each latent approximates the FULL
        # base kernel
        r = torch.arange(f, device=theta.device) % L
        return omega, a, A[:, r] * math.sqrt(L)

    if tag == "sum":
        ka, kb = spec[1], spec[2]
        fa = f // 2
        k1, k2 = draws.split(2)
        oa, aa, la = _sample_mo(ka, theta[: ka.n_theta], k1, fa, ndim)
        ob, ab, lb = _sample_mo(kb, theta[ka.n_theta :], k2, f - fa, ndim)
        if la.shape[0] != lb.shape[0]:
            raise ValueError("LMC terms must share the task count")
        return torch.cat([oa, ob]), torch.cat([aa, ab]), torch.cat([la, lb], dim=1)

    if tag == "scaled":
        omega, a, load = _sample_mo(spec[1], theta[1:], draws, f, ndim)
        return omega, a * theta[0], load

    raise ValueError(
        f"multi-output pathwise sampling supports icm leaves, sums of them "
        f"(lmc) and scaled wrappers — got {tag!r} over an icm"
    )


def sample_features(kernel: Kernel, theta, draws, num_features: int, ndim: int) -> PathFeatures:
    """Draw one random-feature expansion of ``kernel`` at natural-scale
    hyperparameters ``theta`` (a tensor: its device and dtype are the
    features')."""
    theta = torch.as_tensor(theta)
    ko, kp = as_draws(draws, theta).split(2)
    if _contains_icm(kernel.spec):
        omega, a, load = _sample_mo(kernel, theta, ko, num_features, ndim)
    else:
        omega, a = _sample(kernel, theta, ko, num_features, ndim)
        load = None
    phase = _TWO_PI * kp.uniform((num_features,), omega)
    return PathFeatures(omega, phase, a, load)


def eval_features(feat: PathFeatures, z) -> Tensor:
    """Feature matrix Phi(z): (m, F); khat(z, z') = Phi(z) Phi(z')^T.
    Multi-output features read the task id from the LAST input coordinate
    and scale each feature by its task loading."""
    z = _points(_like(z, feat.omega))
    proj = z @ feat.omega.T + feat.phase[None, :]
    phi = torch.sqrt(2.0 * torch.clamp(feat.a, min=0.0))[None, :] * torch.cos(proj)
    if feat.task_load is not None:
        phi = phi * feat.task_load[z[:, -1].to(torch.int64)]  # (T, F) indexed by each row's task -> (m, F)
    return phi


class PathState(NamedTuple):
    """S compiled posterior sample-functions: evaluate with
    :func:`eval_paths` at any inputs, any number of times."""

    feat: PathFeatures
    weights: Tensor  # (S, F) standard-normal feature weights
    v: Tensor  # (n, S) Matheron correction coefficients K^{-1} residual
    theta_simil: Tensor
    x: Tensor  # (n, ndim) training inputs
    mask: Tensor  # (n,)


def prior_paths(kernel: Kernel, theta, draws, num_paths: int, num_features: int,
                ndim: int) -> tuple[PathFeatures, Tensor]:
    """S draws from the GP *prior* as explicit functions:
    f_s(z) = Phi(z) w_s, w_s ~ N(0, I_F).  Returns (features, weights)."""
    theta = torch.as_tensor(theta)
    kf, kw = as_draws(draws, theta).split(2)
    feat = sample_features(kernel, theta, kf, num_features, ndim)
    return feat, kw.normal((num_paths, num_features), feat.omega)


def eval_prior_paths(feat: PathFeatures, weights: Tensor, z) -> Tensor:
    """Evaluate prior paths at ``z``: (S, m)."""
    return weights @ eval_features(feat, z).T


def sample_paths(gp: GP, post: Posterior, draws, num_paths: int, num_features: int = 1024) -> PathState:
    """Compile S posterior sample-functions from a fitted Posterior: one
    ``linalg.cho_solve_mat`` against the cached factor (two blocked TRSMs,
    K5, on the card in f32 at n >= 1024).  The noise in the Matheron
    residual is the GP's own noise kernel at the training inputs (the
    diagonal ``absorb`` put into K), so the math is exact up to the
    random-feature prior."""
    kp, ke = as_draws(draws, post.x).split(2)
    feat, w = prior_paths(gp.simil, post.theta_simil, kp, num_paths, num_features, gp.ndim)
    f_train = eval_prior_paths(feat, w, post.x)  # (S, n)
    noise_sd = torch.sqrt(gp.noise.vector(post.theta_noise, post.x))  # (n,)
    eps = noise_sd[None, :] * ke.normal(f_train.shape, f_train)
    resid = (post.y - f_train - eps) * post.mask[None, :]  # (S, n)
    v = linalg.cho_solve_mat(post.chol, resid.T)  # (n, S)
    return PathState(feat, w, v, post.theta_simil, post.x, post.mask)


def eval_paths(gp: GP, ps: PathState, z) -> Tensor:
    """Evaluate the S posterior sample-functions at ``z``: (S, m).
    f_s(z) = Phi(z) w_s + k(z, X) v_s, two matmuls, the same continuous
    function at every call."""
    z = _points(_like(z, ps.x))
    prior = eval_prior_paths(ps.feat, ps.weights, z)  # (S, m)
    kstar = gp.simil.matrix(ps.theta_simil, ps.x, z) * ps.mask[:, None]  # (n, m)
    return prior + (kstar.T @ ps.v).T


def sample_paths_ski(gp: GP, theta_simil, theta_noise, x, y, draws, num_paths: int, num_features: int = 1024,
                     grid_size: int | tuple = 2048, cg_iters: int = 200, tol: float = 1e-6,
                     method: str | None = None) -> PathState:
    """Posterior sample-functions without a factorization: the Matheron
    solve is one batched CG of the S residuals against the SKI operator
    (``gp.ski``), O(cg_iters (n 4^d + N log N)).  The :func:`eval_paths`
    contract, mask all ones.  ``method`` defaults to "scatter" (any input
    order); "sorted" needs 1-D inputs sorted."""
    x = _points(x)
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    ts = _like(theta_simil, x).reshape(gp.n_theta_simil)
    tn = _like(theta_noise, x).reshape(gp.n_theta_noise)
    kp, ke = as_draws(draws, x).split(2)
    feat, w = prior_paths(gp.simil, ts, kp, num_paths, num_features, gp.ndim)
    f_train = eval_prior_paths(feat, w, x)  # (S, n)
    eps = torch.sqrt(gp.noise.vector(tn, x))[None, :] * ke.normal(f_train.shape, f_train)
    resid = _like(y, x)[None, :] - f_train - eps  # (S, n)
    mv = _ski_operator(gp, ts, tn, x, dims, "scatter" if method is None else method)
    v, _ = iterative.cg_solve(mv, resid.T, cg_iters, tol)  # (n, S)
    return PathState(feat, w, v, ts, x, torch.ones(n, dtype=x.dtype, device=x.device))


def sample_paths_laplace(gp: GP, post, draws, num_paths: int, num_features: int = 1024) -> PathState:
    """Posterior sample-functions of the LATENT f from a fitted Laplace
    posterior (``gp.laplace.LaplacePosterior``, one problem).

    N(f_hat, (K^{-1} + W)^{-1}) is a GP regression posterior with
    pseudo-targets ytilde = f_hat + W^{-1} g and noise W^{-1}, so

        f_s(.) = fp_s(.) + k(., X) (K + W^{-1})^{-1} (ytilde - fp_s(X) - eps),

    eps ~ N(0, W^{-1}), solved through the stored factor of
    B = I + W^0.5 K W^0.5: (K + W^{-1})^{-1} r = W^0.5 B^{-1} W^0.5 r
    (``linalg.cho_solve_mat``, K5 on the card at n >= 1024).  Rows with
    W = 0 carry no information and drop out exactly.  Evaluate with
    :func:`eval_paths`."""
    kp, ke = as_draws(draws, post.x).split(2)
    feat, w = prior_paths(gp.simil, post.theta_simil, kp, num_paths, num_features, gp.ndim)
    fp_x = eval_prior_paths(feat, w, post.x)  # (S, n)
    sw = post.sqrt_w  # (n,) W^0.5, 0 at padded/flat rows
    live = sw > 0.0
    # W^0.5 (ytilde - fp(X)) = W^0.5 (f_hat - fp) + g / W^0.5  (0 where W=0)
    g_over_sw = torch.where(live, post.grad_ll / torch.where(live, sw, torch.ones_like(sw)), 0.0)
    u_det = sw[None, :] * (post.f_hat[None, :] - fp_x) + g_over_sw[None, :]
    # W^0.5 eps with eps ~ N(0, W^{-1}): standard normal on live rows
    z = ke.normal(fp_x.shape, fp_x)
    u = (u_det - z * live[None, :].to(fp_x.dtype)) * post.mask[None, :]
    v = sw[:, None] * linalg.cho_solve_mat(post.chol_b, u.T)  # (n, S)
    return PathState(feat, w, v, post.theta_simil, post.x, post.mask)


class SparsePathState(NamedTuple):
    """S sparse posterior sample-functions: RFF prior + inducing update,
    f_s(t) = Phi(t) w_s + k(t, Z) v_s, v_s = Kzz^{-1} (u_s - f_prior_s(Z)),
    u_s ~ q(u)."""

    feat: PathFeatures
    weights: Tensor  # (S, F)
    v: Tensor  # (M, S)
    theta_simil: Tensor
    z: Tensor  # (M, ndim) inducing inputs


def sample_paths_svgp(gp: GP, theta_simil, state, draws, num_paths: int, num_features: int = 1024,
                      jitter: float | None = None) -> SparsePathState:
    """Pathwise sample-functions from a fitted (whitened) SVGP state
    (``gp.sparse.SVGPState``; for SGPR its ``svgp_optimal_state``): u_s =
    L (q_mu + S eps) from q(u), a random-feature prior path, and the update
    through the inducing points.  Kzz factors through ``sparse._chol_kuu``
    (K1 on the card in f32 at m >= 1024); its two triangular solves are
    ``torch.linalg``'s, as the JAX twin's are XLA's."""
    if jitter is None:
        jitter = DEFAULT_JITTER
    z = state.z
    theta_simil = _like(theta_simil, z).reshape(gp.n_theta_simil)
    kp, ke = as_draws(draws, z).split(2)
    feat, w = prior_paths(gp.simil, theta_simil, kp, num_paths, num_features, gp.ndim)
    L = _chol_kuu(gp, theta_simil, z, jitter)  # (M, M)
    S = torch.tril(state.q_sqrt)
    eps = ke.normal((num_paths, z.shape[0]), z)
    vs = state.q_mu[None, :] + eps @ S.T  # whitened draws v_s ~ N(q_mu, SS^T)
    fp_z = eval_prior_paths(feat, w, z)  # (S, M)
    # L^{-1}(u_s - fp(Z)) = v_s - L^{-1} fp(Z); then one upper solve
    resid = vs.T - torch.linalg.solve_triangular(L, fp_z.T, upper=False)  # (M, S)
    v = torch.linalg.solve_triangular(L.mT, resid, upper=True)  # (M, S) = Kzz^{-1}(u - fp)
    return SparsePathState(feat, w, v, theta_simil, z)


def eval_paths_sparse(gp: GP, ps: SparsePathState, t) -> Tensor:
    """Evaluate sparse posterior sample-functions at ``t``: (S, m)."""
    t = _points(_like(t, ps.z))
    prior = eval_prior_paths(ps.feat, ps.weights, t)  # (S, m)
    kzt = gp.simil.matrix(ps.theta_simil, ps.z, t)  # (M, m)
    return prior + (kzt.T @ ps.v).T


__all__ = [
    "GeneratorDraws",
    "PathDraws",
    "PathFeatures",
    "PathState",
    "SparsePathState",
    "as_draws",
    "eval_features",
    "eval_paths",
    "eval_paths_sparse",
    "eval_prior_paths",
    "prior_paths",
    "sample_features",
    "sample_paths",
    "sample_paths_laplace",
    "sample_paths_ski",
    "sample_paths_svgp",
]
