"""Iterative GP inference: CG solves, stochastic Lanczos quadrature
log-determinants and Hutchinson-trace gradients.

PyTorch twin of ``gogp_tpu/ops/iterative.py`` (all but its row-sharded
form, ``lml_rowsharded_iterative``, which waits for the multi-device
layer).  The exact path (``ops.linalg.lml_core``) factors K in O(n^3); this
module only multiplies by it: batched (P)CG for the solves, Lanczos
quadrature for log|K|, and a backward whose trace term reuses the CG probe
solves, in the GPyTorch/BBMM family (Gardner et al. 2018).  Every operator
is a matvec, an (..., n, n) tensor or a callable on (..., n, k) blocks, so
the dense, matrix-free, Toeplitz and SKI covariances all run through the
same code.

Estimator contract (the JAX twin's): for fixed probes the value is a
deterministic function with about 0.5% relative error at 32 probes x 48
Lanczos steps.  Its gradient is not the derivative of that estimator: the
backward substitutes the Hutchinson estimate of tr(K^-1 dK) from the probe
solves,

    Kbar = g/2 (a a^T - (Z S^T + S Z^T) / 2p),   ybar = -g a,

a = K^-1 y, S = K^-1 Z: an unbiased estimate of the exact gradient (the
theta gradient within 1-3% at 8-128 probes), at no extra solve.

How the JAX constructs map:

- ``jax.lax.while_loop`` of CG is a Python loop with one host read an
  iteration (whether any column is above its tolerance), so it stops where
  the twin stops and ``iters`` match.  Columns that converged or met
  non-positive curvature freeze (alpha 0), as in the twin.
- ``jax.vmap`` of Lanczos over the probes is one block: p columns ride each
  matvec and the full reorthogonalisation works on a (p, m, n) basis.  The
  quadratures take one batched ``torch.linalg.eigh``.
- Leading batch dimensions (the port's layout for ``jax.vmap`` over
  hyperparameters, one lockstep solve for every chain of a sampler): a
  matvec may map (B, n, k) to (B, n, k); every column still freezes on its
  own, and ``cg_solve`` then counts each batch element's iterations as the
  twin's vmapped loop does.  Probes are shared across the batch.
- Randomness: where the twin takes a PRNG key, a function here takes a
  ``PathDraws`` (``gogp_torch.ops.draws``), split as the key is split;
  :func:`rademacher` is the twin's ``where(bernoulli(key, 0.5), 1, -1)``,
  not ``jax.random.rademacher``.
- ``PivotedPrecond``'s rank x rank factor is ``torch.linalg.cholesky`` with
  ``torch.cholesky_solve``, as the twin's is XLA's: the module launches none
  of the port's CUDA kernels.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gogp_torch.ops.draws import as_draws

Tensor = torch.Tensor


def _as_matvec(A):
    """An (..., n, n) tensor or a callable (..., n, k) -> (..., n, k)."""
    return A if callable(A) else (lambda V: A @ V)


def _rows(vec: Tensor, i: Tensor) -> Tensor:
    """``vec[..., i]`` for a batch of indices ``i`` (...,)."""
    return torch.take_along_dim(vec, i[..., None], -1)[..., 0]


def _onehot(i: Tensor, n: int, like: Tensor) -> Tensor:
    return (torch.arange(n, device=like.device) == i[..., None]).to(like.dtype)


def cg_solve(A, B: Tensor, max_iters: int = 100, tol: float = 1e-6, precond=None):
    """Batched (preconditioned) conjugate gradients for SPD ``A``: A X = B.

    ``B``: (n,) or (..., n, k), every right-hand side sharing each matvec.
    ``precond``: optional callable V -> M^-1 V (:func:`pivoted_precond`).
    Runs until every column's relative residual is below ``tol`` or
    ``max_iters``; converged columns freeze.  Returns (X, iters_used): an
    int, or with leading batch dimensions a tensor of each element's count.
    """
    mv = _as_matvec(A)
    pc = (lambda V: V) if precond is None else precond
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    stop2 = (tol * tol) * torch.clamp((B * B).sum(-2), min=1e-30)
    X = torch.zeros_like(B)
    R = B
    P = pc(B)
    rz = (R * P).sum(-2)
    rr = (R * R).sum(-2)
    batch = B.shape[:-2]
    counts = torch.zeros(batch, dtype=torch.int64, device=B.device)
    it = 0
    while it < max_iters:
        live = (rr > stop2).any(-1)
        if not bool(live.any()):  # the host read of each iteration
            break
        counts = counts + live.to(torch.int64)
        AP = mv(P)
        denom = (P * AP).sum(-2)
        # non-positive curvature: matvec rounding has swamped the smallest
        # eigenvalues, so the column stalls where it is instead of stepping
        # to an overflow
        active = (rr > stop2) & (denom > 0.0)
        alpha = torch.where(active, rz / torch.clamp(denom, min=1e-30), 0.0)
        X = X + alpha[..., None, :] * P
        R = R - alpha[..., None, :] * AP
        Z = pc(R)
        rz_new = (R * Z).sum(-2)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        P = Z + beta[..., None, :] * P
        rz = rz_new
        rr = (R * R).sum(-2)
        it += 1
    iters = it if not counts.dim() else counts
    return (X[:, 0] if squeeze else X), iters


def pivoted_cholesky_cols(col_fn, d0: Tensor, rank: int) -> Tensor:
    """Partial pivoted Cholesky from a column accessor: L (..., n, rank) with
    target ~= L L^T, where ``col_fn(i) -> (..., n)`` returns column i (a
    tensor of indices, one per batch element) and ``d0`` (..., n) is the
    target's diagonal.

    Greedy residual-diagonal pivoting (Harbrecht et al.), the pivot the
    first maximum, as ``jnp.argmax`` takes it; a residual pivot at or below
    1e-12 of d0[0] writes a zero column.  No host read.
    """
    *batch, n = d0.shape
    L = d0.new_zeros(*batch, n, rank)
    d = d0
    floor = 1e-12 * torch.clamp(d0[..., 0], min=1e-30)
    for j in range(rank):
        i = torch.argmax(d, -1)
        col = col_fn(i)
        di = _rows(d, i)
        Li = torch.take_along_dim(L, i[..., None, None], -2)[..., 0, :]  # row i of L
        lj = (col - (L @ Li[..., None])[..., 0]) / torch.sqrt(torch.clamp(di, min=1e-30))[..., None]
        lj = torch.where((di > floor)[..., None], lj, 0.0)
        L[..., :, j] = lj
        d = torch.clamp(d - lj * lj, min=0.0)
    return L


def pivoted_cholesky(K: Tensor, rank: int, shift=0.0) -> Tensor:
    """Partial pivoted Cholesky: L (..., n, rank) with K - shift I ~= L L^T
    (``shift`` a scalar or one per batch element)."""
    n = K.shape[-1]
    shift = torch.as_tensor(shift, dtype=K.dtype, device=K.device)

    def col_fn(i):
        col = torch.take_along_dim(K, i[..., None, None], -1)[..., 0]
        return col - shift[..., None] * _onehot(i, n, K)

    return pivoted_cholesky_cols(col_fn, torch.diagonal(K, dim1=-2, dim2=-1) - shift[..., None], rank)


class PivotedPrecond:
    """P = L L^T + D from a partial pivoted Cholesky: callable Woodbury apply
    V -> P^-1 V, the exact ``logdet`` (determinant lemma) and ``sample`` of
    z ~ N(0, P) from standard-normal seeds."""

    def __init__(self, L: Tensor, dvec: Tensor):
        self.L = L
        self.dvec = dvec
        self.dinv = 1.0 / dvec
        rank = L.shape[-1]
        M = torch.eye(rank, dtype=L.dtype, device=L.device) + L.mT @ (self.dinv[..., :, None] * L)
        self.Mc = torch.linalg.cholesky(M)
        # log det(D + L L^T) = log det(D) + log det(I + L^T D^-1 L)
        self.logdet = torch.log(dvec).sum(-1) + 2.0 * torch.log(torch.diagonal(self.Mc, dim1=-2, dim2=-1)).sum(-1)

    def __call__(self, V: Tensor) -> Tensor:
        squeeze = V.dim() == 1
        if squeeze:
            V = V[:, None]
        DV = self.dinv[..., :, None] * V
        LtDV = self.L.mT @ DV
        Mc = self.Mc.expand(LtDV.shape[:-2] + self.Mc.shape[-2:])
        t = torch.cholesky_solve(LtDV, Mc)
        out = DV - self.dinv[..., :, None] * (self.L @ t)
        return out[:, 0] if squeeze else out

    def sample(self, eps_n: Tensor, eps_r: Tensor) -> Tensor:
        """(p, n) and (p, rank) standard normals -> (..., n, p) draws of
        N(0, P)."""
        return torch.sqrt(self.dvec)[..., :, None] * eps_n.mT + self.L @ eps_r.mT


def pivoted_precond(K: Tensor, rank: int, noise_diag) -> PivotedPrecond:
    """:class:`PivotedPrecond` for P = L L^T + D, L pivoted on K - mean(D),
    ``noise_diag`` a scalar or (..., n): the covariance's noise and jitter
    diagonal."""
    n = K.shape[-1]
    dvec = torch.broadcast_to(torch.as_tensor(noise_diag, dtype=K.dtype, device=K.device), K.shape[:-1])
    return PivotedPrecond(pivoted_cholesky(K, rank, shift=dvec.mean(-1)), dvec)


def pivoted_precond_cols(col_fn, diag: Tensor, rank: int, noise_diag) -> PivotedPrecond:
    """Matrix-free :func:`pivoted_precond` from a column accessor
    ``col_fn(i) -> (..., n)`` (column i of K) and K's (..., n) diagonal: the
    same shift and pivots, never a dense K.

    A ``noise_diag`` of one value (per batch element: (..., 1)) is its own
    mean, as XLA folds the mean of a broadcast: the shift then carries no
    rounding, which matters where the residual diagonal holds exact ties
    (a Toeplitz diagonal is constant) and its last bit picks the pivot."""
    n = diag.shape[-1]
    nd = torch.as_tensor(noise_diag, dtype=diag.dtype, device=diag.device)
    dvec = torch.broadcast_to(nd, diag.shape)
    shift = torch.broadcast_to(nd, diag.shape[:-1] + (1,))[..., 0] if nd.shape[-1:] in ((), (1,)) else dvec.mean(-1)

    def col_shifted(i):
        return col_fn(i) - shift[..., None] * _onehot(i, n, diag)

    return PivotedPrecond(pivoted_cholesky_cols(col_shifted, diag - shift[..., None], rank), dvec)


def _quadrature(T: Tensor) -> Tensor:
    """e1^T log(T) e1 = sum tau^2 log(theta) over the eigenpairs of each
    tridiagonal (..., m, m); Ritz values clipped at 1e-30 (their weights are
    O(eps) where rounding makes them negative).  A tridiagonal with a
    non-finite entry gives NaN, as the twin's ``eigh`` does, where
    ``torch.linalg.eigh`` would raise: a sampler's proposal that overflows
    is then rejected, not a crash."""
    finite = torch.isfinite(T).all(-1).all(-1)
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    theta, V = torch.linalg.eigh(torch.where(finite[..., None, None], T, eye))
    tau2 = V[..., 0, :] ** 2
    quad = (tau2 * torch.log(torch.clamp(theta, min=1e-30))).sum(-1)
    return torch.where(finite, quad, torch.nan)


def _lanczos(A, Z: Tensor, num_steps: int) -> tuple[Tensor, Tensor]:
    """``num_steps`` of Lanczos on SPD A from each start column of Z
    (..., n, p), normalised inside, with full reorthogonalisation.  Returns
    (alphas (..., p, m), betas (..., p, m - 1)), the tridiagonals."""
    mv = _as_matvec(A)
    m = num_steps
    q = Z / torch.linalg.vector_norm(Z, dim=-2, keepdim=True)
    Q = None  # (..., p, m, n): the Krylov basis, rows past i zero
    alphas, betas = [], []
    for i in range(m):
        w = mv(q)
        if Q is None:
            q = q.expand(w.shape)
            Q = w.new_zeros(w.shape[:-2] + (w.shape[-1], m, w.shape[-2]))
            Q[..., 0, :] = q.mT
        alpha = (q * w).sum(-2)
        w = w - alpha[..., None, :] * q
        if i > 0:
            w = w - betas[-1][..., None, :] * Q[..., i - 1, :].mT
        basis = Q[..., : i + 1, :]
        proj = basis @ w.mT[..., None]  # (..., p, i + 1, 1)
        w = w - (basis.mT @ proj)[..., 0].mT
        beta = torch.linalg.vector_norm(w, dim=-2)
        alphas.append(alpha)
        if i + 1 < m:
            q = w / torch.clamp(beta, min=1e-30)[..., None, :]
            Q[..., i + 1, :] = q.mT
            betas.append(beta)
    alphas = torch.stack(alphas, -1)
    betas = torch.stack(betas, -1) if betas else alphas[..., :0]
    return alphas, betas


def rademacher(draws, shape, ref: Tensor) -> Tensor:
    """The twin's ``where(bernoulli(key, 0.5, shape), 1, -1)`` in ``ref``'s
    dtype."""
    return torch.where(draws.bernoulli(0.5, shape, ref), 1.0, -1.0).to(ref.dtype)


def slq_logdet(A, probes: Tensor, num_steps: int = 32) -> Tensor:
    """Stochastic Lanczos quadrature estimate of log|A| for SPD A.

    ``probes``: (p, n) Rademacher vectors; each start gives a tridiagonal
    T_j, and log|A| ~= (n / p) sum_j e1^T log(T_j) e1.  All p probes run as
    one (n, p) block.  Deterministic given the probes.
    """
    n = probes.shape[-1]
    alphas, betas = _lanczos(A, probes.mT, num_steps)
    T = torch.diag_embed(alphas) + torch.diag_embed(betas, 1) + torch.diag_embed(betas, -1)
    return n * _quadrature(T).mean(-1)


def _maybe_precond(K: Tensor, noise_diag: Tensor, precond_rank: int):
    if precond_rank <= 0:
        return None
    return pivoted_precond(K.detach(), precond_rank, noise_diag.detach())


def _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank):
    """Preconditioned SLQ where ``precond_rank > 0`` (``probes_slq``
    carries (p, n) seeds for D^1/2 and (p, rank) for L), plain SLQ over
    Rademacher probes otherwise."""
    if precond_rank > 0:
        n = K.shape[-1]
        return slq_logdet_pcg(K, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters)
    return slq_logdet(K, probes_slq, lanczos_iters)


def _solve_block(y: Tensor, probes_tr: Tensor) -> Tensor:
    """[y | Z]: (..., n, 1 + p), the probes shared across the batch."""
    return torch.cat([y[..., None], probes_tr.expand(y.shape[:-1] + probes_tr.shape)], -1)


def _lml_value(K, y, probes_slq, noise_diag, cg_iters, lanczos_iters, precond_rank):
    pc = _maybe_precond(K, noise_diag, precond_rank)
    alpha = cg_solve(K, y[..., None], cg_iters, precond=pc)[0][..., 0]
    logdet = _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank)
    return -0.5 * (logdet + (y * alpha).sum(-1))


class _LmlCoreIterative(torch.autograd.Function):
    """The value and its Hutchinson backward: one batched CG solves y and
    every trace probe, then Kbar and ybar from the solutions."""

    @staticmethod
    def forward(ctx, K, y, probes_slq, probes_tr, noise_diag, cg_iters, lanczos_iters, precond_rank):
        pc = _maybe_precond(K, noise_diag, precond_rank)
        X, _ = cg_solve(K, _solve_block(y, probes_tr), cg_iters, precond=pc)
        alpha, S = X[..., 0], X[..., 1:]
        logdet = _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank)
        ctx.save_for_backward(alpha, probes_tr, S)
        return -0.5 * (logdet + (y * alpha).sum(-1))

    @staticmethod
    def backward(ctx, g):
        alpha, Z, S = ctx.saved_tensors
        p = Z.shape[-1]
        Z = Z.expand(S.shape)
        # Kbar = g/2 (a a^T - (Z S^T + S Z^T) / 2p), one product of
        # [a | Z | S] with [a | -S/2p | -Z/2p]: the symmetrised trace
        # estimate, exact in expectation since dK is symmetric
        left = torch.cat([alpha[..., None], Z, S], -1)
        right = torch.cat([alpha[..., None], S / (-2.0 * p), Z / (-2.0 * p)], -1)
        Kbar = (0.5 * g)[..., None, None] * (left @ right.mT)
        return Kbar, -g[..., None] * alpha, None, None, None, None, None, None


def lml_core_iterative(
    K: Tensor,
    y: Tensor,
    draws,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    noise_diag=None,
) -> Tensor:
    """-1/2 (log|K| + y^T K^-1 y) without factoring K (the n/2 log 2 pi
    constant lives in the GP layer, as for ``linalg.lml_core``).

    ``K``: (..., n, n), ``y``: (..., n).  ``precond_rank > 0`` runs PCG with
    the rank-k pivoted-Cholesky preconditioner and the logdet as
    preconditioned SLQ; pass the covariance's noise and jitter diagonal as
    ``noise_diag``.  ``draws``: a ``PathDraws`` in the twin's key's place
    (split into the quadrature's and the trace's probes).  Where nothing
    needs a gradient only y is solved, as in the twin's primal.
    """
    n = K.shape[-1]
    if precond_rank > 0 and noise_diag is None:
        raise ValueError("precond_rank > 0 needs the covariance noise_diag")
    nd = torch.broadcast_to(torch.as_tensor(0.0 if noise_diag is None else noise_diag, dtype=K.dtype,
                                            device=K.device), K.shape[:-1])
    k1, k2 = as_draws(draws, K).split(2)
    if precond_rank > 0:
        # N(0, P) probe seeds for the preconditioned quadrature
        probes_slq = k1.normal((num_probes, n + precond_rank), K)
    else:
        probes_slq = rademacher(k1, (num_probes, n), K)
    probes_tr = rademacher(k2, (n, num_probes), K)
    needs_grad = torch.is_grad_enabled() and (K.requires_grad or y.requires_grad)
    y = y.expand(K.shape[:-1])
    if not needs_grad:
        return _lml_value(K, y, probes_slq, nd, cg_iters, lanczos_iters, precond_rank)
    return _LmlCoreIterative.apply(K, y, probes_slq, probes_tr, nd, cg_iters, lanczos_iters, precond_rank)


# ---------------------------------------------------------------------------
# Matrix-free form: K is never materialised.  Each matvec rebuilds K's rows a
# (panel, n) block at a time, so memory is O(panel * n); the theta gradient
# differentiates the quadratic forms of the frozen CG solutions panel by
# panel, checkpointed, so no (n, n) object exists in the backward either.
# ---------------------------------------------------------------------------


def _check_panel(n: int, panel: int) -> None:
    if n % panel != 0:
        raise ValueError(f"n={n} not divisible by panel={panel}")


def matfree_matvec(cov_rows_fn, n: int, panel: int):
    """Batched matvec V -> K V with K produced a panel at a time:
    ``cov_rows_fn(row0) -> (..., panel, n)``, rows row0 .. row0 + panel
    (n % panel == 0).  A host loop over the n / panel panels, one matmul
    each."""
    _check_panel(n, panel)

    def mv(V):
        squeeze = V.dim() == 1
        Vm = V[:, None] if squeeze else V
        out = torch.cat([cov_rows_fn(row0) @ Vm for row0 in range(0, n, panel)], -2)
        return out[:, 0] if squeeze else out

    return mv


def lml_matfree(
    cov_rows_fn,
    y: Tensor,
    draws,
    panel: int = 1024,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    cov_col_fn=None,
    cov_diag: Tensor | None = None,
    noise_diag=None,
):
    """Matrix-free -1/2 (log|K| + y^T K^-1 y) and the ingredients of its
    gradient: (value, (alpha, Z, S)).  Differentiate the value through
    :func:`matfree_quadratic_forms` with those frozen
    (``gp.core.lml_iterative_matfree``).

    ``precond_rank > 0``: PCG and preconditioned SLQ, the preconditioner
    built from ``cov_col_fn(i) -> (n,)``, ``cov_diag`` and ``noise_diag``
    (rank column evaluations, never a dense K); the same probe layout as
    :func:`lml_core_iterative`, so the same draws give the same estimate up
    to the matvec's summation order.
    """
    n = y.shape[-1]
    mv = matfree_matvec(cov_rows_fn, n, panel)
    k1, k2 = as_draws(draws, y).split(2)
    pc = None
    if precond_rank > 0:
        if cov_col_fn is None or cov_diag is None or noise_diag is None:
            raise ValueError("precond_rank > 0 needs cov_col_fn, cov_diag and noise_diag")
        nd = torch.broadcast_to(torch.as_tensor(noise_diag, dtype=y.dtype, device=y.device), (n,))
        pc = pivoted_precond_cols(lambda i: cov_col_fn(i).detach(), cov_diag.detach(), precond_rank, nd.detach())
        probes_slq = k1.normal((num_probes, n + precond_rank), y)
    else:
        probes_slq = rademacher(k1, (num_probes, n), y)
    probes_tr = rademacher(k2, (n, num_probes), y)
    X, _ = cg_solve(mv, _solve_block(y, probes_tr), cg_iters, precond=pc)
    alpha, S = X[..., 0], X[..., 1:]
    if pc is not None:
        logdet = slq_logdet_pcg(mv, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters)
    else:
        logdet = slq_logdet(mv, probes_slq, lanczos_iters)
    value = -0.5 * (logdet + (y * alpha).sum(-1))
    return value, (alpha, probes_tr, S)


def matfree_quadratic_forms(cov_rows_fn, n: int, panel: int, alpha: Tensor, Z: Tensor, S: Tensor) -> Tensor:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K), a panel at a time.

    d lml = g/2 dh/dtheta with (alpha, Z, S) held fixed: Kbar paired with
    dK without either (n, n) matrix.  Under autograd each panel is
    checkpointed (the twin's ``jax.checkpoint``): its rows are rebuilt in the
    backward, so memory stays O(panel * n) where a plain graph would keep
    every panel's rows, the whole K.
    """
    _check_panel(n, panel)
    p = Z.shape[-1]
    right = torch.cat([alpha[..., None], S, Z], -1)

    def one(row0):
        rows = cov_rows_fn(row0)  # (..., panel, n)
        sl = slice(row0, row0 + panel)
        prod = rows @ right  # (..., panel, 1 + 2p)
        quad = (alpha[..., sl] * prod[..., 0]).sum(-1)
        # symmetrised trace estimate, the dense backward's form
        tr = 0.5 * ((Z[..., sl, :] * prod[..., 1 : 1 + p]).sum((-2, -1))
                    + (S[..., sl, :] * prod[..., 1 + p :]).sum((-2, -1)))
        return quad - tr / p

    if torch.is_grad_enabled():
        vals = [checkpoint(one, row0, use_reentrant=False, preserve_rng_state=False) for row0 in range(0, n, panel)]
    else:
        vals = [one(row0) for row0 in range(0, n, panel)]
    return torch.stack(vals).sum(0)


# ---------------------------------------------------------------------------
# Preconditioned SLQ (GPyTorch App. C): log|K| = log|P| + logdet(P^-1/2 K
# P^-1/2), the second factor's quadrature from the PCG coefficients of
# K x = z for probes z ~ N(0, P), weighted by z^T P^-1 z.
# ---------------------------------------------------------------------------


def cg_coefficients(A, B: Tensor, num_steps: int, precond=None):
    """Exactly ``num_steps`` (P)CG iterations on A X = B: (X, alphas, betas),
    the coefficients (m, ..., k) that rebuild the Lanczos tridiagonal of the
    (preconditioned) operator.  Converged columns freeze with alpha 0."""
    mv = _as_matvec(A)
    pc = (lambda V: V) if precond is None else precond
    X = torch.zeros_like(B)
    R = B
    P = pc(B)
    rz = (R * P).sum(-2)
    rr_scale = torch.clamp((B * B).sum(-2), min=1e-30)
    alphas, betas = [], []
    for _ in range(num_steps):
        AP = mv(P)
        denom = (P * AP).sum(-2)
        rr = (R * R).sum(-2)
        active = (rr > 1e-24 * rr_scale) & (denom > 0.0)
        alpha = torch.where(active, rz / torch.clamp(denom, min=1e-30), 0.0)
        X = X + alpha[..., None, :] * P
        R = R - alpha[..., None, :] * AP
        Z = pc(R)
        rz_new = (R * Z).sum(-2)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        P = Z + beta[..., None, :] * P
        rz = rz_new
        alphas.append(alpha)
        betas.append(beta)
    return X, torch.stack(alphas), torch.stack(betas)


def _tridiag_from_cg(alphas: Tensor, betas: Tensor) -> Tensor:
    """The Lanczos tridiagonal (..., m, m) from CG coefficients on the last
    axis (..., m): T[0,0] = 1/alpha_0; T[k,k] = 1/alpha_k +
    beta_{k-1}/alpha_{k-1}; T[k,k-1] = sqrt(beta_{k-1})/alpha_{k-1}.  Frozen
    steps (alpha 0) become decoupled identity rows, which the e1 quadrature
    cannot see."""
    live = alphas > 0.0
    inv_a = torch.where(live, 1.0 / torch.clamp(alphas, min=1e-30), 0.0)
    prev_live = live[..., :-1] & live[..., 1:]
    diag_rest = torch.where(live[..., 1:], inv_a[..., 1:] + torch.where(prev_live, betas[..., :-1] * inv_a[..., :-1],
                                                                        0.0), 1.0)
    diag0 = torch.where(live[..., :1], inv_a[..., :1], 1.0)
    diag = torch.cat([diag0, diag_rest], -1)
    off = torch.where(prev_live, torch.sqrt(torch.clamp(betas[..., :-1], min=0.0)) * inv_a[..., :-1], 0.0)
    return torch.diag_embed(diag) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)


def slq_logdet_pcg(A, precond: PivotedPrecond, eps_n: Tensor, eps_r: Tensor, num_steps: int = 32) -> Tensor:
    """log|K| by preconditioned SLQ: log|P| + (1/p) sum_j (z_j^T P^-1 z_j)
    e1^T log(T_j) e1, T_j from the PCG coefficients of K x = z_j, probes
    z = D^1/2 eps_n + L eps_r ~ N(0, P) from the (p, n) and (p, rank)
    seeds.  Unbiased, at the preconditioned spectrum's rate."""
    Z = precond.sample(eps_n, eps_r)  # (..., n, p)
    _, alphas, betas = cg_coefficients(A, Z, num_steps, precond=precond)
    weights = (Z * precond(Z)).sum(-2)  # (..., p)
    quads = _quadrature(_tridiag_from_cg(torch.movedim(alphas, 0, -1), torch.movedim(betas, 0, -1)))
    return precond.logdet + (weights * quads).mean(-1)


__all__ = [
    "PivotedPrecond",
    "cg_coefficients",
    "cg_solve",
    "lml_core_iterative",
    "lml_matfree",
    "matfree_matvec",
    "matfree_quadratic_forms",
    "pivoted_cholesky",
    "pivoted_cholesky_cols",
    "pivoted_precond",
    "pivoted_precond_cols",
    "rademacher",
    "slq_logdet",
    "slq_logdet_pcg",
]
