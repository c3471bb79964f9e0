"""Multi-output (multi-task) GP kernels: ICM and LMC coregionalization.

PyTorch twin of ``gogp_tpu/kernels/multioutput.py``.  Multi-output GPs as
*kernels*, so every GP entry point takes them:

- T tasks' observations are stacked into one dataset whose inputs carry the
  task id as a trailing coordinate (:func:`stack_tasks`): one covariance,
  one factorization.
- The intrinsic coregionalization model (:func:`icm`):
  K((x, i), (x', j)) = B[i, j] k(x, x'), B = W W^T + diag(kappa), W (T, R)
  free, kappa (T,) >= 0.
- The linear model of coregionalization (:func:`lmc`): a sum of ICM terms
  with independent base kernels.

Under the exp-transforming parameter protocol the W slots take ``log`` of
the natural-scale theta, so the optimizer's log-scale parameter is the
signed weight; the kappa slots take theta as it is.
"""

from __future__ import annotations

import torch

from gogp_torch.kernels.base import Kernel

Tensor = torch.Tensor


def icm(base: Kernel, n_tasks: int, rank: int = 1, name: str | None = None) -> Kernel:
    """Intrinsic coregionalization model over ``base``.

    Points are (ndim_base + 1)-dimensional, the last coordinate the task
    index 0 .. n_tasks-1 stored as a float.  Theta layout (natural scale,
    ``base.n_theta + n_tasks*rank + n_tasks`` long):
    [theta_base... | W (T*R, row-major, signed via log) | kappa (T)]."""
    nb = base.n_theta
    T, R = n_tasks, rank

    def pair(theta, xa, xb):
        W = torch.log(theta[nb : nb + T * R]).reshape(T, R)
        kappa = theta[nb + T * R :]
        ti = xa[..., -1].to(torch.int64)
        tj = xb[..., -1].to(torch.int64)
        b = (W[ti] * W[tj]).sum(-1) + torch.where(ti == tj, kappa[ti], 0.0)
        return b * base.pair(theta[:nb], xa[..., :-1], xb[..., :-1])

    return Kernel(nb + T * R + T, pair, name or f"icm({base.name},T={T},R={R})", ("icm", base, T, R))


def lmc(bases: list[Kernel], n_tasks: int, rank: int = 1) -> Kernel:
    """Linear model of coregionalization: the sum of one ICM term per base
    kernel, each with its own B (thetas concatenate, first term first)."""
    terms = [icm(b, n_tasks, rank) for b in bases]
    k = terms[0]
    for t in terms[1:]:
        k = k + t
    return k


def _column(x) -> Tensor:
    x = torch.as_tensor(x)
    return x[:, None] if x.dim() == 1 else x


def task_inputs(z, task: int) -> Tensor:
    """Test inputs for one task: ``z`` with the task-id column appended."""
    z = _column(z)
    return torch.cat([z, torch.full((z.shape[0], 1), float(task), dtype=z.dtype, device=z.device)], dim=1)


def stack_tasks(xs: list, ys: list) -> tuple[Tensor, Tensor]:
    """The per-task datasets (``xs[t]`` (n_t, d), ``ys[t]`` (n_t,)) as one:
    X (sum n_t, d + 1) with the task id in its last column, and y."""
    X = torch.cat([task_inputs(x, t) for t, x in enumerate(xs)], dim=0)
    y = torch.cat([torch.as_tensor(yy).reshape(-1) for yy in ys])
    return X, y


def init_icm_theta(base_log_theta, n_tasks: int, rank: int = 1, w_scale: float = 1.0,
                   dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """Log-scale (protocol) starting vector of an ICM kernel: the base
    thetas as given, W = w_scale in its first column and 0 elsewhere, kappa
    = 1 (log 0).  float32 by default, as in the JAX twin."""
    base_log_theta = torch.as_tensor(base_log_theta, dtype=dtype, device=device).reshape(-1)
    W = torch.zeros((n_tasks, rank), dtype=dtype, device=base_log_theta.device)
    W[:, 0] = w_scale
    return torch.cat([base_log_theta, W.reshape(-1), torch.zeros(n_tasks, dtype=dtype, device=W.device)])


__all__ = ["icm", "init_icm_theta", "lmc", "stack_tasks", "task_inputs"]
