"""Automatic kernel-structure discovery: greedy compositional search.

PyTorch twin of ``gogp_tpu/search.py``.  Starting from base kernels, greedily
grow

    K  ->  K + B   |   K * B        (B in the base vocabulary)

accepting the move that most improves a complexity-penalized score (BIC by
default) and stopping when no move improves it (Duvenaud et al. 2013).

Candidates loop in Python; all RESTARTS of one candidate are one batched
Adam fit (``infer.mle.adam_batched``): the batch's value and gradient comes
from ``ops.fused_gp.make_fused_value_and_grad`` where
``fused_gp.takes_kernel`` sends its (restarts, n, n) covariances to K7 (the
card, f32, n <= ``K7_MAX_N``), one K7 launch per Adam step; elsewhere from
``torch.func.vmap`` of ``gp_observe`` differentiated by autograd.

Scores: "bic" (default) and "aic" penalize by parameter count; "loo" uses
the exact leave-one-out pseudo-likelihood (``gp.model_selection``), all at
the multi-start MLE.  The restarts' starting points, 0.7 N(0, I) on log
scale, come from a ``gp.pathwise.PathDraws`` (or a ``torch.Generator``) in
the JAX twin's key's place.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from gogp_torch.gp import core, model_selection, pathwise
from gogp_torch.infer import mle
from gogp_torch.kernels import (
    linear,
    matern12,
    matern32,
    matern52,
    normal,
    periodic,
    rational_quadratic,
    uniform_noise,
)
from gogp_torch.kernels.base import Kernel
from gogp_torch.models.params import gp_observe
from gogp_torch.ops import fused_gp

Tensor = torch.Tensor

#: Base vocabulary; every base enters compositions with its own output
#: scale (``.scaled()``), the standard CKS convention.
BASE_KERNELS: dict[str, Kernel] = {
    "rbf": normal,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "periodic": periodic,
    "rq": rational_quadratic,
    "linear": linear,
}


class Candidate(NamedTuple):
    name: str
    kernel: Kernel  # similarity kernel (bases already scaled)
    v_opt: Tensor  # (n_theta_total,) log-scale optimum incl. noise theta
    lml: float
    score: float


class SearchResult(NamedTuple):
    """Winning structure + the full greedy trace (one Candidate per accepted
    round)."""

    kernel: Kernel
    name: str
    v_opt: Tensor
    lml: float
    score: float
    history: list  # list[Candidate], accepted move per round
    y_mean: float
    y_std: float


def batched_value_and_grad(gp: core.GP, x: Tensor, y: Tensor):
    """``vg(V) -> (logp, grad)`` of the LML at every row of V (restarts, p):
    the K7 route where ``fused_gp.takes_kernel`` says so (one K7 launch a
    call), else ``torch.func.vmap`` of ``gp_observe`` under autograd."""
    n = x.shape[0]
    if fused_gp.takes_kernel(x.new_empty(0, n, n)):
        return fused_gp.make_fused_value_and_grad(gp, x, y)
    logp_rows = torch.func.vmap(lambda v: gp_observe(gp, v, x=x, y=y))

    def vg(V):
        V = V.detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp_rows(V)
            (grad,) = torch.autograd.grad(val.sum(), V)
        return val.detach(), grad

    return vg


def _fit_candidate(kernel: Kernel, x: Tensor, y: Tensor, key, restarts: int, iters: int, rate: float):
    """Multi-restart Adam MLE of (kernel + uniform noise); returns the best
    (log-theta vector, lml, gp).  The restarts run as one batch."""
    gp = core.GP(ndim=x.shape[1], simil=kernel, noise=uniform_noise)
    V0 = torch.stack([0.7 * k.normal((gp.n_theta,), x) for k in pathwise.as_draws(key, x).split(restarts)])
    res = mle.adam_batched(batched_value_and_grad(gp, x, y), V0, iters=iters, rate=rate)
    vals = torch.where(torch.isnan(res.value), -torch.inf, res.value)
    i = torch.argmax(vals)
    return res.x[i], float(vals[i]), gp


def _score(kind: str, gp: core.GP, v_opt: Tensor, lml_value: float, x: Tensor, y: Tensor) -> float:
    n = x.shape[0]
    if kind == "bic":
        return float(model_selection.bic(lml_value, gp.n_theta, n))
    if kind == "aic":
        return float(model_selection.aic(lml_value, gp.n_theta))
    if kind == "loo":
        theta = torch.exp(v_opt)
        nts = gp.n_theta_simil
        return -float(model_selection.loo_score(gp, theta[:nts], theta[nts:], x, y))
    raise ValueError(f"unknown score {kind!r}")


def search(
    x,
    y,
    bases: Sequence[str] = ("rbf", "matern32", "periodic", "linear"),
    max_depth: int = 3,
    restarts: int = 8,
    iters: int = 400,
    rate: float = 0.05,
    score: str = "bic",
    min_improvement: float = 0.0,
    normalize_y: bool = True,
    key=None,
    device=None,
) -> SearchResult:
    """Greedy compositional kernel search on (x, y).

    Round 0 fits every base alone; later rounds try ``current + B`` and
    ``current * B`` for every base, accepting the best scoring move while it
    improves the incumbent score by more than ``min_improvement`` (lower is
    better).  Returns the winning kernel (bases scaled, ready for
    ``GP(simil=...)`` with ``uniform_noise``), its log-scale optimum and the
    accepted-move history.  ``x`` runs on its own device when it is a
    tensor, else on ``device`` (default the CUDA card); ``key`` as in the
    module docstring (None: a generator there seeded 0)."""
    if not isinstance(x, Tensor):
        x = torch.as_tensor(np.asarray(x), device=torch.device("cuda") if device is None else device)
    x = core._points(x)
    key = pathwise.as_draws(key, x)
    y = np.asarray(y.detach().cpu() if isinstance(y, Tensor) else y, dtype=float)
    y_mean, y_std = (float(y.mean()), float(y.std())) if normalize_y else (0.0, 1.0)
    if normalize_y and y_std > 0:
        y = (y - y_mean) / y_std
    yt = torch.as_tensor(y, dtype=x.dtype, device=x.device)

    vocab = {b: BASE_KERNELS[b].scaled() for b in bases}
    history: list[Candidate] = []
    incumbent: Candidate | None = None

    for _ in range(max_depth):
        if incumbent is None:
            moves = list(vocab.items())
        else:
            moves = []
            for name, k in vocab.items():
                moves.append((f"({incumbent.name}+{name})", incumbent.kernel + k))
                moves.append((f"({incumbent.name}*{name})", incumbent.kernel * k))
        best: Candidate | None = None
        for name, kern in moves:
            key, sub = key.split(2)
            v_opt, lml_value, gp = _fit_candidate(kern, x, yt, sub, restarts, iters, rate)
            if not np.isfinite(lml_value):
                continue
            s = _score(score, gp, v_opt, lml_value, x, yt)
            if best is None or s < best.score:
                best = Candidate(name, kern, v_opt, lml_value, s)
        if best is None:
            break
        if incumbent is not None and best.score >= incumbent.score - min_improvement:
            break
        incumbent = best
        history.append(best)

    if incumbent is None:
        raise RuntimeError("kernel search found no finite-LML candidate")
    return SearchResult(incumbent.kernel, incumbent.name, incumbent.v_opt, incumbent.lml, incumbent.score, history,
                        y_mean, y_std)


__all__ = ["BASE_KERNELS", "Candidate", "SearchResult", "search"]
