"""The plain reference of an exact GP's log marginal likelihood and its
gradient, with an optional independent prior on its log-hyperparameters.

    v = (kernel's log-parameters, noise's log-parameters)
    K = K_f(v) + diag(noise variance(v))
    LML(v) = -1/2 y^T K^-1 y - 1/2 log|K| - n/2 log 2 pi          (GPML 5.8)
    dLML/dv_j = 1/2 tr((alpha alpha^T - K^-1) dK/dv_j),  alpha = K^-1 y   (GPML 5.9)

A configuration's ``model`` block names the parts; each is a plain module
found by that name: ``kernels/<kernel>.py`` (``rbf.scaled()`` is
``rbf_scaled``), ``noises/<noise>.py`` and ``priors/<family>.py``.  Plain
``torch.linalg`` in the dtype of the inputs (the benchmark hands it
float64), a leading batch axis over chains, the gradient's contractions
taken in blocks of rows so that n = 16384 fits beside little else.
Nothing here imports the program.
"""

from __future__ import annotations

import importlib
import math
import re

import torch

Tensor = torch.Tensor


def part(kind: str, name: str):
    """The reference's module of a model part: ``kind`` is ``kernels``,
    ``noises`` or ``priors``."""
    module = re.sub(r"\W+", "_", name).strip("_")
    return importlib.import_module(f"portbench.reference.{kind}.{module}")


def lml_and_grad(x: Tensor, y: Tensor, v: Tensor, model: dict, rows: int = 2048,
                 with_scale: bool = False) -> tuple[Tensor, ...]:
    """LML and its gradient in v at x (n,) or (n, d), y (n,) and v (...,
    theta), every v of the batch at once.  ``with_scale`` adds each gradient
    entry's scale, |1/2 alpha^T dK alpha| + |1/2 tr(K^-1 dK)|: the two terms
    cancel near an optimum, where the gradient is all but zero while the
    rounding of either term is not."""
    kern, noise = part("kernels", model["kernel"]), part("noises", model["noise"])
    p = kern.THETA + noise.THETA
    if v.shape[-1] != p or model["theta"] != p:
        raise ValueError(f"v has {v.shape[-1]} entries, the model {model['theta']}, its parts {p}")
    batch = v.shape[:-1]
    vs = v.reshape(-1, p)
    tk, tn = vs[:, :kern.THETA], vs[:, kern.THETA:]
    x = x if x.dim() == 2 else x[:, None]
    n = x.shape[0]
    K = torch.empty((vs.shape[0], n, n), dtype=x.dtype, device=x.device)
    for r0 in range(0, n, rows):
        K[:, r0:r0 + rows] = kern.rows(x, r0, min(r0 + rows, n), tk)[0]
    var, dvar = noise.var(tn)  # (batch,), each (batch,)
    K.diagonal(dim1=-2, dim2=-1).add_(var[:, None])
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y.expand(vs.shape[0], n)[..., None], L)[..., 0]
    logdet = 2 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    val = -0.5 * (alpha * y).sum(-1) - 0.5 * logdet - 0.5 * n * math.log(2 * math.pi)
    Kinv = torch.cholesky_inverse(L)
    del L
    fit = torch.zeros(vs.shape, dtype=x.dtype, device=x.device)  # alpha^T dK alpha
    tr = torch.zeros_like(fit)  # tr(K^-1 dK)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        dK = kern.rows(x, r0, r1, tk)[1]
        for acc, A in ((fit, alpha[:, r0:r1, None] * alpha[:, None, :]), (tr, Kinv[:, r0:r1])):
            for j, dKj in enumerate(dK):
                acc[:, j] += (A * dKj).sum((-2, -1))
            diag = torch.diagonal(A, offset=r0, dim1=-2, dim2=-1).sum(-1)
            for j, dv in enumerate(dvar):
                acc[:, kern.THETA + j] += diag * dv
    out = (val.reshape(batch), (0.5 * (fit - tr)).reshape(*batch, p))
    return (*out, (0.5 * (fit.abs() + tr.abs())).reshape(*batch, p)) if with_scale else out


def log_density(config: dict):
    """The reference's ``(x, y, v, with_scale=False) -> (value, gradient[,
    scale])`` of a configuration: the LML, plus the prior's log-density
    where the model has one (its scale then adds the prior term's)."""
    model = config["model"]
    prior = model.get("prior")
    pr = part("priors", prior["family"]) if prior else None

    def f(x: Tensor, y: Tensor, v: Tensor, with_scale: bool = False, rows: int = 2048):
        val, g, *scale = lml_and_grad(x, y, v, model, rows, with_scale)
        if pr is not None:
            pv, pg, ps = pr.log_density(v, *prior["args"])
            val, g, scale = val + pv, g + pg, [s + ps for s in scale]
        return (val, g, *scale)

    return f
