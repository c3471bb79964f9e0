"""Sharded serving: serving caches and request batches spread over the mesh.

PyTorch twin of ``gogp_tpu/parallel/serving.py``.  Serving is
embarrassingly parallel along two axes:

- draw-sharded mixture: a ServingMixture's S draws shard over the CHAIN
  axis, each rank holding (and, with :func:`compile_mixture_sharded`,
  compiling) only its draws' (n, n) caches, so the per-draw work (K1 at the
  absorb, K5 in the inversion, on the card at n >= 1024) is rank-local; the
  two mixture moments are one psum each;
- request-sharded batch: the test points shard over the CHAIN axis, each
  rank predicts its rows from the replicated cache, and one gather returns
  the batch.

Where the twin places a global mixture and lets GSPMD insert the psums,
every function here is SPMD: every rank calls it, and every rank gets the
global result.
"""

from __future__ import annotations

import torch

from gogp_torch.gp.core import GP
from gogp_torch.gp.serve import (
    ServingMixture,
    ServingPosterior,
    compile_mixture,
    mixture_draw_moments,
    serve_predict,
)
from gogp_torch.ops import linalg
from gogp_torch.parallel import mesh as pmesh
from gogp_torch.parallel.mesh import CHAIN_AXIS

Tensor = torch.Tensor


def shard_mixture(sm: ServingMixture, mesh: pmesh.Mesh) -> ServingMixture:
    """This rank's slab of a ServingMixture's draws over the chain axis:
    per-draw leaves (thetas, alpha, the (n, n) factors) split their leading
    S axis, shared leaves (inputs, mask) stay whole.  S must divide by the
    chain-axis size."""
    sh = pmesh.chain_sharding(mesh)
    return sm._replace(theta_simil=sh.slab(sm.theta_simil), theta_noise=sh.slab(sm.theta_noise),
                       alpha=sh.slab(sm.alpha), w=sh.slab(sm.w))


def compile_mixture_sharded(gp: GP, vs, x, y, mesh: pmesh.Mesh, mask=None,
                            precision: str | None = linalg.ACCURATE_PRECISION) -> ServingMixture:
    """``gp.serve.compile_mixture`` of this rank's slab of the S draws
    ``vs`` (S, n_theta): the caches every rank holds, each compiled where
    it is held."""
    return compile_mixture(gp, pmesh.chain_sharding(mesh).slab(torch.as_tensor(vs)), x, y, mask, precision)


def serve_predict_mixture_sharded(gp: GP, sm: ServingMixture, z, mesh: pmesh.Mesh,
                                  precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Mixture predict with the draws sharded: ``sm`` is this rank's slab
    (:func:`shard_mixture` or :func:`compile_mixture_sharded`).  The
    per-draw matmuls run rank-local; mu = E_s[mu_s] and E_s[sigma_s^2 +
    mu_s^2] are one psum each over the chain axis."""
    mus, vars_ = mixture_draw_moments(gp, sm, z, precision)  # (S_local, m) each
    with mesh:
        s_total = mesh.axis_size(CHAIN_AXIS) * sm.n_draws
        mu = pmesh.psum(mus.sum(0), CHAIN_AXIS) / s_total
        second = pmesh.psum((vars_ + mus * mus).sum(0), CHAIN_AXIS) / s_total
    var = second - mu * mu
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def serve_predict_sharded(gp: GP, sp: ServingPosterior, z, mesh: pmesh.Mesh,
                          precision: str | None = linalg.ACCURATE_PRECISION) -> tuple[Tensor, Tensor]:
    """Batch predict with the request rows sharded over the chain axis and
    the cache replicated: no collective but the final gather of (mu,
    sigma)."""
    from gogp_torch.gp.serve import _like, _points

    sh = pmesh.chain_sharding(mesh)
    z = _points(_like(z, sp.x))
    mu, sigma = serve_predict(gp, sp, sh.slab(z), precision)
    with mesh:
        return sh.gather(mu), sh.gather(sigma)


__all__ = [
    "compile_mixture_sharded",
    "serve_predict_mixture_sharded",
    "serve_predict_sharded",
    "shard_mixture",
]
