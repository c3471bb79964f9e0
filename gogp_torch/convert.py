"""Carry state across from the JAX package, as numpy arrays.

The JAX package's state is a handful of arrays: theta vectors, flat parameter
vectors, the fields of a ``gogp_tpu.gp.core.Posterior``, of a
``gogp_tpu.infer.mle.OptResult``, of a ``gogp_tpu.infer.chees.ChEESState``
(also rung-stacked, as PT-ChEES keeps it), of a chain batch of
``gogp_tpu.infer.hmc.HMCState`` (the NUTS and HMC state under ``jax.vmap``),
of a ``gogp_tpu.infer.ghmc.GHMCState``, of a
``gogp_tpu.infer.tempering.PTFlow``, of the serving caches
(``gogp_tpu.gp.serve.ServingPosterior`` and ``ServingMixture``), of the
non-Gaussian posteriors (``gogp_tpu.gp.laplace.LaplacePosterior``,
``gogp_tpu.gp.ep.EPPosterior``), of ``gogp_tpu.infer.elliptical.ESSResult``,
of the sparse GPs (``gogp_tpu.gp.sparse.SGPRPosterior``, ``SVGPState``,
``SVGPParams``), of the pathwise samples (``gogp_tpu.gp.pathwise.PathFeatures``,
``PathState``, ``SparsePathState``) and of ``gogp_tpu.bo.BOState``.
The caller turns them into numpy arrays (``np.asarray``) and these functions
put them on the device the caller names.  For the multi-device layer,
:func:`slab_from_numpy` takes one rank's rows of a global array (a
``jax.sharding`` global array gathered to numpy), and
:func:`serving_mixture_slab_from_numpy` one rank's draws of a serving
mixture.  This module does not import JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gogp_torch.bo import BOState
from gogp_torch.gp.core import Posterior
from gogp_torch.gp.ep import EPPosterior
from gogp_torch.gp.laplace import LaplacePosterior
from gogp_torch.gp.pathwise import PathFeatures, PathState, SparsePathState
from gogp_torch.gp.serve import ServingMixture, ServingPosterior
from gogp_torch.gp.sparse import SGPRPosterior, SVGPParams, SVGPState
from gogp_torch.infer.elliptical import ESSResult
from gogp_torch.infer import adapt
from gogp_torch.infer.chees import AdamState, ChEESState
from gogp_torch.infer.ghmc import GHMCState
from gogp_torch.infer.hmc import HMCState
from gogp_torch.infer.mle import OptResult
from gogp_torch.infer.tempering import PTFlow


def _fields(obj) -> Mapping[str, Any]:
    """A NamedTuple's fields as a mapping; a mapping as it is."""
    return obj._asdict() if hasattr(obj, "_asdict") else obj


def array_from_numpy(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A theta vector, a flat parameter vector or any other array, as a
    tensor on ``device`` (the numpy dtype unless ``dtype`` is given).  The
    data is copied: arrays handed over from JAX are read-only."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def posterior_from_numpy(post: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> Posterior:
    """A :class:`Posterior` from the seven fields of the JAX one, given as a
    mapping or as any object with ``_asdict()`` (the JAX NamedTuple itself)."""
    fields = _fields(post)
    return Posterior(*(array_from_numpy(fields[name], device, dtype) for name in Posterior._fields))


def _tuple_from_numpy(cls, obj, device, dtype, fields=None):
    f = _fields(obj)
    return cls(*(array_from_numpy(f[name], device, dtype) for name in fields or cls._fields))


def serving_posterior_from_numpy(sp: Mapping[str, Any] | Any, device,
                                 dtype: torch.dtype | None = None) -> ServingPosterior:
    """A :class:`ServingPosterior` from the six fields of the JAX one."""
    return _tuple_from_numpy(ServingPosterior, sp, device, dtype)


def serving_mixture_from_numpy(sm: Mapping[str, Any] | Any, device,
                               dtype: torch.dtype | None = None) -> ServingMixture:
    """A :class:`ServingMixture` from the six fields of the JAX one."""
    return _tuple_from_numpy(ServingMixture, sm, device, dtype)


def slab_from_numpy(a, index: int, count: int, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Slab ``index`` of ``count`` equal slabs of a global array's leading
    axis: the rows the rank at flattened mesh index ``index`` holds
    (``parallel.mesh.Sharding.slab``), as a JAX array sharded ``P(axes)``
    over a mesh of ``count`` devices places them."""
    a = np.asarray(a)
    if a.shape[0] % count != 0:
        raise ValueError(f"leading axis {a.shape[0]} not divisible by {count} ranks")
    per = a.shape[0] // count
    return array_from_numpy(a[index * per:(index + 1) * per], device, dtype)


def serving_mixture_slab_from_numpy(sm: Mapping[str, Any] | Any, index: int, count: int, device,
                                    dtype: torch.dtype | None = None) -> ServingMixture:
    """One rank's slab of a JAX ServingMixture's S draws (per-draw leaves
    sliced, the shared inputs and mask whole), as
    ``parallel.serving.shard_mixture`` slices the port's."""
    f = dict(_fields(sm))
    for name in ("theta_simil", "theta_noise", "alpha", "w"):
        f[name] = np.asarray(f[name])[index * (len(f[name]) // count):(index + 1) * (len(f[name]) // count)]
    return serving_mixture_from_numpy(f, device, dtype)


def laplace_posterior_from_numpy(post: Mapping[str, Any] | Any, device,
                                 dtype: torch.dtype | None = None) -> LaplacePosterior:
    """A :class:`LaplacePosterior` from the ten fields of the JAX one (its
    ``iters``, which the JAX state does not keep, is None)."""
    return _tuple_from_numpy(LaplacePosterior, post, device, dtype, LaplacePosterior._fields[:-1])


def ep_posterior_from_numpy(post: Mapping[str, Any] | Any, device,
                            dtype: torch.dtype | None = None) -> EPPosterior:
    """An :class:`EPPosterior` from the ten fields of the JAX one (its
    ``sweeps`` is None)."""
    return _tuple_from_numpy(EPPosterior, post, device, dtype, EPPosterior._fields[:-1])


def ess_result_from_numpy(res: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> ESSResult:
    """An :class:`ESSResult` from the eight fields of the JAX one; the
    shrink counts stay integers."""
    f = dict(_fields(res))
    out = _tuple_from_numpy(ESSResult, {**f, "shrinks": np.zeros(0)}, device, dtype)
    return out._replace(shrinks=array_from_numpy(f["shrinks"], device, torch.int64))


def sgpr_posterior_from_numpy(post: Mapping[str, Any] | Any, device,
                              dtype: torch.dtype | None = None) -> SGPRPosterior:
    """An :class:`SGPRPosterior` from the six fields of the JAX one."""
    return _tuple_from_numpy(SGPRPosterior, post, device, dtype)


def svgp_state_from_numpy(state: Mapping[str, Any] | Any, device,
                          dtype: torch.dtype | None = None) -> SVGPState:
    """An :class:`SVGPState` from the three fields of the JAX one."""
    return _tuple_from_numpy(SVGPState, state, device, dtype)


def svgp_params_from_numpy(params: Mapping[str, Any] | Any, device,
                           dtype: torch.dtype | None = None) -> SVGPParams:
    """An :class:`SVGPParams` from the JAX one: ``log_theta`` and the nested
    ``state``."""
    f = _fields(params)
    return SVGPParams(array_from_numpy(f["log_theta"], device, dtype), svgp_state_from_numpy(f["state"], device, dtype))


def path_features_from_numpy(feat: Mapping[str, Any] | Any, device,
                             dtype: torch.dtype | None = None) -> PathFeatures:
    """A :class:`PathFeatures` from the JAX one: ``omega``, ``phase``, ``a``
    and ``task_load`` (None where the kernel is single-output)."""
    f = _fields(feat)
    load = f.get("task_load")
    return PathFeatures(*(array_from_numpy(f[name], device, dtype) for name in ("omega", "phase", "a")),
                        None if load is None else array_from_numpy(load, device, dtype))


def path_state_from_numpy(ps: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> PathState:
    """A :class:`PathState` from the JAX one, its ``feat`` nested."""
    f = _fields(ps)
    return PathState(path_features_from_numpy(f["feat"], device, dtype),
                     *(array_from_numpy(f[name], device, dtype) for name in PathState._fields[1:]))


def sparse_path_state_from_numpy(ps: Mapping[str, Any] | Any, device,
                                 dtype: torch.dtype | None = None) -> SparsePathState:
    """A :class:`SparsePathState` from the JAX one, its ``feat`` nested."""
    f = _fields(ps)
    return SparsePathState(path_features_from_numpy(f["feat"], device, dtype),
                           *(array_from_numpy(f[name], device, dtype) for name in SparsePathState._fields[1:]))


def bo_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> BOState:
    """A :class:`BOState` from the JAX one: its streaming ``post`` (a
    :class:`Posterior`), ``best_x`` and ``best_y``."""
    f = _fields(state)
    return BOState(posterior_from_numpy(f["post"], device, dtype), array_from_numpy(f["best_x"], device, dtype),
                   array_from_numpy(f["best_y"], device, dtype))


def likelihood_theta_from_numpy(theta, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A likelihood's theta vector (natural scale, ``lik.n_theta`` long;
    empty for the Bernoulli and Poisson families), as a 1-D tensor."""
    return array_from_numpy(np.asarray(theta).reshape(-1), device, dtype)


def posterior_to_numpy(post: Posterior) -> dict[str, np.ndarray]:
    """The fields of a :class:`Posterior` as numpy arrays, copied to the
    host."""
    return {name: t.detach().cpu().numpy() for name, t in post._asdict().items()}


def opt_result(res: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> OptResult:
    """An :class:`OptResult` from the five fields of the JAX one (a mapping or
    the JAX NamedTuple): ``x`` and ``value`` as tensors on ``device``,
    ``iters`` as an int, ``converged`` and ``stalled`` as bools."""
    fields = _fields(res)
    return OptResult(
        array_from_numpy(fields["x"], device, dtype),
        array_from_numpy(fields["value"], device, dtype),
        int(np.asarray(fields["iters"])),
        bool(np.asarray(fields["converged"])),
        bool(np.asarray(fields["stalled"])),
    )


def _shared(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A counter that a vmapped JAX state holds once per chain, rung or
    population, as the port's one shared value."""
    a = np.asarray(a)
    if not (a == a.reshape(-1)[0]).all():
        raise ValueError("a counter that differs between chains cannot be shared")
    return array_from_numpy(a.reshape(-1)[0], device, dtype)


def _rng(rng, device) -> torch.Generator:
    """The JAX key cannot carry over: ``rng``, or a new generator on
    ``device`` seeded 0."""
    return torch.Generator(device=device).manual_seed(0) if rng is None else rng


def chees_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None,
                           rng: torch.Generator | None = None) -> ChEESState:
    """A :class:`ChEESState` from the leaves of the JAX one (a mapping, or
    the JAX NamedTuple itself, with ``da``, ``adam`` and ``welford`` nested
    the same way).  A rung-stacked state (every leaf with a leading K, as
    ``pt_chees`` vmaps it) becomes a grouped one: its iteration counters,
    equal on every rung, become the port's shared ones.  Counters become
    int32 tensors and ``step`` an int; ``rng`` is the port's generator (a
    new one on ``device``, seeded 0, if None)."""
    f = _fields(state)

    def t(a):
        return array_from_numpy(a, device, dtype)

    da, adam, welford = _fields(f["da"]), _fields(f["adam"]), _fields(f["welford"])
    return ChEESState(
        positions=t(f["positions"]), logps=t(f["logps"]), grads=t(f["grads"]),
        step_size=t(f["step_size"]), inv_mass=t(f["inv_mass"]), log_traj=t(f["log_traj"]),
        accept_probs=t(f["accept_probs"]),
        da=adapt.DualAveragingState(t(da["log_step"]), t(da["log_step_avg"]), t(da["gradient_avg"]),
                                    _shared(da["t"], device, torch.int32), t(da["mu"])),
        adam=AdamState(t(adam["m"]), t(adam["v"]), _shared(adam["t"], device, torch.int32)),
        welford=adapt.WelfordState(_shared(welford["count"], device, dtype), t(welford["mean"]), t(welford["m2"])),
        step=int(_shared(f["step"], device)),
        rng=_rng(rng, device),
    )


# PT-ChEES keeps its rungs as the groups of one ChEESState.
pt_chees_state_from_numpy = chees_state_from_numpy


def hmc_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None,
                         rng: torch.Generator | None = None) -> HMCState:
    """An :class:`HMCState` from the leaves of a ``jax.vmap``-ed JAX one (the
    chain axis first on every leaf).  The iteration counter of dual
    averaging and the Welford count, equal on every chain, become the port's
    one shared value.  ``rng`` as in :func:`chees_state_from_numpy`."""
    f = _fields(state)

    def t(a):
        return array_from_numpy(a, device, dtype)

    da, welford = _fields(f["da"]), _fields(f["welford"])
    return HMCState(
        position=t(f["position"]), logp=t(f["logp"]), grad=t(f["grad"]), step_size=t(f["step_size"]),
        inv_mass=t(f["inv_mass"]),
        da=adapt.DualAveragingState(t(da["log_step"]), t(da["log_step_avg"]), t(da["gradient_avg"]),
                                    _shared(da["t"], device, torch.int32), t(da["mu"])),
        welford=adapt.WelfordState(_shared(welford["count"], device, dtype), t(welford["mean"]), t(welford["m2"])),
        accept_prob=t(f["accept_prob"]),
        rng=_rng(rng, device),
    )


def ghmc_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None,
                          rng: torch.Generator | None = None) -> GHMCState:
    """A :class:`GHMCState` from the leaves of the JAX one; ``rng`` as in
    :func:`chees_state_from_numpy`."""
    f = _fields(state)

    def t(a):
        return array_from_numpy(a, device, dtype)

    da = _fields(f["da"])
    return GHMCState(
        positions=t(f["positions"]), momenta=t(f["momenta"]), logps=t(f["logps"]), grads=t(f["grads"]),
        step_size=t(f["step_size"]), sigma=t(f["sigma"]), accept_probs=t(f["accept_probs"]),
        da=adapt.DualAveragingState(t(da["log_step"]), t(da["log_step_avg"]), t(da["gradient_avg"]),
                                    array_from_numpy(da["t"], device, torch.int32), t(da["mu"])),
        step=int(np.asarray(f["step"])),
        rng=_rng(rng, device),
    )


def flow_from_numpy(flow: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> PTFlow:
    """A :class:`PTFlow` from the JAX one (per-ladder labels and trips
    where it has them)."""
    f = _fields(flow)
    return PTFlow(array_from_numpy(f["labels"], device, torch.int32), array_from_numpy(f["trips"], device, torch.int32),
                  array_from_numpy(f["rej_sum"], device, dtype), array_from_numpy(f["prop_count"], device, dtype))
