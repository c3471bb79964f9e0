"""Carry state across from the JAX package, as numpy arrays.

The JAX package's state is a handful of arrays: theta vectors, flat parameter
vectors, the fields of a ``gogp_tpu.gp.core.Posterior``, of a
``gogp_tpu.infer.mle.OptResult``, of a ``gogp_tpu.infer.chees.ChEESState``
and of a chain batch of ``gogp_tpu.infer.hmc.HMCState`` (the NUTS and HMC
state under ``jax.vmap``).
The caller turns them into numpy arrays (``np.asarray``) and these functions
put them on the device the caller names.  This module does not import JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gogp_torch.gp.core import Posterior
from gogp_torch.infer import adapt
from gogp_torch.infer.chees import AdamState, ChEESState
from gogp_torch.infer.hmc import HMCState
from gogp_torch.infer.mle import OptResult


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


def chees_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None,
                           rng: torch.Generator | None = None) -> ChEESState:
    """A :class:`ChEESState` from the leaves of the JAX one (a mapping, or
    the JAX NamedTuple itself, with ``da``, ``adam`` and ``welford`` nested
    the same way).  Iteration counters become int32 tensors and ``step`` an
    int.  The JAX key cannot carry over: ``rng`` is the port's generator (a
    new one on ``device``, seeded 0, if None)."""
    f = _fields(state)

    def t(a):
        return array_from_numpy(a, device, dtype)

    def count(a):
        return array_from_numpy(a, device, torch.int32)

    da, adam, welford = _fields(f["da"]), _fields(f["adam"]), _fields(f["welford"])
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    return ChEESState(
        positions=t(f["positions"]), logps=t(f["logps"]), grads=t(f["grads"]),
        step_size=t(f["step_size"]), inv_mass=t(f["inv_mass"]), log_traj=t(f["log_traj"]),
        accept_probs=t(f["accept_probs"]),
        da=adapt.DualAveragingState(t(da["log_step"]), t(da["log_step_avg"]), t(da["gradient_avg"]),
                                    count(da["t"]), t(da["mu"])),
        adam=AdamState(t(adam["m"]), t(adam["v"]), count(adam["t"])),
        welford=adapt.WelfordState(t(welford["count"]), t(welford["mean"]), t(welford["m2"])),
        step=int(np.asarray(f["step"])),
        rng=rng,
    )


def hmc_state_from_numpy(state: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None,
                         rng: torch.Generator | None = None) -> HMCState:
    """An :class:`HMCState` from the leaves of a ``jax.vmap``-ed JAX one (the
    chain axis first on every leaf).  The iteration counter of dual
    averaging and the Welford count, equal on every chain, become the port's
    one shared value.  ``rng`` as in :func:`chees_state_from_numpy`."""
    f = _fields(state)

    def t(a):
        return array_from_numpy(a, device, dtype)

    def shared(a, dt=dtype):
        a = np.asarray(a)
        if not (a == a.reshape(-1)[0]).all():
            raise ValueError("a counter that differs between chains cannot be shared")
        return array_from_numpy(a.reshape(-1)[0], device, dt)

    da, welford = _fields(f["da"]), _fields(f["welford"])
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    return HMCState(
        position=t(f["position"]), logp=t(f["logp"]), grad=t(f["grad"]), step_size=t(f["step_size"]),
        inv_mass=t(f["inv_mass"]),
        da=adapt.DualAveragingState(t(da["log_step"]), t(da["log_step_avg"]), t(da["gradient_avg"]),
                                    shared(da["t"], torch.int32), t(da["mu"])),
        welford=adapt.WelfordState(shared(welford["count"]), t(welford["mean"]), t(welford["m2"])),
        accept_prob=t(f["accept_prob"]),
        rng=rng,
    )
