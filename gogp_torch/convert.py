"""Carry state across from the JAX package, as numpy arrays.

The JAX package's state is a handful of arrays: theta vectors, flat parameter
vectors, the fields of a ``gogp_tpu.gp.core.Posterior`` and those of a
``gogp_tpu.infer.mle.OptResult``.  The caller turns
them into numpy arrays (``np.asarray``) and these functions put them on the
device the caller names.  This module does not import JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gogp_torch.gp.core import Posterior
from gogp_torch.infer.mle import OptResult


def array_from_numpy(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A theta vector, a flat parameter vector or any other array, as a
    tensor on ``device`` (the numpy dtype unless ``dtype`` is given).  The
    data is copied: arrays handed over from JAX are read-only."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def posterior_from_numpy(post: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> Posterior:
    """A :class:`Posterior` from the seven fields of the JAX one, given as a
    mapping or as any object with ``_asdict()`` (the JAX NamedTuple itself)."""
    fields = post._asdict() if hasattr(post, "_asdict") else post
    return Posterior(*(array_from_numpy(fields[name], device, dtype) for name in Posterior._fields))


def posterior_to_numpy(post: Posterior) -> dict[str, np.ndarray]:
    """The fields of a :class:`Posterior` as numpy arrays, copied to the
    host."""
    return {name: t.detach().cpu().numpy() for name, t in post._asdict().items()}


def opt_result(res: Mapping[str, Any] | Any, device, dtype: torch.dtype | None = None) -> OptResult:
    """An :class:`OptResult` from the five fields of the JAX one (a mapping or
    the JAX NamedTuple): ``x`` and ``value`` as tensors on ``device``,
    ``iters`` as an int, ``converged`` and ``stalled`` as bools."""
    fields = res._asdict() if hasattr(res, "_asdict") else res
    return OptResult(
        array_from_numpy(fields["x"], device, dtype),
        array_from_numpy(fields["value"], device, dtype),
        int(np.asarray(fields["iters"])),
        bool(np.asarray(fields["converged"])),
        bool(np.asarray(fields["stalled"])),
    )
