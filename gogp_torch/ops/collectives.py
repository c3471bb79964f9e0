"""The collectives of the multi-device layer, by axis name, on the mesh
entered last.

These are what ``jax.lax``'s ``psum``, ``pmean``, ``all_gather``,
``axis_index`` and ``axis_size`` are inside a ``shard_map`` body: the ops
layer (``ops.distributed``, the row-sharded half of ``ops.iterative``) and
the samplers' ``axis_name`` hooks call them, and ``parallel.mesh.Mesh``
implements them over its process groups.  They sit here, below both the
ops and the parallel layers, so that neither imports the other's package;
``parallel.mesh`` re-exports them.

A mesh is entered with ``with mesh:`` (``Mesh.__enter__`` calls
:func:`push`); the functions act on the mesh entered last, which must have
the methods ``psum``, ``all_gather``, ``broadcast``, ``axis_index`` and
``axis_size``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

CHAIN_AXIS = "chain"  # independent problems: MCMC chains, SMC particles, refits
DATA_AXIS = "data"  # rows of large-N covariance matrices

_ACTIVE: list = []


def push(mesh) -> None:
    _ACTIVE.append(mesh)


def pop() -> None:
    _ACTIVE.pop()


def current():
    """The mesh entered last."""
    if not _ACTIVE:
        raise RuntimeError("no mesh is active: run the sharded body under `with mesh:`")
    return _ACTIVE[-1]


def psum(x: Tensor, axis) -> Tensor:
    return current().psum(x, axis)


def pmean(x: Tensor, axis) -> Tensor:
    return current().pmean(x, axis)


def all_gather(x: Tensor, axis, tiled: bool = True) -> Tensor:
    return current().all_gather(x, axis, tiled)


def broadcast(x: Tensor, axis, src_index: int = 0) -> Tensor:
    return current().broadcast(x, axis, src_index)


def axis_index(axis) -> int:
    return current().axis_index(axis)


def axis_size(axis) -> int:
    return current().axis_size(axis)
