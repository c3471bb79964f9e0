"""Process meshes over ``torch.distributed`` and the collectives of the
multi-device layer.

PyTorch twin of ``gogp_tpu/parallel/mesh.py``.  The JAX twin names a
(chain, data) mesh of devices and runs ``shard_map`` bodies on it; here
every rank is a process, the mesh lays the ranks of an initialised
``torch.distributed`` world out row-major as ``(n_chain, n_data)`` (as
``np.asarray(devices).reshape(n_chain, n_data)`` lays out devices), and a
``shard_map`` body becomes SPMD code: every rank calls the same function on
its shard.

- ``chain`` axis: independent problems, MCMC chains, SMC particles;
- ``data`` axis: rows of large-N covariance matrices.

Each axis has one sub-group per line of the mesh, and the whole mesh one
more, made by ``dist.new_group``: every rank of the world creates every
group, in the same order, whether or not it belongs to it.  A mesh of one
rank still holds a real process group (NCCL on the card, gloo on the CPU),
so every collective call is made, as ``make_mesh``'s 1x1 mesh runs every
sharded code path in the JAX twin.

The collectives take axis names, as ``jax.lax``'s do inside ``shard_map``:
:func:`psum`, :func:`pmean`, :func:`all_gather` (tiled, ordered like JAX's:
a tuple of axes gathers axes[0]-major), :func:`axis_index` and
:func:`axis_size`.  They act on the mesh entered last (``with mesh:``); the
same operations are methods of :class:`Mesh`.  The functions and the
active-mesh stack live in ``ops.collectives``, below the ops layer that
calls them, and are re-exported here.

Backends.  A world with one card a rank is NCCL, each rank bound to its
card by :func:`init_multihost`.  A multi-rank group whose ranks share one
card is gloo with CUDA tensors (gloo's own CUDA work for all_reduce,
broadcast and all_gather); every collective takes its operands where they
lie, and no rank's compute leaves its device.

The placement helpers of the twin (``chain_sharding``, ``data_sharding``,
``replicated``, ``shard_leading``) become :class:`Sharding`: "this rank's
slab of a global tensor" (:meth:`Sharding.slab`, rows in the mesh's
flattened order) and "gather the global tensor" (:meth:`Sharding.gather`).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gogp_torch.ops import collectives
from gogp_torch.ops.collectives import (  # noqa: F401  (re-exported)
    CHAIN_AXIS,
    DATA_AXIS,
    all_gather,
    axis_index,
    axis_size,
    broadcast,
    current,
    pmean,
    psum,
)

Tensor = torch.Tensor


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """A (chain, data) layout of world ranks with a process group per line
    of each axis and one for the whole mesh.

    ``ranks``: (n_chain, n_data) world ranks.  Every rank of the world must
    construct the mesh (group creation is collective over the world); a
    rank outside it holds ``member = False`` and may call no collective."""

    def __init__(self, ranks: np.ndarray):
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != 2:
            raise ValueError(f"mesh ranks must be (n_chain, n_data), got shape {ranks.shape}")
        self.ranks = ranks
        self.axis_names = (CHAIN_AXIS, DATA_AXIS)
        self.shape = {CHAIN_AXIS: ranks.shape[0], DATA_AXIS: ranks.shape[1]}
        self.size = int(ranks.size)
        me = dist.get_rank()
        where = np.argwhere(ranks == me)
        self.member = len(where) == 1
        self.coords = {CHAIN_AXIS: int(where[0][0]), DATA_AXIS: int(where[0][1])} if self.member else None
        # one group per line: the chain axis's lines are columns, the data
        # axis's rows; every rank creates all of them in this order
        self._groups = {}
        for j in range(ranks.shape[1]):
            g = dist.new_group(ranks[:, j].tolist())
            if self.member and self.coords[DATA_AXIS] == j:
                self._groups[(CHAIN_AXIS,)] = g
        for i in range(ranks.shape[0]):
            g = dist.new_group(ranks[i, :].tolist())
            if self.member and self.coords[CHAIN_AXIS] == i:
                self._groups[(DATA_AXIS,)] = g
        g = dist.new_group(ranks.reshape(-1).tolist())
        if self.member:
            self._groups[(CHAIN_AXIS, DATA_AXIS)] = g

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "Mesh":
        collectives.push(self)
        return self

    def __exit__(self, *exc) -> None:
        collectives.pop()

    # -- coordinates ----------------------------------------------------------
    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (a tuple: flattened row-major)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axis)]))

    # -- collectives ----------------------------------------------------------
    def _group(self, axes: tuple[str, ...]):
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def psum(self, x: Tensor, axis) -> Tensor:
        """The sum of ``x`` over the ranks of ``axis`` (one reduction over
        the line's group, or the whole mesh's for both axes)."""
        axes = _axes(axis)
        group = self._group(axes)

        t = torch.as_tensor(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    def pmean(self, x: Tensor, axis) -> Tensor:
        return self.psum(x, axis) / self.axis_size(axis)

    def all_gather(self, x: Tensor, axis, tiled: bool = True) -> Tensor:
        """The ranks' ``x`` along ``axis``, stacked (``tiled``: concatenated
        on the leading axis) in axis-index order; a tuple of axes gathers
        axes[0]-major, as ``jax.lax.all_gather`` nested over them."""
        axes = _axes(axis)
        if tuple(a for a in self.axis_names if a in axes) == axes:
            return self._gather_group(x, self._group(axes), self.axis_size(axes), tiled)
        for a in reversed(axes):  # the axes out of mesh order: one gather each
            x = self._gather_group(x, self._group((a,)), self.shape[a], True)
        return x if tiled else x.reshape(self.axis_size(axes), -1, *x.shape[1:])

    def _gather_group(self, x: Tensor, group, size: int, tiled: bool) -> Tensor:
        t = torch.as_tensor(x).contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, 0) if tiled and t.dim() else torch.stack(parts)

    def broadcast(self, x: Tensor, axis, src_index: int = 0) -> Tensor:
        """``x`` of the rank at ``src_index`` along ``axis``, on every rank."""
        axes = _axes(axis)
        group = self._group(axes)
        src = dist.get_global_rank(group, src_index)

        t = torch.as_tensor(x).clone(memory_format=torch.contiguous_format)
        dist.broadcast(t, src=src, group=group)
        return t

    def __repr__(self) -> str:
        return f"Mesh({self.shape[CHAIN_AXIS]}x{self.shape[DATA_AXIS]}, ranks={self.ranks.tolist()})"


def make_mesh(
    n_chain: int | None = None,
    n_data: int = 1,
    ranks: Sequence[int] | None = None,
) -> Mesh:
    """Build a (chain, data) mesh over the world's ranks (``ranks``: a
    subset, in order; every rank of the world calls this).

    ``n_chain`` defaults to ``len(ranks) // n_data``.  With one rank this
    degenerates to a 1x1 mesh, so all sharded code paths also run on a
    single card."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    if n_chain is None:
        n_chain = len(ranks) // n_data
    n = n_chain * n_data
    if n > len(ranks):
        raise ValueError(f"mesh {n_chain}x{n_data} needs {n} devices, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:n]).reshape(n_chain, n_data))


def rank_card(backend: str, rank: int, n_cards: int, local_rank: str | None = None) -> int | None:
    """The card a rank of a world on ``backend`` binds before its group is
    made: for NCCL, torchrun's ``LOCAL_RANK`` where it is set, else the rank
    modulo the ``n_cards`` visible cards (a world on one host); None for any
    other backend (a gloo world, whose ranks may share one card)."""
    if backend != "nccl":
        return None
    if local_rank is not None:
        return int(local_rank)
    if n_cards < 1:
        raise RuntimeError("an NCCL rank needs a CUDA card, and none is visible")
    return rank % n_cards


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> int:
    """Initialise the ``torch.distributed`` world (one process per rank)
    and return its size.

    A wrapper over ``dist.init_process_group``: with a coordinator
    ``host:port`` it joins ``tcp://host:port`` as rank ``process_id`` of
    ``num_processes``; without one it reads the ``env://`` variables where
    ``MASTER_ADDR`` is set, and otherwise makes a world of one process on
    an in-memory store, so that a 1x1 mesh still holds a real group.  An
    initialised world is left as it is.  ``backend`` defaults to NCCL where
    CUDA is available, else gloo.

    An NCCL rank first binds its card (:func:`rank_card`), as the twin's
    ``jax.distributed.initialize`` gives each process its own devices: the
    card becomes the current device, and the group is made for it
    (``device_id``), so that every communicator of the world and of its
    sub-groups is made on that card.  A gloo world binds none.

    Destroy the group (``dist.destroy_process_group``) before the process
    exits: a gloo rank that exits with its group alive can abort in its
    teardown ("terminate called without an active exception") after its
    work is done."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if coordinator_address is not None:
            rank = process_id
        else:
            rank = int(os.environ.get("RANK", "0")) if "MASTER_ADDR" in os.environ else 0
        card = rank_card(backend, rank, torch.cuda.device_count(), os.environ.get("LOCAL_RANK"))
        device_id = None
        if card is not None:
            torch.cuda.set_device(card)
            device_id = torch.device("cuda", card)
        if coordinator_address is not None:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, device_id=device_id)
        elif "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://", device_id=device_id)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, device_id=device_id)
    return dist.get_world_size()


def describe(mesh: Mesh) -> dict:
    """The backend line every run prints: backend, world size and mesh
    shape."""
    return {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "mesh": [mesh.shape[CHAIN_AXIS], mesh.shape[DATA_AXIS]]}


class Sharding(NamedTuple):
    """A leading axis split over ``axes`` of ``mesh`` (no axes: replicated)."""

    mesh: Mesh
    axes: tuple[str, ...]

    def count(self) -> int:
        return self.mesh.axis_size(self.axes) if self.axes else 1

    def slab(self, x: Tensor) -> Tensor:
        """This rank's rows of the global ``x``: slab ``axis_index(axes)``
        of ``count()`` equal slabs."""
        if not self.axes:
            return x
        n = x.shape[0]
        c = self.count()
        if n % c != 0:
            raise ValueError(f"leading axis {n} not divisible by {c} ranks")
        per = n // c
        i = self.mesh.axis_index(self.axes)
        return x[i * per:(i + 1) * per]

    def gather(self, x: Tensor) -> Tensor:
        """The global tensor from every rank's slab."""
        return self.mesh.all_gather(x, self.axes) if self.axes else x


def chain_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split over chains, everything else replicated."""
    return Sharding(mesh, (CHAIN_AXIS,))


def data_sharding(mesh: Mesh) -> Sharding:
    """Leading axis split over the data axis (rows of K / blocks of X)."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_leading(mesh: Mesh, tree, axis=CHAIN_AXIS):
    """This rank's slab of every tensor in ``tree`` (a tensor, or a tuple,
    list or NamedTuple of them), the leading axis split over ``axis``."""
    sh = Sharding(mesh, _axes(axis))
    return _tree_map(sh.slab, tree)


def gather_leading(mesh: Mesh, tree, axis=CHAIN_AXIS):
    """The inverse of :func:`shard_leading`: every tensor of ``tree``
    gathered over ``axis``."""
    sh = Sharding(mesh, _axes(axis))
    return _tree_map(sh.gather, tree)


def _tree_map(fn, tree):
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return tree
