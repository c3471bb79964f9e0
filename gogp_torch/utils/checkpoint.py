"""Checkpoint and resume for posteriors and sampler states.

PyTorch twin of ``gogp_tpu/utils/checkpoint.py``.  The state is one of the
port's NamedTuple trees (``gp.core.Posterior``, ``gp.serve.ServingPosterior``,
``infer.hmc.HMCState``, SMC particles, ADVI parameters, ...) or any nest of
tuples, lists and dicts of tensors.  The JAX package saves through orbax;
here ``torch.save`` writes the tree with each NamedTuple as its class's
module and name beside its fields, and ``torch.load(weights_only=True)``
reads it back, so a checkpoint never unpickles code; a ``torch.Generator``
(a sampler's stream) is kept as its device and state.  Zero-size leaves (the
thetas of parameter-free kernels) need no placeholder: ``torch.save`` keeps
them.
"""

from __future__ import annotations

import importlib
import os
from typing import Any

import torch

_TUPLE = "__namedtuple__"
_GENERATOR = "__generator__"


def _plain(tree: Any) -> Any:
    """The tree with each NamedTuple as {_TUPLE: "module:Name", fields...}."""
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: str(tree.device), "state": tree.get_state()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {_TUPLE: f"{cls.__module__}:{cls.__qualname__}", **{k: _plain(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _rebuilt(tree: Any) -> Any:
    if isinstance(tree, dict) and _GENERATOR in tree:
        gen = torch.Generator(device=tree[_GENERATOR])
        gen.set_state(tree["state"])
        return gen
    if isinstance(tree, dict) and _TUPLE in tree:
        module, name = tree[_TUPLE].split(":")
        if module.split(".")[0] != "gogp_torch":
            raise ValueError(f"checkpoint names {module}:{name}, not one of gogp_torch's NamedTuples")
        cls = importlib.import_module(module)
        for part in name.split("."):
            cls = getattr(cls, part)
        return cls(**{k: _rebuilt(v) for k, v in tree.items() if k != _TUPLE})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuilt(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _rebuilt(v) for k, v in tree.items()}
    return tree


def save(path: str | os.PathLike, tree: Any, *, force: bool = True) -> None:
    """Save a tree of tensors (Posterior, ServingPosterior, HMCState, ...)
    to the file ``path``; ``force=False`` refuses to overwrite one."""
    path = os.fspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    torch.save(_plain(tree), path)


def _to_like(restored: Any, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        return restored.to(device=like.device, dtype=like.dtype)
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(restored.get_state())
        return gen
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_to_like(r, l) for r, l in zip(restored, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_to_like(r, l) for r, l in zip(restored, like))
    if isinstance(like, dict):
        return {k: _to_like(restored[k], v) for k, v in like.items()}
    return restored


def restore(path: str | os.PathLike, like: Any | None = None) -> Any:
    """A tree saved by :func:`save`, its tensors on the CPU; with ``like`` (a
    tree of the same structure), each tensor on ``like``'s device and in its
    dtype."""
    tree = _rebuilt(torch.load(os.fspath(path), map_location="cpu", weights_only=True))
    return tree if like is None else _to_like(tree, like)
