"""The model a configuration names, as the program builds it.

A configuration's ``model`` block gives ``kernel`` and ``noise`` as a user
of the program writes them (an expression over ``gogp_torch``'s names, as
``rbf.scaled()``), ``ndim``, ``theta`` (the length of v) and ``prior``:
null, or ``{"family": <f>, "args": [...]}`` for an independent
``gogp_torch.dists.<f>_logp(*args, v_j)`` on each v_j.  The reference
(``portbench/reference/gp.py``) reads the same block and finds its own
plain versions of each by name, so a configuration that combines them anew
is a file alone.
"""

from __future__ import annotations

import re

_EXPR = re.compile(r"\w+(\(\))?(\.\w+(\(\))?)*")


def _resolve(expr: str):
    """``gogp_torch``'s object named by ``expr``: dotted names, each
    optionally called with no arguments."""
    import gogp_torch

    if not _EXPR.fullmatch(expr):
        raise ValueError(f"not a name of gogp_torch: {expr!r}")
    obj = gogp_torch
    for name, call in re.findall(r"(\w+)(\(\))?", expr):
        obj = getattr(obj, name)
        if call:
            obj = obj()
    return obj


def program_gp(model: dict):
    from gogp_torch import GP

    gp = GP(ndim=model["ndim"], simil=_resolve(model["kernel"]), noise=_resolve(model["noise"]))
    if gp.simil.n_theta + gp.noise.n_theta != model["theta"]:
        raise ValueError(f"{model['kernel']} + {model['noise']} take {gp.simil.n_theta + gp.noise.n_theta} "
                         f"parameters, the model says {model['theta']}")
    return gp


def program_log_prior(model: dict):
    """v (..., theta) -> the prior's log-density summed over v's last axis,
    or None for no prior."""
    prior = model.get("prior")
    if prior is None:
        return None
    from gogp_torch import dists

    logp, args = getattr(dists, f"{prior['family']}_logp"), prior["args"]
    return lambda v: logp(*args, v).sum(-1)
