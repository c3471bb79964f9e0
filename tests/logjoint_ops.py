"""The operations one batched value and gradient of a study's log-joint
dispatches, as a sampler takes it through ``tutorial/bayes.py``.

A sampler on a card pays each dispatched operation once per leapfrog step in
host time (a launch and its bookkeeping), far more than the card's time for
it at these sizes, so the count is the host cost's first measure.  This
counts, on the CPU, the operations that reach PyTorch's dispatcher
(``TorchDispatchMode``) during one ``hmc.value_and_grad`` call of
``build_logjoint``'s log-joint (the K7 route; K7's plain version on the
CPU), views apart, and lists the source lines that dispatch the most.

    python tests/logjoint_ops.py hyperpriors --chains 4
    python tests/logjoint_ops.py barebones --chains 8 --top 10

One JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Operations that make no new tensor data (no kernel on a card).
VIEWS = frozenset({"view", "_unsafe_view", "as_strided", "select", "slice", "unsqueeze", "squeeze", "permute",
                   "expand", "transpose", "t", "detach", "alias", "diagonal", "reshape", "unbind"})


def count_ops(study_name: str, chains: int, seed: int = 0) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from gogp_torch.infer import hmc
    from gogp_torch.tutorial import bayes
    from gogp_torch.tutorial import io as tio

    _, study, data = bayes.get_study(study_name)
    x, y = tio.load_csv(data)
    logp, _, v0, free = bayes.build_logjoint(study, x, tio.normalize(y)[0], torch.device("cpu"))
    vg = hmc.value_and_grad(logp, free)
    g = torch.Generator().manual_seed(seed)
    V = v0[None, :] + 0.1 * torch.randn((chains, v0.shape[0]), generator=g, dtype=v0.dtype) * free[None, :]
    vg(V)  # first call: any one-time set-up

    ops, views, where = collections.Counter(), 0, collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal views
            name = func.__name__.split(".")[0]
            if name in VIEWS:
                views += 1
            else:
                ops[name] += 1
                frames = [f for f in traceback.extract_stack() if "gogp_torch" in f.filename]
                where[f"{frames[-1].filename.rsplit('gogp_torch', 1)[-1].lstrip('/')}:{frames[-1].lineno}"
                      if frames else "?"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        vg(V)
    return {"study": study_name, "chains": chains, "ops": sum(ops.values()), "views": views,
            "by_op": dict(ops.most_common()), "by_line": dict(where.most_common())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("study")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--top", type=int, default=20, help="source lines to list")
    args = ap.parse_args(argv)
    out = count_ops(args.study, args.chains)
    out["by_line"] = dict(list(out["by_line"].items())[: args.top])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
