"""Device times of the factorizations that form L's block columns against
a diagonal tile, one JSON line a run: K1 at n = 1024, 1536 and 4096 beside
``cholesky_ex``, the stepwise driver at n = 16384 beside cuSOLVER's
factor, and at n = 16384 on an NCCL group of one rank the row-sharded
Cholesky and the row-sharded value and gradient (``chip_smoke.rows_case``'s
calls; the first of each includes the group's and the kernels' set-up).
Each factor is also held against the plain f32 one (column-relative, as
``chip_smoke.col_rel_err``).  ``--profile`` adds one stepwise and one
row-sharded factorization under torch.profiler (``chip_smoke.profile_once``:
device busy time, idle share, the kernels with the most device time) and
the panel's solve at three block columns in four forms, event-timed.

``--tree DIR`` takes the package, its kernels and ``chip_smoke``'s helpers
from the checkout at DIR (an unpacked ``git archive`` of another commit,
say), so that two versions run in turns in one process tree on one card:

    for t in base . . base; do python3 tests/panel_times.py --tree $t || exit 1; done

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def panel_forms(K, block: int) -> dict:
    """Device ms of one panel, rows c1: of block column k against its
    diagonal tile, at k = 0, nb / 2 and nb - 2, in four forms: the solve as
    the code forms it, the same on a contiguous copy of the panel, the
    left-sided solve on the panel's transpose, and the former product with
    inv(L_kk)^T."""
    import torch

    import chip_smoke as cs

    n, out = K.shape[-1], {}
    for k in (0, n // block // 2, n // block - 2):
        c0, c1 = k * block, (k + 1) * block
        Lkk = torch.linalg.cholesky(K[c0:c1, c0:c1])
        V = torch.linalg.solve_triangular(Lkk, torch.eye(block, device=K.device), upper=False)
        C = K[c1:, c0:c1]
        forms = {"solve_right": lambda: torch.linalg.solve_triangular(Lkk.mT, C, upper=True, left=False),
                 "solve_right_contiguous": lambda: torch.linalg.solve_triangular(Lkk.mT, C.contiguous(), upper=True,
                                                                                 left=False),
                 "solve_left_transposed": lambda: torch.linalg.solve_triangular(Lkk, C.mT, upper=False).mT,
                 "inverse_product": lambda: C @ V.mT}
        out[k] = {"rows": n - c1, **{name: cs.event_ms(fn, 20) for name, fn in forms.items()}}
    return out


def measure(dev, reps: int = 3, profile: bool = False) -> dict:
    """The times and errors above on ``dev``, from the package and the
    ``chip_smoke`` on ``sys.path``."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from gogp_torch.gp import core
    from gogp_torch.ops import cholesky_blocked as cb
    from gogp_torch.ops import distributed as dops
    from gogp_torch.parallel import large_n
    from gogp_torch.parallel import mesh as pmesh

    out = {"k1": {}}
    gp, x, _, _, ts, tn, _ = cs.problem(torch.float32, dev)
    for n in (1024, 1536, 4096):
        K = core.masked_cov(gp, ts, tn, x, None) if n == cs.N else cs.train_cov(n, dev)
        L = cb.fused_cholesky_invs(K)[0]
        out["k1"][n] = {"ms": cs.event_ms(lambda: cb.fused_cholesky_invs(K), 20),
                        "cholesky_ex_ms": cs.event_ms(lambda: torch.linalg.cholesky_ex(K), 20),
                        "col_rel_err_vs_plain": cs.col_rel_err(L, cb.plain_cholesky(K))}

    n = cs.N_LARGE
    K = cs.large_cov(n, dev)
    L = cb.blocked_cholesky_invs(K, cs.BLOCK)[0]
    out["stepwise"] = {"n": n, "ms": cs.event_ms(lambda: cb.blocked_cholesky_invs(K, cs.BLOCK), reps, warmup=1),
                       "cusolver_ms": cs.event_ms(lambda: cb.plain_cholesky(K), reps, warmup=1),
                       "col_rel_err_vs_plain": cs.col_rel_err(L, cb.plain_cholesky(K))}
    if profile:
        out["stepwise"]["profile"] = cs.profile_once(lambda: cb.blocked_cholesky_invs(K, cs.BLOCK))
        out["panel_forms"] = panel_forms(K, cs.BLOCK)
    del K, L

    data = pmesh.DATA_AXIS
    pmesh.init_multihost(f"127.0.0.1:{cs._free_port()}", 1, 0, backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = pmesh.make_mesh(1, 1)
        gp, x, y, v0, _ = cs.large_problem(n, torch.float32, dev)
        theta = torch.exp(v0)
        K = core.masked_cov(gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil:], x, None)
        with mesh:
            chol = [cs._timed(dev, lambda: dops.cholesky_rowsharded(K, data, cs.PAR_BLOCK))
                    for _ in range(1 + reps)]
        vg = large_n.make_rowsharded_value_and_grad(
            large_n.make_rowsharded_logp(gp, x, x, y, torch.ones_like(y), data, cs.PAR_BLOCK), data)
        with mesh:
            vg_ms = [cs._timed(dev, lambda: vg(v0))[1] for _ in range(1 + reps)]
            prof = cs.profile_once(lambda: dops.cholesky_rowsharded(K, data, cs.PAR_BLOCK)) if profile else None
        out["rowsharded"] = {"n": n, "block": cs.PAR_BLOCK, "cholesky_ms": [t for _, t in chol],
                             "value_and_grad_ms": vg_ms,
                             "col_rel_err_vs_plain": cs.col_rel_err(chol[-1][0], cb.plain_cholesky(K)),
                             **({"profile": prof} if profile else {})}
    finally:
        dist.destroy_process_group()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                        help="the checkout whose package and kernels run (default: this one)")
    parser.add_argument("--reps", type=int, default=3, help="timed calls at n = 16384")
    parser.add_argument("--profile", action="store_true", help="also profile both factorizations and time "
                                                               "the panel's forms")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import chip_smoke as cs

    info = cs.phase_device()  # exits without a card
    cs.phase_build()
    out = measure(torch.device("cuda", 0), args.reps, args.profile)
    print(json.dumps({"tree": str(tree), "card": info["nvidia_smi"], **out}), flush=True)


if __name__ == "__main__":
    main()
