"""The CPU errors behind ``chip_smoke.py``'s bounds of the large_n_bayes_exact
phase (benchmarks/large_n_bayes.py's exact leg: 8 chains at n = 1024).

Runs the port on the CPU at the phase's full size: the MLE warm start (Adam
300 at 0.05 on the plain route, f32), the phase's 8 positions around it
(``chip_smoke.lnbx_positions``: numpy's draws, the same on either device),
then in f32 against f64 on the plain route

- one batched value and gradient of the vmapped log-joint on the blocked
  route (``force_blocked(128)``: the card's route with the tile kernels'
  plain versions), at "float32" and at "tensorfloat32" with TF32 emulated:
  every matmul input the blocked drivers see inside a TF32 setting cut to
  TF32's 10-bit mantissa.  The cut truncates: rounding to nearest gave a
  gradient error 7.6 times smaller than the H100's at the same positions,
  truncating 1.4 times smaller (PERF.md);
- the tile kernels' algorithms against their plain versions in f32 at the
  phase's shapes: K4's (the diagonal tiles applied through their inverses)
  both ways, K5's (tile inverses by another algorithm) and K2's (factor and
  inverse of the (8, 128, 128) diagonal tiles);
- the predictive mixture of the 8 positions at 256 points.

Prints one JSON object; the phase's bounds are 10x these.  About 1 min.

    python tests/batched_bounds.py
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from gogp_torch import GP, dists, mle, rbf, uniform_noise  # noqa: E402
from gogp_torch.gp import core  # noqa: E402
from gogp_torch.infer import hmc  # noqa: E402
from gogp_torch.models.params import gp_observe  # noqa: E402
from gogp_torch.ops import cholesky_blocked as cb  # noqa: E402
from gogp_torch.ops import linalg  # noqa: E402

N, CHAINS, BLOCK = 1024, 8, 128


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 cut to TF32: the low 13 of its 23 mantissa bits cleared."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32).view(t.shape)


class TF32Inputs(TorchFunctionMode):
    """Matmuls see TF32 inputs while ``allow_tf32`` is set."""

    PRODUCTS = {torch.mm, torch.matmul, torch.bmm, torch.Tensor.__matmul__, torch.Tensor.mm, torch.Tensor.bmm}
    ADDS = {torch.addmm, torch.baddbmm, torch.Tensor.addmm_, torch.Tensor.baddbmm_}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.backends.cuda.matmul.allow_tf32:
            if func in self.PRODUCTS:
                args = (tf32(args[0]), tf32(args[1]), *args[2:])
            elif func in self.ADDS:
                args = (args[0], tf32(args[1]), tf32(args[2]), *args[3:])
        return func(*args, **kwargs)


@contextlib.contextmanager
def emulated_tf32(tf32_on: bool):
    """``cb._matmul_tf32`` that also cuts the matmuls' inputs inside: the
    blocked drivers enter it in forward and backward (a backward runs
    outside any mode entered around the call)."""
    with real_matmul_tf32(tf32_on), (TF32Inputs() if tf32_on else contextlib.nullcontext()):
        yield


real_matmul_tf32 = cb._matmul_tf32


def problem(dtype):
    """benchmarks/large_n_bayes.py's build_problem (:45-63): x in f32, y from
    the f32 x."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 100, (N, 1)), axis=0).astype(np.float32)
    y = (np.sin(x[:, 0].astype(np.float64) / 3.0) + 0.1 * rng.normal(size=N)).astype(np.float32)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    return gp, torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)


def logjoint(gp, x, y, precision=None):
    def one(v):
        return gp_observe(gp, v, x=x, y=y, precision=precision) + dists.normal_logp(0.0, 1.0, v).sum()

    return torch.func.vmap(one)


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def main() -> None:
    torch.set_num_threads(4)
    gp, x, y = problem(torch.float32)
    _, x64, y64 = problem(torch.float64)
    with linalg.force_plain():
        vg1 = hmc.value_and_grad(logjoint(gp, x, y), None)
        opt = mle.adam(lambda v: tuple(t[0] for t in vg1(v[None])), torch.zeros(3), iters=300, rate=0.05)
    x0 = chip_smoke.lnbx_positions(opt.x)
    with linalg.force_plain():
        want_v, want_g = hmc.value_and_grad(logjoint(gp, x64, y64), None)(x0.double())
    out = {"mle": opt.x.tolist(), "positions": x0.tolist()}
    cb._matmul_tf32 = emulated_tf32
    with cb.force_blocked(BLOCK):
        for precision in ("float32", "tensorfloat32"):
            v, g = hmc.value_and_grad(logjoint(gp, x, y, precision), None)(x0)
            out[f"value_{precision}"] = float(((v.double() - want_v).abs() / want_v.abs()).max())
            out[f"grad_{precision}"] = rel(g, want_g)
    with linalg.force_plain():
        v, g = hmc.value_and_grad(logjoint(gp, x, y), None)(x0)
    cb._matmul_tf32 = real_matmul_tf32
    out["value_plain_f32"] = float(((v.double() - want_v).abs() / want_v.abs()).max())
    out["grad_plain_f32"] = rel(g, want_g)

    theta = torch.exp(x0)
    Ks = torch.stack([core.masked_cov(gp, t[:2], t[2:], x, None) for t in theta])
    L = torch.linalg.cholesky(Ks).contiguous()
    y8 = y.expand(CHAINS, N).contiguous()
    z = cb.trsv_lower_plain(L, y8)
    out["k4_forward"] = rel(cb.blocked_trsm_lower(L, y8, BLOCK), z)
    out["k4_transpose"] = rel(cb.blocked_trsm_lower_t(L, z, BLOCK), cb.trsv_lower_t_plain(L, z))
    tiles = cb._diag_tiles(L, BLOCK).contiguous()
    out["k5"] = rel(torch.linalg.inv(tiles), cb.tril_inv_tile_plain(tiles))
    tile2 = Ks[:, :BLOCK, :BLOCK].contiguous()
    L2, V2 = cb.cholesky_inv_tile_plain(tile2)
    Ls, _ = cb._stepwise_cholesky_invs(tile2, 32)
    out["k2_factor"] = rel(Ls, L2)
    out["k2_inverse"] = rel(cb.blocked_tril_inv(Ls, 32), V2)

    zz = torch.linspace(0, 100, 256)
    with cb.force_blocked(BLOCK):
        mu, sd = core.predict_mixture(gp, x0, x, y, zz)
    with linalg.force_plain():
        mu64, sd64 = core.predict_mixture(gp, x0.double(), x64, y64, zz.double())
    out["mixture_mu_abs"] = float((mu.double() - mu64).abs().max())
    out["mixture_sigma_abs"] = float((sd.double() - sd64).abs().max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
