"""Case study: warped (latent) time, the inputs inferred with the thetas.

PyTorch-package twin of ``gogp_tpu/tutorial/warpedtime.py`` (reference
tutorial/warpedtime): OPTINP puts the inputs and outputs into the parameter
vector; the priors put N(1, sigma) on the relative input steps against the
initial steps, closed over from the data; the first and last (real) input
and all outputs are pinned.  The priors index ``v[..., k]`` and read the
mask, so they take one vector or a batch with a mask a row.

Run:  python -m gogp_torch.tutorial.warpedtime [flags] selfcheck
Flags: --logsigma (log std of relative step, default log 0.5),
       --show-warp (re-emit rows at the warped inputs).
"""

from __future__ import annotations

import math
import sys
from importlib import resources

import numpy as np
import torch

from gogp_torch import dists
from gogp_torch.gp.core import GP, predict_from_posterior
from gogp_torch.kernels import matern52_ref, uniform_noise
from gogp_torch.tutorial import io as tio
from gogp_torch.tutorial.evaluate import Study, last_posterior, run_cli


def make_priors(x0, y0, logsigma=math.log(0.5)):
    n = x0.shape[0]
    step0 = np.asarray(x0[1:, 0] - x0[:-1, 0], dtype=np.float64)  # the initial steps
    sigma = math.exp(logsigma)

    def priors(v, mask):
        # v = [log c, log l, log s, x_0..x_{n-1}, y_0..y_{n-1}]
        ll = dists.normal_logp(-1.0, 1.0, v[..., 0])  # output scale mostly < 1
        ll = ll + dists.normal_logp(0.0, 2.0, v[..., 1])  # length scale around 1
        ll = ll + dists.normal_logp(0.5, 1.0, v[..., 2])  # noise (x0.01 scale)
        xs = v[..., 3 : 3 + n]
        ratio = (xs[..., 1:] - xs[..., :-1]) / torch.as_tensor(step0, dtype=v.dtype, device=v.device)
        # step term i involves x_i and x_{i+1}: active iff x_{i+1} is real
        return ll + (dists.normal_logp(1.0, sigma, ratio) * mask[..., 1:]).sum(-1)

    return priors


def free_fn(n_theta: int, n: int, end: int) -> np.ndarray:
    """Pin the first and last (real) input and all outputs
    (warpedtime/main.go:44-56)."""
    free = np.ones(n_theta + 2 * n)
    free[n_theta + n :] = 0.0  # all outputs
    if end > 0:
        free[n_theta] = 0.0  # first input
        free[n_theta + end - 1] = 0.0  # last real input
    return free


def make_study(logsigma=math.log(0.5)) -> Study:
    return Study(
        name="warpedtime",
        gp=GP(ndim=1, simil=matern52_ref.scaled(), noise=uniform_noise.scaled_by(0.01)),
        optinp=True,
        make_priors=lambda x0, y0: make_priors(x0, y0, logsigma),
        free_fn=free_fn,
    )


def selfcheck_data() -> str:
    return resources.files("gogp_torch.tutorial").joinpath("data/regimes.csv").read_text()


def _extra_flags(ap):
    # single-dash aliases: the reference's Go-style flags
    ap.add_argument("--logsigma", "-logsigma", type=float, default=math.log(0.5),
                    help="log standard deviation of relative step")
    ap.add_argument("--show-warp", "-show-warp", action="store_true", help="show warped inputs")


def main(argv=None):
    import io as _io

    # --show-warp buffers the rows and re-emits them at the warped inputs
    # (reference warpedtime/main.go:90-116): the warped x, the (normalized)
    # stored y, and mu/sigma at the warped inputs from the final fit; the
    # trailing columns are kept; the last line is left as it is (its input
    # is pinned).
    raw_args = sys.argv[1:] if argv is None else argv
    show_warp = "--show-warp" in raw_args or "-show-warp" in raw_args
    buffered = _io.StringIO() if show_warp else None

    args, cfg, study, result = run_cli(
        lambda a: make_study(logsigma=a.logsigma),
        selfcheck_data(),
        "GP with warped (latent) time inputs.",
        extra_flags=_extra_flags,
        argv=argv,
        wtr=buffered,
    )
    if not args.show_warp:
        return args, cfg, study, result

    n_theta, n = study.gp.n_theta, result.x.shape[0]
    v_last = result.v_all[-1]
    x_warp, y_lat = v_last[n_theta : n_theta + n], v_last[n_theta + n :]
    post = last_posterior(study, result)
    with torch.no_grad():
        mu, sigma = predict_from_posterior(
            study.gp, post, torch.as_tensor(x_warp[:, None], dtype=result.dtype, device=result.device))
    mu, sigma = mu.cpu().double().numpy(), sigma.cpu().double().numpy()

    patched = []
    for i, row in enumerate(result.rows):
        if i < n - 1:
            patched.append([x_warp[i], y_lat[i], mu[i], sigma[i]] + row[4:])
        else:
            patched.append(row)
    tio.write_forecast_rows(sys.stdout, patched)
    return args, cfg, study, result


if __name__ == "__main__":
    main()
