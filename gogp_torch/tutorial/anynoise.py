"""Case study: non-Gaussian (Laplace) observation noise via latent outputs.

PyTorch-package twin of ``gogp_tpu/tutorial/anynoise.py`` (reference
tutorial/anynoise): the noise kernel contributes only a 1e-5 jitter but
allocates one theta slot that the priors consume as the Laplace scale; the
latent outputs are parameters (OPTINP), tied to the observed outputs by
Expon.Logp(1/exp(s), |y_obs - y_latent|); inputs are pinned, outputs free.

The observed outputs are closed over from the (normalized) data.  The
priors index ``v[..., k]``, so they take one vector or a batch of them.

Run:  python -m gogp_torch.tutorial.anynoise [flags] selfcheck
"""

from __future__ import annotations

from importlib import resources

import numpy as np
import torch

from gogp_torch import dists
from gogp_torch.gp.core import GP
from gogp_torch.kernels import jitter_only_noise, matern52_ref
from gogp_torch.tutorial.evaluate import Study, run_cli


def make_priors(x0, y0):
    n = y0.shape[0]
    y_obs = np.asarray(y0, dtype=np.float64)  # memoized observed outputs (normalized)

    def priors(v, mask):
        # v = [log c, log l, log s, x_0..x_{n-1}, y_0..y_{n-1}]
        ll = dists.normal_logp(-1.0, 1.0, v[..., 0])  # output scale mostly < 1
        ll = ll + dists.normal_logp(0.0, 2.0, v[..., 1])  # length scale around 1
        ll = ll + dists.normal_logp(-1.0, 2.0, v[..., 2])  # noise std below 1
        y_lat = v[..., 3 + n :]
        lam = 1.0 / torch.exp(v[..., 2:3])
        r = torch.as_tensor(y_obs, dtype=v.dtype, device=v.device) - y_lat
        # |r| with derivative +1 at r = 0, as jnp.abs has (torch.abs: 0): the
        # latent outputs start at the observed ones, where r is exactly 0
        residual = torch.where(r >= 0, r, -r)
        return ll + (dists.expon_logp(lam, residual) * mask).sum(-1)

    return priors


def free_fn(n_theta: int, n: int, end: int) -> np.ndarray:
    """Pin all inputs, keep outputs free (anynoise/main.go:33-44)."""
    free = np.ones(n_theta + 2 * n)
    free[n_theta : n_theta + n] = 0.0
    return free


def make_study() -> Study:
    return Study(
        name="anynoise",
        gp=GP(ndim=1, simil=matern52_ref.scaled(), noise=jitter_only_noise(1e-5)),
        optinp=True,
        make_priors=make_priors,
        free_fn=free_fn,
    )


def selfcheck_data() -> str:
    return resources.files("gogp_torch.tutorial").joinpath("data/sine.csv").read_text()


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "GP with non-Gaussian (Laplace) observation noise via latent outputs.",
        argv=argv,
    )


if __name__ == "__main__":
    main()
