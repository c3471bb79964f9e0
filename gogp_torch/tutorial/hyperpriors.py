"""Case study: hyperparameter priors on a composite kernel.

PyTorch-package twin of ``gogp_tpu/tutorial/hyperpriors.py`` (reference
tutorial/hyperpriors): a 5-theta similarity kernel, a Matérn-5/2 trend
(``matern52_ref``, the reference's own coefficients) plus a periodic season
with the period pre-scaled by 10, 1-theta noise scaled by 0.01, and Normal
priors on the log-scale thetas, among them "the season weight lies below the
trend weight".  The priors index ``v[..., k]``, so a (chains, p) batch gets
one log-prior per chain.

Run:  python -m gogp_torch.tutorial.hyperpriors [flags] selfcheck (the MLE
rolling forecast); ``python -m gogp_torch.tutorial.bayes hyperpriors
--engine chees selfcheck`` runs the Bayesian one.
"""

from __future__ import annotations

import math
from importlib import resources

import torch

from gogp_torch import dists
from gogp_torch.gp.core import GP
from gogp_torch.kernels import Kernel, matern52_ref, periodic, uniform_noise
from gogp_torch.tutorial.evaluate import Study, run_cli

_LOG2 = math.log(2.0)


def _simil_pair(theta, xa, xb):
    # theta = [c1 trend scale, c2 season scale, l1, l2, p] (natural scale)
    c1, c2, l1, l2, p = theta.unbind(-1)
    trend = c1 * matern52_ref.pair(torch.stack([l1]), xa, xb)
    season = c2 * periodic.pair(torch.stack([l2, 10.0 * p]), xa, xb)
    return trend + season


simil = Kernel(5, _simil_pair, "trend+season")


# The priors' scales, in the order of v: c1, c2, l1, l2, p, s.
_PRIOR_SIGMAS = (1.0, 1.0, 2.0, 2.0, 1.0, 1.0)


def make_priors(x0, y0):
    def priors(v, mask):
        # v[..., :6] are log-scale thetas: c1, c2, l1, l2, p, s, with Normal
        # priors of these means, all six in one normal_logp (a sampler pays
        # each operation once per leapfrog step)
        c1 = v[..., 0]
        zero = torch.zeros_like(c1)
        mu = torch.stack([torch.full_like(c1, -1.0),  # trend weight in (0, 1)
                          c1 - _LOG2,  # season below trend
                          zero, zero,
                          zero,  # period approx known (x10 scale)
                          zero], -1)  # noise (x0.01 scale)
        return dists.normal_logp(mu, _PRIOR_SIGMAS, v[..., :6]).sum(-1)

    return priors


def make_study() -> Study:
    return Study(
        name="hyperpriors",
        gp=GP(ndim=1, simil=simil, noise=uniform_noise.scaled_by(0.01)),
        make_priors=make_priors,
    )


def selfcheck_data() -> str:
    """The study's embedded series (44 points), the JAX package's
    ``trend_season.csv``, copied into this package."""
    return resources.files("gogp_torch.tutorial").joinpath("data/trend_season.csv").read_text()


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "GP with hyperparameter priors: Matern52 trend + periodic seasonality.",
        argv=argv,
    )


if __name__ == "__main__":
    main()
