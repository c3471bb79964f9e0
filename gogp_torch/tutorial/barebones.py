"""Case study: bare-bones time-series forecasting (MLE only).

PyTorch-package twin of ``gogp_tpu/tutorial/barebones.py`` (reference
tutorial/barebones): a 2-theta scaled-Matérn32 similarity kernel with
uniform noise scaled by 0.01, the GP used directly as the optimization model
(no priors).

Run:  python -m gogp_torch.tutorial.barebones [flags] selfcheck
      (add --platform cpu where there is no CUDA card)
"""

from __future__ import annotations

from importlib import resources

from gogp_torch.gp.core import GP
from gogp_torch.kernels import matern32, uniform_noise
from gogp_torch.tutorial.evaluate import Study, run_cli


def make_study() -> Study:
    return Study(
        name="barebones",
        gp=GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01)),
    )


def selfcheck_data() -> str:
    return resources.files("gogp_torch.tutorial").joinpath("data/sine.csv").read_text()


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "Bare-bones time series forecasting with gogp_torch (scaled Matern32 + uniform noise).",
        argv=argv,
    )


if __name__ == "__main__":
    main()
