"""Forecast plotting: the counterpart of the reference's gnuplot script
(tutorial/forecast.gp), PyTorch-package twin of ``gogp_tpu/tutorial/plot.py``.
Posterior mean with +-1 sigma and +-1.96 sigma bands over the observed
series, from the forecast CSV the Evaluate driver prints (columns: x..., y,
mu, sigma, lml0, lml, theta...).  numpy, and matplotlib only inside
:func:`plot_forecast`.

Usage:
    python -m gogp_torch.tutorial.barebones --platform cpu selfcheck > fc.csv
    python -m gogp_torch.tutorial.plot fc.csv forecast.png
"""

from __future__ import annotations

import sys

import numpy as np


def load_forecast(path_or_file, ndim: int = 1):
    """(x (n, ndim), y, mu, sigma) of a forecast CSV."""
    rows = np.genfromtxt(path_or_file, delimiter=",")
    rows = np.atleast_2d(rows)
    x = rows[:, :ndim]
    y, mu, sigma = rows[:, ndim], rows[:, ndim + 1], rows[:, ndim + 2]
    return x, y, mu, sigma


def plot_forecast(path_or_file, out_path: str, ndim: int = 1, title: str = ""):
    """Write the forecast's plot to ``out_path`` (PNG); returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y, mu, sigma = load_forecast(path_or_file, ndim)
    xs = x[:, 0]
    order = np.argsort(xs)
    xs, y, mu, sigma = xs[order], y[order], mu[order], sigma[order]

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.fill_between(xs, mu - 1.96 * sigma, mu + 1.96 * sigma, alpha=0.15, label="95% band")
    ax.fill_between(xs, mu - sigma, mu + sigma, alpha=0.25, label="+-1 sigma")
    ax.plot(xs, mu, lw=1.5, label="posterior mean")
    obs = np.isfinite(y)
    ax.plot(xs[obs], y[obs], "o", ms=4, alpha=0.8, label="observed")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if title:
        ax.set_title(title)
    ax.legend(loc="best", frameon=False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or len(argv) > 2:
        raise SystemExit("usage: python -m gogp_torch.tutorial.plot <forecast.csv> [out.png]")
    src = argv[0]
    out = argv[1] if len(argv) > 1 else "forecast.png"
    plot_forecast(sys.stdin if src == "-" else src, out)
    print(out)


if __name__ == "__main__":
    main()
