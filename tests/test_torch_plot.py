"""Forecast plotting (the reference's forecast.gp counterpart): the port's
``tutorial.plot`` against the JAX package's, and on a forecast CSV that the
port's ``evaluate`` writes."""

import io

import numpy as np
import pytest

from gogp_tpu.tutorial import plot as jplot
from gogp_torch.tutorial import barebones, plot


def _csv():
    rows = []
    for i in range(12):
        x = i * 0.5
        rows.append(f"{x},{np.sin(x):.4f},{np.sin(x) * 0.9:.4f},{0.2:.4f},0,0,1")
    return "\n".join(rows)


def test_load_forecast():
    x, y, mu, sigma = plot.load_forecast(io.StringIO(_csv()))
    assert x.shape == (12, 1)
    assert np.all(sigma == 0.2)
    for got, want in zip((x, y, mu, sigma), jplot.load_forecast(io.StringIO(_csv()))):
        np.testing.assert_array_equal(got, want)


def test_plot_forecast_writes_png(tmp_path):
    out = tmp_path / "fc.png"
    path = plot.plot_forecast(io.StringIO(_csv()), str(out), title="barebones")
    assert out.exists() and out.stat().st_size > 1000
    assert path == str(out)


def test_forecast_of_the_ports_evaluate_loads_in_both(tmp_path, capsys):
    """A forecast CSV from the port's barebones command line (Adam, 20
    steps, on the CPU) loads with both ``load_forecast``s, row for row, and
    plots; its "nan" fields (the first row's lml0) stay NaN."""
    barebones.main(["--platform", "cpu", "-a", "adam", "--iters", "20", "selfcheck"])
    text = capsys.readouterr().out
    (tmp_path / "fc.csv").write_text(text)
    got = plot.load_forecast(str(tmp_path / "fc.csv"))
    want = jplot.load_forecast(str(tmp_path / "fc.csv"))
    rows = [line.split(",") for line in text.strip().splitlines()]
    assert got[0].shape == (len(rows), 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2], [float(r[2]) for r in rows])
    assert np.isfinite(got[3]).all() and (got[3] >= 0).all()
    assert plot.plot_forecast(str(tmp_path / "fc.csv"), str(tmp_path / "fc.png")) == str(tmp_path / "fc.png")


def test_main(tmp_path, capsys):
    (tmp_path / "fc.csv").write_text(_csv())
    plot.main([str(tmp_path / "fc.csv"), str(tmp_path / "out.png")])
    assert capsys.readouterr().out.strip() == str(tmp_path / "out.png")
    assert (tmp_path / "out.png").stat().st_size > 1000
    with pytest.raises(SystemExit, match="usage"):
        plot.main([])
