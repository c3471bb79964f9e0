"""Parity of the port's classify study (gogp_torch.tutorial.classify) with
gogp_tpu.tutorial.classify, on its embedded data (n = 40), and the
selfcheck runner's sixth study.

Both packages start every prefix from the same numpy jitter (seed 0) and
fit it in one batch.  Rows: x and y exactly, lml0 and lml to rtol 1e-9, the
thetas to rtol 1e-8 and p_hat to rtol 1e-7.  p_hat reads the Newton iterate
at which psi's tolerance stops, which that tolerance fixes only to about
1e-8: JAX's own vmapped batch and its single-row fit of prefix 19 part by
3.4e-8 there, picking different steps of the grid among trial objectives
that tie to rounding (the port matches the single-row fit to 1e-15).
The ESS engine runs on JAX's draws (``JaxESSDraws``) at a short chain; its
p_hat is held to rtol 1e-6, as ``ess_predict`` solves K^-1 K* with the
jitter-only prior covariance, of condition number 1.0e11 to 1.9e11 on these
prefixes, where LAPACK's solves and XLA's part by about that times the f64
epsilon.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_elliptical import JaxESSDraws, chain_keys, one_torch_thread  # noqa: F401 (an autouse fixture)

from gogp_tpu.gp import likelihoods as jlik
from gogp_tpu.tutorial import classify as jclassify
from gogp_torch.gp import likelihoods
from gogp_torch.tutorial import classify, selfcheck
from gogp_torch.tutorial import io as tio


def _data():
    return tio.load_csv(classify.selfcheck_data())


def assert_rows_match(got, want, p_rtol=1e-7):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape == (40, 7)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[:, 5:], want[:, 5:], rtol=1e-8)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=p_rtol)


def test_data_is_the_jax_packages():
    assert classify.selfcheck_data() == jclassify.selfcheck_data()


@pytest.mark.parametrize("engine,link,iters", [("laplace", "bernoulli_logit", 10), ("laplace", "bernoulli_probit", 5),
                                               ("ep", "bernoulli_logit", 5)])
def test_rows_match_jax(engine, link, iters):
    x, y = _data()
    want = jclassify.evaluate_classify(jclassify.make_gp(), getattr(jlik, link), x, y, engine=engine, iters=iters)
    got = classify.evaluate_classify(classify.make_gp(), getattr(likelihoods, link), x, y, engine=engine, iters=iters,
                                     device="cpu")
    assert_rows_match(got, want)
    # the prefixes at or below MINOPT are not fitted: lml0 == lml there
    rows = np.asarray(got)
    np.testing.assert_array_equal(rows[: classify.MINOPT + 1, 3], rows[: classify.MINOPT + 1, 4])
    assert (rows[classify.MINOPT + 1 :, 4] > rows[classify.MINOPT + 1 :, 3]).all()


def test_ess_rows_on_jax_draws():
    x, y = _data()
    n, chains, warm, samp = x.shape[0], 2, 6, 6
    want = jclassify.evaluate_classify(jclassify.make_gp(), jlik.bernoulli_logit, x, y, engine="ess", iters=3,
                                       ess_chains=chains, ess_warmup=warm, ess_samples=samp)
    key0 = jax.random.PRNGKey(0)
    keys = jnp.stack([chain_keys(jax.random.fold_in(key0, row), chains) for row in range(n)])
    got = classify.evaluate_classify(classify.make_gp(), likelihoods.bernoulli_logit, x, y, engine="ess", iters=3,
                                     ess_chains=chains, ess_warmup=warm, ess_samples=samp,
                                     ess_draws=JaxESSDraws.for_chains(keys, warm + samp), device="cpu")
    assert_rows_match(got, want, p_rtol=1e-6)


def test_main_prints_jax_schema():
    out = io.StringIO()
    rows = classify.main(["-e", "ep", "--seed", "0", "--iters", "2", "--platform", "cpu", "selfcheck"], wtr=out)
    lines = out.getvalue().splitlines()
    assert len(lines) == len(rows) == 40
    assert all(len(line.split(",")) == 7 for line in lines)
    assert lines[0] == ",".join(f"{v:f}" for v in rows[0])
    with pytest.raises(SystemExit):
        classify.main(["-e", "nuts", "selfcheck"])


def test_selfcheck_classify_study(capsys):
    """The selfcheck runner's sixth study: 40 classification rows after a
    ``# classify`` line (the runner's other five are the evaluate tests')."""
    assert [name for name, _ in selfcheck.RUNS] + ["classify"] == [
        "barebones", "hyperpriors", "warpedtime", "anynoise", "events", "classify"]
    selfcheck.check_classify(["-a", "adam", "--platform", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# classify" and len(out) == 41
