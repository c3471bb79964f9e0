"""The port's utilities against the JAX package's: packed datasets, the
minibatch stream (native and Python), the native CSV parser, checkpoints
and the profiling helpers.

The stream draws its rows with the twin's xorshift64* generator, so the
port's stream (native or Python) equals the twin's Python stream bit for
bit.  The native helpers build at first use with g++ into the checkout's
``build/`` directory; where no compiler is present the native cases skip.
"""

import io

import numpy as np
import pytest
import torch

from gogp_tpu.tutorial import io as jio
from gogp_tpu.utils import dataio as jdataio
from gogp_torch import GP, rbf, uniform_noise, utils
from gogp_torch.gp import core, serve
from gogp_torch.infer import hmc
from gogp_torch.tutorial import hyperpriors
from gogp_torch.tutorial import io as tio
from gogp_torch.utils import dataio, native

needs_compiler = pytest.mark.skipif(not native.available(), reason="no C++ compiler to build the native helpers")


def _data(n=64, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5, size=(n, d))
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)


def _packed(tmp_path, n=64, d=2, seed=0):
    x, y = _data(n, d, seed)
    path = tmp_path / "data.ggpd"
    dataio.pack_dataset(path, x, y)
    return path, x, y


# -- packed datasets ---------------------------------------------------------------


def test_packed_files_are_the_twins_bytes(tmp_path):
    x, y = _data(seed=1)
    dataio.pack_dataset(tmp_path / "port.ggpd", x, y)
    jdataio.pack_dataset(tmp_path / "jax.ggpd", x, y)
    assert (tmp_path / "port.ggpd").read_bytes() == (tmp_path / "jax.ggpd").read_bytes()
    assert dataio.read_header(tmp_path / "port.ggpd") == jdataio.read_header(tmp_path / "jax.ggpd") == (64, 3)
    for got, want in zip(dataio.load_dataset(tmp_path / "jax.ggpd"), jdataio.load_dataset(tmp_path / "port.ggpd")):
        np.testing.assert_array_equal(got, want)


def test_packed_format_errors(tmp_path):
    with pytest.raises(ValueError, match="rows"):
        dataio.pack_dataset(tmp_path / "b.ggpd", np.zeros((3, 1)), np.zeros(4))
    (tmp_path / "bad.ggpd").write_bytes(b"XXXX" + b"\0" * 28)
    with pytest.raises(ValueError, match="not a gogp packed dataset"):
        dataio.read_header(tmp_path / "bad.ggpd")


# -- the minibatch stream -----------------------------------------------------------


@pytest.mark.parametrize("native_loader", [False, pytest.param(True, marks=needs_compiler)], ids=["python", "native"])
@pytest.mark.parametrize("seed", [0, 7])
def test_stream_equals_the_twins_bit_for_bit(tmp_path, native_loader, seed):
    """Twenty batches of 16 from the port's stream (native or Python) equal
    the twin's Python stream (``native=False``) bit for bit; seed 0 takes the
    generator's default state."""
    path, _, _ = _packed(tmp_path, n=97, d=3, seed=2)
    with dataio.MinibatchStream(path, batch=16, seed=seed, native=native_loader) as got, \
            jdataio.MinibatchStream(path, batch=16, seed=seed, native=False) as want:
        assert (got._handle is not None) == native_loader
        for _ in range(20):
            (gx, gy), (wx, wy) = next(got), next(want)
            assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
            assert gx.shape == (16, 3) and gy.shape == (16,)


@needs_compiler
def test_stream_picks_the_native_loader_by_default(tmp_path):
    path, x, y = _packed(tmp_path)
    with dataio.MinibatchStream(path, batch=8, seed=3) as st:
        assert st._handle is not None and st.ndim == 2
        bx, by = next(st)
    rows = np.concatenate([x, y[:, None]], axis=1)
    assert all(any((r == rows).all(1)) for r in np.concatenate([bx, by[:, None]], axis=1))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A build that is attempted and fails raises: no quiet fallback."""
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_compiler", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="building the native helpers failed"):
        native.build()


# -- the native CSV parser ---------------------------------------------------------


@needs_compiler
def test_parse_csv_matches_python_and_reference_semantics():
    text = "0.1,1.5\n0.2,-2.5\n0.3,0\n"
    x, y = tio.load_csv(text)
    np.testing.assert_array_equal(native.parse_csv(text), np.c_[x, y])
    assert native.parse_csv("+1.5,2e3\n-1,.5\n").tolist() == [[1.5, 2000.0], [-1.0, 0.5]]
    assert native.parse_csv("").shape[0] == 0
    for bad in ("1,2\n3\n", "1,abc\n"):
        with pytest.raises(ValueError):
            native.parse_csv(bad)


@pytest.mark.parametrize("compiler", [True, False], ids=["native", "python"])
def test_load_csv_matches_the_twins(compiler, monkeypatch):
    """``tutorial.io.load_csv`` (the native parser where a compiler is
    present, Python otherwise) against the twin's on a study's data, an
    empty text and text the native parser rejects ("nan")."""
    if compiler and not native.available():
        pytest.skip("no C++ compiler")
    if not compiler:
        monkeypatch.setattr(native, "available", lambda: False)
    for text in (hyperpriors.selfcheck_data(), "", "1,nan\n2,3\n"):
        for got, want in zip(tio.load_csv(text), jio.load_csv(text)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tio.load_csv("1,abc\n")


# -- checkpoints -------------------------------------------------------------------


def _serving(n=48):
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x = torch.linspace(0, 5, n, dtype=torch.float64)[:, None]
    return gp, serve.fit_serving(gp, torch.tensor([1.0, 0.8]), torch.tensor([0.1]), x, torch.sin(x[:, 0]))


def test_serving_posterior_round_trip_serves_the_same_answers(tmp_path):
    gp, sp = _serving()
    z = torch.linspace(-1, 6, 17, dtype=torch.float64)
    utils.save(tmp_path / "sp.pt", sp)
    back = utils.restore(tmp_path / "sp.pt", like=sp)
    assert type(back) is serve.ServingPosterior
    for got, want in zip(serve.serve_predict(gp, back, z), serve.serve_predict(gp, sp, z)):
        assert torch.equal(got, want)
    plain = utils.restore(tmp_path / "sp.pt")
    assert type(plain) is serve.ServingPosterior and all(torch.equal(a, b) for a, b in zip(plain, sp))


def test_sampler_state_and_posterior_round_trip(tmp_path):
    """A nested NamedTuple (HMCState with its dual-averaging state) and a
    Posterior; ``like`` casts onto its dtypes; ``force=False`` refuses to
    overwrite."""
    state = hmc.init_state(lambda v: -0.5 * (v * v).sum(-1), torch.zeros(4, 3, dtype=torch.float64),
                           torch.Generator().manual_seed(0))
    utils.save(tmp_path / "state.pt", state)
    back = utils.restore(tmp_path / "state.pt")
    assert type(back) is hmc.HMCState and type(back.da) is type(state.da)
    for a, b in zip(torch.utils._pytree.tree_leaves(back), torch.utils._pytree.tree_leaves(state)):
        if isinstance(a, torch.Generator):  # the same stream from here on
            assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
        else:
            assert torch.equal(a, b)
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    post = core.absorb(gp, torch.tensor([1.0, 0.8]), torch.tensor([0.1]), torch.linspace(0, 5, 9)[:, None],
                       torch.linspace(0, 1, 9))
    utils.save(tmp_path / "post.pt", post)
    like = post._replace(alpha=post.alpha.double())
    assert utils.restore(tmp_path / "post.pt", like=like).alpha.dtype == torch.float64
    with pytest.raises(FileExistsError):
        utils.save(tmp_path / "post.pt", post, force=False)


def test_restore_refuses_other_packages_types(tmp_path):
    torch.save({"__namedtuple__": "os:stat_result", "x": torch.ones(1)}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="not one of gogp_torch's"):
        utils.restore(tmp_path / "x.pt")


# -- profiling ---------------------------------------------------------------------


def test_phase_timer_and_timed_on_the_cpu(tmp_path):
    timer = utils.PhaseTimer()
    for _ in range(3):
        with timer.phase("solve", sync=torch.ones(1)):
            torch.linalg.cholesky(torch.eye(64) * 2.0)
    assert timer.counts["solve"] == 3 and timer.totals["solve"] > 0
    assert timer.report().startswith("solve: ") and "(3 calls" in timer.report()
    assert utils.timed(lambda a: a @ a, torch.eye(32), reps=5) >= 0.0
    with utils.device_trace(str(tmp_path)) as prof:
        torch.eye(8) @ torch.eye(8)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert any(tmp_path.iterdir())


def test_forecast_csv_of_a_stream_reads_back(tmp_path):
    """The loader's rows written as CSV load through ``tutorial.io`` as the
    twin's do."""
    path, x, y = _packed(tmp_path, d=1)
    bx, by = next(iter(dataio.MinibatchStream(path, batch=8, seed=5, native=False)))
    buf = io.StringIO()
    tio.write_forecast_rows(buf, np.c_[bx, by])
    for got, want in zip(tio.load_csv(buf.getvalue()), jio.load_csv(buf.getvalue())):
        np.testing.assert_array_equal(got, want)
