"""Parity of the PyTorch port's kernels (gogp_torch.kernels) with
gogp_tpu.kernels, and the port's independence from JAX.

Both packages get the same numpy inputs in float64.  Tolerance: rtol 1e-12,
atol 1e-14 (f64, the same closed forms, only libm and the order of a
d-term sum differ).
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gogp_tpu import kernels as jk
from gogp_torch import kernels as tk

RTOL, ATOL = 1e-12, 1e-14
REPO = pathlib.Path(__file__).resolve().parents[1]

# (id, jax kernel, torch kernel, natural-scale theta)
SIMIL = [
    ("rbf", jk.rbf, tk.rbf, [0.7]),
    ("periodic", jk.periodic, tk.periodic, [0.9, 2.5]),
    ("matern32", jk.matern32, tk.matern32, [1.3]),
    ("matern52", jk.matern52, tk.matern52, [1.3]),
    ("matern52_ref", jk.matern52_ref, tk.matern52_ref, [1.3]),
    ("rational_quadratic", jk.rational_quadratic, tk.rational_quadratic, [0.8, 1.7]),
    ("scaled", jk.rbf.scaled(), tk.rbf.scaled(), [1.7, 0.7]),
    (
        "sum",
        jk.matern52_ref.scaled() + jk.periodic,
        tk.matern52_ref.scaled() + tk.periodic,
        [1.3, 0.9, 1.1, 2.0],
    ),
    ("product", jk.matern32 * jk.periodic, tk.matern32 * tk.periodic, [1.1, 0.9, 2.0]),
    ("ard", jk.rbf.ard(3), tk.rbf.ard(3), [0.5, 2.0, 1.5, 1.2]),
    (
        "warp",
        jk.matern52.warp_inputs(lambda x: x * x),
        tk.matern52.warp_inputs(lambda x: x * x),
        [0.9],
    ),
    ("linear", jk.linear, tk.linear, [0.4]),
    ("white", jk.white, tk.white, [0.8]),
    ("matern12", jk.matern12, tk.matern12, [1.3]),
    ("exponential", jk.exponential, tk.exponential, [0.6]),
    ("spectral_mixture-d1", jk.spectral_mixture(2), tk.spectral_mixture(2), [1.2, 0.5, 0.3, 0.1, 0.8, 0.05]),
    (
        "spectral_mixture-d3",
        jk.spectral_mixture(2, 3),
        tk.spectral_mixture(2, 3),
        [1.2, 0.5, 0.3, 0.1, 0.2, 0.4, 0.15, 0.25, 0.8, 0.05, 0.3, 0.2, 0.1, 0.6],
    ),
]
# The kernels this slice adds, held also by their theta gradients.
NEW = ("linear", "white", "matern12", "exponential", "spectral_mixture-d1", "spectral_mixture-d3")

NOISE = [
    ("uniform", jk.uniform_noise, tk.uniform_noise, [0.3]),
    ("constant", jk.constant_noise(0.2), tk.constant_noise(0.2), []),
    ("jitter_only", jk.jitter_only_noise(1e-5), tk.jitter_only_noise(1e-5), [0.7]),
    ("scaled_by", jk.uniform_noise.scaled_by(0.01), tk.uniform_noise.scaled_by(0.01), [0.3]),
]


def _inputs(ndim, seed=0):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(7, ndim))
    xb = rng.normal(size=(5, ndim))
    xb[2] = xa[4]  # one coincident pair: the zero-distance guard
    return xa, xb


def _ndims(case_id):
    if case_id.startswith("spectral_mixture"):
        return [int(case_id[-1])]
    return [3] if case_id in ("ard",) else [1, 3]


SIMIL_NDIM = [(c, d) for c in SIMIL for d in _ndims(c[0])]


@pytest.mark.parametrize(
    "case,ndim", SIMIL_NDIM, ids=[f"{c[0]}-d{d}" for c, d in SIMIL_NDIM]
)
def test_matrix_matches_jax(case, ndim):
    _, kj, kt, theta = case
    xa, xb = _inputs(ndim)
    want = np.asarray(kj.matrix(jnp.asarray(theta), xa, xb))
    got = kt.matrix(torch.tensor(theta, dtype=torch.float64), torch.as_tensor(xa), torch.as_tensor(xb))
    assert got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "case,ndim", SIMIL_NDIM, ids=[f"{c[0]}-d{d}" for c, d in SIMIL_NDIM]
)
def test_diag_matrix_matches_jax(case, ndim):
    _, kj, kt, theta = case
    xa, _ = _inputs(ndim)
    want = np.asarray(kj.diag_matrix(jnp.asarray(theta), xa))
    got = kt.diag_matrix(torch.tensor(theta, dtype=torch.float64), torch.as_tensor(xa))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", SIMIL, ids=[c[0] for c in SIMIL])
def test_single_pair_is_scalar(case):
    _, kj, kt, theta = case
    ndim = _ndims(case[0])[-1] if case[0] in ("ard",) or case[0].startswith("spectral") else 2
    xa, xb = _inputs(ndim)
    want = float(kj(jnp.asarray(theta), xa[0], xb[0]))
    got = kt(torch.tensor(theta, dtype=torch.float64), torch.as_tensor(xa[0]), torch.as_tensor(xb[0]))
    assert got.dim() == 0
    assert abs(float(got) - want) <= ATOL + RTOL * abs(want)


NEW_NDIM = [(c, d) for c, d in SIMIL_NDIM if c[0] in NEW]


@pytest.mark.parametrize("case,ndim", NEW_NDIM, ids=[f"{c[0]}-d{d}" for c, d in NEW_NDIM])
def test_theta_gradient_matches_jax(case, ndim):
    """d sum(K)/dtheta of the kernels this slice adds, against jax.grad."""
    _, kj, kt, theta = case
    xa, xb = _inputs(ndim)
    want = jax.grad(lambda t: jnp.sum(kj.matrix(t, xa, xb) * jnp.arange(1.0, 6.0)))(jnp.asarray(theta))
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    (kt.matrix(th, torch.as_tensor(xa), torch.as_tensor(xb)) * torch.arange(1.0, 6.0, dtype=torch.float64)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)


def _spec_tree(spec):
    """A spec with each kernel child replaced by its own spec, recursively."""
    if spec is None:
        return None
    return tuple(_spec_tree(part.spec) if hasattr(part, "spec") else part for part in spec)


@pytest.mark.parametrize("case", SIMIL, ids=[c[0] for c in SIMIL])
def test_spec_tags_match_jax(case):
    _, kj, kt, _ = case
    assert _spec_tree(kt.spec) == _spec_tree(kj.spec)


@pytest.mark.parametrize("case", NOISE, ids=[c[0] for c in NOISE])
def test_noise_vector_matches_jax(case):
    _, nj, nt, theta = case
    xa, _ = _inputs(2)
    want = np.asarray(nj.vector(jnp.asarray(theta), xa))
    got = nt.vector(torch.tensor(theta, dtype=torch.float64), torch.as_tensor(xa))
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["matern32", "matern52", "matern52_ref"])
def test_zero_distance_gradient_matches_jax(name):
    """The _dist guard: the gradient of the covariance diagonal with respect
    to the inputs is finite (0), as in the JAX twin."""
    kj, kt = getattr(jk, name), getattr(tk, name)
    xa, _ = _inputs(2)
    want = jax.grad(lambda x: jnp.sum(kj.matrix(jnp.asarray([1.3]), x, x)))(jnp.asarray(xa))
    x = torch.as_tensor(xa).clone().requires_grad_(True)
    kt.matrix(torch.tensor([1.3], dtype=torch.float64), x, x).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_port_never_imports_jax():
    """gogp_torch and chip_smoke.py import neither jax nor gogp_tpu: by
    source scan, and by importing every module in a fresh interpreter."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gogp_tpu)\b", re.MULTILINE)
    files = sorted((REPO / "gogp_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "gogp_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gogp_tpu')]\n"
        "sys.exit(f'imported {bad}' if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr + proc.stdout
