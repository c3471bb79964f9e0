"""The plain reference against the port on the CPU in float64 at small n,
and the harness's imports against JAX and the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from portbench import cells
from portbench.model import program_gp
from portbench.reference import chees as rchees
from portbench.reference import gp as ref
from portbench.traffic.fit import make_data

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _data(n, seed=11):
    x, y, _ = make_data(n, seed, torch.device("cpu"))
    return x.double(), y.double()


V = torch.tensor([[0.0, 0.0, 0.0], [0.3, 1.1, -2.0], [-0.5, 0.7, -1.2]], dtype=torch.float64)
GP_RBF = cells._read("configs", "gp_rbf")
GP_RBF_PRIORS = cells._read("configs", "gp_rbf_priors")


@pytest.mark.parametrize("rows", [7, 2048])
def test_lml_against_the_port(rows):
    from gogp_torch import make_gp_logp, masked_value_and_grad

    x, y = _data(96)
    vg = masked_value_and_grad(make_gp_logp(program_gp(GP_RBF["model"]), x=x[:, None], y=y))
    val, grad, scale = ref.lml_and_grad(x, y, V, GP_RBF["model"], rows=rows, with_scale=True)
    for i, v in enumerate(V):
        pv, pg = vg(v)
        torch.testing.assert_close(val[i], pv, rtol=1e-11, atol=0)
        torch.testing.assert_close(grad[i], pg, rtol=1e-9, atol=1e-9)
    assert (scale >= grad.abs() * (1 - 1e-12)).all()


@pytest.mark.parametrize("prior", [None, {"family": "normal", "args": [0.0, 1.0]},
                                   {"family": "normal", "args": [0.5, 2.0]}])
def test_log_joint_against_the_port(prior):
    """The configuration's model block chooses both sides' log-density: the
    program's (``portbench/model.py``) and the reference's."""
    from gogp_torch.infer import hmc
    from portbench.traffic.chees import program_logp

    config = {**GP_RBF_PRIORS, "model": {**GP_RBF_PRIORS["model"], "prior": prior}}
    x, y = _data(64)
    pv, pg = hmc.value_and_grad(program_logp(config["model"], x, y, None), None)(V)
    val, grad, scale = ref.log_density(config)(x, y, V, with_scale=True)
    torch.testing.assert_close(val, pv, rtol=1e-11, atol=0)
    torch.testing.assert_close(grad, pg, rtol=1e-9, atol=1e-9)
    assert (scale >= grad.abs() * (1 - 1e-12)).all()


def test_model_parts_found_by_name():
    from gogp_torch import rbf, uniform_noise

    gp = program_gp(GP_RBF["model"])
    assert gp.noise is uniform_noise and gp.simil.name == rbf.scaled().name
    assert ref.part("kernels", "rbf.scaled()").THETA + ref.part("noises", "uniform_noise").THETA == 3
    with pytest.raises(ValueError):
        program_gp({**GP_RBF["model"], "kernel": "rbf.scaled(); import os"})
    with pytest.raises(ValueError):
        ref.lml_and_grad(*_data(16), V[:, :2], GP_RBF["model"])


def _chees_state(n=64, chains=6, seed=5):
    from gogp_torch.infer import chees
    from portbench.traffic.chees import program_logp

    x, y = _data(n, seed)
    logp = program_logp(GP_RBF_PRIORS["model"], x, y, None)
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64) + 0.05 * torch.randn(chains, 3, generator=gen,
                                                                                   dtype=torch.float64)
    state = chees.chees_init(logp, x0, torch.Generator().manual_seed(seed), 0.02, 0.2)
    return x, y, logp, state


def test_follow_against_the_port():
    """The reference follows a float64 transition of the port to rounding:
    its kicks, step count and acceptance."""
    from gogp_torch.infer import chees

    x, y, logp, state = _chees_state()
    for _ in range(3):
        state = chees.chees_transition(logp, state, max_num_steps=64)
    path, box = [], []

    def counted(V):
        path.append(V.detach())
        return logp(V)

    def draws(s):
        box.append(chees.generator_draws(s))
        return box[-1]

    post = chees.chees_transition(counted, state, max_num_steps=64, draws=draws)
    f = rchees.follow(ref.log_density(GP_RBF_PRIORS), x, y, torch.stack([state.positions, *path]), state.step_size,
                      state.inv_mass, box[0][0])
    assert rchees.n_steps(state.step_size, state.log_traj, state.step, 64) == len(path) > 1
    assert float(f.kick_rel.max()) < 1e-10
    torch.testing.assert_close(f.accept_prob, post.accept_probs, rtol=0, atol=1e-9)


def test_halton_against_the_port():
    from gogp_torch.infer import chees

    for i in (0, 1, 2, 3, 77, 1023, 123456):
        assert rchees.halton2(i) == float(chees._halton2(i))


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"gogp_torch", "gogp_tpu", "jax", "jaxlib", "flax"}, path


def test_harness_loads_no_jax():
    """Every module of the harness and what it loads of the port, imported in
    a fresh process: no top-level module name is JAX's or the JAX
    package's, compared whole (the port's name begins with the package's)."""
    mods = [f"portbench.{p.relative_to(HERE).with_suffix('').as_posix().replace('/', '.')}"
            for p in HERE.rglob("*.py") if "tests" not in p.parts and p.name != "__init__.py"]
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in mods)
            + "import gogp_torch, gogp_torch.infer.chees, gogp_torch.infer.mle, gogp_torch.models.params\n"
            + "from portbench.run import forbidden_modules\n"
            + "assert 'gogp_torch' in sys.modules\n"
            + "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
