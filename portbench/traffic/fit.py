"""Back-to-back maximum-likelihood fits of an exact GP (plus its prior,
where the configuration's model has one: a MAP fit).

A mix file of this kind gives ``n`` (points), ``adam_steps`` and ``rate``
(each fit is ``mle.adam`` from v0 = 0 with ``threshold=0.0``, so it runs
all its steps), ``trace_steps`` (the steps the traced run profiles) and
``check_steps`` (the window's steps whose value and gradient the reference
recomputes).  The data is bench.py's noisy sine drawn from the seed on the
card: x sorted uniform on [0, 100], y = sin(x / 3) + 0.1 N(0, 1).

The value and gradient go through ``make_gp_logp`` and
``masked_value_and_grad``, the program's own entry, on the GP the
configuration's ``model`` names (``portbench/model.py``), and every fit of
the window through ``mle.adam``.  A step is one value-and-gradient call:
the window marks each call's start, where Adam has just read its stop flag.
The window keeps the calls the check judges (:class:`portbench.window.Kept`)
and counts the finite ones on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import work
from portbench.model import program_gp, program_log_prior
from portbench.window import Closed, Kept

SAMPLER = False


def make_data(n: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Generator]:
    """x (n,) sorted uniform on [0, 100] and y (n,), float32, from ``seed``
    on ``device``; the generator goes on to draw whatever else the run
    needs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.sort(100.0 * torch.rand(n, generator=gen, device=device)).values
    y = torch.sin(x / 3.0) + 0.1 * torch.randn(n, generator=gen, device=device)
    return x, y, gen


@dataclasses.dataclass
class Fits:
    x: torch.Tensor
    y: torch.Tensor
    mix: dict
    vg: object  # the program's value-and-gradient function
    v0: torch.Tensor
    kept: Kept  # (v, value, grad) of the calls the check judges
    finite: torch.Tensor  # the window's calls whose value and gradient are finite, counted on the card
    calls: int = 0

    chains = 1


def setup(config: dict, mix: dict, seed: int, device, precision: str | None) -> Fits:
    from gogp_torch import make_gp_logp, masked_value_and_grad

    model = config["model"]
    x, y, _ = make_data(mix["n"], seed, device)
    logp = make_gp_logp(program_gp(model), x=x[:, None], y=y, precision=precision)
    prior = program_log_prior(model)
    vg = masked_value_and_grad(logp if prior is None else lambda v: logp(v) + prior(v))
    v0 = torch.zeros(model["theta"], dtype=x.dtype, device=device)
    for _ in range(2):  # loads the kernels, and every shape the fits use
        vg(v0)
    kept = Kept(ADAM_FOLLOWED + 1, mix["check_steps"], seed)
    return Fits(x, y, mix, vg, v0, kept, torch.zeros((), dtype=torch.int64, device=device))


def vg_flops(fits: Fits) -> float:
    return work.vg_flops(1, fits.mix["n"], fits.v0.shape[0])


def drive(fits: Fits, window) -> None:
    """Fits back to back until the window closes."""
    from gogp_torch.infer import mle

    def step(v):
        window.step()
        t = window.vg_enter()
        value, grad = fits.vg(v)
        window.vg_exit(t)
        fits.calls += 1
        fits.kept.offer((v, value, grad))
        fits.finite += torch.isfinite(value + grad.sum())
        return value, grad

    window.open()
    try:
        while True:
            mle.adam(step, fits.v0, iters=fits.mix["adam_steps"], rate=fits.mix["rate"], threshold=0.0)
    except Closed:
        pass


def vg_calls(fits: Fits) -> int:
    return fits.calls


def failed(fits: Fits) -> int:
    return fits.calls - int(fits.finite)


def release(fits: Fits) -> None:
    fits.vg = None


def _adam_ref(logdens, x, y, v0: torch.Tensor, steps: int, rate: float) -> torch.Tensor:
    """``steps`` of Adam ascent on the reference log-density from v0:
    b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected."""
    v = v0.clone()
    m = torch.zeros_like(v)
    s = torch.zeros_like(v)
    for t in range(1, steps + 1):
        g = -logdens(x, y, v)[1]
        m = 0.9 * m + 0.1 * g
        s = 0.999 * s + 0.001 * g * g
        v = v - rate * (m / (1 - 0.9**t)) / (torch.sqrt(s / (1 - 0.999**t)) + 1e-8)
    return v


ADAM_FOLLOWED = 3  # the reference follows the first fit's first steps


def check(fits: Fits, config: dict, seed: int) -> dict:
    """Readings of the window against the float64 reference: the value and
    gradient at the calls kept (the first always among them, and
    ``check_steps`` drawn from the seed; the gradient's error over the scale
    of its terms, as ``reference.gp.lml_and_grad`` gives it), and the change
    Adam made to v over the first fit's first three steps, by the worst
    coordinate."""
    from portbench.reference import gp as ref

    logdens = ref.log_density(config)
    x, y = fits.x.double(), fits.y.double()
    kept = dict(fits.kept.items())
    value_rel = grad_rel = 0.0
    for i in sorted({0, *kept.keys() - set(range(1, ADAM_FOLLOWED + 1))} & kept.keys()):
        v, val, g = kept[i]
        rv, rg, scale = logdens(x, y, v.double(), with_scale=True)
        value_rel = max(value_rel, float((val.double() - rv).abs() / rv.abs()))
        grad_rel = max(grad_rel, float((g.double() - rg).abs().max() / scale.max()))
    out = {"value_rel": value_rel, "grad_rel": grad_rel}
    if fits.calls > ADAM_FOLLOWED and fits.mix["adam_steps"] > ADAM_FOLLOWED:
        v0 = fits.v0.double()
        want = (_adam_ref(logdens, x, y, v0, ADAM_FOLLOWED, fits.mix["rate"]) - v0).abs()
        got = (kept[ADAM_FOLLOWED][0].double() - v0).abs()
        scale = torch.maximum(want, want.median())
        out["adam_gap"] = float(((got - want).abs() / scale).max())
    else:
        out["adam_gap"] = float("nan")  # too few steps in the window to judge
    return out
