"""A plain ChEES-HMC transition (Hoffman, Radul & Sountsov, AISTATS 2021):
the jittered trajectory length, velocity Verlet, the Metropolis step.

A sampler's chains part from any other run of them after a few
transitions, and a trajectory replayed whole from the same start and
draws parts from the program's just as soon wherever the leapfrog nears
its stability limit: it amplifies any difference in the gradient, f32
rounding included.  So the reference follows the program's own trajectory,
step by step: given the positions at which the program evaluated its
log-density (the start, then one a leapfrog step), it checks each step's
kick against its own gradient there, and works out the end momentum, the
energy error and the acceptance probability, all in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

DIVERGENCE = 1000.0


def halton2(i: int) -> float:
    """van der Corput base-2 radical inverse of ``i``, summed in float32
    over 24 bits (each partial sum exact)."""
    val = torch.zeros((), dtype=torch.float32)
    for k in range(24):
        val = val + float((i >> k) & 1) * (0.5 ** (k + 1.0))
    return float(val)


def n_steps(step_size: Tensor, log_traj: Tensor, step: int, max_steps: int) -> int:
    """The trajectory's leapfrog count, ceil(max(u T, h) / h) with u =
    halton2(step), between 1 and ``max_steps``, in the state's own
    precision."""
    u = torch.as_tensor(halton2(step), dtype=step_size.dtype, device=step_size.device)
    t = torch.maximum(u * torch.exp(log_traj), step_size)
    return min(max(int(torch.ceil(t / step_size)), 1), max_steps)


class Follow(NamedTuple):
    kick_rel: Tensor  # (steps, chains) each leapfrog residual, as a gradient, over the gradient's scale
    accept_prob: Tensor  # (chains,)


def follow(logdens, x: Tensor, y: Tensor, path: Tensor, step_size: Tensor, inv_mass: Tensor,
           r0_raw: Tensor) -> Follow:
    """One transition along the program's ``path`` (steps + 1, chains,
    dim): its start, then the positions of its leapfrog steps.  Velocity
    Verlet gives q1 = q0 + h M^-1 (r0 + h/2 g0) and q_{k+1} = 2 q_k - q_{k-1}
    + h^2 M^-1 g_k; each step's residual, divided by h^2 M^-1 (h^2/2 on the
    first), is the difference between the gradient the program kicked with
    and the reference's, measured against the gradient's scale
    (``gp.lml_and_grad``).  The end momentum follows from the last two
    positions, r_n = (q_n - q_{n-1}) / (h M^-1) + h/2 g_n."""
    dt = x.dtype
    h, im = step_size.to(dt), inv_mass.to(dt)
    q = path.to(dt)
    n = q.shape[0] - 1
    lp, g, scale = (torch.stack(t) for t in zip(*(logdens(x, y, qk, with_scale=True) for qk in q)))
    r0 = r0_raw.to(dt) / torch.sqrt(im)
    kick = [(q[1] - q[0] - h * im * r0) / (0.5 * h * h * im) - g[0]]
    kick += [(q[k + 1] - 2 * q[k] + q[k - 1]) / (h * h * im) - g[k] for k in range(1, n)]
    kick_rel = torch.stack([(kk.abs().amax(-1) / scale[k].amax(-1)) for k, kk in enumerate(kick)])
    rn = (q[n] - q[n - 1]) / (h * im) + 0.5 * h * g[n]
    delta = (-lp[n] + 0.5 * (rn * im * rn).sum(-1)) - (-lp[0] + 0.5 * (r0 * im * r0).sum(-1))
    delta = torch.where(torch.isnan(delta), torch.inf, delta)
    return Follow(kick_rel, torch.where(delta > DIVERGENCE, 0.0, torch.clamp(torch.exp(-delta), max=1.0)))
