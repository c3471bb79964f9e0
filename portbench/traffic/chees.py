"""ChEES-HMC sampling over a population of chains in lockstep, on the
exact GP plus the prior its configuration's model names.

A mix file of this kind gives ``n`` (points), ``chains``, the warm start
(``mle_steps`` of Adam at ``mle_rate`` on one chain, then ``spread``
N(0, 1) around its optimum), the sampler's adapted settings
(``step_size``, ``traj_length``, ``inv_mass``, ``max_steps``),
``trace_steps`` and ``check_transitions``.

The log-joint is ``torch.func.vmap`` of ``gp_observe`` plus the prior, as
the program's command line builds one, and the window drives
``chees_transition`` over it as ``run_chees`` samples once its warm-up is
done: the step size, the trajectory length and the diagonal mass fixed,
each transition's length jittered by the Halton sequence of its index.
The settings are those a warm-up of ``run_chees`` (256 transitions) found
on this posterior, measured once on the card when the cell was defined
(PERF.md).  A warm-up in the window would adapt them anew on every run:
the trajectories' lengths would follow each seed's draws, and the work
with them (1.7x between four seeds).  With them fixed, every transition's
leapfrog count follows from its index alone, so every seed runs the same
work, on its own data, from its own start and with its own draws, all
drawn from ``--seed``.  No warm-up transition is in the window.  A step is
one transition: the window marks each one's start, just before it reads
its step count to the host.  The window keeps the transitions the check
judges (:class:`portbench.window.Kept`) and counts on the card those whose
state stays finite.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import work
from portbench.model import program_gp, program_log_prior
from portbench.traffic.fit import make_data
from portbench.window import Closed, Kept

SAMPLER = True


@dataclasses.dataclass
class Sampler:
    x: torch.Tensor
    y: torch.Tensor
    mix: dict
    logp: object  # the program's batched log-joint
    state0: object  # the chains' state after chees_init
    rng_seed: int
    kept: Kept  # the transitions the check judges
    finite: torch.Tensor  # the window's transitions whose state stays finite, counted on the card
    calls: int = 0  # value-and-gradient calls of the whole batch
    transitions: int = 0

    @property
    def chains(self) -> int:
        return self.mix["chains"]


def program_logp(model, x, y, precision):
    from gogp_torch.models.params import gp_observe

    gp, prior = program_gp(model), program_log_prior(model)

    def one(v):
        lml = gp_observe(gp, v, x=x[:, None], y=y, precision=precision)
        return lml if prior is None else lml + prior(v)

    return torch.func.vmap(one)


def setup(config: dict, mix: dict, seed: int, device, precision: str | None) -> Sampler:
    from gogp_torch.infer import chees, hmc, mle
    from gogp_torch.ops import linalg

    theta = config["model"]["theta"]
    x, y, gen = make_data(mix["n"], seed, device)
    logp = program_logp(config["model"], x, y, precision)
    # the warm start, as the exact leg of large_n_bayes.py takes it: Adam on
    # the plain route from 0, then the chains spread around its optimum
    with linalg.force_plain():
        vg1 = hmc.value_and_grad(logp, None)
        opt = mle.adam(lambda v: tuple(t[0] for t in vg1(v[None])), torch.zeros(theta, device=device),
                       iters=mix["mle_steps"], rate=mix["mle_rate"])
    x0 = opt.x[None, :] + mix["spread"] * torch.randn((mix["chains"], theta), generator=gen, device=device)
    rng_seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=device))
    state0 = chees.chees_init(logp, x0, None, mix["step_size"], mix["traj_length"])
    state0 = state0._replace(inv_mass=torch.tensor(mix["inv_mass"], dtype=x0.dtype, device=device))
    chees.chees_transition(logp, _with_rng(state0, rng_seed - 1), max_num_steps=mix["max_steps"])  # every shape warm
    kept = Kept(1, mix["check_transitions"], seed)
    return Sampler(x, y, mix, logp, state0, rng_seed, kept, torch.zeros((), dtype=torch.int64, device=device))


def vg_flops(sampler: Sampler) -> float:
    return work.vg_flops(sampler.chains, sampler.mix["n"], sampler.state0.positions.shape[-1])


def _with_rng(state, seed: int):
    return state._replace(rng=torch.Generator(device=state.positions.device).manual_seed(seed))


@dataclasses.dataclass
class Transition:
    pre: object
    draws: tuple | None
    path: list  # the positions of its leapfrog steps, as the log-density was called on them
    post: object


def drive(sampler: Sampler, window) -> None:
    """Transitions until the window closes."""
    from gogp_torch.infer import chees

    path = []  # the current transition's leapfrog positions

    def counted(V):
        sampler.calls += 1
        path.append(V.detach())
        return sampler.logp(V)

    orig_vg = chees.value_and_grad
    if window.trace_steps:  # the traced run times each value-and-gradient call on the host
        def timed(logp, free):
            vg = orig_vg(logp, free)

            def f(q):
                t = window.vg_enter()
                out = vg(q)
                window.vg_exit(t)
                return out

            return f

        chees.value_and_grad = timed
    state = _with_rng(sampler.state0, sampler.rng_seed)
    window.open()
    try:
        while True:
            window.step()
            box = []
            path.clear()

            def draws(s):
                box.append(chees.generator_draws(s))
                return box[-1]

            post = chees.chees_transition(counted, state, max_num_steps=sampler.mix["max_steps"], draws=draws)
            sampler.transitions += 1
            sampler.kept.offer(Transition(state, box[0] if box else None, list(path), post))
            sampler.finite += torch.isfinite(post.logps.sum() + post.positions.sum())
            state = post
    except Closed:
        pass
    finally:
        chees.value_and_grad = orig_vg


def vg_calls(sampler: Sampler) -> int:
    return sampler.calls


def failed(sampler: Sampler) -> int:
    return sampler.transitions - int(sampler.finite)


def release(sampler: Sampler) -> None:
    sampler.logp = None


NUMBERS = ("grad_rel", "kick_rel", "steps_gap", "move_gap", "value_rel", "grad_max", "kick_max", "accept_gap",
           "unjudged")


def _per_chain(parts: list) -> tuple[float, float, int]:
    """Of readings (points, chains): the largest over chains of each
    chain's median, the largest reading, and how many are not finite."""
    every = torch.cat(parts) if parts else torch.zeros((0, 1), dtype=torch.float64)
    fin = torch.isfinite(every)
    medians = [float(every[fin[:, c], c].median()) for c in range(every.shape[1]) if fin[:, c].any()]
    if not medians:
        return float("nan"), float("nan"), int((~fin).sum())
    return max(medians), float(every[fin].max()), int((~fin).sum())


def check(sampler: Sampler, config: dict, seed: int) -> dict:
    """Readings of the window against the float64 reference, on the
    transitions kept (the first, and ``check_transitions`` drawn from the
    seed).

    The gradient of the log-joint at the positions the transitions left and
    at the chains' start, its error over the scale of its terms
    (``reference.gp.lml_and_grad``): ``grad_rel`` the largest over chains
    of each chain's median over its points, ``grad_max`` the largest.
    Each transition followed along the program's own trajectory
    (``reference.chees.follow``): each leapfrog kick against the
    reference's gradient there (``kick_rel`` the largest over chains of
    each chain's median over its steps, ``kick_max`` the largest), the
    number of steps (``steps_gap``, exact), where each chain stands after
    the Metropolis step (``move_gap``: exactly its trajectory's end or its
    start, by the program's own acceptance probability), and that
    probability (``accept_gap``).  The log-joint's value (``value_rel``).
    A chain's median is its typical error: a wrong gradient in any one
    chain of the batch shows in it, where a median over chains passes up
    to half the batch wrong.  Points where a diverging trajectory has left
    the region where either side's log-density is finite are not judged,
    and counted (``unjudged``)."""
    from portbench.reference import chees as rchees
    from portbench.reference import gp as ref

    logdens = ref.log_density(config)
    x, y = sampler.x.double(), sampler.y.double()
    ts = [t for _, t in sampler.kept.items()]
    if not ts:
        return dict.fromkeys(NUMBERS, float("nan"))
    out = dict.fromkeys(NUMBERS, 0.0)
    grads, kicks = [], []

    def worst(key, value):
        out[key] = max(out[key], float(value))

    def judge_point(state):
        rv, rg, scale = logdens(x, y, state.positions.double(), with_scale=True)
        worst("value_rel", ((state.logps.double() - rv).abs() / rv.abs()).max())
        grads.append(((state.grads.double() - rg).abs().amax(-1) / scale.amax(-1))[None])

    judge_point(ts[0].pre)
    for t in ts:
        judge_point(t.post)
        pre, post = t.pre, t.post
        steps = rchees.n_steps(pre.step_size, pre.log_traj, pre.step, sampler.mix["max_steps"])
        worst("steps_gap", abs(steps - len(t.path)))
        if not t.path:
            continue
        path = torch.stack([pre.positions, *t.path])
        f = rchees.follow(logdens, x, y, path, pre.step_size, pre.inv_mass, t.draws[0])
        kicks.append(f.kick_rel)
        worst("accept_gap", (post.accept_probs.double() - f.accept_prob).abs().max())
        expect = torch.where((t.draws[1] < post.accept_probs)[:, None], path[-1], pre.positions)
        worst("move_gap", (post.positions - expect).abs().max())
    for key, parts in (("grad", grads), ("kick", kicks)):
        out[f"{key}_rel"], out[f"{key}_max"], bad = _per_chain(parts)
        out["unjudged"] += bad
    return out
