"""No-U-Turn Sampler: iterative tree doubling, every chain in lockstep.

PyTorch twin of ``gogp_tpu/infer/nuts.py`` (Hoffman & Gelman 2014,
multinomial variant), on the chain batch of ``infer/hmc.py``: positions
(chains, dim), per-chain step size and mass.  The algorithm is the JAX
twin's:

- a subtree of 2^d leaves is built by up to 2^d leapfrog steps;
- the U-turn checks of the recursive algorithm come from a checkpoint
  stack of ``max_tree_depth + 1`` slots: leaf ``n`` (even) stores its
  momentum and running momentum sum at slot ``popcount(n)``; leaf ``n``
  (odd, with ``t`` trailing one-bits) checks the spans of sizes 2, 4, ...,
  2^t that end at it against slots ``popcount(n >> 1) - t + 1`` to
  ``popcount(n >> 1)``;
- proposals are multinomial in the leaf weights ``exp(energy0 -
  energy_leaf)``: progressive within a subtree, biased progressive across
  doublings.

Lockstep: every leapfrog step of the tree is one batched value and gradient
of all chains (one K7 launch on a theta-only GP study).  A chain that has
turned or diverged is frozen by ``torch.where`` while the others go on, as
vmap's while loops keep it.  Every chain still building its tree is at the
same depth and leaf index ``n``, so ``popcount(n)``, the trailing ones and
the checkpoint slots are host integers.  Direction, proposal, endpoints and
momentum sums stay per chain.  One host read per leaf asks whether any chain
is still building (the JAX while loop's ``cond``); a transition costs the
deepest chain's tree.

Randomness: each transition takes its draws from ``draws(state)``, a
:class:`NUTSDraws`: the standard normal momenta, then at each depth the
direction bit and the merge uniform, and at each ``(depth, n)`` the leaf
uniform.  These are the JAX twin's ``split(rng, 5)``, ``fold_in(key_dirs,
depth)``, ``fold_in(key_merge, depth)`` and ``fold_in(fold_in(key_sub,
depth), n)``, so tests can hand in JAX's own values.  By default
:func:`generator_draws` takes them from the state's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gogp_torch.infer.hmc import (
    HMCState,
    IntegratorState,
    LogDensity,
    Samples,
    as_free,
    init_state,
    kinetic,
    leapfrog_step,
    run_sampler,
    sample_momentum,
    value_and_grad,
    where_chains,
)

Tensor = torch.Tensor

DIVERGENCE_THRESHOLD = 1000.0


class TreeInfo(NamedTuple):
    """What one transition's trees were, per chain (for diagnostics)."""

    depth: Tensor  # (chains,) doublings taken
    num_leaves: Tensor  # (chains,) leapfrog steps of the chain's tree
    diverging: Tensor  # (chains,) bool
    leapfrogs: int  # batched value-and-gradient calls the transition made


class NUTSDraws(NamedTuple):
    """One transition's random numbers, each (chains,) unless noted."""

    momentum: Tensor  # (chains, dim) standard normal
    direction: Callable[[int], Tensor]  # depth -> bool, True: forward in time
    merge: Callable[[int], Tensor]  # depth -> uniform of the merge across the doubling
    leaf: Callable[[int, int], Tensor]  # (depth, n) -> uniform of leaf n's proposal


def generator_draws(state: HMCState) -> NUTSDraws:
    """Draws from the state's generator, each made when first asked for."""
    chains, dim = state.position.shape
    like = dict(dtype=state.position.dtype, device=state.position.device, generator=state.rng)
    return NUTSDraws(
        momentum=torch.randn((chains, dim), **like),
        direction=lambda depth: torch.rand((chains,), **like) < 0.5,
        merge=lambda depth: torch.rand((chains,), **like),
        leaf=lambda depth, n: torch.rand((chains,), **like),
    )


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    return ((n + 1) & -(n + 1)).bit_length() - 1


def _is_turning(inv_mass: Tensor, rho: Tensor, r_left: Tensor, r_right: Tensor) -> Tensor:
    v = inv_mass * rho
    return ((v * r_left).sum(-1) <= 0) | ((v * r_right).sum(-1) <= 0)


class _TreeState(NamedTuple):
    left: IntegratorState  # the trajectory's earliest leaf
    right: IntegratorState  # its latest
    prop: IntegratorState  # the multinomial proposal
    r_sum: Tensor  # momentum sum over all leaves
    log_weight: Tensor  # logsumexp of the leaf log-weights
    depth: Tensor
    turning: Tensor
    diverging: Tensor
    sum_accept: Tensor  # sum of the per-leaf accept statistics
    num_leaves: Tensor


class _Subtree(NamedTuple):
    n: Tensor  # leaves built
    integ: IntegratorState  # the last leaf built
    r_sum: Tensor
    prop: IntegratorState
    log_weight: Tensor
    turning: Tensor
    diverging: Tensor
    sum_accept: Tensor


def _build_subtree(vg, from_state: IntegratorState, depth: int, running: Tensor, step: Tensor,
                   inv_mass: Tensor, energy0: Tensor, leaf_u: Callable[[int, int], Tensor],
                   max_tree_depth: int, free) -> tuple[_Subtree, int]:
    """Up to 2^depth leaves from ``from_state`` for the chains in
    ``running``; ``step`` (chains, 1) holds each chain's signed step.
    Returns the subtree and the number of leapfrog steps taken."""
    chains, dim = from_state.position.shape
    zeros = from_state.logp.new_zeros((chains,))
    r_ckpts = from_state.position.new_zeros((chains, max_tree_depth + 1, dim))
    r_sum_ckpts = torch.zeros_like(r_ckpts)
    c = _Subtree(n=torch.zeros_like(zeros, dtype=torch.int64), integ=from_state,
                 r_sum=torch.zeros_like(from_state.position), prop=from_state,
                 log_weight=torch.full_like(zeros, -torch.inf), turning=torch.zeros_like(running),
                 diverging=torch.zeros_like(running), sum_accept=zeros)
    active, n = running, 0
    while n < (1 << depth) and (n == 0 or bool(active.any())):
        integ = leapfrog_step(vg, c.integ, step, inv_mass, free, active=active)
        energy = -integ.logp + kinetic(integ.momentum, inv_mass)
        delta = energy - energy0
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        diverging = delta > DIVERGENCE_THRESHOLD
        leaf_lw = -delta
        accept_stat = torch.exp(torch.clamp(leaf_lw, max=0.0))
        r_sum = c.r_sum + integ.momentum

        # progressive multinomial proposal within the subtree
        total_lw = torch.logaddexp(c.log_weight, leaf_lw)
        take = torch.log(leaf_u(depth, n)) < (leaf_lw - total_lw)
        prop = where_chains(take, integ, c.prop)

        if n % 2 == 0:  # even leaf: checkpoint at slot popcount(n)
            slot = _popcount(n)
            r_ckpts[:, slot] = torch.where(active[:, None], integ.momentum, r_ckpts[:, slot])
            r_sum_ckpts[:, slot] = torch.where(active[:, None], r_sum, r_sum_ckpts[:, slot])
            turning = torch.zeros_like(active)
        else:  # odd leaf: the spans of size 2, 4, ..., 2^t ending here
            idx_max = _popcount(n >> 1)
            turning = torch.zeros_like(active)
            for k in range(idx_max - _trailing_ones(n) + 1, idx_max + 1):
                rho = r_sum - r_sum_ckpts[:, k] + r_ckpts[:, k]
                turning = turning | _is_turning(inv_mass, rho, r_ckpts[:, k], integ.momentum)

        new = _Subtree(n=c.n + 1, integ=integ, r_sum=r_sum, prop=prop, log_weight=total_lw, turning=turning,
                       diverging=diverging, sum_accept=c.sum_accept + accept_stat)
        c = where_chains(active, new, c)
        active = active & ~c.turning & ~c.diverging
        n += 1
    return c, n


def nuts_transition(
    logp: LogDensity,
    state: HMCState,
    max_tree_depth: int = 10,
    free: Tensor | None = None,
    draws: Callable[[HMCState], NUTSDraws] = generator_draws,
    trace: list | None = None,
) -> HMCState:
    """One NUTS transition of every chain (multinomial, iterative doubling).
    With ``trace``, a :class:`TreeInfo` of the transition is appended to it."""
    freea = as_free(free, state.position)
    vg = value_and_grad(logp, freea)
    d = draws(state)
    inv_mass = state.inv_mass
    r0 = sample_momentum(d.momentum, inv_mass, freea)
    energy0 = -state.logp + kinetic(r0, inv_mass)

    z0 = IntegratorState(state.position, r0, state.logp, state.grad)
    zeros = state.logp.new_zeros(state.logp.shape)
    no = torch.zeros_like(zeros, dtype=torch.bool)
    count = torch.zeros_like(zeros, dtype=torch.int64)
    tree = _TreeState(left=z0, right=z0, prop=z0, r_sum=r0, log_weight=zeros, depth=count, turning=no,
                      diverging=no, sum_accept=zeros, num_leaves=count)
    running, leapfrogs = ~no, 0
    for depth in range(max_tree_depth):
        if depth and not bool(running.any()):
            break
        forward = d.direction(depth)
        step = torch.where(forward, 1.0, -1.0).to(zeros.dtype)[:, None] * state.step_size[:, None]
        from_state = where_chains(forward, tree.right, tree.left)
        sub, taken = _build_subtree(vg, from_state, depth, running, step, inv_mass, energy0, d.leaf,
                                    max_tree_depth, freea)
        leapfrogs += taken
        ok = ~sub.turning & ~sub.diverging

        # biased progressive sampling across the doubling
        take_new = ok & (torch.log(d.merge(depth)) < (sub.log_weight - tree.log_weight))
        new_left = where_chains(forward, tree.left, where_chains(ok, sub.integ, tree.left))
        new_right = where_chains(forward, where_chains(ok, sub.integ, tree.right), tree.right)
        r_sum = tree.r_sum + torch.where(ok[:, None], sub.r_sum, 0.0)
        turning_total = ok & _is_turning(inv_mass, r_sum, new_left.momentum, new_right.momentum)
        new = _TreeState(
            left=new_left,
            right=new_right,
            prop=where_chains(take_new, sub.prop, tree.prop),
            r_sum=r_sum,
            log_weight=torch.where(ok, torch.logaddexp(tree.log_weight, sub.log_weight), tree.log_weight),
            depth=tree.depth + 1,
            turning=sub.turning | turning_total,
            diverging=sub.diverging,
            sum_accept=tree.sum_accept + sub.sum_accept,
            num_leaves=tree.num_leaves + sub.n,
        )
        tree = where_chains(running, new, tree)
        running = running & ~tree.turning & ~tree.diverging

    accept_prob = tree.sum_accept / torch.clamp(tree.num_leaves.to(zeros.dtype), min=1.0)
    if trace is not None:
        trace.append(TreeInfo(tree.depth, tree.num_leaves, tree.diverging, leapfrogs))
    return state._replace(position=tree.prop.position, logp=tree.prop.logp, grad=tree.prop.grad,
                          accept_prob=accept_prob)


def run_nuts(
    logp: LogDensity,
    position0: Tensor,
    rng: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_tree_depth: int = 10,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Tensor | None = None,
    draws: Callable[[HMCState], NUTSDraws] = generator_draws,
    trace: list | None = None,
) -> Samples:
    """Warmup then sampling of every chain of ``position0`` (chains, dim);
    the returned positions are (num_samples, chains, dim).  ``trace`` as in
    :func:`nuts_transition`, one entry per transition."""
    state = init_state(logp, position0, rng, init_step_size, free)

    def transition(s):
        return nuts_transition(logp, s, max_tree_depth, free, draws, trace)

    return run_sampler(transition, state, num_warmup, num_samples, target_accept)
