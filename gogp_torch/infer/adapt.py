"""Warmup adaptation for HMC-family samplers: dual-averaging step size and
a diagonal mass matrix.

PyTorch twin of ``gogp_tpu/infer/adapt.py``: Stan's windowed scheme, dual
averaging (Nesterov 2009, as in Hoffman & Gelman 2014) for the step size,
Welford accumulators for the diagonal mass, the warmup split into a fast
initial interval, doubling slow windows and a fast final interval.

States are NamedTuples of tensors in the positions' dtype (iteration counts
int32), on the positions' device; the update functions are pure.  The
schedule is host-side numpy, as in the JAX twin.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class DualAveragingState(NamedTuple):
    log_step: Tensor  # current log step size
    log_step_avg: Tensor  # averaged iterate (used after warmup)
    gradient_avg: Tensor  # running average of (target - accept_prob)
    t: Tensor  # iteration counter, int32
    mu: Tensor  # shrinkage point = log(10 * init_step)


def da_init(step_size: float | Tensor, dtype: torch.dtype | None = None, device=None) -> DualAveragingState:
    """Start at ``step_size``: a tensor keeps its dtype and device, a number
    takes ``dtype`` (torch's default if None) and ``device``."""
    if isinstance(step_size, Tensor):
        log_step = torch.log(step_size)
    else:
        log_step = torch.log(torch.as_tensor(step_size, dtype=dtype or torch.get_default_dtype(), device=device))
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=torch.zeros_like(log_step),
        gradient_avg=torch.zeros_like(log_step),
        t=torch.zeros((), dtype=torch.int32, device=log_step.device),
        mu=math.log(10.0) + log_step,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: Tensor,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1
    tf = t.to(state.log_step.dtype)
    w = 1.0 / (tf + t0)
    gradient_avg = (1.0 - w) * state.gradient_avg + w * (target - accept_prob)
    log_step = state.mu - torch.sqrt(tf) / gamma * gradient_avg
    eta = tf ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    count: Tensor  # ()
    mean: Tensor  # (dim,)
    m2: Tensor  # (dim,) sum of squared deviations


def welford_init(dim: int, dtype: torch.dtype = torch.float32, device=None) -> WelfordState:
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros((dim,), dtype=dtype, device=device),
        m2=torch.zeros((dim,), dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Merge two accumulators (Chan et al.); additive, so a sharded chain
    population can all-reduce it."""
    count = a.count + b.count
    safe = torch.clamp(count, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * b.count / safe
    m2 = a.m2 + b.m2 + delta * delta * a.count * b.count / safe
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState, regularize: bool = True) -> Tensor:
    """Sample variance with Stan's shrinkage toward unit scale."""
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
    if regularize:
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


class WarmupSchedule(NamedTuple):
    """Per-step flags for the three-phase windowed warmup (host numpy)."""

    update_mass: np.ndarray  # (num_warmup,) bool: feed the sample into Welford
    window_end: np.ndarray  # (num_warmup,) bool: refresh mass, reset Welford and DA


def build_schedule(
    num_warmup: int, init_buffer: int = 75, term_buffer: int = 50, base_window: int = 25
) -> WarmupSchedule:
    """Static schedule, indexed by warmup step."""
    update_mass = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return WarmupSchedule(update_mass, window_end)
    if init_buffer + base_window + term_buffer > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    end_slow = num_warmup - term_buffer
    size = base_window
    while start < end_slow:
        stop = min(start + size, end_slow)
        if stop + size > end_slow:  # the last window absorbs the remainder
            stop = end_slow
        update_mass[start:stop] = True
        window_end[stop - 1] = True
        start = stop
        size *= 2
    return WarmupSchedule(update_mass, window_end)
