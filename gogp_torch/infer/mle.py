"""Maximum-likelihood / MAP optimization of log-densities.

PyTorch twin of ``gogp_tpu/infer/mle.py``: Adam and LBFGS *maximizing*
``logp``, stopping when every |grad_i| < threshold or after ``iters`` major
iterations.

The JAX twin runs each optimization as one ``lax.while_loop``.  Here each
runs as a Python loop on the host, with one host read per step: that read is
the counterpart of the while_loop's ``cond``.  Capturing the loop in a CUDA
graph is later work.

Batched fits (the JAX twin's ``vmap`` over the rolling forecast's prefix
fits): :func:`adam_batched` and :func:`lbfgs_batched` take x0 of shape
(rows, p) and a ``value_and_grad`` of the whole batch, one call per step (and
per line-search trial).  Every row runs as if alone, as under ``vmap`` of a
``while_loop``: a row that stops keeps its state frozen while the others go
on, and reports its own iterations, ``converged`` and ``stalled``.  The one
host read per step (per trial) asks whether any row is still running.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gogp_torch.utils.profiling import host_read, span

Tensor = torch.Tensor

DEFAULT_ITERS = 1000
DEFAULT_THRESHOLD = 1e-6
DEFAULT_RATE = 0.01
# optax's LBFGS as the JAX twin takes it (optax.lbfgs defaults, optax 0.2.6):
# zoom line search of at most 20 trials, first trial step 1, doubling while
# no bracket is found, Armijo constant 1e-4, curvature 0.9, Hager and Zhang's
# approximate decrease within 1e-6 of |f|, a bracket narrower than 1e-5
# ending the search once a point of sufficient decrease is known.
_MAX_LINE_SEARCH = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL, _INTERVAL_THRESHOLD = 1e-4, 0.9, 1e-6, 1e-5


class OptResult(NamedTuple):
    """One fit's result; from the batched optimizers each field has a
    leading rows axis (``iters``, ``converged`` and ``stalled`` tensors)."""

    x: Tensor  # optimized parameter vector
    value: Tensor  # logp at the last point whose gradient was taken
    iters: int  # iterations actually taken
    converged: bool  # True if the gradient threshold was hit
    # True if the run stopped without converging: Adam met a non-finite value
    # or gradient, or two LBFGS line searches in a row failed (the second
    # from a cleared memory)
    stalled: bool


def adam(
    value_and_grad_logp: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    rate: float = DEFAULT_RATE,
    threshold: float = DEFAULT_THRESHOLD,
) -> OptResult:
    """Adam ascent on ``logp``, in optax's arithmetic: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, bias-corrected moments.

    ``value_and_grad_logp`` may carry a gradient mask
    (``gogp_torch.models.masked_value_and_grad``) to pin coordinates.  As in
    the JAX twin's driver: the step whose gradient falls below the threshold
    still applies its update; a non-finite value or gradient zeroes that
    step's update, keeps the last finite value, ends the run (unless the
    threshold is 0) and sets ``stalled``.  One problem: :func:`adam_batched`
    on one row."""

    def one_row(X):
        v, g = value_and_grad_logp(X[0])
        return v[None], g[None]

    res = adam_batched(one_row, torch.as_tensor(x0)[None], iters, rate, threshold)
    return OptResult(res.x[0], res.value[0], int(res.iters[0]), bool(res.converged[0]), bool(res.stalled[0]))


class AdamState(NamedTuple):
    """``optax.adam``'s state: the moments of each parameter and the count."""

    mu: tuple[Tensor, ...]
    nu: tuple[Tensor, ...]
    count: int


def adam_init(params) -> AdamState:
    return AdamState(tuple(torch.zeros_like(p) for p in params), tuple(torch.zeros_like(p) for p in params), 0)


def adam_update(grads, state: AdamState, rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[tuple[Tensor, ...], AdamState]:
    """``optax.adam(rate).update``: the updates (to add to the parameters,
    which descends) and the new state, in optax's arithmetic."""
    count = state.count + 1
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu))
    updates = tuple(-rate * ((m / (1 - b1**count)) / (torch.sqrt(v / (1 - b2**count)) + eps)) for m, v in zip(mu, nu))
    return updates, AdamState(mu, nu, count)


def _row_gmax(g: Tensor) -> Tensor:
    """The largest |g| of each row; 0 for rows of no coordinates."""
    return g.abs().amax(-1) if g.shape[-1] else g.new_zeros(g.shape[:-1])


def adam_batched(
    value_and_grad_logp: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    rate: float = DEFAULT_RATE,
    threshold: float = DEFAULT_THRESHOLD,
) -> OptResult:
    """:func:`adam` on every row of x0 (rows, p) at once: ``value_and_grad_logp``
    maps (rows, p) to ((rows,), (rows, p)).  A row stops at its own gradient
    threshold or non-finite value, its x and moments frozen from then on.
    Rows only ever stop, so every running row has taken the same number of
    steps: the bias correction is the batch's step count."""
    x = torch.as_tensor(x0).detach().clone()
    rows = x.shape[0]
    moments = adam_init((x,))
    value = x.new_zeros(rows)  # -logp, last finite
    bad = torch.zeros(rows, dtype=torch.bool, device=x.device)
    steps = torch.zeros(rows, dtype=torch.int64, device=x.device)
    gmax = torch.full((rows,), math.inf, dtype=x.dtype, device=x.device)
    active = torch.full((rows,), iters > 0, dtype=torch.bool, device=x.device)
    running = iters > 0 and rows > 0  # active.any(), known without a read
    while running:
        with span("mle.step"):
            v, g = value_and_grad_logp(x)
            v, g = -v, -g  # minimize -logp
            finite = torch.isfinite(v) & torch.isfinite(g).all(-1)
            g = torch.where(finite[:, None], g, 0.0)
            value = torch.where(active & finite, v, value)
            steps = steps + active
            (update,), new = adam_update((g,), moments, rate)
            x_new = x + torch.where(finite[:, None], update, 0.0)
            on = active[:, None]
            x = torch.where(on, x_new, x)
            moments = AdamState((torch.where(on, new.mu[0], moments.mu[0]),),
                                (torch.where(on, new.nu[0], moments.nu[0]),), new.count)
            bad = bad | (active & ~finite)
            gmax = torch.where(active, torch.where(finite, _row_gmax(g), 0.0), gmax)
            active = active & (steps < iters) & (gmax >= threshold)
            with host_read("adam_stop"):
                running = bool(active.any())
    return OptResult(x, -value, steps, (gmax < threshold) & ~bad, bad)


def lbfgs(
    logp: Callable[[Tensor], Tensor],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    threshold: float = DEFAULT_THRESHOLD,
    memory_size: int = 15,
    free: Tensor | None = None,
) -> OptResult:
    """LBFGS ascent on ``logp`` (gradients by autograd): :func:`lbfgs_batched`
    on one row, the JAX twin's algorithm (optax's LBFGS with its zoom line
    search) but for a failed search without a safe point, which takes no
    step.  ``free`` is an optional 0/1 mask applied to the gradient, so
    pinned coordinates keep their initialization."""
    x0 = torch.as_tensor(x0)

    def one_row(X):
        v = X[0].detach().requires_grad_(True)
        with torch.enable_grad():
            val = logp(v)
            (g,) = torch.autograd.grad(val, v) if val.requires_grad else (torch.zeros_like(v),)
        return val.detach()[None], g[None]

    res = lbfgs_batched(one_row, x0[None], iters, threshold, memory_size,
                        None if free is None else torch.as_tensor(free, dtype=x0.dtype, device=x0.device)[None])
    return OptResult(res.x[0], res.value[0], int(res.iters[0]), bool(res.converged[0]), bool(res.stalled[0]))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a, fa)
    with slope fpa there, (b, fb) and (c, fc); NaN where there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc * dc * rb - db * db * rc) / denom
    B = (-(dc * dc * dc) * rb + db * db * db * rc) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa) with slope fpa there and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _errors(t, value, slope, value0, slope0):
    """optax's decrease and curvature errors of a trial (0 where met, +inf
    where NaN): Armijo's condition, or near a minimum Hager and Zhang's
    approximate decrease; |slope| at most 0.9 of the initial one."""
    dec = value - value0 - _SLOPE_RTOL * t * slope0
    approx = torch.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope0,
                           value - value0 - _APPROX_DEC_RTOL * value0.abs())
    dec = torch.clamp(torch.minimum(approx, dec), min=0.0)
    curv = torch.clamp(slope.abs() - _CURV_RTOL * slope0.abs(), min=0.0)
    return (torch.where(torch.isnan(dec), math.inf, dec), torch.where(torch.isnan(curv), math.inf, curv))


def _zoom_linesearch(objective, x, d, f, g, searching):
    """optax's ``scale_by_zoom_linesearch`` (Nocedal and Wright's algorithms
    3.5 and 3.6, the strong Wolfe conditions) on every row at once, each
    row on its own trials; a row that is done (or has failed) waits,
    masked, while the others go on.  Each round is one call of ``objective``
    on the whole batch, at most ``_MAX_LINE_SEARCH``.  A row that fails
    takes its safe point, the lowest trial of sufficient decrease, at
    optax's step length (optax's ``_try_safe_step``), where that point is
    no higher than f.  Only where there is no such point does the port
    part from optax: the row takes no step, where optax would step to its
    last trial, even one above f or not finite.  Returns each row's step length
    and the value and gradient there (0, f and g where the search failed
    without a safe point)."""
    slope0 = (g * d).sum(-1)
    t, value, grad, slope = torch.zeros_like(f), f, g, slope0
    bracketed = torch.zeros_like(searching)
    done, failed = ~searching, torch.zeros_like(searching)
    low, v_low, s_low = torch.zeros_like(f), f, slope0
    high, v_high, s_high = torch.zeros_like(f), f, slope0
    ref, v_ref = torch.zeros_like(f), f
    # optax's safe step, the lowest point of sufficient decrease: once one
    # is known, a bracket narrower than _INTERVAL_THRESHOLD ends the search
    safe_t, safe_v, safe_g = torch.zeros_like(f), f, g
    count = 0
    while True:
        on = ~(done | failed)
        if not bool(on.any()):
            break
        # the next trial: doubling until bracketed, then interpolation
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mid_c = _cubicmin(low, v_low, s_low, high, v_high, ref, v_ref)
        use_c = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, v_low, s_low, high, v_high)
        use_q = ~use_c & (mid_q > left + 0.1 * delta) & (mid_q < right - 0.1 * delta)
        middle = torch.where(use_c, mid_c, torch.where(use_q, mid_q, (low + high) / 2.0))
        trial = torch.where(bracketed, middle, 1.0 if count == 0 else 2.0 * t)
        v_new, g_new = objective(torch.where(on[:, None], x + trial[:, None] * d, x))
        s_new = (g_new * d).sum(-1)
        dec_new, curv_new = _errors(trial, v_new, s_new, f, slope0)
        ok = torch.maximum(dec_new, curv_new) <= 0.0
        search, zoom = on & ~bracketed, on & bracketed

        # bracketing (algorithm 3.5): any point of sufficient decrease is safe
        hi_new = (dec_new > 0.0) | ((v_new >= value) & (count > 0))
        lo_new = (s_new >= 0.0) & ~hi_new
        s_low_new = search & lo_new
        s_default = search & ~lo_new
        # zoom (algorithm 3.6): the safe point is the lowest of sufficient decrease
        hi_mid = (dec_new > 0.0) | (v_new >= v_low)
        hi_low = ((s_new * (high - low)) >= 0.0) & ~hi_mid
        z_hi_mid, z_hi_low, z_lo_mid = zoom & hi_mid, zoom & hi_low, zoom & ~hi_mid
        new_safe = ((search & (dec_new <= 0.0)) | (zoom & (dec_new <= 0.0) & (v_new < safe_v)))
        safe_t = torch.where(new_safe, trial, safe_t)
        safe_v = torch.where(new_safe, v_new, safe_v)
        safe_g = torch.where(new_safe[:, None], g_new, safe_g)

        # the zoom's next cubic reference: the old high where high moves,
        # else the old low
        ref_zoom, v_ref_zoom = torch.where(z_hi_mid | z_hi_low, high, low), torch.where(z_hi_mid | z_hi_low, v_high, v_low)
        # bracket ends (search: low = previous point, high = new, or the
        # other way round where the new point's slope is non-negative)
        n_low = torch.where(s_low_new, trial, torch.where(s_default, t, torch.where(z_lo_mid, trial, low)))
        n_v_low = torch.where(s_low_new, v_new, torch.where(s_default, value, torch.where(z_lo_mid, v_new, v_low)))
        n_s_low = torch.where(s_low_new, s_new, torch.where(s_default, slope, torch.where(z_lo_mid, s_new, s_low)))
        n_high = torch.where(s_low_new, t, torch.where(s_default, trial, torch.where(
            z_hi_mid, trial, torch.where(z_hi_low, low, high))))
        n_v_high = torch.where(s_low_new, value, torch.where(s_default, v_new, torch.where(
            z_hi_mid, v_new, torch.where(z_hi_low, v_low, v_high))))
        n_s_high = torch.where(s_low_new, slope, torch.where(s_default, s_new, torch.where(
            z_hi_mid, s_new, torch.where(z_hi_low, s_low, s_high))))
        ref = torch.where(search, n_low, torch.where(zoom, ref_zoom, ref))
        v_ref = torch.where(search, n_v_low, torch.where(zoom, v_ref_zoom, v_ref))
        low, v_low, s_low, high, v_high, s_high = n_low, n_v_low, n_s_low, n_high, n_v_high, n_s_high

        too_small = zoom & (delta <= _INTERVAL_THRESHOLD) & (safe_t > 0.0)
        bracketed = bracketed | (search & (hi_new | lo_new | ok))
        done = done | (on & ok)
        count += 1
        failed = failed | (on & ~ok & ((count >= _MAX_LINE_SEARCH) | too_small))
        t, value, slope = torch.where(on, trial, t), torch.where(on, v_new, value), torch.where(on, s_new, slope)
        grad = torch.where(on[:, None], g_new, grad)
    # a failed search takes its safe point where it is no higher than f (the
    # approximate decrease allows a rise of 1e-6 |f|), else no step
    safe = failed & (safe_t > 0.0) & (safe_v <= f)
    stay = failed & ~safe
    t = torch.where(safe, safe_t, torch.where(stay, 0.0, t))
    value = torch.where(safe, safe_v, torch.where(stay, f, value))
    grad = torch.where(safe[:, None], safe_g, torch.where(stay[:, None], g, grad))
    return t, value, grad


def lbfgs_batched(
    value_and_grad_logp: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    iters: int = DEFAULT_ITERS,
    threshold: float = DEFAULT_THRESHOLD,
    memory_size: int = 15,
    free: Tensor | None = None,
) -> OptResult:
    """LBFGS ascent on every row of x0 (rows, p) at once:
    ``value_and_grad_logp`` maps (rows, p) to ((rows,), (rows, p)).

    The JAX twin's algorithm, ``optax.lbfgs(memory_size)`` driven as
    gogp_tpu/infer/mle.py drives it: each step takes the value and gradient
    the last line search ended on (a fresh evaluation where that is not
    finite), masks the gradient by ``free`` ((p,) or one row each), adds the
    last step's pair to the row's memory (rows, m, p; no curvature test, a
    zero product weighs 0), scales the identity by s.y / y.y (on the first
    step by min(1, 1/|g|)), runs the two-loop recursion on the whole batch
    and then :func:`_zoom_linesearch`.  Where a search fails, the row takes
    its safe point as optax does, if one no higher than f was found.  Where
    none was, the row takes no step (optax would step to its last trial,
    even uphill) and, as L-BFGS-B does, clears its memory and searches again
    along the scaled gradient; a second such failure in a row stalls it.  So
    a fit never ends below its start, and a row at its precision's noise
    floor stops.  A row
    stops at its gradient threshold, at ``iters`` or at a stall, frozen from
    then on; rows only ever stop, so every running row is on the batch's
    step.

    The optimizer's own arithmetic (the memory, the recursion, the line
    search's per-row scalars: some hundred small operations a step) runs on
    the host in x0's dtype; only each objective call runs on x0's device,
    one copy there and one back.  On a card, launching those operations
    cost more than the objective itself."""
    device = torch.as_tensor(x0).device
    x = torch.as_tensor(x0).detach().to("cpu", copy=True)
    rows, p = x.shape
    mask = None if free is None else torch.as_tensor(free, dtype=x.dtype).cpu()

    def objective(X):
        v, g = value_and_grad_logp(X.to(device))
        vg = torch.cat([v.detach()[:, None], g.detach()], 1).cpu()
        v, g = -vg[:, 0], -vg[:, 1:]
        return v, g if mask is None else g * mask

    hist_s, hist_y, hist_rho = x.new_zeros(rows, memory_size, p), x.new_zeros(rows, memory_size, p), x.new_zeros(rows, memory_size)
    x_prev, g_prev = torch.zeros_like(x), torch.zeros_like(x)
    ls_value, ls_grad = torch.full((rows,), math.inf, dtype=x.dtype, device=x.device), torch.zeros_like(x)
    value, gmax = x.new_zeros(rows), torch.full((rows,), math.inf, dtype=x.dtype, device=x.device)
    steps = torch.zeros(rows, dtype=torch.int64, device=x.device)
    stalled = torch.zeros(rows, dtype=torch.bool, device=x.device)
    restart = torch.zeros_like(stalled)
    active = torch.full((rows,), iters > 0, dtype=torch.bool, device=x.device)
    step = 0
    while bool(active.any()):
        reuse = torch.isfinite(ls_value)
        if bool((active & ~reuse).any()):
            f_fresh, g_fresh = objective(x)
            f, g = torch.where(reuse, ls_value, f_fresh), torch.where(reuse[:, None], ls_grad, g_fresh)
        else:
            f, g = ls_value, ls_grad
        if mask is not None:
            g = g * mask
        # the memory: the last step's pair, newest last
        s, y = x - x_prev, g - g_prev
        sy, yy = (s * y).sum(-1), (y * y).sum(-1)
        rho = torch.where(sy == 0.0, 0.0, 1.0 / sy)
        if step == 0:
            s, y, rho = torch.zeros_like(s), torch.zeros_like(y), torch.zeros_like(rho)
        # the identity's scale; on the first step, and where a row restarts
        # after a failed search (its memory cleared), min(1, 1/|g|)
        gamma = torch.where(restart | (step == 0), torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0),
                            torch.where(yy > 0.0, sy / yy, 1.0))
        keep = (~restart)[:, None, None]
        hist_s, hist_y, hist_rho = hist_s * keep, hist_y * keep, hist_rho * keep[:, :, 0]
        on = active[:, None, None]
        hist_s = torch.where(on, torch.cat([hist_s[:, 1:], s[:, None]], 1), hist_s)
        hist_y = torch.where(on, torch.cat([hist_y[:, 1:], y[:, None]], 1), hist_y)
        hist_rho = torch.where(active[:, None], torch.cat([hist_rho[:, 1:], rho[:, None]], 1), hist_rho)
        # the two-loop recursion, newest pair first
        q, alphas = g, [None] * memory_size
        for i in range(memory_size - 1, -1, -1):
            alphas[i] = hist_rho[:, i] * (hist_s[:, i] * q).sum(-1)
            q = q - alphas[i][:, None] * hist_y[:, i]
        q = gamma[:, None] * q
        for i in range(memory_size):
            beta = hist_rho[:, i] * (hist_y[:, i] * q).sum(-1)
            q = q + (alphas[i] - beta)[:, None] * hist_s[:, i]
        d = -q
        x_prev = torch.where(active[:, None], x, x_prev)
        g_prev = torch.where(active[:, None], g, g_prev)
        t, v_ls, g_ls = _zoom_linesearch(objective, x, d, f, g, active)
        # a zero step leaves x as it is: in float32 a curvature pair with
        # s.y below 1e-38 overflows its weight and the direction is NaN,
        # where optax's 0 * d would make x NaN
        update = torch.where(t[:, None] == 0.0, 0.0, t[:, None] * d)
        step += 1
        on = active[:, None]
        x = torch.where(on, x + update, x)
        ls_value, ls_grad = torch.where(active, v_ls, ls_value), torch.where(on, g_ls, ls_grad)
        value = torch.where(active, f, value)
        gmax = torch.where(active, _row_gmax(g), gmax)
        # no step: the first time the row restarts, the second it stalls
        still = _row_gmax(update) <= 0.0
        stalled = torch.where(active, still & restart, stalled)
        restart = torch.where(active, still & ~restart, restart)
        steps = steps + active
        active = active & (steps < iters) & (gmax >= threshold) & ~stalled
    converged = gmax < threshold
    return OptResult(*(a.to(device) for a in (x, -value, steps, converged, stalled & ~converged)))
