"""L-BFGS over independent lanes: a port of optax 0.2.6's `optax.lbfgs()`,
the optimizer of the JAX package's searches and device polish
(mobocmf_tpu/acquisition/optimize.py, mobocmf_tpu/moop/moop.py).

optax.lbfgs() (optax/_src/alias.py:2591) chains
`scale_by_lbfgs(memory_size=10, scale_init_precond=True)`, `scale(-1)` and
`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`. This module follows, line for line:
- `precondition`: `scale_by_lbfgs`'s update and `_precondition_by_lbfgs`
  (optax/_src/transform.py:1497-1570, 1640-1745): every pair is stored
  with weight 1/(s.y) (0 only where s.y == 0) in a ring of 10 slots read
  in optax's order; gamma = s.y / y.y of the newest pair (1 where y.y is
  0), and min(1, 1 / ||g||_2) at the first step;
- `zoom_linesearch`: `zoom_linesearch` (optax/_src/linesearch.py:576-1283,
  `_cubicmin` / `_quadmin` :455-519): an interval search that doubles the
  step from 1, then a zoom by cubic, quadratic or bisection steps with
  their safeguards; the strong-Wolfe criteria with Hager-Zhang's
  approximate decrease (slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol
  1e-6, tol 0); a safe step (the best point with sufficient decrease); and
  after 20 steps, or once the interval is under 1e-5 with a safe step in
  hand, the safe step, or else the last step tried (`_try_safe_step`);
- `lbfgs_lanes`: the JAX package's loop around `optax.lbfgs()`
  (mobocmf_tpu/acquisition/optimize.py:66-84): the value and gradient are
  those the line search ended on (`optax.value_and_grad_from_state`,
  recomputed where that value is not finite), and a lane stops once the
  gradient of the previous body satisfies max|g| <= gtol (one step late,
  as the JAX loop's carry) or after `maxiter` iterations; without gtol
  every lane runs `maxiter` iterations (the polish's lax.scan).

Every lane is one of `vmap`'s: it keeps its own memory and line-search
state, and the lanes of a step are evaluated together, one call of `fun`
on all (L, d) points and one backward of the lanes' sum (`fun` must not
couple lanes). A lane that is not searching is evaluated at its own point
and its state kept, bit for bit, as vmap's select keeps it. Every branch
on the host reads values derived from `fun`'s values and gradients alone,
so ranks that all-reduce them take the same branches.

optax is Apache 2.0, like this repository.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5  # the zoom's interval_threshold

# the last lbfgs_lanes run: iterations (the longest lane's) and per lane,
# value-and-gradient calls, line-search steps per lane and iteration (max,
# mean), and how the lanes ended (at gtol or at maxiter; with at least one
# failed line search; on a point that is not finite)
last_stats: dict = {}


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


class Memory(NamedTuple):
    """scale_by_lbfgs's state for L lanes: the step count (one for every
    lane still running), the last params and gradients (L, d), and the ring
    of parameter and gradient differences (m, L, d) with their weights
    (m, L)."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor


def init_memory(z: torch.Tensor) -> Memory:
    ring = torch.zeros((MEMORY_SIZE,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    return Memory(0, torch.zeros_like(z), torch.zeros_like(z), ring, ring.clone(),
                  torch.zeros((MEMORY_SIZE, z.shape[0]), dtype=z.dtype, device=z.device))


def precondition(grad: torch.Tensor, z: torch.Tensor, mem: Memory) -> Tuple[torch.Tensor, Memory]:
    """scale_by_lbfgs(scale_init_precond=True).update(grad, mem, z): stores
    the newest pair, then returns P_k grad (the two-loop product) and the
    new memory."""
    size = mem.weights.shape[0]
    memory_idx, prev_idx = mem.count % size, (mem.count - 1) % size
    if mem.count > 0:
        diff_params, diff_updates = z - mem.params, grad - mem.updates
        sy = _vdot(diff_updates, diff_params)
        weight = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
        yy = _vdot(diff_updates, diff_updates)
        gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
    else:
        diff_params, diff_updates = torch.zeros_like(z), torch.zeros_like(z)
        weight = torch.zeros_like(z[:, 0])
        gamma = torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad)), max=1.0)
    dps, dus, ws = mem.diff_params.clone(), mem.diff_updates.clone(), mem.weights.clone()
    dps[prev_idx], dus[prev_idx], ws[prev_idx] = diff_params, diff_updates, weight

    order = [(memory_idx + i) % size for i in range(size)]
    vec, alphas = grad, {}
    for i in reversed(order):  # newest to oldest
        alphas[i] = ws[i] * _vdot(dps[i], vec)
        vec = vec + (-alphas[i])[:, None] * dus[i]
    vec = gamma[:, None] * vec
    for i in order:  # oldest to newest
        beta = ws[i] * _vdot(dus[i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * dps[i]
    return vec, Memory(mem.count + 1, z, grad, dps, dus, ws)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin: the critical point of the cubic through (a, fa),
    (b, fb), (c, fc) with slope fpa at a (NaN where there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    u, w = fb - fa - fpa * db, fc - fa - fpa * dc
    cub_a = (dc * dc * u + (-(db * db)) * w) / denom
    cub_b = ((-(dc * (dc * dc))) * u + db * (db * db) * w) / denom
    radical = cub_b * cub_b - 3.0 * cub_a * fpa
    return a + (-cub_b + torch.sqrt(radical)) / (3.0 * cub_a)


def _quadmin(a, fa, fpa, b, fb):
    """optax's _quadmin: the critical point of the quadratic through (a, fa),
    (b, fb) with slope fpa at a."""
    db = b - a
    quad_b = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * quad_b)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    armijo = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    approx = torch.maximum(approx, value - value_init - APPROX_DEC_RTOL * torch.abs(value_init))
    err = torch.clamp(torch.minimum(approx, armijo), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)


def _where(cond, new, old):
    """Per lane: `new` where cond, else `old`, for (L,) or (L, d) tensors."""
    return torch.where(cond if new.dim() == 1 else cond[:, None], new, old)


class _Search(NamedTuple):
    """zoom_linesearch's ZoomLinesearchState for L lanes (the fixed params,
    updates, value_init and slope_init are arguments of the steps)."""

    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    decrease_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor

    def select(self, cond, other: "_Search") -> "_Search":
        return _Search(*[_where(cond, a, b) for a, b in zip(self, other)])


def _zoom_middle(st: _Search) -> torch.Tensor:
    """The zoom's next trial step: the cubic's minimizer if it lies inside
    the interval by 0.2 of its length, else the quadratic's (0.1), else the
    midpoint."""
    delta = torch.abs(st.high - st.low)
    left, right = torch.minimum(st.high, st.low), torch.maximum(st.high, st.low)
    cubic = _cubicmin(st.low, st.value_low, st.slope_low, st.high, st.value_high,
                      st.cubic_ref, st.value_cubic_ref)
    use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
    quad = _quadmin(st.low, st.value_low, st.slope_low, st.high, st.value_high)
    use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)
    middle = torch.where(use_cubic, cubic, st.cubic_ref)
    middle = torch.where(use_quad, quad, middle)
    return torch.where(~use_cubic & ~use_quad, (st.low + st.high) / 2.0, middle)


def zoom_linesearch(
    value_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    z: torch.Tensor,
    updates: torch.Tensor,
    value: torch.Tensor,
    grad: torch.Tensor,
    searching: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """optax's zoom line search along `updates` from z (L, d), with value
    (L,) and grad (L, d) there, for the lanes where `searching`; every step
    evaluates all lanes in one value_and_grad call. Returns per lane the
    stepsize, value and gradient it ended on, its steps and whether it
    failed (the safe step or the last step tried was taken)."""
    lanes = z.shape[0]
    zero = torch.zeros_like(value)
    slope_init = _vdot(updates, grad)
    inf = torch.full_like(value, float("inf"))
    st = _Search(
        stepsize=zero, value=value, grad=grad, slope=slope_init, decrease_error=inf,
        interval_found=torch.zeros(lanes, dtype=torch.bool, device=z.device),
        done=~searching, failed=torch.zeros(lanes, dtype=torch.bool, device=z.device),
        low=zero, value_low=value, slope_low=slope_init, high=zero, value_high=value,
        slope_high=slope_init, cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
        safe_value=value, safe_grad=grad,
    )
    steps = torch.zeros(lanes, dtype=torch.long, device=z.device)
    count = 0
    while True:
        going = ~(st.done | st.failed)
        if not bool(going.any()):
            break
        # each lane's trial step: its interval search's (1, then doubling)
        # or its zoom's
        grown = torch.full_like(value, 1.0) if count == 0 else INCREASE_FACTOR * st.stepsize
        middle = _zoom_middle(st)
        t = torch.where(st.interval_found, middle, grown)
        v, g = value_and_grad(_where(going, z + t[:, None] * updates, z))
        slope = _vdot(g, updates)
        dec = _decrease_error(t, v, slope, value, slope_init)
        err = torch.maximum(dec, _curvature_error(slope, slope_init))
        done = err <= 0.0
        last = count + 1 >= MAX_LINESEARCH_STEPS
        safe_decrease = dec <= 0.0

        # the interval search (Algorithm 3.5 of Nocedal and Wright)
        set_high = (dec > 0.0) | ((v >= st.value) & (count > 0))
        set_low = (slope >= 0.0) & ~set_high
        low = torch.where(set_low, t, st.stepsize)
        value_low = torch.where(set_low, v, st.value)
        slope_low = torch.where(set_low, slope, st.slope)
        found = set_high | set_low | done
        interval = _Search(
            stepsize=t, value=v, grad=g, slope=slope, decrease_error=dec,
            interval_found=found, done=done, failed=torch.full_like(done, last) & ~done,
            low=low, value_low=value_low, slope_low=slope_low,
            high=torch.where(set_low, st.stepsize, t), value_high=torch.where(set_low, st.value, v),
            slope_high=torch.where(set_low, st.slope, slope), cubic_ref=low,
            value_cubic_ref=value_low,
            safe_stepsize=torch.where(safe_decrease, t, st.safe_stepsize),
            safe_value=torch.where(safe_decrease, v, st.safe_value),
            safe_grad=_where(safe_decrease, g, st.safe_grad),
        )

        # the zoom (Algorithm 3.6)
        to_safe = safe_decrease & (v < st.safe_value)
        new_safe = torch.where(to_safe, t, st.safe_stepsize)
        high_to_middle = (dec > 0.0) | (v >= st.value_low)
        high_to_low = (slope * (st.high - st.low) >= 0.0) & ~high_to_middle
        low_to_middle = ~high_to_middle

        def high_of(mid, at_low, at_high):
            return torch.where(high_to_low, at_low, torch.where(high_to_middle, mid, at_high))

        moved_high = high_to_middle | high_to_low
        too_small = torch.abs(st.high - st.low) <= STEPSIZE_PRECISION
        zoom = _Search(
            stepsize=t, value=v, grad=g, slope=slope, decrease_error=dec,
            interval_found=st.interval_found, done=done,
            failed=(last | (too_small & (new_safe > 0.0))) & ~done,
            low=torch.where(low_to_middle, t, st.low),
            value_low=torch.where(low_to_middle, v, st.value_low),
            slope_low=torch.where(low_to_middle, slope, st.slope_low),
            high=high_of(t, st.low, st.high), value_high=high_of(v, st.value_low, st.value_high),
            slope_high=high_of(slope, st.slope_low, st.slope_high),
            cubic_ref=torch.where(moved_high, st.high, st.low),
            value_cubic_ref=torch.where(moved_high, st.value_high, st.value_low),
            safe_stepsize=new_safe, safe_value=torch.where(to_safe, v, st.safe_value),
            safe_grad=_where(to_safe, g, st.safe_grad),
        )
        new = zoom.select(st.interval_found, interval)

        # a failed search ends on its safe step, or (none, and still in
        # the domain) on the last step tried
        use_safe = new.failed & ((new.safe_stepsize > 0.0) | torch.isinf(new.decrease_error))
        new = new._replace(
            stepsize=torch.where(use_safe, new.safe_stepsize, new.stepsize),
            value=torch.where(use_safe, new.safe_value, new.value),
            grad=_where(use_safe, new.safe_grad, new.grad),
        )
        st = new.select(going, st)
        steps = steps + going.to(steps.dtype)
        count += 1
    return st.stepsize, st.value, st.grad, steps, st.failed


def lbfgs_lanes(
    fun: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    maxiter: int,
    gtol: Optional[float] = None,
) -> torch.Tensor:
    """Minimize each lane of fun: (L, d) -> (L,) from z0 (L, d) by
    optax.lbfgs(), as the JAX package's loop runs it (module docstring).
    gtol=None: every lane runs exactly `maxiter` iterations. Returns the
    final iterates; `last_stats` describes the run."""
    global last_stats
    lanes = z0.shape[0]
    evaluations = 0

    def value_and_grad(z):
        nonlocal evaluations
        evaluations += 1
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = fun(zz)
            (g,) = torch.autograd.grad(torch.sum(v), zz)
        return v.detach(), g

    z = z0.detach().clone()
    mem = init_memory(z)
    # the line search's last value and gradient (optax's init: inf, 0)
    value = torch.full((lanes,), float("inf"), dtype=z.dtype, device=z.device)
    grad = torch.zeros_like(z)
    grad_prev = torch.full_like(z, float("inf"))  # the loop's carry: at least one iteration
    active = torch.ones(lanes, dtype=torch.bool, device=z.device)
    lane_iterations = torch.zeros(lanes, dtype=torch.long, device=z.device)
    ls_failed = torch.zeros_like(active)
    ls_steps_sum, ls_steps_max = 0, 0
    for _ in range(maxiter):
        if gtol is not None:
            active = active & (torch.amax(torch.abs(grad_prev), dim=-1) > gtol)
            if not bool(active.any()):
                break
        fresh = ~torch.isfinite(value)
        if bool(fresh.any()):  # value_and_grad_from_state: recomputed where not finite
            v0, g0 = value_and_grad(z)
            value, grad = torch.where(fresh, v0, value), _where(fresh, g0, grad)
        direction, mem = precondition(grad, z, mem)
        updates = -direction
        t, v, g, steps, failed = zoom_linesearch(value_and_grad, z, updates, value, grad, active)
        z = _where(active, z + t[:, None] * updates, z)
        grad_prev = _where(active, grad, grad_prev)
        value, grad = torch.where(active, v, value), _where(active, g, grad)
        lane_iterations += active.to(lane_iterations.dtype)
        ls_failed |= failed & active
        ls_steps_sum += int(steps.sum())
        ls_steps_max = max(ls_steps_max, int(steps.max()))
    at_gtol = (torch.amax(torch.abs(grad_prev), dim=-1) <= gtol if gtol is not None
               else torch.zeros_like(active))
    iterations = int(lane_iterations.max()) if lanes else 0
    last_stats = dict(
        iterations=iterations, lane_iterations=lane_iterations.tolist(), evaluations=evaluations,
        ls_steps_max=ls_steps_max,
        ls_steps_mean=ls_steps_sum / max(int(lane_iterations.sum()), 1),
        lanes=lanes, at_gtol=int(at_gtol.sum()), at_maxiter=int((~at_gtol).sum()),
        failed_searches=int(ls_failed.sum()),
        nonfinite=int((~torch.isfinite(z).all(dim=-1)).sum()),
    )
    return z
