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
- `_Lanes.step`: one step of `zoom_linesearch` (optax/_src/linesearch.py:
  576-1283, `_cubicmin` / `_quadmin` :455-519): an interval search that
  doubles the step from 1, then a zoom by cubic, quadratic or bisection
  steps with their safeguards; the strong-Wolfe criteria with Hager-Zhang's
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
and its state kept, bit for bit, as vmap's select keeps it.

The run is the counterpart of the JAX package's one jitted while_loop: its
state lives in tensors allocated once per run (`_Lanes`: the lanes (L, d),
the ring (10, L, d), the line search's fields, the step counts), and four
pieces read and write only those: `fresh` (the value and gradient
recomputed where not finite), `prologue` (the preconditioned direction and
the line search's start), `step` (one line-search step: every lane's trial
point, one evaluation, the interval / zoom / safe-step selection) and
`epilogue` (the iterate, the stop rule, the statistics). On the card each
piece is replayed from its own CUDA graph (fit/graphs.py::Steps: two eager
runs, one capture, then replays); on the CPU the same pieces run eagerly.
The host keeps only the loop exits, as the JAX loop's `cond`: one read per
line-search step (any lane still searching) and one per iteration (any
lane active, any value not finite). Each reads values derived from `fun`'s
values and gradients alone, so ranks that all-reduce them take the same
branches. A `fun` whose collectives cannot be captured (gloo) runs its
pieces eagerly on the card, decided up front by parallel/sharding.py::
capture_rule.

optax is Apache 2.0, like this repository.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mobocmf_tpu_torch.fit import graphs
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util.profiling import span

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5  # the zoom's interval_threshold

# the last lbfgs_lanes run: iterations (the longest lane's) and per lane,
# value-and-gradient calls (`fresh` of them recomputing a non-finite value),
# line-search steps per lane and iteration (max, mean), how the lanes ended
# (at gtol or at maxiter; with at least one failed line search; on a point
# that is not finite), and how the pieces ran (captured, why, the captures'
# seconds, the graphs' replays)
last_stats: dict = {}


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


class Memory(NamedTuple):
    """scale_by_lbfgs's state for L lanes: the step count (one for every
    lane still running, a (1,) int64 tensor), the last params and gradients
    (L, d), and the ring of parameter and gradient differences (m, L, d)
    with their weights (m, L). `precondition` updates it in place."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor


def init_memory(z: torch.Tensor) -> Memory:
    ring = torch.zeros((MEMORY_SIZE,) + tuple(z.shape), dtype=z.dtype, device=z.device)
    return Memory(torch.zeros((1,), dtype=torch.int64, device=z.device), torch.zeros_like(z),
                  torch.zeros_like(z), ring, ring.clone(),
                  torch.zeros((MEMORY_SIZE, z.shape[0]), dtype=z.dtype, device=z.device))


def precondition(grad: torch.Tensor, z: torch.Tensor, mem: Memory) -> Tuple[torch.Tensor, Memory]:
    """scale_by_lbfgs(scale_init_precond=True).update(grad, mem, z): stores
    the newest pair, then returns P_k grad (the two-loop product) and the
    memory, updated in place. The ring position is read on the device: the
    ring is gathered oldest first, so the two loops run over fixed slots in
    optax's order."""
    size = mem.weights.shape[0]
    first = mem.count == 0
    zeros = torch.zeros_like(z)
    diff_params = torch.where(first, zeros, z - mem.params)
    diff_updates = torch.where(first, zeros, grad - mem.updates)
    sy = _vdot(diff_updates, diff_params)
    weight = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
    yy = _vdot(diff_updates, diff_updates)
    gamma = torch.where(first, torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad)), max=1.0),
                        torch.where(yy > 0.0, sy / yy, torch.ones_like(sy)))
    newest = (mem.count - 1) % size
    mem.diff_params.index_copy_(0, newest, diff_params[None])
    mem.diff_updates.index_copy_(0, newest, diff_updates[None])
    mem.weights.index_copy_(0, newest, weight[None])

    order = (mem.count + torch.arange(size, device=z.device)) % size  # oldest to newest
    dps, dus, ws = (t.index_select(0, order) for t in (mem.diff_params, mem.diff_updates,
                                                        mem.weights))
    vec, alphas = grad, [None] * size
    for i in reversed(range(size)):  # newest to oldest
        alphas[i] = ws[i] * _vdot(dps[i], vec)
        vec = vec + (-alphas[i])[:, None] * dus[i]
    vec = gamma[:, None] * vec
    for i in range(size):  # oldest to newest
        beta = ws[i] * _vdot(dus[i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * dps[i]
    mem.count.add_(1)
    mem.params.copy_(z)
    mem.updates.copy_(grad)
    return vec, mem


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
    updates, value_init and slope_init are the run's z, updates, value and
    slope_init)."""

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


def _assign(dst, src) -> None:
    """Copy each tensor of `src` into the buffer of `dst` in its place."""
    for d, s in zip(dst, src):
        d.copy_(s)


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


class _Lanes:
    """One lbfgs_lanes run: its state in tensors allocated once and the four
    pieces (module docstring), each a closure with no arguments that reads
    and writes only those tensors. `flags` holds, for the host, whether any
    lane is active and whether any value is not finite (set at the start
    and by the epilogue); `searching`, whether any lane is still in its line
    search (set by each step)."""

    PIECES = ("fresh", "prologue", "step", "epilogue")

    def __init__(self, fun: Callable[[torch.Tensor], torch.Tensor], z0: torch.Tensor,
                 gtol: Optional[float]):
        self.fun, self.gtol = fun, gtol
        z = self.z = z0.detach().clone()
        lanes, dev = z.shape[0], z.device
        self.mem = init_memory(z)
        # the line search's last value and gradient (optax's init: inf, 0)
        self.value = torch.full((lanes,), float("inf"), dtype=z.dtype, device=dev)
        self.grad = torch.zeros_like(z)
        self.grad_prev = torch.full_like(z, float("inf"))  # the loop's carry: one iteration at least
        self.active = torch.ones(lanes, dtype=torch.bool, device=dev)
        self.updates = torch.zeros_like(z)
        self.slope_init = torch.zeros_like(self.value)
        self.search = _Search(*(t.clone() for t in self._search_start()))
        long = dict(dtype=torch.int64, device=dev)
        self.steps = torch.zeros(lanes, **long)  # this iteration's line-search steps per lane
        self.ls_count = torch.zeros((1,), **long)  # the line search's step number
        self.lane_iterations = torch.zeros(lanes, **long)
        self.ls_failed = torch.zeros_like(self.active)
        self.ls_steps_sum = torch.zeros((1,), **long)
        self.ls_steps_max = torch.zeros((1,), **long)
        self.searching = torch.zeros((1,), dtype=torch.bool, device=dev)
        self.flags = torch.zeros((2,), dtype=torch.bool, device=dev)
        self._set_flags()

    def _set_flags(self) -> None:
        self.flags.copy_(torch.stack([self.active.any(), (~torch.isfinite(self.value)).any()]))

    def _search_start(self) -> _Search:
        value, zero = self.value, torch.zeros_like(self.value)
        no = torch.zeros_like(self.active)
        return _Search(
            stepsize=zero, value=value, grad=self.grad, slope=self.slope_init,
            decrease_error=torch.full_like(value, float("inf")), interval_found=no,
            done=~self.active, failed=no, low=zero, value_low=value, slope_low=self.slope_init,
            high=zero, value_high=value, slope_high=self.slope_init, cubic_ref=zero,
            value_cubic_ref=value, safe_stepsize=zero, safe_value=value, safe_grad=self.grad)

    def _value_and_grad(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = self.fun(zz)
            (g,) = torch.autograd.grad(torch.sum(v), zz)
        return v.detach(), g

    def fresh(self) -> None:
        """value_and_grad_from_state: recomputed where the value is not finite."""
        fresh = ~torch.isfinite(self.value)
        v, g = self._value_and_grad(self.z)
        self.value.copy_(torch.where(fresh, v, self.value))
        self.grad.copy_(_where(fresh, g, self.grad))

    def prologue(self) -> None:
        """The direction -P_k grad (the ring keeps its own copy of the
        iterate) and the line search's start: step 0 from the iterate."""
        direction, _ = precondition(self.grad, self.z.clone(), self.mem)
        self.updates.copy_(-direction)
        self.slope_init.copy_(_vdot(self.updates, self.grad))
        _assign(self.search, self._search_start())
        self.steps.zero_()
        self.ls_count.zero_()

    def step(self) -> None:
        """One zoom line-search step for every lane still searching; the
        others are evaluated at the iterate and kept."""
        st, z, updates = self.search, self.z, self.updates
        value, slope_init, count = self.value, self.slope_init, self.ls_count
        going = ~(st.done | st.failed)
        # each lane's trial step: its interval search's (1, then doubling)
        # or its zoom's
        grown = torch.where(count == 0, torch.ones_like(value), INCREASE_FACTOR * st.stepsize)
        middle = _zoom_middle(st)
        t = torch.where(st.interval_found, middle, grown)
        v, g = self._value_and_grad(_where(going, z + t[:, None] * updates, z))
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
            interval_found=found, done=done, failed=last & ~done,
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
        _assign(st, new.select(going, st))
        self.steps.add_(going.to(self.steps.dtype))
        count.add_(1)
        self.searching.copy_(torch.any(~(st.done | st.failed)).reshape(1))

    def epilogue(self) -> None:
        """The lanes' new iterates, value and gradient (where active), the
        statistics, then the stop rule for the next iteration."""
        st, active, z = self.search, self.active, self.z
        self.grad_prev.copy_(_where(active, self.grad, self.grad_prev))
        z.copy_(_where(active, z + st.stepsize[:, None] * self.updates, z))
        self.value.copy_(torch.where(active, st.value, self.value))
        self.grad.copy_(_where(active, st.grad, self.grad))
        self.lane_iterations.add_(active.to(self.lane_iterations.dtype))
        self.ls_failed.logical_or_(st.failed & active)
        self.ls_steps_sum.add_(self.steps.sum())
        self.ls_steps_max.copy_(torch.maximum(self.ls_steps_max, self.steps.amax(0, keepdim=True)))
        if self.gtol is not None:
            active.logical_and_(torch.amax(torch.abs(self.grad_prev), dim=-1) > self.gtol)
        self._set_flags()

    def stats(self) -> dict:
        """The run's statistics, read from the device at once."""
        lanes = self.z.shape[0]
        if self.gtol is not None:
            at_gtol = torch.amax(torch.abs(self.grad_prev), dim=-1) <= self.gtol
        else:
            at_gtol = torch.zeros_like(self.active)
        nonfinite = ~torch.isfinite(self.z).all(dim=-1)
        read = torch.cat([self.lane_iterations, self.ls_steps_sum, self.ls_steps_max,
                          torch.stack([self.ls_failed.sum(), at_gtol.sum(), nonfinite.sum()])])
        read = read.tolist()
        lane_iterations, (steps_sum, steps_max, failed, gtol, nonfinite) = (
            read[:lanes], read[lanes:])
        return dict(
            iterations=max(lane_iterations, default=0), lane_iterations=lane_iterations,
            ls_steps_max=steps_max, ls_steps_mean=steps_sum / max(sum(lane_iterations), 1),
            lanes=lanes, at_gtol=gtol, at_maxiter=lanes - gtol, failed_searches=failed,
            nonfinite=nonfinite)


# each piece's run is a span of this name (util/profiling.py), the host's
# reads of `flags` and `searching` are `lbfgs.read` spans
SPANS = {name: f"lbfgs.{name}" for name in _Lanes.PIECES}


def lbfgs_lanes(
    fun: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    maxiter: int,
    gtol: Optional[float] = None,
    collectives=None,
) -> torch.Tensor:
    """Minimize each lane of fun: (L, d) -> (L,) from z0 (L, d) by
    optax.lbfgs(), as the JAX package's loop runs it (module docstring).
    gtol=None: every lane runs exactly `maxiter` iterations. collectives:
    the mesh or group whose collectives `fun` runs (None: none), from which
    capture_rule decides whether the pieces are captured on the card.
    Returns the final iterates; `last_stats` describes the run."""
    global last_stats
    run = _Lanes(fun, z0, gtol)
    capture, reason = sharding.capture_rule(collectives)
    pieces = {name: graphs.Steps(getattr(run, name), z0.device, capture=capture,
                                 capture_reason=reason) for name in _Lanes.PIECES}

    def piece(name: str) -> None:
        with span(SPANS[name]):
            pieces[name].run(1)

    evaluations = fresh = 0
    try:
        for _ in range(maxiter):
            with span("lbfgs.read"):
                any_active, any_nonfinite = run.flags.tolist()
            if not any_active:
                break
            if any_nonfinite:
                piece("fresh")
                evaluations, fresh = evaluations + 1, fresh + 1
            piece("prologue")
            for _ in range(MAX_LINESEARCH_STEPS):  # every lane is done or failed by the last
                piece("step")
                evaluations += 1
                with span("lbfgs.read"):
                    searching = bool(run.searching)
                if not searching:
                    break
            piece("epilogue")
        stats = run.stats()
    finally:
        for p in pieces.values():
            p.close()
    captured = capture and z0.device.type == "cuda"
    last_stats = dict(
        stats, evaluations=evaluations, fresh=fresh, captured=captured,
        capture_reason=reason if z0.device.type == "cuda" else "the CPU runs the pieces eagerly",
        capture_seconds=sum(p.capture_seconds for p in pieces.values()),
        replays=sum(p.replays for p in pieces.values()))
    return run.z
