"""Multi-start acquisition maximization over the unit box
(counterpart of mobocmf_tpu/acquisition/optimize.py).

Replaces botorch's optimize_acqf(q=1, num_restarts=5, raw_samples=200,
options={"maxiter": 200}) of the reference acquisitions
(JESMOC_MFDGP.py:159-160), as the JAX package does:
1. score `raw_samples` uniform points, without gradients (so each model's
   layer 0 runs through K2, models/mfdgp.py::uses_k2);
2. take the top `num_restarts` per surface as starts (deterministic top-k);
3. run L-BFGS in the unconstrained box x = sigmoid(z), every start of every
   surface as one lane of ONE batched L-BFGS: the lanes' objectives are
   independent, so one evaluation and one backward of their sum give every
   lane its own value and gradient. Each lane keeps its own curvature pairs
   and its own backtracking (Armijo) line search of at most 20 halvings
   (optax.lbfgs' max_linesearch_steps), and stops as the JAX package's
   loop does: once max|g| <= gtol (scipy L-BFGS-B's pgtol contract) or
   after `maxiter` iterations. A lane whose line search finds no decrease
   keeps its point and its curvature pairs, so every later iteration would
   repeat the same search: it is stopped at once, with the point the cap
   would return;
4. return the best point seen per surface, the raw screening values
   included as a floor (a failed line search cannot regress).
The trial steps of a line search are evaluated together, `trials` of them
per call (all 21 on the card, where an evaluation costs its launches, not
its points; one at a time on the CPU). The first trial that passes Armijo
is taken either way, so the iterates do not depend on `trials` (up to the
rounding of evaluations batched at another size). They differ
from optax's L-BFGS (zoom line search); the values are what the tests
compare. `last_stats` holds the iterations and evaluations of the last run.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

_HISTORY = 10  # curvature pairs kept per lane (optax.lbfgs' memory_size)
_ARMIJO = 1e-4
_STEPS = 21  # trial steps t, t/2, ..., t/2^20 (optax's max_linesearch_steps = 20)

# the last batched_lbfgs run: iterations, value-and-gradient calls, and how
# its lanes ended (at gtol, at maxiter, on a line search with no decrease)
last_stats: dict = {}


def _logit(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


def _two_loop(g, s_hist, y_hist, rho, gamma):
    """L-BFGS direction -H g per lane; pairs with rho = 0 are skipped."""
    q = g.clone()
    alphas = []
    for i in range(len(s_hist) - 1, -1, -1):
        a = rho[i] * torch.sum(s_hist[i] * q, dim=-1)
        q = q - a[:, None] * y_hist[i]
        alphas.append(a)
    r = gamma[:, None] * q
    for i, a in zip(range(len(s_hist)), reversed(alphas)):
        beta = rho[i] * torch.sum(y_hist[i] * r, dim=-1)
        r = r + s_hist[i] * (a - beta)[:, None]
    return -r


def batched_lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    maxiter: int,
    gtol: float,
    trials: Optional[int] = None,
) -> torch.Tensor:
    """Minimize each lane of fun: (..., L, d) -> (..., L) independently
    from z0 (L, d); fun must not couple lanes. trials: line-search steps
    per evaluation (default: all on CUDA, 1 elsewhere). Returns the final
    iterates."""
    global last_stats
    lanes = z0.shape[0]
    lane = torch.arange(lanes, device=z0.device)
    if trials is None:
        trials = _STEPS if z0.device.type == "cuda" else 1
    halvings = 0.5 ** torch.arange(_STEPS, dtype=z0.dtype, device=z0.device)
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
    v, g = value_and_grad(z)
    active = torch.ones(lanes, dtype=torch.bool, device=z.device)
    stuck = torch.zeros_like(active)
    s_hist, y_hist, rho = [], [], []
    gamma = torch.ones(lanes, dtype=z.dtype, device=z.device)
    iterations = 0
    for it in range(maxiter):
        if it > 0:  # at least one iteration, as the JAX loop
            active = active & (torch.amax(torch.abs(g), dim=-1) > gtol)
            if not bool(active.any()):
                break
        iterations += 1
        p = _two_loop(g, s_hist, y_hist, rho, gamma)
        slope = torch.sum(g * p, dim=-1)
        descent = slope < 0
        p = torch.where(descent[:, None], p, -g)
        slope = torch.where(descent, slope, -torch.sum(g * g, dim=-1))
        if not s_hist:  # first step: at most a unit move in the largest coordinate
            t = torch.clamp(1.0 / torch.amax(torch.abs(g), dim=-1).clamp(min=1e-30), max=1.0)
        else:
            t = torch.ones(lanes, dtype=z.dtype, device=z.device)
        # backtracking: a lane keeps the first of t, t/2, ... that passes Armijo
        done = ~active
        z_new, v_new, g_new = z.clone(), v.clone(), g.clone()
        for k0 in range(0, _STEPS, trials):
            tk = t * halvings[k0 : k0 + trials, None]  # (k, L)
            zt = z + tk[..., None] * p  # (k, L, d)
            vt, gt = value_and_grad(zt)
            ok = (vt <= v + _ARMIJO * tk * slope) & torch.isfinite(vt) & ~done
            first = torch.argmax(ok.to(z.dtype), dim=0)  # the first passing trial
            take = ok.any(dim=0)
            z_new = torch.where(take[:, None], zt[first, lane], z_new)
            v_new = torch.where(take, vt[first, lane], v_new)
            g_new = torch.where(take[:, None], gt[first, lane], g_new)
            done = done | take
            if bool(done.all()):
                break
        moved = active & done
        stuck = stuck | (active & ~done)
        s = torch.where(moved[:, None], z_new - z, torch.zeros_like(z))
        y = torch.where(moved[:, None], g_new - g, torch.zeros_like(g))
        sy = torch.sum(s * y, dim=-1)
        curv = sy > 1e-10
        s_hist.append(s)
        y_hist.append(y)
        rho.append(torch.where(curv, 1.0 / torch.where(curv, sy, torch.ones_like(sy)),
                               torch.zeros_like(sy)))
        yy = torch.sum(y * y, dim=-1)
        gamma = torch.where(curv, sy / torch.where(curv, yy, torch.ones_like(yy)), gamma)
        if len(s_hist) > _HISTORY:
            s_hist.pop(0), y_hist.pop(0), rho.pop(0)
        z = torch.where(moved[:, None], z_new, z)
        v = torch.where(moved, v_new, v)
        g = torch.where(moved[:, None], g_new, g)
        # a lane with no decrease is unchanged and would repeat this search
        # every later iteration: it has its final point
        active = moved
    at_gtol = torch.amax(torch.abs(g), dim=-1) <= gtol
    last_stats = dict(
        iterations=iterations, evaluations=evaluations, lanes=lanes,
        at_gtol=int(at_gtol.sum()), stuck=int((stuck & ~at_gtol).sum()),
        at_maxiter=int((active & ~at_gtol).sum()),
    )
    return z


def optimize_acqf_box_multi(
    acq_all_fn: Callable[[torch.Tensor], torch.Tensor],
    n_out: int,
    input_dim: int,
    generator: Optional[torch.Generator],
    num_restarts: int = 5,
    raw_samples: int = 200,
    maxiter: int = 200,
    gtol: float = 1e-5,
    dtype: torch.dtype = torch.float64,
    device=None,
    raw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize `n_out` acquisition surfaces sharing one evaluator.

    acq_all_fn: (N, d) -> (n_out, N), pointwise in N. The screening is
    shared (one evaluation scores every surface) and all n_out x
    num_restarts lanes run in one batched L-BFGS. raw: the (raw_samples, d)
    screening points (default: uniform from `generator`). Returns
    (xs (n_out, d), values (n_out,))."""
    if raw is None:
        dev = device if device is not None else (generator.device if generator is not None else None)
        raw = torch.rand((raw_samples, input_dim), generator=generator, dtype=dtype, device=dev)
    with torch.no_grad():
        raw_vals = acq_all_fn(raw)  # (n_out, raw_samples)
    top_vals, top_idx = torch.topk(raw_vals, num_restarts, dim=1)  # (n_out, R)
    starts = raw[top_idx]  # (n_out, R, d)
    lanes = n_out * num_restarts
    lane_out = torch.arange(n_out, device=raw.device).repeat_interleave(num_restarts)

    def neg_acq(z):  # (..., lanes, d) -> (..., lanes)
        flat = torch.sigmoid(z).reshape(-1, input_dim)
        rows = torch.arange(flat.shape[0], device=raw.device)
        vals = acq_all_fn(flat)[lane_out.repeat(flat.shape[0] // lanes), rows]
        return -vals.reshape(z.shape[:-1])

    z = batched_lbfgs(neg_acq, _logit(starts.reshape(lanes, input_dim)), maxiter, gtol)
    xs = torch.sigmoid(z)
    with torch.no_grad():
        vals = acq_all_fn(xs)[lane_out, torch.arange(lanes, device=raw.device)]
    all_x = torch.cat([xs.reshape(n_out, num_restarts, input_dim), starts], dim=1)  # (n_out, 2R, d)
    all_v = torch.cat([vals.reshape(n_out, num_restarts), top_vals], dim=1)
    best = torch.argmax(all_v, dim=1)
    take = torch.arange(n_out, device=raw.device)
    return all_x[take, best], all_v[take, best]


def optimize_acqf_box(
    acq_fn: Callable[[torch.Tensor], torch.Tensor],
    input_dim: int,
    generator: Optional[torch.Generator],
    num_restarts: int = 5,
    raw_samples: int = 200,
    maxiter: int = 200,
    gtol: float = 1e-5,
    dtype: torch.dtype = torch.float64,
    device=None,
    raw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize acq_fn ((N, d) -> (N,)) over [0, 1]^d: (x_best (d,), value ())."""
    xs, vals = optimize_acqf_box_multi(
        lambda x: acq_fn(x)[None], 1, input_dim, generator, num_restarts, raw_samples,
        maxiter, gtol, dtype, device, raw,
    )
    return xs[0], vals[0]
