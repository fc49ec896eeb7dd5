"""Constrained multi-objective optimization over sampled functions (MOOP)
(counterpart of mobocmf_tpu/moop/moop.py).

Uniform grid + training inputs, feasibility filter, per-objective SLSQP
polish, Pareto cull, min-max summary (reference moop.py). The grid
evaluation of the RFF samples, the dominance cull and the greedy summary
run on the samples' device with static shapes and masks; the
d-dimensional SLSQP polish runs on the host (scipy) fed by fused
value / gradient / constraint / Jacobian evaluations (autograd), with the
reference's accept / verify / retry logic (moop.py:72-139).

Infeasible grid rows keep their slot with valid=False instead of being
removed. Polish "device" keeps the polish on the samples' device too: a
multi-start L-BFGS on a quadratic penalty from the best feasible grid
points, all starts as lanes of one batched search, with the same accept
rule as SLSQP.

Over a mesh (`mesh=`, parallel/sharding.py) every grid evaluation is
sharded over 'dp' (`sharding.sharded_grid_eval`). The samples and the
random grid are the mesh's first rank's (broadcast), and the polish, the
front and the summary run there and the solution is broadcast: scipy's
SLSQP and an f32 polish are not bitwise across processes, so recomputing
them on every rank would not give one answer.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.acquisition.lbfgs import lbfgs_lanes
from mobocmf_tpu_torch.acquisition.optimize import _logit
from mobocmf_tpu_torch.parallel import sharding


class NotFeasiblePoints(ValueError):
    pass


class ParetoSolution(NamedTuple):
    pareto_set: torch.Tensor  # (P, d)
    pareto_front: torch.Tensor  # (P, k)
    mask: torch.Tensor  # (P,) bool: valid rows (padding repeats chosen rows)
    num_valid: int


def pareto_front_mask(pts: torch.Tensor, valid: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Non-dominated mask among valid rows (minimization).

    Matches the reference cull (moop.py:141-168) including its
    first-of-duplicates tie-break: row i is kept iff no valid j dominates it
    (all <= and any <) and no earlier valid j equals it exactly. Chunked
    O(n^2) dominance over blocks of `chunk` candidate rows."""
    n = pts.shape[0]
    big = torch.finfo(pts.dtype).max
    # invalid rows can never dominate: push them to +max
    pts_dom = torch.where(valid[:, None], pts, torch.full_like(pts, big))
    idx = torch.arange(n, device=pts.device)
    dom = []
    for c0 in range(0, n, chunk):
        cand = pts[c0 : c0 + chunk, None, :]
        cand_idx = idx[c0 : c0 + chunk, None]
        le = torch.all(pts_dom[None] <= cand, dim=-1)
        lt = torch.any(pts_dom[None] < cand, dim=-1)
        eq = torch.all(pts_dom[None] == cand, dim=-1)
        dominated = torch.any(le & lt & (idx[None] != cand_idx), dim=1)
        dup_earlier = torch.any(eq & (idx[None] < cand_idx), dim=1)
        dom.append(dominated | dup_earlier)
    return valid & ~torch.cat(dom)


def summarize_pareto(
    pareto_set: torch.Tensor, pareto_front: torch.Tensor, mask: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-max summary in objective space (reference moop.py:187-219).

    Seeds with each objective's argmin, then greedily adds the point
    farthest (in front-space distance) from the chosen set. Returns
    (chosen_set (size, d), chosen_front (size, k), valid (size,)); with
    fewer than `size` valid points the extras repeat chosen points and are
    flagged invalid."""
    n, k = pareto_front.shape
    dtype, device = pareto_front.dtype, pareto_front.device
    big = torch.finfo(dtype).max
    front_masked = torch.where(mask[:, None], pareto_front, torch.full_like(pareto_front, big))
    chosen = torch.zeros((size,), dtype=torch.long, device=device)
    chosen_front = torch.zeros((size, k), dtype=dtype, device=device)
    chosen_mask = torch.zeros((n,), dtype=torch.bool, device=device)

    def take(i, j):
        chosen[i] = j
        chosen_front[i] = pareto_front[j]
        chosen_mask[j] = True

    for i in range(min(k, size)):
        take(i, torch.argmin(front_masked[:, i]))
    sq_front = torch.sum(pareto_front**2, dim=1, keepdim=True)  # (n, 1)
    slots = torch.arange(size, device=device)[None, :]
    for i in range(min(k, size), size):
        # squared distance from each candidate to each chosen slot
        d2 = sq_front - 2.0 * (pareto_front @ chosen_front.mT) + torch.sum(chosen_front**2, 1)[None]
        min_d = torch.min(torch.where(slots < i, torch.clamp(d2, min=0.0), big), dim=1).values
        # candidates: valid pareto points not yet chosen
        cand_score = torch.where(mask & ~chosen_mask, min_d, torch.full_like(min_d, -1.0))
        take(i, torch.argmax(cand_score))
    out_valid = slots[0] < torch.clamp(torch.sum(mask), max=size)
    return pareto_set[chosen], pareto_front[chosen], out_valid


class SampledFunction:
    """A function sample as (fn, tree): `fn(tree, x)` maps (N, d) -> (N,)
    on the tree's device and is differentiable in x by autograd."""

    def __init__(self, fn: Callable, tree):
        self.fn = fn
        self.tree = tree

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.tree, x)

    def value_and_grad(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Value and gradient at one point x (d,)."""
        with torch.enable_grad():
            xx = x.detach().clone().requires_grad_(True)
            v = self.fn(self.tree, xx[None, :])[0]
            (g,) = torch.autograd.grad(v, xx)
        return v.detach(), g


def _slsqp_fused_eval(obj: SampledFunction, cons: Sequence[SampledFunction], x, like):
    """(obj value, obj grad, cons values, cons Jacobian) at one point x
    (host numpy), from one forward per function and one backward per
    output, brought to the host in one transfer."""
    with torch.enable_grad():
        xx = torch.as_tensor(x, dtype=like.dtype, device=like.device).requires_grad_(True)
        outs = [obj.fn(obj.tree, xx[None, :])[0]] + [c.fn(c.tree, xx[None, :])[0] for c in cons]
        grads = [torch.autograd.grad(o, xx, retain_graph=i + 1 < len(outs))[0]
                 for i, o in enumerate(outs)]
    flat = torch.cat([torch.stack(outs).detach(), torch.cat(grads)]).cpu().numpy()
    flat = flat.astype(np.float64)
    d, k = xx.shape[0], len(cons)
    vals, jac = flat[: 1 + k], flat[1 + k :].reshape(1 + k, d)
    return float(vals[0]), jac[0], vals[1:], jac[1:]


def _broadcast_solution(mesh, solution: Optional[ParetoSolution],
                        like: torch.Tensor) -> Optional[ParetoSolution]:
    """The mesh's first rank's solution (or None) on every rank, on `like`'s device."""
    host = None if solution is None else tuple(
        t.cpu() if isinstance(t, torch.Tensor) else t for t in solution)
    host = sharding.broadcast_object(mesh, host)
    if host is None:
        return None
    return ParetoSolution(*(t.to(like.device) if isinstance(t, torch.Tensor) else t
                            for t in host))


class MOOP:
    """Constrained MOO over sampled functions on [0, 1]^d.

    samples_objs / samples_cons: `SampledFunction`s or plain callables
    f(x: (N, d) tensor) -> (N,). `grid_size` and `feasible_values` follow
    the reference's conventions (the fitter passes grid_size =
    opt_grid_size * d and feasible_values = -thresholds,
    blackbox_mfdgp_fitter.py:197-202). mesh: shard the grid evaluations
    over its 'dp' axis (the module docstring)."""

    def __init__(
        self,
        samples_objs: Sequence[Callable],
        samples_cons: Sequence[Callable],
        input_dim: int,
        grid_size: int = 1000,
        pareto_set_size: Optional[int] = None,
        feasible_values=0.0,
        min_distance_between_points: float = 1e-6,
        use_slsqp_polish: bool = True,
        polish: str = "slsqp",
        mesh=None,
    ):
        if polish not in ("slsqp", "device", "none"):
            raise ValueError(f"polish must be 'slsqp', 'device' or 'none', got {polish!r}")
        self.samples_objs = list(samples_objs)
        self.samples_cons = list(samples_cons)
        self.input_dim = input_dim
        self.grid_size = grid_size
        self.pareto_set_size = pareto_set_size
        self.min_distance_between_points = min_distance_between_points
        if not isinstance(feasible_values, np.ndarray):
            feasible_values = np.ones(max(len(self.samples_cons), 1)) * feasible_values
        self.feasible_values = np.asarray(feasible_values, dtype=float)
        self.polish = polish if use_slsqp_polish else "none"
        self.mesh = mesh

        def wrap(f):
            if isinstance(f, SampledFunction):
                return f
            return SampledFunction(lambda _tree, x, f=f: f(x), None)

        self._objs = [wrap(f) for f in self.samples_objs]
        self._cons = [wrap(f) for f in self.samples_cons]

    # -- feasibility ---------------------------------------------------------

    def _feasible_mask(self, cons_evals: np.ndarray, allow_negative: bool, valid=None):
        """Reference find_feasible_grid (moop.py:38-70), mask-based. `valid`
        excludes padded grid slots from every branch."""
        if valid is None:
            valid = np.ones(cons_evals.shape[-1], dtype=bool)
        feas = np.all(cons_evals >= self.feasible_values[:, None], axis=0) & valid
        if feas.any():
            return feas
        if not allow_negative:
            return None
        viol = np.minimum(cons_evals - self.feasible_values[:, None], 0.0).sum(axis=0)
        nz = (viol != 0) & valid
        if not nz.any():  # everything exactly on the boundary: all feasible
            return valid.copy()
        return (viol == viol[nz].max()) & valid

    # -- SLSQP polish ---------------------------------------------------------

    def optimize_obj_globally(
        self, obj_idx: int, obj_evals: np.ndarray, feasible_mask: np.ndarray,
        grid: np.ndarray, like: torch.Tensor, constraint_tol: float = 1e-6,
    ) -> Optional[np.ndarray]:
        """Reference moop.py:72-139: SLSQP from the best feasible grid point,
        verify improvement and feasibility, retry once with tolerance."""
        import scipy.optimize as spo

        masked = np.where(feasible_mask, obj_evals, np.inf)
        best_idx = int(np.argmin(masked))
        best_val = float(masked[best_idx])
        x0 = grid[best_idx].copy()
        obj = self._objs[obj_idx]
        cache = {}

        def at(x):
            key = x.tobytes()
            if key not in cache:
                cache[key] = _slsqp_fused_eval(obj, self._cons, x, like)
            return cache[key]

        def f(x):
            return at(x)[0]

        def f_prime(x):
            return at(x)[1]

        def make_g(tol):
            def g(x):
                return at(x)[2] - tol - self.feasible_values[: len(self._cons)]
            return g

        def g_prime(x):
            return at(x)[3]

        bounds = [(0.0, 1.0)] * self.input_dim
        for tol, accept_tol in ((0.0, 0.0), (constraint_tol, constraint_tol)):
            g = make_g(tol)
            try:
                opt_x = spo.fmin_slsqp(
                    f, x0.copy(), bounds=bounds, disp=0, fprime=f_prime,
                    f_ieqcons=g, fprime_ieqcons=g_prime,
                )
            except (ValueError, ArithmeticError, np.linalg.LinAlgError):
                return None
            opt_x = np.clip(np.asarray(opt_x, dtype=float), 0.0, 1.0)
            if f(opt_x) < best_val and np.all(make_g(0.0)(opt_x) >= -accept_tol):
                return opt_x[None]
        return None

    def optimize_obj_globally_device(
        self, obj_idx: int, obj_evals: np.ndarray, feasible_mask: np.ndarray,
        grid: np.ndarray, like: torch.Tensor, num_starts: int = 5, iters: int = 100,
    ) -> Optional[np.ndarray]:
        """The JAX package's device polish (moop.py:205-260, 425-453): from
        the `num_starts` best feasible grid points (an argsort, so the
        starts are deterministic), minimize obj(x) + 1e6 * sum(max(c_lo -
        c(x), 0)^2) over x = sigmoid(z) by optax's L-BFGS for `iters`
        iterations (acquisition/lbfgs.py; every start a lane of one batched
        search, each running all `iters`, as the JAX package's lax.scan
        does; on the card its pieces are replayed from CUDA graphs, the
        loss running no collectives). The same accept rule as
        SLSQP: the best feasible end point is returned only if it improves
        on the best feasible grid value."""
        obj, cons = self._objs[obj_idx], self._cons
        dev, dtype = like.device, like.dtype
        masked = np.where(feasible_mask, obj_evals, np.inf)
        order = np.argsort(masked)[:num_starts]
        best_val = float(masked[order[0]])
        x0 = torch.as_tensor(grid[order], dtype=dtype, device=dev)
        c_lo = torch.as_tensor(self.feasible_values[: len(cons)], dtype=dtype, device=dev)
        mu_pen = 1e6  # equilibrium violation ~ |grad| / (2 mu), far under the 1e-6 accept tol

        def cons_at(x):  # (N, d) -> (C, N)
            if not cons:
                return torch.zeros((0, x.shape[0]), dtype=x.dtype, device=x.device)
            return torch.stack([c(x) for c in cons])

        def loss(z):  # (R, d) -> (R,): the lanes are independent
            x = torch.sigmoid(z)
            viol = torch.clamp(c_lo[:, None] - cons_at(x), min=0.0)
            return obj(x) + mu_pen * torch.sum(viol**2, dim=0)

        z = lbfgs_lanes(loss, _logit(x0), iters)
        with torch.no_grad():
            xs = torch.clamp(torch.sigmoid(z), 0.0, 1.0)
            vals = obj(xs)
            feas = torch.all(cons_at(xs) - c_lo[:, None] >= -1e-6, dim=0)
            score = torch.where(feas, vals, torch.full_like(vals, float("inf")))
            best = int(torch.argmin(score))
            if bool(feas[best]) and float(score[best]) < best_val:
                return xs[best].double().cpu().numpy()[None]
        return None

    # -- main entry ------------------------------------------------------------

    def _grid_evals(self, fns: List[SampledFunction], grid_t: torch.Tensor) -> np.ndarray:
        return sharding.sharded_grid_eval(fns, grid_t, self.mesh)

    def compute_pareto_solution_from_samples(
        self,
        inputs,
        generator: Optional[torch.Generator] = None,
        allow_negative_constraints: bool = False,
        inputs_valid=None,
        grid: Optional[np.ndarray] = None,
        like: Optional[torch.Tensor] = None,
    ):
        """Reference moop.py:221-286; returns (ParetoSolution, samples_objs,
        samples_cons) or None when infeasible.

        The grid is input_dim * grid_size uniform points (from `generator`,
        or `grid` when given) followed by `inputs`. inputs_valid: optional
        (len(inputs),) mask; padded training rows keep their grid slot but
        are excluded from feasibility, polish starts and the front. like: a
        tensor whose dtype and device the evaluations use (default: the
        generator's device in float64). Over a mesh every rank calls this
        and gets the first rank's answer."""
        inputs = np.asarray(inputs, dtype=float)
        if like is None:
            dev = generator.device if generator is not None else torch.device("cpu")
            like = torch.zeros((), dtype=torch.float64, device=dev)
        if grid is None:
            grid = torch.rand(
                (self.input_dim * self.grid_size, self.input_dim), generator=generator,
                dtype=torch.float64, device=like.device,
            ).cpu().numpy()
        rand = np.asarray(grid, dtype=float)
        if self.mesh is not None:
            rand = sharding.broadcast_object(self.mesh, rand)
            self._objs, self._cons = (
                [SampledFunction(f.fn, sharding.replicate(self.mesh, f.tree)) for f in fns]
                for fns in (self._objs, self._cons))
        grid = np.concatenate([rand, inputs], axis=0)
        grid_t = torch.as_tensor(grid, dtype=like.dtype, device=like.device)
        grid_valid = np.ones(grid.shape[0], dtype=bool)
        if inputs_valid is not None:
            grid_valid[rand.shape[0]:] = np.asarray(inputs_valid, dtype=bool)

        cons_evals = (
            self._grid_evals(self._cons, grid_t) if self._cons else np.zeros((0, grid.shape[0]))
        )
        if not np.isfinite(cons_evals).all():
            # non-finite constraint samples cannot define feasibility
            print("[MOOP] non-finite constraint samples; resampling")
            return None
        feasible = self._feasible_mask(cons_evals, allow_negative_constraints, valid=grid_valid)
        if feasible is None:
            return None

        obj_evals = self._grid_evals(self._objs, grid_t)
        n_bad = int((~np.isfinite(obj_evals)).any(axis=0).sum())
        if n_bad:
            print(f"[MOOP] dropped {n_bad} grid rows with non-finite objective samples")
        feasible = feasible & np.isfinite(obj_evals).all(axis=0)
        if not feasible.any():
            return None
        solution = None
        if sharding.is_root(self.mesh):
            solution = self._solve(grid, grid_t, obj_evals, feasible, like)
        if self.mesh is not None:
            solution = _broadcast_solution(self.mesh, solution, like)
        if solution is None:
            return None
        return solution, self.samples_objs, self.samples_cons

    def _solve(self, grid: np.ndarray, grid_t: torch.Tensor, obj_evals: np.ndarray,
               feasible: np.ndarray, like: torch.Tensor) -> Optional[ParetoSolution]:
        """The polish, the front and its summary (the mesh's first rank
        only); None when no valid finite point remains."""
        # per-objective polish; accepted optima fill a block of one row per
        # objective (rejected slots masked infeasible)
        if self.polish != "none":
            n_obj = len(self._objs)
            extra = np.tile(grid[:1], (n_obj, 1))
            extra_valid = np.zeros(n_obj, dtype=bool)
            polish_one = (
                self.optimize_obj_globally_device if self.polish == "device"
                else self.optimize_obj_globally
            )
            for i in range(n_obj):
                opt_x = polish_one(i, obj_evals[i], feasible, grid, like)
                if opt_x is not None:
                    d = np.sqrt(((grid - opt_x) ** 2).sum(axis=1)).min()
                    if d > self.min_distance_between_points:
                        extra[i] = np.asarray(opt_x).reshape(-1)
                        extra_valid[i] = True
            extra_t = torch.as_tensor(extra, dtype=like.dtype, device=like.device)
            grid = np.concatenate([grid, extra], axis=0)
            grid_t = torch.cat([grid_t, extra_t])
            extra_evals = sharding.sharded_grid_eval(self._objs, extra_t, None)
            obj_evals = np.concatenate([obj_evals, extra_evals], axis=1)
            feasible = np.concatenate([feasible, extra_valid])

        pts = torch.as_tensor(obj_evals.T, dtype=like.dtype, device=like.device)
        mask = pareto_front_mask(pts, torch.as_tensor(feasible, device=like.device))

        if self.pareto_set_size is not None:
            pset, pfront, out_mask = summarize_pareto(grid_t, pts, mask, self.pareto_set_size)
        else:
            pset, pfront = grid_t[mask], pts[mask]
            out_mask = torch.ones((pset.shape[0],), dtype=torch.bool, device=like.device)
        num_valid = int(torch.sum(out_mask))
        finite = bool(torch.isfinite(torch.where(out_mask[:, None], pfront, 0.0)).all())
        if num_valid == 0 or not finite:
            return None
        return ParetoSolution(
            pareto_set=pset, pareto_front=pfront, mask=out_mask, num_valid=num_valid
        )

    @classmethod
    def compute_pareto_front(cls, pts) -> np.ndarray:
        """Boolean non-dominated mask (reference classmethod, moop.py:141-168)."""
        pts_t = torch.as_tensor(np.asarray(pts, dtype=float))
        valid = torch.ones((pts_t.shape[0],), dtype=torch.bool)
        return pareto_front_mask(pts_t, valid).numpy()
