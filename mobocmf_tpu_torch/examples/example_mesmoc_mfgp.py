"""MESMOC over MFGP models: constrained multi-fidelity BO with exact GPs
(counterpart of examples/example_mesmoc_mfgp.py).

The Branin-Currin pair with a feasibility constraint, 16 low + 8 high
fidelity initial points, costs 1 / 5. Each iteration fits three MFGPs
(150 Adam steps on the exact NLML, every factor through K1), builds the
MESMOC acquisition, picks the next point and fidelity by value over cost,
and logs the observed hypervolume of feasible high-fidelity evaluations,
the recommendation's hypervolume beside the optimal one, the point and
its fidelity. Every iteration's data is padded to one shape for the whole
campaign (mfgp.PAD_PENALTY rows). On `--device` (cuda unless named):
float32 on the card, as the JAX example runs on its TPU; float64 on the
CPU, as the JAX package runs under its tests.

    python -m mobocmf_tpu_torch.examples.example_mesmoc_mfgp [--iters N] [--log-dir DIR]
        [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from mobocmf_tpu_torch.test_functions.synthetic import branin_scaled, currin, currin_low

LOG_FILES = ("observed_hypervolumes.txt", "recommendation_hv.txt", "points_evaluated.txt",
             "fidelities_evaluated.txt")
FIT_ITERS = 150
NUM_FIDELITIES = 2
REF_POINT = np.array([10.0, 10.0])


def obj1(x, fid):  # branin, standardized-ish
    v = branin_scaled(x) / 50.0
    return v + (0.3 * np.sin(6 * x[:, 0]) if fid == 0 else 0.0)


def obj2(x, fid):
    return (currin_low(x) if fid == 0 else currin(x)) / 10.0


def con1(x, fid):  # feasible iff >= 0
    return 0.7 - x[:, 0] - 0.2 * x[:, 1]


FNS = {"obj1": obj1, "obj2": obj2, "con1": con1}


def pareto_idx(v: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows (minimization), by the port's
    moop.pareto_front_mask."""
    from mobocmf_tpu_torch.moop.moop import pareto_front_mask

    pts = torch.as_tensor(np.asarray(v, dtype=float))
    return np.where(pareto_front_mask(pts, torch.ones(pts.shape[0], dtype=torch.bool)).numpy())[0]


def observed_hv(x: np.ndarray, fid: np.ndarray) -> float:
    """HV of the feasible highest-fidelity observations (bo/loop.py's
    convention)."""
    from mobocmf_tpu_torch.util.hypervolume import hypervolume

    top = fid == NUM_FIDELITIES - 1
    if not top.any():
        return 0.0
    xs = x[top]
    feas = con1(xs, 1) >= 0.0
    if not feas.any():
        return 0.0
    return float(hypervolume(np.stack([obj1(xs[feas], 1), obj2(xs[feas], 1)], axis=1), REF_POINT))


def padded(x: np.ndarray, fid: np.ndarray, target: int, y: Optional[np.ndarray] = None):
    """Rows padded to `target` ([0.5, ...] at fidelity 0, y = 0): (x with
    the fidelity column, the valid-row mask[, y])."""
    n = len(x)
    x_p = np.vstack([x, np.full((target - n, x.shape[1]), 0.5)])
    fid_p = np.concatenate([fid, np.zeros(target - n, dtype=int)])
    valid = np.arange(target) < n
    xf = np.concatenate([x_p, fid_p[:, None].astype(float)], axis=1)
    if y is None:
        return xf, valid
    return xf, valid, np.concatenate([y, np.zeros(target - n)])


def fit_models(x: np.ndarray, fid: np.ndarray, target: int, device, dtype,
               num_iters: int = FIT_ITERS):
    """The three fitted MFGPs by name, and each objective's best observed
    value (at the top fidelity where there is one)."""
    from mobocmf_tpu_torch.models import mfgp as G

    models: Dict[str, G.MFGPModel] = {}
    best: Dict[str, float] = {}
    for name, fn in FNS.items():
        y = np.array([fn(x[i: i + 1], fid[i])[0] for i in range(len(x))])
        xf, valid, y_p = padded(x, fid, target, y)
        models[name] = G.fit_mfgp(
            G.init_mfgp(xf, y_p, NUM_FIDELITIES, row_valid=valid, device=device, dtype=dtype),
            num_iters=num_iters)
        if name != "con1":
            top = fid == NUM_FIDELITIES - 1
            best[name] = float(y[top].min()) if top.any() else float(y.min())
    return models, best


def make_acquisition(models, best, seed: int, device):
    from mobocmf_tpu_torch.acquisition.mesmoc import MESMOC_MFGP

    mes = MESMOC_MFGP(
        objectives={k: models[k] for k in ("obj1", "obj2")},
        constraints={"con1": models["con1"]},
        input_dim=2, num_fidelities=NUM_FIDELITIES,
        best_objective_values=best,
        constraint_thresholds={"con1": 0.0},
        seed=seed, device=device,
    )
    for f in range(NUM_FIDELITIES):
        mes.add_blackbox(f, "obj1", cost_evaluation=1.0 if f == 0 else 5.0)
        mes.add_blackbox(f, "obj2", cost_evaluation=1.0 if f == 0 else 5.0)
        mes.add_blackbox(f, "con1", is_constraint=True)
    return mes


def recommendation_hv(models, grid: np.ndarray) -> float:
    """Model-feasible (P(c >= 0) > 0.999) grid points, culled to the front
    of the predicted high-fidelity means and scored on the true functions
    (the least-infeasible points when none is feasible)."""
    from scipy.stats import norm

    from mobocmf_tpu_torch.models import mfgp as G
    from mobocmf_tpu_torch.util.hypervolume import hypervolume

    like = models["obj1"].x_train
    gt = torch.as_tensor(grid, dtype=like.dtype, device=like.device)
    with torch.no_grad():
        mu1 = G.predict(models["obj1"], gt, 1)[0].double().cpu().numpy()
        mu2 = G.predict(models["obj2"], gt, 1)[0].double().cpu().numpy()
        muc, varc = (t.double().cpu().numpy() for t in G.predict(models["con1"], gt, 1))
    p_feas = 1.0 - norm.cdf((0.0 - muc) / np.sqrt(varc))
    feas = p_feas > 0.999
    if not feas.any():
        feas = p_feas >= p_feas.max()
    cand = np.where(feas)[0]
    rec_x = grid[cand[pareto_idx(np.stack([mu1[cand], mu2[cand]], axis=1))]]
    ok = con1(rec_x, 1) >= 0.0
    if not ok.any():
        return 0.0
    vals = np.stack([obj1(rec_x[ok], 1), obj2(rec_x[ok], 1)], axis=1)
    return float(hypervolume(vals[pareto_idx(vals)], REF_POINT))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.util.hypervolume import hypervolume

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64

    def clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    rng = np.random.default_rng(0)
    n0, n1 = 16, 8
    x = np.vstack([rng.uniform(size=(n0, 2)), rng.uniform(size=(n1, 2))])
    fid = np.concatenate([np.zeros(n0), np.ones(n1)]).astype(int)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        # no resume: every invocation starts with clean logs
        for name in LOG_FILES:
            open(os.path.join(args.log_dir, name), "w").close()

    grid = np.random.default_rng(1234).uniform(size=(1024, 2))
    true_feas = con1(grid, 1) >= 0.0
    true_objs = np.stack([obj1(grid, 1), obj2(grid, 1)], axis=1)[true_feas]
    optimal_hv = float(hypervolume(true_objs[pareto_idx(true_objs)], REF_POINT))

    # one padded shape for the whole campaign
    target = int(8 * np.ceil((n0 + n1 + args.iters) / 8))
    hvs, rec_hvs, stages, values = [], [], [], []
    for it in range(args.iters):
        t0 = clock()
        models, best = fit_models(x, fid, target, device, dtype)
        t1 = clock()
        mes = make_acquisition(models, best, it, device)
        x_next, f_next = mes.get_nextpoint_coupled(iteration=it, verbose=True)
        x_next = x_next.double().cpu().numpy()
        t2 = clock()
        x = np.vstack([x, x_next[None]])
        fid = np.concatenate([fid, [f_next]])
        hvs.append(observed_hv(x, fid))
        rec_hvs.append(recommendation_hv(models, grid))
        t3 = clock()
        stages.append(dict(fit=t1 - t0, search=t2 - t1, recommendation_hv=t3 - t2))
        values.append(dict(mes.last_values))
        print(f"[timing] iteration {it}: fit {t1 - t0:.3f} s, search {t2 - t1:.3f} s, "
              f"recommendation HV {t3 - t2:.3f} s", flush=True)
        if args.log_dir:
            rows = ((LOG_FILES[0], f"{hvs[-1]}"), (LOG_FILES[1], f"{rec_hvs[-1]} {optimal_hv}"),
                    (LOG_FILES[2], " ".join(str(v) for v in x_next)), (LOG_FILES[3], f"{f_next}"))
            for name, row in rows:
                with open(os.path.join(args.log_dir, name), "a") as fh:
                    fh.write(row + "\n")

    top = fid == NUM_FIDELITIES - 1
    feas = con1(x, 1) >= 0
    print(f"final: {len(x)} evaluations, {int((top & feas).sum())} feasible high-fidelity")
    print(f"observed HV trajectory: {[round(h, 4) for h in hvs]}")
    print(f"recommendation HV trajectory (optimal {optimal_hv:.4f}): "
          f"{[round(h, 4) for h in rec_hvs]}")
    return dict(x=x, fidelities=fid, hypervolumes=hvs, recommendation_hvs=rec_hvs,
                optimal_hv=optimal_hv, stage_seconds=stages, values=values)


if __name__ == "__main__":
    main()
