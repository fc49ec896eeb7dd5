"""Whether K1 moves the Pareto-sampling stage, and where that stage's time
goes.

    python -m mobocmf_tpu_torch.profile_pareto [--points 490] [--epochs 100]

Trains chip_smoke.py's Branin-Currin configuration (490 points padded to
m = 512, outputs standardized per blackbox as run_bo_loop does, seed 7,
--epochs + --epochs two-phase steps, full batch, f32) twice in one process:
once with every factorization through K1 ("kernel"), once with K1's
launch replaced by cholesky_plain, which is torch.linalg.cholesky_ex with
the same ladder on the same card ("library"). After each training it times
one Pareto sample (`sample_and_store_pareto_solution`), split into the RFF
posterior draws, the MOOP's grid evaluations, its SLSQP polish (the fused
evaluations it makes, counted and timed inside it), the Pareto front mask
and the front's min-max summary. Before and after training it factors
each layer's Kzz with K1 and with the library and measures both against
the f64 factor (`factor_errors`). Prints one JSON line per route with
each training phase's first and last neg-ELBO and ladder escalations.
--device cpu rehearses it on the CPU (both routes are then the plain
version).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from mobocmf_tpu_torch.profiling import patched

SEED = 7


class Stages:
    """Seconds and calls per named stage, the device synchronised around
    each call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}
        self.calls: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, key: str, fn):
        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.seconds[key] = self.seconds.get(key, 0.0) + time.perf_counter() - t0
            self.calls[key] = self.calls.get(key, 0) + 1
            return out

        return timed


def make_fitter(points: int, epochs: int, device: torch.device):
    """chip_smoke.py's bc512 fitter (run_slice), initialized."""
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
    from mobocmf_tpu_torch.test_functions import synthetic as S

    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(points, 2))
    n_high = points // 4
    fid = np.concatenate([np.zeros(points - n_high), np.ones(n_high)]).astype(int)
    boxes = [
        ("branin", S.branin_scaled_low, S.branin_scaled, False),
        ("currin", S.currin_low, S.currin, False),
        ("disk", S.disk_constraint, S.disk_constraint, True),
    ]
    fitter = BlackBoxMFDGPFitter(
        num_fidelities=2, batch_size=points, lr_1=0.003, lr_2=0.001, num_epochs_1=epochs,
        num_epochs_2=epochs, seed=SEED, pad_data=True, device=device,
    )
    for name, lo, hi, is_con in boxes:
        y = np.where(fid == 0, lo(x), hi(x))
        mu, sd = float(y.mean()), float(y.std())
        fitter.initialize_mfdgp(x, (y - mu) / sd, fid, name,
                                threshold_constraint=-mu / sd if is_con else 0.0,
                                is_constraint=is_con)
    return fitter


def factor_errors(fitter, kernel) -> list:
    """Each layer's Kzz of the fitter's stacked models at their current
    parameters, factored by K1 (`kernel`, the unpatched launch; the plain
    version on the CPU) and by the library (cholesky_plain), both with the
    ladder: per layer the rungs, and the largest over the batch of each
    factor's error against the f64 factor at the jitter of its own rung
    (max |L - L64| / max |L64|), its reconstruction error
    (max |L L^T - K_j| / max |K_j|) and its log-determinant error."""
    from mobocmf_tpu_torch.fit import trainer
    from mobocmf_tpu_torch.linalg import chol, ops
    from mobocmf_tpu_torch.models import mfdgp as M

    names = [(n, False) for n in fitter.obj_names] + [(n, True) for n in fitter.con_names]
    model = trainer.stack_models([fitter.get_model(n, c) for n, c in names])
    seen = []
    real = ops.k1_cholesky

    def spy(k, jitter=None, ladder=False):
        seen.append((k.detach().clone(), jitter))
        return real(k, jitter, ladder)

    with patched(ops, "k1_cholesky", spy), torch.no_grad():
        M.compute_layer_states(model.params, model.consts, model.config)
    rows = []
    for k, jitter in seen:
        jit = torch.full((k.shape[0],), float(jitter), dtype=k.dtype, device=k.device)
        eye = torch.eye(k.shape[-1], dtype=torch.float64, device=k.device)
        row = {}
        for name, (l, level) in (
            ("k1", kernel(k, jit, True) if k.is_cuda else chol.cholesky_plain(k, jit, True)),
            ("library", chol.cholesky_plain(k, jit, True)),
        ):
            j = ops.ladder_jitter(float(jitter), level, ops._diag_scale(k)).double()
            a64 = k.double() + j[:, None, None] * eye
            l64 = torch.linalg.cholesky(a64)
            l = l.double()
            row[f"{name}_rungs"] = level.tolist()
            row[f"{name}_rel"] = ((l - l64).abs().amax((-2, -1)) / l64.abs().amax((-2, -1))).max().item()
            row[f"{name}_recon"] = ((l @ l.mT - a64).abs().amax((-2, -1))
                                    / a64.abs().amax((-2, -1))).max().item()
            row[f"{name}_logdet"] = (ops.logdet_from_chol(l) - ops.logdet_from_chol(l64)).abs().max().item()
        rows.append(row)
    return rows


def run_route(route: str, points: int, epochs: int, device: torch.device) -> dict:
    from mobocmf_tpu_torch.linalg import chol
    from mobocmf_tpu_torch.moop import moop as moop_mod
    from mobocmf_tpu_torch.util import counters

    kernel = chol._launch

    def library(a, jitter, ladder, pl=None):
        return chol.cholesky_plain(a, jitter, ladder)

    stages = Stages(device)
    errors = {}
    with contextlib.ExitStack() as stack:
        if route == "library":
            stack.enter_context(patched(chol, "_launch", library))
        fitter = make_fitter(points, epochs, device)
        errors["initial"] = factor_errors(fitter, kernel)
        counters.reset()
        fitter.train_mfdgps()
        k1_train = counters.get("k1.launches")
        errors["trained"] = factor_errors(fitter, kernel)
        fitter._sample_models = stages.wrap("rff_draws", fitter._sample_models)
        for owner, name, key in (
            (moop_mod.MOOP, "_grid_evals", "grid_evals"),
            (moop_mod.MOOP, "optimize_obj_globally", "slsqp"),
            (moop_mod, "_slsqp_fused_eval", "slsqp_fused_evals"),
            (moop_mod, "pareto_front_mask", "front"),
            (moop_mod, "summarize_pareto", "summary"),
        ):
            stack.enter_context(patched(owner, name, stages.wrap(key, getattr(owner, name))))
        stages.sync()
        t0 = time.perf_counter()
        sol = fitter.sample_and_store_pareto_solution()
        stages.sync()
        pareto_s = time.perf_counter() - t0
    return dict(
        route=route, device=str(device), m=int(fitter.x_train.shape[0]),
        phases=[{k: st[k] for k in ("phase", "epochs", "first", "last", "chol_launches",
                                    "escalations")} for st in fitter.phase_stats],
        k1_launches_training=k1_train, pareto_seconds=pareto_s,
        moop_attempts=fitter.pareto_tries, num_valid=sol.num_valid,
        stage_seconds=stages.seconds, stage_calls=stages.calls, factor_errors=errors,
    )


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=490)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_pareto: needs a CUDA device (or --device cpu)")
    for route in ("kernel", "library"):
        print(json.dumps(run_route(route, args.points, args.epochs, device)), flush=True)


if __name__ == "__main__":
    main()
