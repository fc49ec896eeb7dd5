"""The candidate search and the MOOP's device polish on the card, with the
L-BFGS pieces (acquisition/lbfgs.py) replayed from CUDA graphs and eager.

    python -m mobocmf_tpu_torch.profile_search [--paths bc512,b128,...] [--json PATH]
    python -m mobocmf_tpu_torch.profile_search --device cpu --small  # rehearsal

Each path runs in a process of its own. It trains one state at the path's
width (f32 on the card), conditions it on a Pareto sample as JESMOC_MFDGP
does, and runs the all-fidelity search (jesmoc.optimize_coupled_jes_all_
fidelities, 5 restarts per fidelity) at full depth from raw points fixed by
a seed, in turns eager, captured, captured, eager ("eager": capture_rule
patched to answer no, so every piece runs eagerly on the card):
- bc512: Branin, Currin and a disk constraint at 2 fidelities, 490 points
  padded to m = 512, d = 2, 100 + 100 epochs, 100 conditioned steps, 200
  raw samples, maxiter 200 (chip_smoke.py's bc512);
- b128: the same with a second disk, 120 points (m = 128), 50 + 50 epochs;
- dtlz2_2048: example_dtlz2_2048's 4 objectives at 3 fidelities, 2040
  points (m = 2048), d = 6, 10 + 20 epochs, 20 conditioned steps, its
  search's 64 raw samples and maxiter 15;
- batch10d: example_batch_bo_10d's problem drawn on the CPU (2
  objectives, 1 constraint, d = 10, 40 points, m = 48), 10 + 20 epochs,
  20 conditioned steps, maxiter 200 (one all-fidelity search; the example
  makes 16 penalized ones);
- polish: one MOOP device polish (5 starts, 100 iterations) of bc512's
  first objective's RFF posterior sample under its constraint's.
Then each arm once more, cut to PROFILE_ITERS iterations, under
torch.profiler: the card's busy time (kernels and copies) per evaluation,
and the host time of each of the search's spans (acquisition/lbfgs.py:
`lbfgs.fresh`, `lbfgs.prologue`, `lbfgs.step`, `lbfgs.epilogue`,
`lbfgs.read`) over that search.
Prints one JSON row per run: seconds (synchronized on both ends), ms per
evaluation, iterations, evaluations and evaluations per iteration, how the
lanes ended, the line-search steps per lane and iteration, the capture
seconds and replays, and per arm the device ms per evaluation and the
spans' host ms; then the card's name and power limit. With --json, writes
the rows to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 7
PATHS = ("bc512", "b128", "dtlz2_2048", "batch10d", "polish")
PROFILE_ITERS = 10  # iterations of the profiled runs


def _paths(small: bool) -> dict:
    """Per path: blackboxes as (name, fns per fidelity, is_constraint), the
    points per fidelity, d, epochs, conditioned steps, raw samples, maxiter."""
    from mobocmf_tpu_torch.examples.example_batch_bo_10d import build_problem
    from mobocmf_tpu_torch.examples.example_dtlz2_2048 import NUM_OBJ, mf_objective
    from mobocmf_tpu_torch.test_functions import synthetic as S

    def disk(radius):
        def fn(x):
            return S.disk_constraint(x, radius=radius)
        return fn

    bc = [("branin", (S.branin_scaled_low, S.branin_scaled), False),
          ("currin", (S.currin_low, S.currin), False),
          ("disk", (S.disk_constraint, S.disk_constraint), True)]
    b10 = [(b.name, tuple(b.fns), b.is_constraint) for b in build_problem(torch.device("cpu"))]
    dtlz = [(f"obj{i + 1}", tuple(mf_objective(i)), False) for i in range(NUM_OBJ)]
    cut = 8 if small else 1
    return {
        "bc512": (bc, (368 // cut, 122 // cut), 2, (100 // cut, 100 // cut), 100 // cut, 200, 200),
        "b128": (bc + [("disk04", (disk(0.4), disk(0.4)), True)], (90 // cut, 30 // cut), 2,
                 (50 // cut, 50 // cut), 100 // cut, 200, 200),
        "dtlz2_2048": (dtlz, (1020 // cut, 510 // cut, 510 // cut), 6, (10, 20), 20, 64, 15),
        "batch10d": (b10, (30, 10), 10, (10, 20), 20, 200, 200),
    }


def _state(spec, device, dtype):
    """The path's unconditioned and conditioned stacks, trained and
    conditioned as JESMOC_MFDGP does, outputs standardized per blackbox."""
    from mobocmf_tpu_torch.fit import trainer
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

    blackboxes, counts, d, (e1, e2), cond_steps, _, _ = spec
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(sum(counts), d))
    fid = np.concatenate([np.full(c, f) for f, c in enumerate(counts)]).astype(int)
    fitter = BlackBoxMFDGPFitter(
        num_fidelities=len(counts), batch_size=x.shape[0], num_epochs_1=e1, num_epochs_2=e2,
        seed=SEED, pad_data=True, device=device, dtype=dtype)
    for name, fns, is_con in blackboxes:
        y = np.empty(x.shape[0])
        for f, fn in enumerate(fns):
            y[fid == f] = np.asarray(fn(x[fid == f])).reshape(-1)
        mu, sd = float(y.mean()), float(y.std())
        fitter.initialize_mfdgp(x, (y - mu) / sd, fid, name, is_constraint=is_con,
                                threshold_constraint=-mu / sd if is_con else 0.0)
    fitter.train_mfdgps()
    cond = fitter.copy_uncond()
    cond.num_epochs_2 = cond_steps
    cond.sample_and_store_pareto_solution()
    cond.train_conditioned_mfdgps()
    names = [(n, c) for n, _, c in blackboxes]
    su = trainer.stack_models([fitter.get_model(n, c) for n, c in names])
    sc = trainer.stack_models([cond.get_model(n, c) for n, c in names])
    return (su.params, su.consts, sc.params, sc.consts, su.config), cond


def _arm(arm: str):
    """The block in which the L-BFGS pieces run as `arm` says."""
    from mobocmf_tpu_torch.parallel import sharding
    from mobocmf_tpu_torch.profiling import patched

    if arm == "captured":
        return contextlib.nullcontext()
    return patched(sharding, "capture_rule", lambda collectives: (False, "eager arm"))


def _timed(fn, device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _profiled(fn, device):
    """One call of fn under torch.profiler: the card's busy time (its
    kernels and copies, not the device-side copies of the host's spans) in
    ms (None on the CPU), and the host ms of each `lbfgs.*` span, summed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    busy_us, spans = 0.0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if not evt.is_user_annotation:
                busy_us += evt.time_range.elapsed_us()
        elif evt.name.startswith("lbfgs."):
            spans[evt.name] = spans.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    return (busy_us / 1e3 if device.type == "cuda" else None), spans


def _row(path, arm, seconds, stats, values=None, device_ms=None, span_ms=None) -> dict:
    its = max(stats["iterations"], 1)
    evals = max(stats["evaluations"], 1)
    row = dict(path=path, arm=arm, seconds=seconds,
               ms_per_evaluation=None if seconds is None else 1e3 * seconds / evals,
               device_ms_per_evaluation=None if device_ms is None else device_ms / evals,
               iterations=stats["iterations"], evaluations=stats["evaluations"],
               evals_per_iteration=stats["evaluations"] / its, lanes=stats["lanes"],
               at_gtol=stats["at_gtol"], at_maxiter=stats["at_maxiter"],
               ls_steps_mean=stats["ls_steps_mean"], ls_steps_max=stats["ls_steps_max"],
               failed_searches=stats["failed_searches"], captured=stats["captured"],
               capture_seconds=stats["capture_seconds"], replays=stats["replays"],
               values=values, span_ms=span_ms)
    print(json.dumps(row), flush=True)
    return row


def _runs(path, device, run) -> list:
    """`run(maxiter)` -> values, in turns eager, captured, captured, eager at
    full depth, then each arm profiled at PROFILE_ITERS iterations."""
    from mobocmf_tpu_torch.acquisition import lbfgs

    rows = []
    for arm in ("eager", "captured", "captured", "eager"):
        with _arm(arm):
            values, seconds = _timed(lambda: run(None), device)
        rows.append(_row(path, arm, seconds, lbfgs.last_stats, values))
    for arm in ("eager", "captured"):
        with _arm(arm):
            ms, span_ms = _profiled(lambda: run(PROFILE_ITERS), device)
        rows.append(_row(path, f"{arm} profiled", None, lbfgs.last_stats, None, ms, span_ms))
    return rows


def search_rows(path, spec, device, dtype) -> list:
    from mobocmf_tpu_torch.acquisition import jesmoc

    pair, _ = _state(spec, device, dtype)
    d, raw_samples, maxiter = spec[2], spec[5], spec[6]
    raw = torch.rand((raw_samples, d), generator=torch.Generator().manual_seed(SEED + 1),
                     dtype=dtype).to(device)

    def run(iters):
        _, vals = jesmoc.optimize_coupled_jes_all_fidelities(
            *pair, None, d, raw_samples=raw_samples, maxiter=iters or maxiter, raw=raw)
        return vals.tolist()

    return _runs(path, device, run)


def polish_rows(spec, device, dtype) -> list:
    """One device polish of the bc512 state's first objective (see the
    module docstring), 100 iterations."""
    from mobocmf_tpu_torch.moop import moop
    from mobocmf_tpu_torch.sampling import rff

    _, cond = _state(spec, device, dtype)
    m = moop.MOOP([moop.SampledFunction(rff.eval_sample_fn, s) for s in cond.samples_objs],
                  [moop.SampledFunction(rff.eval_sample_fn, s) for s in cond.samples_cons],
                  input_dim=2, feasible_values=-1.0 * np.asarray(cond.thresholds_cons),
                  polish="device")
    grid = np.random.default_rng(SEED).uniform(size=(1000, 2))
    like = torch.zeros((), dtype=dtype, device=device)
    with torch.no_grad():
        g = torch.as_tensor(grid, dtype=dtype, device=device)
        evals = m._objs[0](g).double().cpu().numpy()
        cons = torch.stack([c(g) for c in m._cons]).double().cpu().numpy()
    feas = m._feasible_mask(cons, True)
    if feas is None:
        feas = np.ones(grid.shape[0], dtype=bool)

    def run(iters):
        got = m.optimize_obj_globally_device(0, evals, feas, grid, like, iters=iters or 100)
        return None if got is None else float(m._objs[0](torch.as_tensor(
            got, dtype=dtype, device=device)).item())

    return _runs("polish", device, run)


def card_name_and_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def one_path(path: str, device, small: bool) -> list:
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    specs = _paths(small)
    if path == "polish":
        return polish_rows(specs["bc512"], device, dtype)
    return search_rows(path, specs[path], device, dtype)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--paths", default=",".join(PATHS))
    parser.add_argument("--device", default=None)
    parser.add_argument("--small", action="store_true", help="cut the points and epochs 8x")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    from mobocmf_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    paths = args.paths.split(",")
    rows = []
    if len(paths) == 1:
        rows = one_path(paths[0], device, args.small)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            for path in paths:  # one process per path
                out = Path(tmp) / f"{path}.json"
                cmd = [sys.executable, "-m", "mobocmf_tpu_torch.profile_search", "--paths", path,
                       "--json", str(out)] + (["--device", args.device] if args.device else [])
                subprocess.run(cmd + (["--small"] if args.small else []), check=True)
                rows += json.loads(out.read_text())
    print(card_name_and_power_limit(), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
