"""BO-iteration wall clock of the port at full JESMOCMF settings
(counterpart of bench.py::bench_bo_iteration, bench.py:229-286).

    python -m mobocmf_tpu_torch.bench [--fast] [--iters N] [--log-dir DIR] [--device cpu]

Runs `run_bo_loop` on the bench's problem: 4 blackboxes (2 objectives, 2
constraints) from the port's `sample_problem` (seed 0, the calibration
probe from numpy's default_rng(7)), d = 2, 80 low + 40 high fidelity
initial points, which pad to the 128 bucket (m = 128 inducing points), and
BOConfig(num_bo_iterations=2, seed=0, pad_data=True) at full settings
(5000 + 15000 epochs, 15000 conditioned iterations). It prints one JSON
line: the last iteration's row of iteration_seconds.txt (the second by
default: the first pays the kernel builds), every phase_seconds.txt row,
and the card's name and power limit as nvidia-smi gives them.

--fast (10 + 20 epochs, grid 50, 10 Pareto points) checks the plumbing
and measures nothing of interest. --device cpu rehearses the run on the
CPU; its numbers are not device numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

D = 2
PHASES = ("setup", "train", "pareto", "cond", "acq", "recommend")


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_blackboxes(device):
    from mobocmf_tpu_torch.bo.loop import Blackbox
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.test_functions.prior_problem import sample_problem

    # a feasibility-calibrated problem (reference toy:60-76): an
    # uncalibrated prior draw can leave a near-empty feasible region and
    # send Pareto sampling into tens of constraint resamples
    objs, cons = sample_problem(
        torch.Generator(device=device).manual_seed(0), d=D, num_constraints=2,
        probe=np.random.default_rng(7).uniform(size=(500, D)), dtype=torch.float32,
        device=device,
    )

    def make_fns(sample):
        def at(level):
            def fn(xs):
                x = torch.as_tensor(np.atleast_2d(xs), dtype=torch.float32, device=device)
                return rff.eval_sample(sample, x, layer=level).cpu().numpy()
            return fn
        return [at(level) for level in range(2)]

    return [
        Blackbox("obj1", make_fns(objs[0])),
        Blackbox("obj2", make_fns(objs[1])),
        Blackbox("con1", make_fns(cons[0]), is_constraint=True, threshold=0.0),
        Blackbox("con2", make_fns(cons[1]), is_constraint=True, threshold=0.0),
    ]


def bench_bo_iteration(iters: int = 2, fast: bool = False, log_dir=None, device=None) -> dict:
    """Run the campaign; returns the logged rows of its iterations."""
    from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop
    from mobocmf_tpu_torch.core.device import resolve_device

    device = resolve_device(device)
    blackboxes = bench_blackboxes(device)
    # 120 initial points (2:1 low:high, reference toy:100-103) pad to the
    # 128 bucket, so every iteration runs m = 128
    rng = np.random.default_rng(0)
    n_low, n_high = 80, 40
    x_init = rng.uniform(size=(n_low + n_high, D)).astype(np.float32)
    fid_init = np.concatenate([np.zeros(n_low), np.ones(n_high)]).astype(int)

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = log_dir or tmp
        if log_dir is not None and os.path.exists(os.path.join(log_dir, "points_evaluated.txt")):
            raise ValueError(f"{log_dir} holds a campaign already: the bench starts fresh")
        config = BOConfig(num_bo_iterations=iters, seed=0, log_dir=out_dir, pad_data=True,
                          device=device)
        if fast:
            config.num_epochs_1, config.num_epochs_2 = 10, 20
            config.opt_grid_size, config.pareto_set_size = 50, 10
        run_bo_loop(blackboxes, x_init, fid_init, config)
        iterations = np.loadtxt(os.path.join(out_dir, "iteration_seconds.txt"), ndmin=2)
        phases = np.loadtxt(os.path.join(out_dir, "phase_seconds.txt"), ndmin=2)
    return dict(device=device, iterations=iterations, phases=phases)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--log-dir", default=None,
                        help="keep the campaign's log files here (default: a temporary dir)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    res = bench_bo_iteration(args.iters, args.fast, args.log_dir, args.device)
    dev = res["device"]
    last = res["iterations"][-1]
    line = {
        "metric": "BO iteration wall clock, JESMOCMF at "
        + ("--fast settings (not a benchmark)" if args.fast else
           "full settings (5000 + 15000 epochs, 15000 conditioned iterations, m = 128)"),
        "value": float(last[2]),
        "unit": "s/iteration",
        "iteration": int(last[0]),
        "n": int(last[1]),
        "iteration_seconds": [[int(r[0]), int(r[1]), float(r[2])] for r in res["iterations"]],
        "phase_seconds": [dict(zip(("iteration", "n") + PHASES,
                                   [int(r[0]), int(r[1])] + [float(v) for v in r[2:]]))
                          for r in res["phases"]],
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card_name_and_power_limit() if dev.type == "cuda" else None,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
