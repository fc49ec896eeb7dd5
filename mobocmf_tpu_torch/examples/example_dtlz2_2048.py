"""DTLZ2, 4 objectives, 3 fidelities, 2048 inducing points
(counterpart of examples/example_dtlz2_2048.py).

Objectives: the four DTLZ2 objectives on [0,1]^6; the top fidelity is the
exact function, the two lower ones add a smooth sinusoidal distortion and
a bias. 2040 initial points pad to the 2048 bucket (fit/bucketing.py), so
a campaign trains m = 2048 inducing points per layer throughout: K1 at
n = 2048 in every training step and K2 at M = 2048 in the search. Costs
1 / 5 / 25.

Default epochs are reduced (1000 / 2000, 2000 conditioned steps, a
15-iteration search from 64 raw samples); --full-epochs keeps that search
with the reference schedule (5000 / 15000 / 15000); --fast is 10 / 20
epochs for plumbing checks. Runs `run_bo_loop` on `--device` (cuda unless
named) at `--dtype` (float32 on the card and float64 on the CPU unless
named; float64 is the reference MOBOCMF's precision).

    python -m mobocmf_tpu_torch.examples.example_dtlz2_2048 [--iters 1] [--n-init N] [--fast]
        [--full-epochs] [--log-dir DIR] [--device cpu] [--dtype float64] ...
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEED = 13
D = 6
NUM_OBJ = 4


def mf_objective(i: int):
    """Objective i at fidelities 0, 1, 2 (2 = the exact DTLZ2 objective)."""
    from mobocmf_tpu_torch.test_functions.synthetic import dtlz2

    def distort(xs, level):
        xs = np.atleast_2d(np.asarray(xs, dtype=float))
        base = dtlz2(xs, NUM_OBJ)[:, i]
        if level == 2:
            return base
        amp = 0.1 * (2 - level)
        return base + amp * np.mean(np.sin(6.0 * np.pi * xs), axis=1) + 0.05 * (2 - level)

    return [lambda xs, level=level: distort(xs, level) for level in range(3)]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--n-init", type=int, default=2040)
    parser.add_argument("--full-epochs", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--whitened", action="store_true",
                        help="whitened parameterization (recommended at large m)")
    parser.add_argument("--whitened-init", default="match", choices=("match", "prior"),
                        help="'prior' = the standard whitened-SVGP init q(v) = N(0, I)")
    parser.add_argument("--log-dir", default="dtlz2_2048_logs")
    parser.add_argument("--track-recommendation", action="store_true",
                        help="per-iteration model recommendation scored on the true "
                        "functions (6-tuple hypervolumes.txt)")
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: cuda)")
    parser.add_argument("--dtype", default=None, choices=("float32", "float64"),
                        help="the models' precision (default: float32 on the card, "
                        "float64 on the CPU)")
    return parser.parse_args(argv)


def make_config(args: argparse.Namespace, device: torch.device):
    """The BOConfig that `args` ask for on `device`."""
    from mobocmf_tpu_torch.bo.loop import BOConfig

    dtype = args.dtype or ("float32" if device.type == "cuda" else "float64")
    # full batch (batch_size None): the m = 2048 factor is paid once per
    # step either way, so minibatches would only multiply factorizations
    common = dict(num_fidelities=3, num_bo_iterations=args.iters, seed=SEED,
                  log_dir=args.log_dir, track_recommendation=args.track_recommendation,
                  whitened=args.whitened, whitened_init=args.whitened_init, device=device,
                  dtype=getattr(torch, dtype))
    if args.fast:
        return BOConfig(num_epochs_1=10, num_epochs_2=20, opt_grid_size=50,
                        pareto_set_size=10, **common)
    if args.full_epochs:
        return BOConfig(acq_maxiter=15, acq_raw_samples=64, **common)
    return BOConfig(num_epochs_1=1000, num_epochs_2=2000, acq_maxiter=15,
                    acq_raw_samples=64, **common)


def main(argv=None):
    args = parse_args(argv)

    from mobocmf_tpu_torch.bo.loop import Blackbox, run_bo_loop
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.util.util import reset_random_state

    device = resolve_device(args.device)
    reset_random_state(SEED)
    blackboxes = [Blackbox(f"obj{i + 1}", mf_objective(i), costs=(1.0, 5.0, 25.0))
                  for i in range(NUM_OBJ)]
    n = args.n_init
    n0, n1 = n // 2, n // 4
    x_init = np.random.default_rng(SEED).uniform(size=(n, D))
    fid_init = np.concatenate([np.zeros(n0), np.ones(n1), np.full(n - n0 - n1, 2)]).astype(int)
    config = make_config(args, device)
    state = run_bo_loop(blackboxes, x_init, fid_init, config)
    print(f"final: {state.x.shape[0]} points, observed HV trajectory "
          f"{[round(h, 4) for h in state.hypervolumes]}")
    return state


if __name__ == "__main__":
    main()
