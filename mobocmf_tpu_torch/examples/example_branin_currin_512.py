"""Constrained Branin-Currin, 2 fidelities, 512 inducing points
(counterpart of examples/example_branin_currin_512.py).

Objectives: Branin (scaled to [0,1]^2, the Perdikaris low-fidelity
pairing) and Currin exponential (Xiong smoothing as low fidelity).
Constraint: the disk c(x) = 0.25 - ||x - 0.5||^2 >= 0 at both
fidelities. 490 initial points pad to the 512 bucket (fit/bucketing.py),
so a 15-22 iteration campaign trains m = 512 inducing points throughout.
Runs `run_bo_loop` on `--device` (cuda unless named): float32 on the card,
float64 on the CPU.

    python -m mobocmf_tpu_torch.examples.example_branin_currin_512 [--iters 3] [--fast]
        [--n-init N] [--log-dir DIR] [--device cpu] ...
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEED = 7


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=15)
    parser.add_argument("--n-init", type=int, default=490)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--whitened", action="store_true",
                        help="whitened parameterization: at m = 512 the unwhitened KL's "
                        "m^T K^-1 m is stiff along near-duplicate inducing directions")
    parser.add_argument("--whitened-init", default="match", choices=("match", "prior"),
                        help="'prior' = the standard whitened-SVGP init q(u) = N(0, Kzz)")
    parser.add_argument("--log-dir", default="bc512_logs")
    parser.add_argument("--track-recommendation", action="store_true",
                        help="per-iteration model recommendation scored on the true "
                        "functions (6-tuple hypervolumes.txt)")
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.bo.loop import Blackbox, BOConfig, run_bo_loop
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.test_functions import synthetic as S
    from mobocmf_tpu_torch.util.util import reset_random_state

    device = resolve_device(args.device)
    reset_random_state(SEED)
    blackboxes = [
        Blackbox("branin", [S.branin_scaled_low, S.branin_scaled]),
        Blackbox("currin", [S.currin_low, S.currin]),
        Blackbox("disk", [S.disk_constraint, S.disk_constraint], is_constraint=True,
                 threshold=0.0),
    ]
    n_high = args.n_init // 4
    n_low = args.n_init - n_high
    x_init = np.random.default_rng(SEED).uniform(size=(args.n_init, 2))
    fid_init = np.concatenate([np.zeros(n_low), np.ones(n_high)]).astype(int)

    common = dict(num_bo_iterations=args.iters, seed=SEED, log_dir=args.log_dir,
                  track_recommendation=args.track_recommendation, whitened=args.whitened,
                  whitened_init=args.whitened_init, device=device,
                  dtype=torch.float32 if device.type == "cuda" else torch.float64)
    if args.fast:
        config = BOConfig(num_epochs_1=10, num_epochs_2=20, opt_grid_size=50,
                          pareto_set_size=10, **common)
    else:
        config = BOConfig(**common)
    state = run_bo_loop(blackboxes, x_init, fid_init, config)
    print(f"final: {state.x.shape[0]} points, observed HV trajectory "
          f"{[round(h, 4) for h in state.hypervolumes]}")
    return state


if __name__ == "__main__":
    main()
