"""10-D q = 16 batch JESMOCMF campaign
(counterpart of examples/example_batch_bo_10d.py).

Each BO iteration picks a fidelity with the cost-normalized coupled-JES
maximizer, then fills a q-point batch by greedy local penalization
(acquisition/batch.py; every penalized pick screens through K2). The
problem: 2 objectives + 1 constraint drawn from the MFDGP prior with
feasibility calibration (test_functions/prior_problem.py) from a
torch.Generator on `--device` (cuda unless named), d = 10, 2 fidelities,
costs 1 : 10. The models run float32 on the card, float64 on the CPU.

    python -m mobocmf_tpu_torch.examples.example_batch_bo_10d [--iters 6] [--q 16] [--fast]
        [--log-dir DIR] [--device cpu] ...
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SEED = 11
D = 10


def build_problem(device):
    """The blackboxes: two objectives and one constraint, evaluated on
    `device` at either fidelity."""
    from mobocmf_tpu_torch.bo.loop import Blackbox
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.test_functions.prior_problem import sample_problem

    generator = torch.Generator(device=device).manual_seed(SEED)
    objs, cons = sample_problem(generator, d=D, num_constraints=1, device=device)

    def make_fns(sample):
        def at(level):
            def fn(xs):
                x = torch.as_tensor(np.atleast_2d(xs), dtype=torch.float64, device=device)
                return rff.eval_sample(sample, x, layer=level).cpu().numpy()
            return fn
        return [at(level) for level in range(2)]

    return [
        Blackbox("obj1", make_fns(objs[0])),
        Blackbox("obj2", make_fns(objs[1])),
        Blackbox("con1", make_fns(cons[0]), is_constraint=True, threshold=0.0),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--q", type=int, default=16)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--whitened", action="store_true",
                        help="whitened parameterization (recommended at large m)")
    parser.add_argument("--whitened-init", default="match", choices=("match", "prior"),
                        help="'prior' = the standard whitened-SVGP init q(v) = N(0, I)")
    parser.add_argument("--log-dir", default="batch10d_logs")
    parser.add_argument("--eval-highest-fidelity", action="store_true",
                        help="always evaluate the selected batch at the top fidelity")
    parser.add_argument("--track-recommendation", action="store_true",
                        help="per-iteration model recommendation scored on the true "
                        "functions (6-tuple hypervolumes.txt)")
    parser.add_argument("--device", default=None,
                        help="torch device of the models and the problem (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.util.util import reset_random_state

    device = resolve_device(args.device)
    reset_random_state(SEED)
    blackboxes = build_problem(device)
    n_low, n_high = 30, 10
    x_init = np.random.default_rng(SEED).uniform(size=(n_low + n_high, D))
    fid_init = np.concatenate([np.zeros(n_low), np.ones(n_high)]).astype(int)

    common = dict(
        num_bo_iterations=args.iters, seed=SEED, log_dir=args.log_dir, q=args.q, pad_data=True,
        track_recommendation=args.track_recommendation,
        eval_highest_fidelity=args.eval_highest_fidelity,
        whitened=args.whitened, whitened_init=args.whitened_init, device=device,
        dtype=torch.float32 if device.type == "cuda" else torch.float64,
    )
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
