"""Full JESMOCMF BO loop on a model-generated 2-D synthetic problem
(counterpart of examples/toy_synthetic_2D_JESMOCMF.py).

The ground-truth objectives and constraints are sampled from the MFDGP
prior via RFF (constraints rejection-sampled to a 10-90 % feasibility
ratio, reference toy:60-76) and evaluated on `--device`; the initial data
is 10 low + 5 high fidelity points; each BO iteration retrains from
scratch, samples a Pareto solution, trains the conditioned models and
maximizes the cost-normalized coupled JES acquisition (costs 1.0 / 10.0).
The observed hypervolume is logged every iteration; a rerun on the same
--log-dir resumes (either package's log dir).

    python -m mobocmf_tpu_torch.examples.toy_synthetic_2D_JESMOCMF [--iters N] [--fast]
        [--device cpu] [--log-dir DIR] ...
"""

import argparse

import numpy as np
import torch

SEED = 4


def build_problem(seed: int, device):
    """The blackboxes of the campaign: two objectives and two constraints,
    each evaluated on `device` at either fidelity."""
    from mobocmf_tpu_torch.bo.loop import Blackbox
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.test_functions.prior_problem import sample_problem

    generator = torch.Generator(device=device).manual_seed(seed)
    objs, cons = sample_problem(generator, d=2, num_constraints=2, device=device)

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
        Blackbox("con2", make_fns(cons[1]), is_constraint=True, threshold=0.0),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--eval-highest-fidelity", action="store_true")
    parser.add_argument("--log-dir", default="toy2d_logs")
    parser.add_argument("--track-recommendation", action="store_true",
                        help="per-iteration model recommendation + 6-tuple hypervolumes.txt "
                        "(reference toy:533-618)")
    parser.add_argument("--dump-params", action="store_true",
                        help="kernel hyperparameter dumps to <log-dir>/params/ (toy:230-257)")
    parser.add_argument("--plots", action="store_true",
                        help="predictive/acquisition contour PDFs to <log-dir>/plots/ "
                        "(toy:139-226,484-493); needs matplotlib")
    parser.add_argument("--store-models", action="store_true",
                        help="checkpoint the trained models of every iteration")
    parser.add_argument("--load-models", action="store_true",
                        help="restore per-iteration models instead of retraining")
    parser.add_argument("--no-pad-data", action="store_true",
                        help="exact reference shapes (no bucketing of the training rows)")
    parser.add_argument("--polish", choices=("slsqp", "device", "none"), default="slsqp",
                        help="Pareto-sampling polish: slsqp = host scipy (reference "
                        "semantics), device = batched penalty L-BFGS on the device")
    parser.add_argument("--warm-start", action="store_true",
                        help="warm-start each iteration's models from the previous "
                        "iteration (the reference ships this commented out, toy:333-357)")
    parser.add_argument("--acquisition", choices=("jesmoc", "random"), default="jesmoc",
                        help="candidate selection: the full JES pipeline or the "
                        "reference's Random_choice baseline")
    parser.add_argument("--whitened", action="store_true",
                        help="whitened inducing-point parameterization")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="campaign seed: problem draw, initial design and BO loop "
                        "(default: the reference's SEED=4, toy:22)")
    parser.add_argument("--device", default=None,
                        help="torch device of the models and the problem (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop
    from mobocmf_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    seed = args.seed
    blackboxes = build_problem(seed, device)

    n_low, n_high = 10, 5
    x_init = np.random.default_rng(seed).uniform(size=(n_low + n_high, 2))
    fid_init = np.concatenate([np.zeros(n_low), np.ones(n_high)]).astype(int)

    common = dict(
        num_bo_iterations=args.iters, seed=seed, log_dir=args.log_dir,
        eval_highest_fidelity=args.eval_highest_fidelity,
        track_recommendation=args.track_recommendation,
        dump_params=args.dump_params, plot_surfaces=args.plots,
        store_models_in_disk=args.store_models,
        load_models_from_disk=args.load_models,
        pad_data=not args.no_pad_data,
        polish=args.polish,
        warm_start=args.warm_start,
        whitened=args.whitened,
        acquisition=args.acquisition,
        device=device,
    )
    if args.fast:
        config = BOConfig(num_epochs_1=10, num_epochs_2=20, opt_grid_size=50,
                          pareto_set_size=10, **common)
    else:
        config = BOConfig(**common)
    state = run_bo_loop(blackboxes, x_init, fid_init, config)
    print("hypervolume trajectory:", state.hypervolumes)
    return state


if __name__ == "__main__":
    main()
