"""Forrester 1-D 2-fidelity MFDGP fit + JES acquisition demo
(counterpart of examples/example_acquisition_mfdgp_forrester.py).

Fits an MFDGP to the Forrester pair, samples a Pareto solution (a single
objective: the Pareto "front" is the minimum), trains the conditioned
model, and pickles the trained fitter and the acquisition object halfway
through the pipeline (each round trip holds the predictions to those
before it). The acquisition surfaces are evaluated without gradients, as
the search's screening is (layer 0 through K2 on the card), then the next
point is chosen. `--plot` draws the unconditioned and conditioned
predictive means and the per-fidelity JES acquisition (matplotlib is
imported only then). Float32 on the card, float64 on the CPU.

    python -m mobocmf_tpu_torch.examples.example_acquisition_mfdgp_forrester [--fast]
        [--plot] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from mobocmf_tpu_torch.examples.example_synthetic_2D import predictions, round_trip_gap


def _jes_predictions(jes, x: torch.Tensor) -> list:
    """The acquisition object's unconditioned and conditioned models'
    predictions at x."""
    return (predictions(jes.blackbox_mfdgp_fitter_uncond, x)
            + predictions(jes.blackbox_mfdgp_fitter_cond, x))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fast", action="store_true", help="tiny epoch counts")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.acquisition.jesmoc import JESMOC_MFDGP
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
    from mobocmf_tpu_torch.models import mfdgp as M
    from mobocmf_tpu_torch.test_functions.synthetic import forrester_mf0, forrester_mf1
    from mobocmf_tpu_torch.util.util import (read_pickle, reset_random_state, save_pickle,
                                             standardize_outputs)

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    reset_random_state(0)

    num_fidelities = 2
    n_low, n_high = 12, 6
    x_low = np.random.uniform(size=(n_low, 1))
    x_high = np.random.uniform(size=(n_high, 1))
    y_low = forrester_mf0(x_low).reshape(-1)
    y_high = forrester_mf1(x_high).reshape(-1)
    y_low_s, y_high_s, y_mean, y_std = standardize_outputs(y_low, y_high)

    x = np.vstack([x_high, x_low])
    y = np.concatenate([y_high_s, y_low_s])
    fid = np.concatenate([np.ones(n_high), np.zeros(n_low)]).astype(int)
    grid = torch.linspace(0.0, 1.0, 200, dtype=dtype, device=device)[:, None]

    epochs = (10, 20, 10) if args.fast else (800, 1500, 1500)
    fitter = BlackBoxMFDGPFitter(
        num_fidelities, batch_size=x.shape[0],
        num_epochs_1=epochs[0], num_epochs_2=epochs[1],
        opt_grid_size=100, pareto_set_size=10, device=device, dtype=dtype,
    )
    fitter.initialize_mfdgp(x, y, fid, "obj1", is_constraint=False)
    fitter.train_mfdgps()

    # pickle round trip of the trained fitter mid-pipeline
    before = predictions(fitter, grid)
    with tempfile.TemporaryDirectory() as tmp:
        save_pickle(tmp, "fitter.pkl", fitter)
        fitter = read_pickle(tmp, "fitter.pkl")
    gap_fitter = round_trip_gap(before, predictions(fitter, grid))
    if gap_fitter != 0.0:
        raise RuntimeError(f"the fitter's pickle round trip moved the predictions by {gap_fitter}")
    print("fitter pickle round-trip OK: predictions equal", flush=True)

    cond = fitter.copy_uncond()
    solution = cond.sample_and_store_pareto_solution()
    print(f"pareto points: {solution.num_valid} (MOOP attempts {cond.pareto_tries})",
          flush=True)
    cond.num_epochs_2 = epochs[2]
    cond.train_conditioned_mfdgps()
    cond_loss = cond.phase_stats[-1]["last"]
    print(f"conditioned loss: {cond_loss:.6g}", flush=True)

    jes = JESMOC_MFDGP(model=fitter, num_fidelities=num_fidelities, model_cond=cond)
    jes.add_blackbox(0, "obj1", cost_evaluation=1.0)
    jes.add_blackbox(1, "obj1", cost_evaluation=10.0)

    # pickle round trip of the whole acquisition object
    before = _jes_predictions(jes, grid)
    with tempfile.TemporaryDirectory() as tmp:
        save_pickle(tmp, "jesmoc.pkl", jes)
        jes = read_pickle(tmp, "jesmoc.pkl")
    gap_jes = round_trip_gap(before, _jes_predictions(jes, grid))
    if gap_jes != 0.0:
        raise RuntimeError(f"the acquisition's pickle round trip moved the predictions by {gap_jes}")
    print("jesmoc pickle round-trip OK: predictions equal", flush=True)

    with torch.no_grad():
        acq0 = jes.decoupled_acq(grid, 0, "obj1", is_constraint=False)
        acq1 = jes.decoupled_acq(grid, 1, "obj1", is_constraint=False)
    maxima = {"f=0": float(torch.max(acq0)), "f=1": float(torch.max(acq1))}
    print(f"acq obj1 f=0: max={maxima['f=0']:.4f}; f=1: max={maxima['f=1']:.4f}", flush=True)
    x_next, f_next = jes.get_nextpoint_coupled(iteration=0, verbose=True)
    print("next evaluation:", x_next.cpu().numpy(), "fidelity", f_next, flush=True)

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        model, model_c = fitter.get_model("obj1"), cond.get_model("obj1")

        def moments(m_, f):
            with torch.no_grad():
                mu, var = M.predict_for_acquisition(m_.params, m_.consts, m_.config, grid, f)
            return (mu[0].cpu().numpy() * y_std + y_mean,
                    np.sqrt(var[0].cpu().numpy()) * y_std)

        g = grid.cpu().numpy().ravel()
        pset = jes.pareto_set.cpu().numpy().ravel()
        pfront = jes.pareto_front.cpu().numpy().ravel() * y_std + y_mean
        fig, axes = plt.subplots(3, 1, figsize=(8, 12), sharex=True)
        for ax, f, name, truth, data_x, data_y in [
            (axes[0], 0, "low fidelity", forrester_mf0, x_low, y_low),
            (axes[1], 1, "high fidelity", forrester_mf1, x_high, y_high),
        ]:
            mu_u, sd_u = moments(model, f)
            mu_c, sd_c = moments(model_c, f)
            ax.plot(g, truth(g[:, None]).ravel(), "k--", label="truth")
            ax.plot(g, mu_u, "b", label="unconditioned mean")
            ax.fill_between(g, mu_u - 2 * sd_u, mu_u + 2 * sd_u, alpha=0.2, color="b")
            ax.plot(g, mu_c, "g", label="conditioned mean")
            ax.fill_between(g, mu_c - 2 * sd_c, mu_c + 2 * sd_c, alpha=0.15, color="g")
            ax.plot(data_x.ravel(), data_y, "ko", ms=5, label="data")
            if f == 1:
                ax.plot(pset, pfront, "r*", ms=12, label="pareto sample")
            ax.set_title(name)
            ax.legend()
        axes[2].plot(g, acq0.cpu().numpy(), label="JES f=0")
        axes[2].plot(g, acq1.cpu().numpy(), label="JES f=1")
        axes[2].axvline(float(x_next.reshape(-1)[0]), color="r", ls=":")
        axes[2].set_title("acquisition")
        axes[2].legend()
        fig.savefig("forrester_jes.png", dpi=120)
        print("saved forrester_jes.png")

    return dict(gap_fitter=gap_fitter, gap_jes=gap_jes, pareto_points=solution.num_valid,
                pareto_tries=cond.pareto_tries, cond_loss=cond_loss, acq_max=maxima,
                next_fidelity=int(f_next))


if __name__ == "__main__":
    main()
