"""Fast 2-D smoke version of the JESMOCMF pipeline
(counterpart of examples/example_synthetic_2D.py).

Fake blackboxes sampled from the MFDGP prior (RFF prior samples), 2
objectives + 2 constraints, tiny epoch counts (10 / 20 unconditioned, 10
conditioned), a checkpoint round trip of the trained fitter after the
unconditioned phases and of the conditioned one after its phase (each
holds its models' predictions to those before it), and the acquisition
surfaces on a 25 x 25 grid, evaluated without gradients as the search's
screening is (layer 0 through K2 on the card). Float32 on the card,
float64 on the CPU; the checkpoints go to a temporary directory.

    python -m mobocmf_tpu_torch.examples.example_synthetic_2D [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

NAMES = ["obj1", "obj2", "con1", "con2"]


def predictions(fitter, x: torch.Tensor) -> list:
    """Every model's acquisition predictive (means and variances of every
    fidelity) at x, without gradients."""
    from mobocmf_tpu_torch.models import mfdgp as M

    out = []
    with torch.no_grad():
        for name in fitter.obj_names + fitter.con_names:
            m = fitter.get_model(name, name in fitter.con_names)
            out.extend(M.predict_for_acquisition_all(m.params, m.consts, m.config, x))
    return out


def round_trip_gap(before: list, after: list) -> float:
    """The largest |difference| between two lists of predictions (0.0 when
    the round trip kept them bitwise)."""
    return max(float((a - b).abs().max()) for a, b in zip(before, after))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device of the models (default: cuda)")
    args = parser.parse_args(argv)

    from mobocmf_tpu_torch.acquisition.jesmoc import JESMOC_MFDGP
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.util import checkpoint
    from mobocmf_tpu_torch.util.profiling import phase_report, phase_timer
    from mobocmf_tpu_torch.util.util import reset_random_state, standardize_outputs

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    reset_random_state(0)
    num_fidelities = 2
    n_low, n_high = 10, 5
    num_epochs_1, num_epochs_2, num_epochs_cond = 10, 20, 10

    gen = torch.Generator(device=device).manual_seed(0)
    samples = [rff.sample_prior(gen, 2, 2, device=device) for _ in NAMES]

    x_low = np.random.uniform(size=(n_low, 2))
    x_high = np.random.uniform(size=(n_high, 2))
    x = np.vstack([x_high, x_low])
    fid = np.concatenate([np.ones(n_high), np.zeros(n_low)]).astype(int)

    ys, thresholds = {}, {}
    for name, s in zip(NAMES, samples):
        y_low = rff.eval_sample(s, torch.as_tensor(x_low, device=device), layer=0).cpu().numpy()
        y_high = rff.eval_sample(s, torch.as_tensor(x_high, device=device), layer=1).cpu().numpy()
        y_low_s, y_high_s, mean, std = standardize_outputs(y_low, y_high)
        ys[name] = np.concatenate([y_high_s, y_low_s])
        thresholds[name] = (0.0 - mean) / std

    fitter = BlackBoxMFDGPFitter(
        num_fidelities, batch_size=x.shape[0],
        num_epochs_1=num_epochs_1, num_epochs_2=num_epochs_2,
        opt_grid_size=50, pareto_set_size=10, device=device, dtype=dtype,
    )
    for name in NAMES:
        is_con = name.startswith("con")
        fitter.initialize_mfdgp(x, ys[name], fid, name, is_constraint=is_con,
                                threshold_constraint=thresholds[name] if is_con else 0.0)

    g = np.linspace(0, 1, 25)
    xx, yy = np.meshgrid(g, g)
    grid = torch.as_tensor(np.vstack([xx.ravel(), yy.ravel()]).T, dtype=dtype, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        # unconditioned training + checkpoint round trip
        with phase_timer("train_uncond"):
            fitter.train_mfdgps()
        before = predictions(fitter, grid)
        checkpoint.save_fitter(f"{tmp}/uncond", fitter)
        fitter = checkpoint.restore_fitter(f"{tmp}/uncond", device=device)
        gap_uncond = round_trip_gap(before, predictions(fitter, grid))
        if gap_uncond != 0.0:
            raise RuntimeError(f"checkpoint round trip moved the predictions by {gap_uncond}")
        print("checkpoint round-trip (unconditioned) OK: predictions equal", flush=True)

        # Pareto sampling + conditioned training
        cond = fitter.copy_uncond()
        with phase_timer("pareto_sampling"):
            solution = cond.sample_and_store_pareto_solution()
        tries = cond.pareto_tries
        print(f"pareto points: {solution.num_valid} (MOOP attempts {tries})", flush=True)
        cond.num_epochs_2 = num_epochs_cond
        with phase_timer("train_conditioned"):
            cond.train_conditioned_mfdgps()
        cond_loss = cond.phase_stats[-1]["last"]
        print(f"conditioned loss: {cond_loss:.6g}", flush=True)
        before = predictions(cond, grid)
        checkpoint.save_fitter(f"{tmp}/cond", cond)
        cond = checkpoint.restore_fitter(f"{tmp}/cond", device=device)
        gap_cond = round_trip_gap(before, predictions(cond, grid))
        if gap_cond != 0.0:
            raise RuntimeError(f"checkpoint round trip moved the predictions by {gap_cond}")
        print("checkpoint round-trip (conditioned) OK: predictions equal", flush=True)

    # acquisition surfaces on the 25 x 25 grid, without gradients
    jes = JESMOC_MFDGP(model=fitter, num_fidelities=num_fidelities, model_cond=cond)
    for f in range(num_fidelities):
        for name in NAMES:
            jes.add_blackbox(f, name, is_constraint=name.startswith("con"))
    maxima = {}
    with torch.no_grad():
        for f in range(num_fidelities):
            for name in NAMES:
                acq = jes.decoupled_acq(grid, f, name, is_constraint=name.startswith("con"))
                maxima[f"{name} f={f}"] = float(torch.max(acq))
                print(f"acq {name} f={f}: max={maxima[f'{name} f={f}']:.4f}")
            maxima[f"coupled f={f}"] = float(torch.max(jes.coupled_acq(grid, f)))
            print(f"coupled f={f}: max={maxima[f'coupled f={f}']:.4f}")

    print("phase report:", phase_report())
    return dict(gap_uncond=gap_uncond, gap_cond=gap_cond, pareto_points=solution.num_valid,
                pareto_tries=tries, cond_loss=cond_loss, acq_max=maxima)


if __name__ == "__main__":
    main()
