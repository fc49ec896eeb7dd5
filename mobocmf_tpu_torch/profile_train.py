"""Where a training or conditioned step's time goes on the card.

    python -m mobocmf_tpu_torch.profile_train [--points 490] [--steps 20] [--phase cond]

Builds the Branin-Currin models of chip_smoke.py (490 points padded to
m = 512, or --points 120 for m = 128, with a fourth blackbox) and runs
full-batch steps as the fitter does: one phase whose steps replay one
captured CUDA graph (fit/graphs.py), a training phase
(fit/trainer.py::TrainPhase) or, with --phase cond, a conditioned phase
(fit/conditioned.py::ConditionedPhase) on a Pareto set of the fitter's
size (50 points drawn uniformly, a front drawn from normals: the step's
shapes, not a sampled solution). A first chunk of --steps warms up and
captures the step; a second is timed with CUDA-synchronised host clocks; a
third is traced with torch.profiler. Prints one JSON line: steps/s, the
capture's seconds, device time per step and its share of the traced and
of the untraced step, kernel launches per step, and the kernels that take
the most device time, with the settings of MOBOCMF_FLAT_ADAM and
MOBOCMF_FUSED_COND (set them in the environment to A/B a switch). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch


def build_model(points: int, seed: int = 7):
    from mobocmf_tpu_torch.fit import fitter as F
    from mobocmf_tpu_torch.fit import trainer
    from mobocmf_tpu_torch.test_functions import synthetic as S

    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(points, 2))
    n_high = points // 4
    fid = np.concatenate([np.zeros(points - n_high), np.ones(n_high)]).astype(int)
    disk04 = functools.partial(S.disk_constraint, radius=0.4)
    boxes = [
        ("branin", S.branin_scaled_low, S.branin_scaled, False),
        ("currin", S.currin_low, S.currin, False),
        ("disk", S.disk_constraint, S.disk_constraint, True),
    ]
    if points <= 128:
        boxes.append(("disk04", disk04, disk04, True))
    fitter = F.BlackBoxMFDGPFitter(2, points, seed=seed, pad_data=True)
    for name, lo, hi, is_con in boxes:
        y = np.where(fid == 0, lo(x), hi(x))
        fitter.initialize_mfdgp(x, y, fid, name, is_constraint=is_con)
    model = trainer.stack_models([fitter.get_model(n, c) for n, _, _, c in boxes])
    ys = torch.stack(fitter.ys_objs + fitter.ys_cons)
    return fitter, model, ys


def cond_phase(fitter, model, ys, steps: int, pareto_points: int = 50):
    """A conditioned phase on the stacked models (objectives first, as the
    fitter stacks them) and its data: a Pareto set of `pareto_points`
    uniform points with a front of standard normals."""
    from mobocmf_tpu_torch.fit import conditioned, trainer

    num_obj = len(fitter.ys_objs)
    obj = trainer.select_model(model, 0, num_obj)
    con = trainer.select_model(model, num_obj, ys.shape[0])
    x = fitter.x_train
    g = torch.Generator(device=x.device).manual_seed(11)
    data = conditioned.ConditionedData(
        x=x, ys_obj=ys[:num_obj], ys_con=ys[num_obj:], fidelities=fitter.fidelities,
        pareto_set=torch.rand((pareto_points, x.shape[1]), generator=g, dtype=x.dtype,
                              device=x.device),
        pareto_front=torch.randn((pareto_points, num_obj), generator=g, dtype=x.dtype,
                                 device=x.device),
        front_mask=torch.ones((pareto_points,), dtype=torch.bool, device=x.device),
        thresholds=torch.as_tensor(fitter.thresholds_cons, dtype=x.dtype, device=x.device),
        row_weights=fitter.row_weights)
    phase = conditioned.ConditionedPhase(obj.params, con.params, obj.consts, con.consts,
                                         model.config, data, 0.001, 1e-8, x.shape[0],
                                         chunk=steps)
    return phase, data


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=490)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--phase", choices=("train", "cond"), default="train")
    args = parser.parse_args()

    from mobocmf_tpu_torch.fit import conditioned, graphs, trainer
    from mobocmf_tpu_torch.linalg import chol

    fitter, model, ys = build_model(args.points)
    x = fitter.x_train
    if args.phase == "train":
        num_data = torch.tensor(float(fitter.num_real), device="cuda")
        phase = trainer.TrainPhase(model, x, ys, fitter.fidelities, 0.001, "all_free",
                                   x.shape[0], fitter.row_weights, num_data, chunk=args.steps)

        def run(steps):
            eps, _ = trainer.draw_chunk(fitter.generator, model.config, steps, ys.shape[0],
                                        x.shape[0], x.shape[0], x.dtype, x.device)
            return phase.run_chunk(eps, None)
    else:
        phase, data = cond_phase(fitter, model, ys, args.steps)

        def run(steps):
            return phase.run_chunk(conditioned.draw_chunk(fitter.generator, data, model.config,
                                                          x.shape[0], steps))

    run(args.steps)  # warm up and capture: kernel build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    chol.reset_counts()
    with torch.profiler.profile(activities=activities) as prof:
        t1 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t1
    kernels = {}
    launches = 0
    for evt in prof.events():
        # device-side events, without the ranges that mirror a CPU annotation
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            evt, "is_user_annotation", False
        ) and not evt.name.startswith("Optimizer."):
            launches += 1
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "phase": args.phase,
        "flat_adam": graphs.flat_adam(),
        "fused_cond": conditioned.FUSED_COND_DEFAULT,
        "m": int(fitter.x_train.shape[0]),
        "blackboxes": int(ys.shape[0]),
        "steps": args.steps,
        "steps_per_s": args.steps / wall,
        "capture_seconds": phase.steps.capture_seconds,
        "replays": phase.steps.replays,
        "traced_steps_per_s": args.steps / traced_wall,
        "device_us_per_step": busy_us / args.steps,
        "device_share_of_traced_wall": busy_us / (traced_wall * 1e6),
        "device_share_of_untraced_step": busy_us / (wall * 1e6),
        "kernel_launches_per_step": launches / args.steps,
        "k1_launches_per_step": chol.launches / args.steps,
        "top_kernels_us_per_step": {k[:80]: v / args.steps for k, v in top},
    }))
    phase.close()


if __name__ == "__main__":
    main()
