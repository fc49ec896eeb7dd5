"""Cost-aware JESMOCMF outer BO loop (counterpart of mobocmf_tpu/bo/loop.py).

Per iteration: build and train the fitter from scratch (the reference
retrains every iteration, toy_synthetic_2D_JESMOCMF.py:333-357), sample a
Pareto solution, train the conditioned models, maximize the cost-normalized
coupled JES acquisition, evaluate the chosen blackbox fidelity and append
to the evaluation history.

The log directory has the JAX package's files, names and columns, so
either package resumes the other's campaign: points and fidelities are
appended every iteration and replayed on restart (reference toy:277-301).
Phase times synchronize the device before each clock read, so work queued
on the card is charged to the phase that queued it.

Under `BOConfig.mesh` (parallel/sharding.py) every rank of the mesh runs
the loop and the fitter gives the mesh to the MOOP, which shards its grid
evaluations. Only the mesh's first rank writes the log directory, the
checkpoints and the plots, evaluates the blackboxes and reads the resume
state; every host decision (the resume state, the evaluations, the next
point and fidelity, the recommendation) is broadcast from it, so every
rank ends with the same BOState.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.acquisition.jesmoc import JESMOC_MFDGP
from mobocmf_tpu_torch.acquisition.random_choice import Random_choice
from mobocmf_tpu_torch.bo.recommend import recommendation_model_pass
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.fit.conditioned import empty_like_stack
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util import checkpoint, heartbeat
from mobocmf_tpu_torch.util.describe import describe_hyperparams
from mobocmf_tpu_torch.util.hypervolume import hypervolume, hypervolume_pair

PHASES = ("setup", "train", "pareto", "cond", "acq", "recommend")


@dataclasses.dataclass
class Blackbox:
    """One blackbox: `fns[f]` evaluates fidelity f on (n, d) numpy arrays."""

    name: str
    fns: Sequence[Callable[[np.ndarray], np.ndarray]]
    is_constraint: bool = False
    threshold: float = 0.0
    costs: Sequence[float] = (1.0, 10.0)


@dataclasses.dataclass
class BOConfig:
    """The JAX package's BOConfig (its field names, defaults and checks),
    with `device` (`cuda` unless named) and `dtype` (float32 unless named).
    `mesh` is a mesh of parallel/sharding.py::make_mesh over the ranks that
    run the loop (the module docstring)."""

    num_fidelities: int = 2
    num_bo_iterations: int = 60
    num_epochs_1: int = 5000
    num_epochs_2: int = 15000
    lr_1: float = 0.003
    lr_2: float = 0.001
    pareto_set_size: int = 50
    opt_grid_size: int = 1000
    batch_size: Optional[int] = None  # default: full batch
    type_lengthscale: TL = TL.MEDIAN
    eval_highest_fidelity: bool = False
    seed: int = 4
    log_dir: Optional[str] = None
    hv_reference: Optional[np.ndarray] = None  # reference point for HV logging
    # model-based recommendation + HV-vs-optimal scoring per iteration
    # (reference toy:533-614; needs true-function access)
    track_recommendation: bool = False
    recommendation_grid_size: int = 1000
    # warm start each iteration from the previous iteration's trained models
    # (the reference ships this commented out, toy:333-357)
    warm_start: bool = False
    # bucket the growing training set to geometric sizes with masked padding
    # (fit/bucketing.py)
    pad_data: bool = True
    # Pareto-sampling polish: "slsqp" (host scipy, reference moop.py:72-139),
    # "device" (batched penalty L-BFGS on the device) or "none"; the same
    # accept rule either way
    polish: str = "slsqp"
    # candidates per BO iteration: the fidelity comes from the q=1 search,
    # the batch is filled at that fidelity by greedy local penalization
    # (acquisition/batch.py)
    q: int = 1
    acq_maxiter: int = 200
    acq_raw_samples: int = 200
    # per-iteration kernel-hyperparameter dumps to <log_dir>/params/*.txt
    # (reference toy:230-257)
    dump_params: bool = False
    # per-iteration contour plots (2-D problems) to <log_dir>/plots/
    # (reference toy:139-226, 484-493)
    plot_surfaces: bool = False
    whitened: bool = False
    whitened_init: str = "match"
    # checkpoints of the trained (uncond, cond) fitters per iteration
    # (reference toy:38-45, 366-425): store writes
    # <log_dir>/models/iter{it}/{uncond,cond}; load restores them instead of
    # retraining when present
    store_models_in_disk: bool = False
    load_models_from_disk: bool = False
    # "jesmoc" (the full JES pipeline) or "random" (the reference's
    # Random_choice baseline: models are trained only when something
    # consumes them, and Pareto sampling and conditioning are skipped)
    acquisition: str = "jesmoc"
    # stall watchdog (util/heartbeat.py): no progress beat for this many
    # seconds prints the hung phase and exits 86; None = disarmed unless
    # MOBOCMF_STALL_TIMEOUT_S is set
    stall_timeout_s: Optional[float] = None
    # optional mesh (parallel/sharding.py::make_mesh): shards the MOOP grid
    # evaluations over the mesh's 'dp' axis (parallel/sharding.sharded_grid_eval)
    mesh: Optional[object] = None
    device: DeviceLike = None
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        # a silently-ignored typo would run the wrong pipeline
        if self.acquisition not in ("jesmoc", "random"):
            raise ValueError(
                f"BOConfig.acquisition must be 'jesmoc' or 'random', "
                f"got {self.acquisition!r}"
            )
        if self.polish not in ("slsqp", "device", "none"):
            raise ValueError(
                f"BOConfig.polish must be 'slsqp', 'device' or 'none', "
                f"got {self.polish!r}"
            )


@dataclasses.dataclass
class BOState:
    x: np.ndarray  # (N, d)
    fidelities: np.ndarray  # (N,)
    ys: Dict[str, np.ndarray]  # per blackbox, (N,)
    hypervolumes: List[float]


def _standardize(y: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Shared mean/std across fidelities (example_synthetic_2D.py:75-88)."""
    mean, std = float(y.mean()), float(y.std())
    std = std if std > 0 else 1.0
    return (y - mean) / std, mean, std


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=float)


def run_bo_loop(
    blackboxes: Sequence[Blackbox],
    x_init: np.ndarray,
    fidelities_init: np.ndarray,
    config: BOConfig,
    callback: Optional[Callable[[int, BOState], None]] = None,
) -> BOState:
    device = resolve_device(config.device)
    dtype = resolve_dtype(config.dtype)

    def clock() -> float:
        # queued device work belongs to the phase that queued it
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    d = x_init.shape[1]
    log_dir = config.log_dir
    mesh = config.mesh
    root = sharding.is_root(mesh)
    # the directory this rank writes (the mesh's first rank only)
    out_dir = log_dir if root else None
    x = np.asarray(x_init, dtype=float)
    fid = np.asarray(fidelities_init, dtype=int).reshape(-1)

    stall_s = config.stall_timeout_s
    if stall_s is None:
        env_stall = os.environ.get("MOBOCMF_STALL_TIMEOUT_S", "")
        stall_s = float(env_stall) if env_stall else None
    if stall_s:
        heartbeat.start(float(stall_s))
        print(f"[watchdog] armed: stall timeout {stall_s:.0f}s")

    # resume from logs if present (reference toy:277-301)
    start_iter = 0
    if out_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        pts_file = os.path.join(log_dir, "points_evaluated.txt")
        fid_file = os.path.join(log_dir, "fidelities_evaluated.txt")
        if os.path.exists(pts_file) and os.path.getsize(pts_file) > 0:
            x_extra = np.loadtxt(pts_file).reshape(-1, d)
            fid_extra = np.loadtxt(fid_file).reshape(-1).astype(int)
            x = np.vstack([x, x_extra])
            fid = np.concatenate([fid, fid_extra])
            # q points are appended per iteration
            if x_extra.shape[0] % config.q != 0:
                raise ValueError(
                    f"resume mismatch: {log_dir} holds {x_extra.shape[0]} "
                    f"evaluated points, not a multiple of q={config.q} — the "
                    "log dir was written under a different q; restart with "
                    "the original q or a fresh log_dir"
                )
            start_iter = x_extra.shape[0] // config.q
            print(
                f"[resume] replayed {x_extra.shape[0]} evaluated points "
                f"({start_iter} iterations)"
            )
        # the iteration this process starts at: its first iteration pays the
        # process's one-time costs (kernel builds, allocator warm-up)
        with open(os.path.join(log_dir, "process_starts.txt"), "a") as fh:
            fh.write(f"{start_iter}\n")
    x, fid, start_iter = sharding.broadcast_object(mesh, (x, fid, start_iter))

    def eval_all(x_pts: np.ndarray, f: np.ndarray) -> Dict[str, np.ndarray]:
        """Every blackbox at its fidelity per point (the mesh's first rank
        evaluates, every rank gets its values)."""
        out: Dict[str, np.ndarray] = {}
        for bb in blackboxes if root else ():
            y = np.empty(x_pts.shape[0])
            for level in range(config.num_fidelities):
                sel = f == level
                if sel.any():
                    y[sel] = np.asarray(bb.fns[level](x_pts[sel])).reshape(-1)
            out[bb.name] = y
        return sharding.broadcast_object(mesh, out)

    ys = eval_all(x, fid)
    state = BOState(x=x, fidelities=fid, ys=ys, hypervolumes=[])
    if out_dir is not None:
        obs_file = os.path.join(log_dir, "observed_hypervolumes.txt")
        if os.path.exists(obs_file) and os.path.getsize(obs_file) > 0:
            state.hypervolumes = list(np.atleast_1d(np.loadtxt(obs_file)))
        if len(state.hypervolumes) < start_iter:
            # a crash between the points append and the HV append loses the
            # tail entry: pad the end so recorded entries keep their
            # iteration indices (assumes the log was written from iteration 0)
            missing = start_iter - len(state.hypervolumes)
            print(
                f"[resume] observed-HV history is {missing} entries short; "
                "NaN-padding the tail (recorded entries are assumed to "
                "start at iteration 0)"
            )
            state.hypervolumes = state.hypervolumes + [float("nan")] * missing
    state.hypervolumes = sharding.broadcast_object(mesh, state.hypervolumes)

    prev_fitter = None
    # the random baseline trains no models unless something consumes them
    needs_models = (
        config.acquisition != "random"
        or config.track_recommendation
        or config.dump_params
        or config.plot_surfaces
        or config.warm_start
        or config.store_models_in_disk
    )

    for it in range(start_iter, config.num_bo_iterations):
        t_iter = clock()
        n = state.x.shape[0]
        batch_size = config.batch_size or n
        stats = {}
        std_ys = {}
        for bb in blackboxes:
            y_std, mean, std = _standardize(state.ys[bb.name])
            stats[bb.name] = (mean, std)
            std_ys[bb.name] = y_std

        models_dir = (
            os.path.join(log_dir, "models", f"iter{it}") if log_dir is not None else None
        )
        phase_t: Dict[str, float] = {}
        # restore both fitters or neither, before paying for construction
        loaded = False
        if config.load_models_from_disk and models_dir is not None and needs_models:
            try:
                f_u = checkpoint.restore_fitter(os.path.join(models_dir, "uncond"), device)
                # random-mode checkpoints have no conditioned fitter
                f_c = (
                    checkpoint.restore_fitter(os.path.join(models_dir, "cond"), device)
                    if config.acquisition != "random"
                    else None
                )
                fitter, cond, loaded = f_u, f_c, True
                print(f"[BO iter {it}] restored models from {models_dir}")
            except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) as e:
                print(f"[BO iter {it}] model restore failed ({e!r}); retraining")
                loaded = False
            if sharding.broadcast_object(mesh, loaded) != loaded:
                raise RuntimeError(f"[BO iter {it}] the mesh's ranks disagree on restoring "
                                   f"{models_dir}")
            if loaded:
                for f in (fitter, cond):
                    if f is not None:
                        f.mesh = mesh
        if not needs_models:
            fitter, cond = None, None
        elif not loaded:
            fitter = BlackBoxMFDGPFitter(
                config.num_fidelities, batch_size,
                lr_1=config.lr_1, lr_2=config.lr_2,
                num_epochs_1=config.num_epochs_1, num_epochs_2=config.num_epochs_2,
                pareto_set_size=config.pareto_set_size,
                opt_grid_size=config.opt_grid_size,
                type_lengthscale=config.type_lengthscale, seed=config.seed + it,
                pad_data=config.pad_data, polish=config.polish,
                whitened=config.whitened, whitened_init=config.whitened_init,
                device=device, dtype=dtype, mesh=mesh,
            )
            for bb in blackboxes:
                mean, std = stats[bb.name]
                thr = (bb.threshold - mean) / std if bb.is_constraint else 0.0
                prev_model = (
                    prev_fitter.get_model(bb.name, is_constraint=bb.is_constraint)
                    if (config.warm_start and prev_fitter is not None)
                    else None
                )
                fitter.initialize_mfdgp(
                    state.x, std_ys[bb.name], state.fidelities, bb.name,
                    threshold_constraint=thr, is_constraint=bb.is_constraint,
                    previously_trained_model=prev_model,
                )
            # setup = fitter construction + per-blackbox model init
            phase_t["setup"] = clock() - t_iter
            heartbeat.beat(f"iter{it}:setup")
            if out_dir is not None:
                # warm-start fetch, host init math, ship to the device, and
                # the rest (standardize, constructor, bookkeeping)
                ti = fitter.init_timings
                other = phase_t["setup"] - sum(ti.values())
                with open(os.path.join(log_dir, "setup_breakdown.txt"), "a") as fh:
                    fh.write(
                        f"{it} {n} {ti.get('fetch', 0.0):.3f} "
                        f"{ti.get('host', 0.0):.3f} {ti.get('ship', 0.0):.3f} "
                        f"{other:.3f}\n"
                    )
            t0 = clock()
            fitter.train_mfdgps()
            phase_t["train"] = clock() - t0
            heartbeat.beat(f"iter{it}:train")
            if config.acquisition == "random":
                cond = None
            else:
                t0 = clock()
                cond = fitter.copy_uncond()
                cond.sample_and_store_pareto_solution()
                phase_t["pareto"] = clock() - t0
                heartbeat.beat(f"iter{it}:pareto")
                if out_dir is not None:
                    # MOOP attempts consumed (1 = the first draw was feasible)
                    with open(os.path.join(log_dir, "pareto_resamples.txt"), "a") as fh:
                        fh.write(f"{it} {n} {cond.pareto_tries}\n")
                t0 = clock()
                cond.train_conditioned_mfdgps()
                phase_t["cond"] = clock() - t0
                heartbeat.beat(f"iter{it}:cond")
            if config.store_models_in_disk and models_dir is not None and root:
                checkpoint.save_fitter(os.path.join(models_dir, "uncond"), fitter)
                if cond is not None:
                    checkpoint.save_fitter(os.path.join(models_dir, "cond"), cond)
        prev_fitter = fitter

        if config.dump_params and out_dir is not None:
            params_dir = os.path.join(log_dir, "params")
            os.makedirs(params_dir, exist_ok=True)
            for bb in blackboxes:
                model = fitter.get_model(bb.name, is_constraint=bb.is_constraint)
                with open(os.path.join(params_dir, f"{bb.name}_iter{it}.txt"), "w") as fh:
                    for layer, vals in describe_hyperparams(model).items():
                        fh.write(f"{layer}: {vals}\n")

        t0 = clock()
        if config.acquisition == "random":
            rc = Random_choice(
                input_size=d, num_fidelities=config.num_fidelities,
                seed=config.seed + it, device=device,
            )
            for bb in blackboxes:
                for level in range(config.num_fidelities):
                    rc.add_blackbox(level, bb.name, cost_evaluation=bb.costs[level])
            x_next, fid_next = rc.get_batch_coupled(config.q, iteration=it, verbose=True)
            x_next = _to_numpy(x_next).reshape(config.q, d)
        else:
            jes = JESMOC_MFDGP(
                model=fitter, num_fidelities=config.num_fidelities, model_cond=cond,
                eval_highest_fidelity=config.eval_highest_fidelity, seed=config.seed + it,
                acq_maxiter=config.acq_maxiter,
                acq_raw_samples=config.acq_raw_samples,
            )
            for bb in blackboxes:
                for level in range(config.num_fidelities):
                    jes.add_blackbox(
                        level, bb.name, cost_evaluation=bb.costs[level],
                        is_constraint=bb.is_constraint,
                    )
            x_next, fid_next = jes.get_nextpoint_coupled(iteration=it, verbose=True)
            x_next = _to_numpy(x_next).reshape(1, d)
            if config.q > 1:
                # the q=1 maximizer seeds the batch as its first point
                xs_batch = jes.get_batch_coupled(fid_next, config.q - 1, x0=x_next)
                x_next = np.vstack([x_next, _to_numpy(xs_batch)])
        x_next, fid_next = sharding.broadcast_object(mesh, (x_next, int(fid_next)))
        phase_t["acq"] = clock() - t0
        heartbeat.beat(f"iter{it}:acq")
        fid_batch = np.full(x_next.shape[0], fid_next, dtype=int)

        y_next = eval_all(x_next, fid_batch)
        state.x = np.vstack([state.x, x_next])
        state.fidelities = np.concatenate([state.fidelities, fid_batch])
        for bb in blackboxes:
            state.ys[bb.name] = np.concatenate([state.ys[bb.name], y_next[bb.name]])

        # hypervolume of feasible high-fidelity observations
        hv = _observed_hypervolume(blackboxes, state, config)
        state.hypervolumes.append(hv)
        wall = clock() - t_iter
        print(
            f"[BO iter {it}] fidelity={fid_next} x={x_next.ravel()} HV={hv:.6f} "
            f"n={n} wallclock={wall:.2f}s"
        )
        sys.stdout.flush()
        if out_dir is not None:
            with open(os.path.join(log_dir, "iteration_seconds.txt"), "a") as fh:
                fh.write(f"{it} {n} {wall:.3f}\n")

        rec = None
        if config.track_recommendation:
            t0 = clock()
            rec = recommend_and_score(
                fitter, blackboxes, stats, config,
                grid_size=config.recommendation_grid_size, seed=config.seed + it,
            )
            rec = sharding.broadcast_object(mesh, rec)
            phase_t["recommend"] = clock() - t0
            heartbeat.beat(f"iter{it}:recommend")
            print(
                f"[BO iter {it}] recommended {rec.num_points_final} points, "
                f"HV={rec.hv:.6f} / optimal {rec.hv_optimal:.6f} "
                f"(feasible={rec.feasible}, dropped={rec.num_infeasible})"
            )

        if config.plot_surfaces and out_dir is not None and fitter is not None:
            try:
                plot_iteration_surfaces(
                    os.path.join(log_dir, "plots"), it, fitter, cond, blackboxes,
                    stats, config,
                )
            except Exception as e:  # plotting must never kill a campaign
                print(f"[BO iter {it}] plotting failed: {e}")

        if phase_t:
            breakdown = " ".join(f"{k}={v:.2f}s" for k, v in phase_t.items())
            print(f"[BO iter {it}] phases: {breakdown}")
            if out_dir is not None:
                with open(os.path.join(log_dir, "phase_seconds.txt"), "a") as fh:
                    fh.write(
                        f"{it} {n} "
                        + " ".join(f"{phase_t.get(k, 0.0):.3f}" for k in PHASES)
                        + "\n"
                    )
        if out_dir is not None:
            with open(os.path.join(log_dir, "points_evaluated.txt"), "a") as fh:
                np.savetxt(fh, x_next)
            with open(os.path.join(log_dir, "fidelities_evaluated.txt"), "a") as fh:
                # one line per evaluated point, row-aligned with the points
                for fv in fid_batch:
                    fh.write(f"{float(fv)}\n")
            with open(os.path.join(log_dir, "observed_hypervolumes.txt"), "a") as fh:
                fh.write(f"{hv}\n")
            if rec is not None:
                # the reference's 6-tuple row (toy:616-618)
                with open(os.path.join(log_dir, "hypervolumes.txt"), "a") as fh:
                    fh.write(
                        f"{rec.hv:f} {rec.hv_optimal:f} {float(rec.feasible):f} "
                        f"{float(rec.num_infeasible):f} {float(rec.num_points_final):f} "
                        f"{float(rec.num_points_initial):f}\n"
                    )
                with open(os.path.join(log_dir, "hypervolume_solution.txt"), "a") as fh:
                    fh.write(f"{rec.hv_optimal:f}\n")
        if callback is not None:
            callback(it, state)
    return state


def plot_iteration_surfaces(
    plot_dir: str,
    it: int,
    fitter: BlackBoxMFDGPFitter,
    cond: Optional[BlackBoxMFDGPFitter],
    blackboxes: Sequence[Blackbox],
    stats: Dict[str, Tuple[float, float]],
    config: BOConfig,
    grid_res: int = 40,
) -> None:
    """Per-iteration contour plots: the predictive mean and std of every
    blackbox at every fidelity, and the coupled JES acquisition surface per
    fidelity (reference toy:139-226, 484-493). 2-D problems only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = fitter.x_train.shape[1]
    if d != 2:
        return
    os.makedirs(plot_dir, exist_ok=True)
    g = np.linspace(0.0, 1.0, grid_res)
    xx, yy = np.meshgrid(g, g)
    grid = torch.as_tensor(
        np.vstack([xx.ravel(), yy.ravel()]).T, dtype=fitter.dtype, device=fitter.device
    )

    nbb, nf = len(blackboxes), config.num_fidelities
    fig, axes = plt.subplots(nbb, 2 * nf, figsize=(4 * 2 * nf, 3.2 * nbb), squeeze=False)
    with torch.no_grad():
        for i, bb in enumerate(blackboxes):
            model = fitter.get_model(bb.name, is_constraint=bb.is_constraint)
            mean_s, std_s = stats[bb.name]
            for f in range(nf):
                mu, var = M.predict_for_acquisition(
                    model.params, model.consts, model.config, grid, f
                )
                mu = _to_numpy(mu[0]) * std_s + mean_s
                sd = np.sqrt(_to_numpy(var[0])) * std_s
                for j, (vals, label) in enumerate([(mu, "mean"), (sd, "std")]):
                    ax = axes[i][2 * f + j]
                    c = ax.contourf(xx, yy, vals.reshape(grid_res, grid_res), levels=20)
                    fig.colorbar(c, ax=ax)
                    ax.set_title(f"{bb.name} f={f} {label}")
    fig.suptitle(f"iteration {it}: predictive surfaces")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"predictive_iter{it}.pdf"))
    plt.close(fig)

    if cond is None:
        # no conditioned model (acquisition='random'): only the JES figure
        # needs one
        return

    jes = JESMOC_MFDGP(model=fitter, num_fidelities=nf, model_cond=cond, seed=config.seed + it)
    for bb in blackboxes:
        for f in range(nf):
            jes.add_blackbox(f, bb.name, cost_evaluation=bb.costs[f],
                             is_constraint=bb.is_constraint)
    fig, axes = plt.subplots(1, nf, figsize=(5 * nf, 4), squeeze=False)
    with torch.no_grad():
        for f in range(nf):
            acq = _to_numpy(jes.coupled_acq(grid, f))
            ax = axes[0][f]
            c = ax.contourf(xx, yy, acq.reshape(grid_res, grid_res), levels=20)
            fig.colorbar(c, ax=ax)
            ax.set_title(f"coupled JES acquisition f={f}")
    fig.suptitle(f"iteration {it}: acquisition surfaces")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, f"acquisition_iter{it}.pdf"))
    plt.close(fig)


@dataclasses.dataclass
class RecommendationScore:
    """Per-iteration recommendation metrics: the reference's 6-tuple
    hypervolumes.txt row (toy:616-618) plus the recommended set."""

    rec_set: np.ndarray  # truly-feasible recommended points
    hv: float  # HV of TRUE objective values at rec_set (toy:591-593)
    hv_optimal: float  # optimal HV on the same grid (toy:600-614)
    feasible: bool  # no recommended point violates a true constraint (toy:581)
    num_infeasible: int  # recommended points dropped as truly infeasible
    num_points_final: int  # rec points after dropping infeasible ones
    num_points_initial: int  # rec points after the model-mean Pareto cull


def recommend_and_score(
    fitter: BlackBoxMFDGPFitter,
    blackboxes: Sequence[Blackbox],
    stats: Dict[str, Tuple[float, float]],
    config: BOConfig,
    grid_size: int = 1000,
    feasibility_prob: float = 0.999,
    seed: int = 0,
) -> RecommendationScore:
    """Model-based recommendation + true-function hypervolume scoring
    (reference toy:533-614). The grid comes from numpy's default_rng(seed),
    as in the JAX package, so both score the same grid. Points the model
    deems feasible with P > 0.999 (top fidelity, likelihood noise
    subtracted, toy:545-546) are Pareto-culled on the model means in one
    pass without gradients (bo/recommend.py, layer 0 through K2); points
    that are truly infeasible are dropped (toy:583-589); the true
    functions' HV at the rest is scored against the optimal HV on the same
    grid, both through hypervolume_pair."""
    d = fitter.x_train.shape[1]
    rng = np.random.default_rng(seed)
    grid = rng.uniform(size=(grid_size, d))
    like = fitter.x_train
    grid_t = torch.as_tensor(grid, dtype=like.dtype, device=like.device)
    top = config.num_fidelities - 1

    objs = [bb for bb in blackboxes if not bb.is_constraint]
    cons = [bb for bb in blackboxes if bb.is_constraint]

    ref = (
        np.asarray(config.hv_reference, dtype=float)
        if config.hv_reference is not None
        else np.array([1000.0] * len(objs))  # reference point (1000,1000), toy:592
    )

    def true_values(pts):
        vals = np.stack(
            [np.asarray(bb.fns[top](pts)).reshape(-1) for bb in objs], axis=1
        )
        feas = np.ones(pts.shape[0], dtype=bool)
        for bb in cons:
            feas &= np.asarray(bb.fns[top](pts)).reshape(-1) >= bb.threshold
        return vals, feas

    # the optimal side is held and scored with the rec side at the end, so
    # the front cap of hypervolume_pair applies to both alike
    tv, tfeas = true_values(grid)
    opt_pts = tv[tfeas] if tfeas.any() else np.zeros((0, len(objs)))

    obj = trainer.stack_models([fitter.get_model(bb.name) for bb in objs])
    if cons:
        con = trainer.stack_models([fitter.get_model(bb.name, is_constraint=True) for bb in cons])
        con_p, con_c = con.params, con.consts
    else:
        con_p, con_c = empty_like_stack(obj.params, obj.consts)
    thr_std = torch.as_tensor(
        [(bb.threshold - stats[bb.name][0]) / stats[bb.name][1] for bb in cons],
        dtype=like.dtype, device=like.device,
    )
    obj_scale = torch.as_tensor(
        [[stats[bb.name][0], stats[bb.name][1]] for bb in objs],
        dtype=like.dtype, device=like.device,
    )
    _, feasible_t, mask_t = recommendation_model_pass(
        obj.params, obj.consts, con_p, con_c, obj.config, top, grid_t,
        thr_std, obj_scale, feasibility_prob,
    )
    feasible = feasible_t.cpu().numpy()
    if not feasible.any():
        hv_opt, _ = hypervolume_pair(opt_pts, np.zeros((0, len(objs))), ref)
        return RecommendationScore(np.zeros((0, d)), 0.0, hv_opt, False, 0, 0, 0)
    mask = mask_t.cpu().numpy()
    rec_set = grid[mask]
    num_ini = int(rec_set.shape[0])

    # drop recommended points that are TRULY infeasible (toy:583-589)
    rec_vals, rec_feas = true_values(rec_set)
    feasible_flag = bool(rec_feas.all())
    rec_set = rec_set[rec_feas]
    rec_vals = rec_vals[rec_feas]
    num_fini = int(rec_set.shape[0])

    hv_opt, hv_rec = hypervolume_pair(
        opt_pts, rec_vals if num_fini else np.zeros((0, len(objs))), ref
    )
    return RecommendationScore(
        rec_set=rec_set, hv=hv_rec, hv_optimal=hv_opt, feasible=feasible_flag,
        num_infeasible=num_ini - num_fini, num_points_final=num_fini,
        num_points_initial=num_ini,
    )


def _observed_hypervolume(blackboxes, state: BOState, config: BOConfig) -> float:
    objs = [bb for bb in blackboxes if not bb.is_constraint]
    cons = [bb for bb in blackboxes if bb.is_constraint]
    top = config.num_fidelities - 1
    sel = state.fidelities == top
    if not sel.any():
        return 0.0
    feas = np.ones(sel.sum(), dtype=bool)
    for bb in cons:
        feas &= state.ys[bb.name][sel] >= bb.threshold
    if not feas.any():
        return 0.0
    front = np.stack([state.ys[bb.name][sel][feas] for bb in objs], axis=1)
    ref = (
        np.asarray(config.hv_reference, dtype=float)
        if config.hv_reference is not None
        else front.max(axis=0) + 1.0
    )
    return hypervolume(front, ref)
