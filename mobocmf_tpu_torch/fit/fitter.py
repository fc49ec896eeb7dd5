"""BlackBoxMFDGPFitter: the training and conditioning engine
(counterpart of mobocmf_tpu/fit/fitter.py).

Holds one MFDGP per blackbox (objectives and constraints share x: coupled
evaluation), trains all of them at once with the two-phase schedule,
stacked on a leading blackbox dim, samples a Pareto solution through MOOP
over RFF pathwise samples, and retrains every model conditioned on it
(theta / omega factors, fit/conditioned.py).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.fit import bucketing, trainer
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.linalg import chol
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.moop.moop import MOOP, NotFeasiblePoints, ParetoSolution, SampledFunction
from mobocmf_tpu_torch.sampling import rff
from mobocmf_tpu_torch.util import counters

MAX_TRIES_FOR_FEASIBLE_GRID = 50  # reference MFDGPHandler.MAX_TRIES_FOR_FEASIBLE_GRID


class BlackBoxMFDGPFitter:
    def __init__(
        self,
        num_fidelities: int,
        batch_size: int,
        lr_1: float = 0.003,
        lr_2: float = 0.001,
        num_epochs_1: int = 5000,
        num_epochs_2: int = 15000,
        pareto_set_size: int = 50,
        opt_grid_size: int = 1000,
        eps: float = 1e-8,
        decoupled_evals: bool = False,
        type_lengthscale: TL = TL.MEDIAN,
        seed: int = 0,
        whitened: bool = False,
        whitened_init: str = "match",
        pad_data: bool = False,
        polish: str = "slsqp",
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        """Constructor defaults of the JAX fitter (fitter.py:39-58).
        pad_data: bucket the training rows (fit/bucketing.py). polish: the
        MOOP's polish of each objective's optimum, "slsqp" (host scipy),
        "device" (batched penalty L-BFGS on the device) or "none". device:
        `cuda` unless named; dtype: float32 unless named (the CPU parity
        tests pass float64). mesh: passed to the MOOP only, which shards its
        grid evaluations over 'dp' (parallel/sharding.py), as in the JAX
        fitter; every rank of the mesh runs the fitter."""
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.num_obj = 0
        self.num_con = 0
        self.models_uncond_trained = False

        self.models_objs: Dict[str, M.MFDGPModel] = {}
        self.models_cons: Dict[str, M.MFDGPModel] = {}
        self.obj_names: List[str] = []
        self.con_names: List[str] = []
        self.thresholds_cons: List[float] = []

        self.x_train: Optional[torch.Tensor] = None
        self.fidelities: Optional[torch.Tensor] = None
        self.ys_objs: List[torch.Tensor] = []
        self.ys_cons: List[torch.Tensor] = []
        self.pad_data = pad_data
        self.num_real: Optional[int] = None
        self.row_weights: Optional[torch.Tensor] = None

        self.num_fidelities = num_fidelities
        self.batch_size = batch_size
        self.lr_1, self.lr_2 = lr_1, lr_2
        self.num_epochs_1, self.num_epochs_2 = num_epochs_1, num_epochs_2
        self.pareto_set_size = pareto_set_size
        self.opt_grid_size = opt_grid_size
        self.eps = eps
        self.decoupled_evals = decoupled_evals
        self.type_lengthscale = type_lengthscale
        self.whitened = whitened
        self.whitened_init = whitened_init
        self.polish = polish
        self.mesh = mesh
        # host draws (acq_eps at init) and device draws (training eps, RFF
        # frequencies and phases, MOOP grids, conditioned draws)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._x_np: Optional[np.ndarray] = None
        # one entry per trained phase: epochs, seconds, first/last summed
        # loss, K1 launches and ladder escalations during the phase, and its
        # capture record and chunks as trainer.run_chunks gives them
        self.phase_stats: List[dict] = []
        # seconds of initialize_mfdgp's warm-start fetch, host math and ship
        # to the device, summed over blackboxes (models/mfdgp.py::init_mfdgp)
        self.init_timings: Dict[str, float] = {}

        self.pareto_solution: Optional[ParetoSolution] = None
        self.samples_objs = None
        self.samples_cons = None
        self.pareto_tries = 0

    # -- setup -----------------------------------------------------------------

    def initialize_mfdgp(
        self,
        x_train,
        y_train,
        fidelities,
        blackbox_name: str,
        threshold_constraint: float = 0.0,
        is_constraint: bool = False,
        previously_trained_model: Optional[M.MFDGPModel] = None,
        init_params_to_prior_and_fix_them: bool = False,
        use_only_highest_fidelity: bool = False,
    ):
        x_np = np.asarray(x_train, dtype=np.float64)
        y_np = np.asarray(y_train, dtype=np.float64).reshape(-1)
        f_np = np.asarray(fidelities).reshape(-1).astype(np.int32)
        n_real = x_np.shape[0]
        if self.pad_data:
            target = bucketing.next_bucket(n_real)
            x_np, f_np, w_np = bucketing.pad_inputs_np(x_np, f_np, target)
            y_np = bucketing.pad_rows_np(y_np, target)
        else:
            w_np = np.ones((n_real,), dtype=x_np.dtype)
        if self.x_train is None:
            self._x_np = x_np
            self.x_train = torch.as_tensor(x_np, dtype=self.dtype, device=self.device)
            self.fidelities = torch.as_tensor(f_np, device=self.device)
            self.num_real = n_real
            self.row_weights = torch.as_tensor(w_np, dtype=self.dtype, device=self.device)
        elif not np.array_equal(self._x_np, x_np):
            raise ValueError(
                "The inputs for this new mfdgp do not match previous models; "
                "coupled evaluation only (reference :87-91)."
            )
        model = M.init_mfdgp(
            x_np, y_np, f_np, self.num_fidelities,
            type_lengthscale=self.type_lengthscale,
            use_only_highest_fidelity=use_only_highest_fidelity,
            previously_trained=previously_trained_model,
            whitened=self.whitened,
            whitened_init=self.whitened_init,
            init_params_to_prior_and_fix_them=init_params_to_prior_and_fix_them,
            generator=self.host_generator,
            device=self.device,
            dtype=self.dtype,
            timings=self.init_timings,
        )
        y_dev = torch.as_tensor(y_np, dtype=self.dtype, device=self.device)
        if is_constraint:
            self.models_cons[blackbox_name] = model
            self.con_names.append(blackbox_name)
            self.ys_cons.append(y_dev)
            self.thresholds_cons.append(float(threshold_constraint))
            self.num_con += 1
        else:
            self.models_objs[blackbox_name] = model
            self.obj_names.append(blackbox_name)
            self.ys_objs.append(y_dev)
            self.num_obj += 1

    # -- unconditioned training ------------------------------------------------

    def _effective_batch_size(self) -> int:
        """Full-batch intent (batch_size >= real rows) covers the padded rows too."""
        n = self.x_train.shape[0]
        if self.batch_size >= self.num_real:
            return n
        return self.batch_size

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase_record(self, label, phase, epochs, seconds, losses, launches0, esc0,
                      stats) -> dict:
        return dict(
            label=label, phase=phase, epochs=epochs, seconds=seconds,
            first=float(losses[0]), last=float(losses[-1]),
            chol_launches=counters.get("k1.launches") - launches0,
            escalations=chol.escalations() - esc0, **stats,
        )

    def _train_group(self, entries, label):
        """entries: (name, is_constraint, y). Objectives and constraints
        share x and shapes, so all stack into one model trained at once."""
        models = [
            self.models_cons[n] if is_con else self.models_objs[n] for n, is_con, _ in entries
        ]
        stacked = trainer.stack_models(models)
        ys = torch.stack([y for _, _, y in entries])
        num_data = torch.tensor(float(self.num_real), dtype=self.dtype, device=self.device)

        for phase, (epochs, lr, mask_kind) in enumerate(
            [
                (self.num_epochs_1, self.lr_1, "fix_variational_hypers"),
                (self.num_epochs_2, self.lr_2, "all_free"),
            ]
        ):
            if epochs == 0:
                continue
            launches0, esc0 = counters.get("k1.launches"), chol.escalations()
            self._sync()
            t0 = time.perf_counter()
            # a NaN model would poison every later stage: the trainer fails
            # fast at the end of the chunk that produced it
            stats: dict = {}
            params, logs = trainer.train_phase_stacked_chunked(
                stacked, self.x_train, ys, self.fidelities, epochs, lr, mask_kind,
                self._effective_batch_size(), self.row_weights, num_data,
                generator=self.generator, stats=stats, label=label,
            )
            self._sync()
            seconds = time.perf_counter() - t0
            stacked = stacked._replace(params=params)
            loss = logs.loss.sum(dim=0).cpu().numpy()
            self.phase_stats.append(self._phase_record(
                label, phase + 1, epochs, seconds, loss, launches0, esc0, stats))
            print(
                f"[{label}] phase {phase + 1}: epochs={epochs} "
                f"first/last neg-ELBO {loss[0]:.4f} / {loss[-1]:.4f}",
                flush=True,
            )

        for i, (n, is_con, _) in enumerate(entries):
            d = self.models_cons if is_con else self.models_objs
            d[n] = trainer.select_model(stacked, i)

    def train_mfdgps(self):
        """Two-phase schedule (reference :154-176), all blackboxes at once."""
        entries = [(n, False, y) for n, y in zip(self.obj_names, self.ys_objs)] + [
            (n, True, y) for n, y in zip(self.con_names, self.ys_cons)
        ]
        if entries:
            self._train_group(entries, "ALL")
        self.models_uncond_trained = True

    # -- Pareto sampling ---------------------------------------------------------

    def _sample_models(self, names, models_dict) -> List[rff.MFDGPFunctionSample]:
        """Pathwise samples of the (same-shaped) blackbox models, one
        batched layer-state pass for all of them."""
        m = trainer.stack_models([models_dict[n] for n in names])
        return rff.sample_posterior_stacked(self.generator, m.params, m.consts, m.config)

    def _pareto_attempt(self, moop: MOOP, allow_negative: bool):
        self.pareto_tries += 1
        return moop.compute_pareto_solution_from_samples(
            self.x_train.double().cpu().numpy(), self.generator,
            allow_negative_constraints=allow_negative,
            inputs_valid=(self.row_weights > 0).cpu().numpy(),
            like=self.x_train,
        )

    def _sample_and_store_pareto_solution(self) -> ParetoSolution:
        samples_objs = self._sample_models(self.obj_names, self.models_objs)
        obj_fns = [SampledFunction(rff.eval_sample_fn, s) for s in samples_objs]
        moop, samples_cons = None, []
        for try_idx in range(MAX_TRIES_FOR_FEASIBLE_GRID):
            if try_idx > 0 and try_idx % 10 == 0:
                # degenerate objective samples would make the retries spin:
                # refresh them every 10 tries (beyond the reference, :181-186)
                samples_objs = self._sample_models(self.obj_names, self.models_objs)
                obj_fns = [SampledFunction(rff.eval_sample_fn, s) for s in samples_objs]
            samples_cons = (
                self._sample_models(self.con_names, self.models_cons) if self.con_names else []
            )
            con_fns = [SampledFunction(rff.eval_sample_fn, s) for s in samples_cons]
            moop = MOOP(
                obj_fns, con_fns,
                input_dim=self.x_train.shape[1],
                grid_size=self.opt_grid_size * self.x_train.shape[1],
                pareto_set_size=self.pareto_set_size,
                feasible_values=-1.0 * np.asarray(self.thresholds_cons),
                polish=self.polish,
                mesh=self.mesh,
            )
            res = self._pareto_attempt(moop, False)
            if res is not None:
                break
            if (try_idx + 1) % 5 == 0:
                print(f"[pareto] no feasible grid after {try_idx + 1} constraint resamples; "
                      "retrying", flush=True)
        else:
            res = self._pareto_attempt(moop, True)
            if res is None:
                raise NotFeasiblePoints(
                    "[ERROR] No feasible points were found in the constraint space! "
                    f"# tries: {MAX_TRIES_FOR_FEASIBLE_GRID}."
                )
        self.pareto_solution = res[0]
        self.samples_objs, self.samples_cons = samples_objs, samples_cons
        return self.pareto_solution

    def sample_and_store_pareto_solution(self) -> ParetoSolution:
        """Retry-forever wrapper (reference :219-225); self.pareto_tries
        counts the MOOP attempts this call took (1 = the first draw worked)."""
        self.pareto_tries = 0
        while True:
            try:
                return self._sample_and_store_pareto_solution()
            except NotFeasiblePoints:
                print("Not feasible solution found, trying another time!", flush=True)

    @property
    def pareto_set(self) -> torch.Tensor:
        return self.pareto_solution.pareto_set

    @property
    def pareto_front(self) -> torch.Tensor:
        return self.pareto_solution.pareto_front

    # -- conditioned training ------------------------------------------------------

    def train_conditioned_mfdgps(self):
        """Joint conditioned retraining of every model on the stored Pareto
        solution (reference :227-348), num_epochs_2 iterations at lr_2."""
        if self.pareto_solution is None:
            raise RuntimeError("sample a Pareto solution first")
        obj = trainer.stack_models([self.models_objs[n] for n in self.obj_names])
        if self.con_names:
            con = trainer.stack_models([self.models_cons[n] for n in self.con_names])
            cp, cc = con.params, con.consts
            ys_con = torch.stack(self.ys_cons)
        else:
            # explicitly empty stacked constraint params (leading dim 0)
            cp, cc = C.empty_like_stack(obj.params, obj.consts)
            ys_con = torch.zeros((0, self.x_train.shape[0]), dtype=self.dtype, device=self.device)
        sol = self.pareto_solution
        data = C.ConditionedData(
            x=self.x_train,
            ys_obj=torch.stack(self.ys_objs),
            ys_con=ys_con,
            fidelities=self.fidelities,
            pareto_set=sol.pareto_set,
            pareto_front=sol.pareto_front,
            front_mask=sol.mask,
            thresholds=torch.as_tensor(self.thresholds_cons, dtype=self.dtype, device=self.device),
            row_weights=self.row_weights,
        )
        launches0, esc0 = counters.get("k1.launches"), chol.escalations()
        self._sync()
        t0 = time.perf_counter()
        stats: dict = {}
        op, cp, losses = C.train_conditioned_chunked(
            obj.params, cp, obj.consts, cc, obj.config, data, self.generator,
            self.num_epochs_2, self.lr_2, self.eps, self._effective_batch_size(), stats=stats,
        )
        self._sync()
        seconds = time.perf_counter() - t0
        losses = losses.cpu().numpy()
        if losses.size:
            self.phase_stats.append(self._phase_record(
                "COND", "cond", self.num_epochs_2, seconds, losses, launches0, esc0, stats))
            print(f"[COND] iters={self.num_epochs_2} first/last loss "
                  f"{losses[0]:.4f} / {losses[-1]:.4f}", flush=True)
        for n, p in zip(self.obj_names, trainer.unstack_params(op, len(self.obj_names))):
            self.models_objs[n] = self.models_objs[n]._replace(params=p)
        for n, p in zip(self.con_names, trainer.unstack_params(cp, len(self.con_names))):
            self.models_cons[n] = self.models_cons[n]._replace(params=p)

    # -- misc ------------------------------------------------------------------

    def copy_uncond(self) -> "BlackBoxMFDGPFitter":
        """Snapshot sharing the current tensors: every trainer returns new
        parameter tensors and never writes into a model it was given."""
        new = copy.copy(self)
        new.models_objs = dict(self.models_objs)
        new.models_cons = dict(self.models_cons)
        new.obj_names = list(self.obj_names)
        new.con_names = list(self.con_names)
        new.ys_objs = list(self.ys_objs)
        new.ys_cons = list(self.ys_cons)
        new.thresholds_cons = list(self.thresholds_cons)
        new.phase_stats = list(self.phase_stats)
        return new

    def get_model(self, name: str, is_constraint: bool = False) -> M.MFDGPModel:
        if is_constraint:
            return self.models_cons[name]
        return self.models_objs[name]
