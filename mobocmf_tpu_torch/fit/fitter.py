"""BlackBoxMFDGPFitter: model setup and unconditioned training
(counterpart of mobocmf_tpu/fit/fitter.py).

Holds one MFDGP per blackbox (objectives and constraints share x: coupled
evaluation), and trains all of them at once with the two-phase schedule,
stacked on a leading blackbox dim. Pareto sampling and conditioned training
are not ported yet.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.fit import bucketing, trainer
from mobocmf_tpu_torch.linalg import chol
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.util.tree import tree_leaves


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
        device: DeviceLike = None,
        dtype: Optional[torch.dtype] = None,
    ):
        """Constructor defaults of the JAX fitter (fitter.py:39-58).
        pareto_set_size, opt_grid_size and decoupled_evals are kept for the
        Pareto-sampling stage, not ported yet. pad_data: bucket the training
        rows (fit/bucketing.py). device: `cuda` unless named; dtype: float32
        unless named (the CPU parity tests pass float64)."""
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
        # host draws (acq_eps at init) and device draws (training eps)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._x_np: Optional[np.ndarray] = None
        # one entry per trained phase: epochs, seconds, first/last summed
        # neg-ELBO, K1 launches and ladder escalations during the phase
        self.phase_stats: List[dict] = []

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
            launches0, esc0 = chol.launches, chol.escalations()
            self._sync()
            t0 = time.perf_counter()
            params, logs = trainer.train_phase_stacked(
                stacked, self.x_train, ys, self.fidelities, epochs, lr, mask_kind,
                self._effective_batch_size(), self.row_weights, num_data,
                generator=self.generator,
            )
            self._sync()
            seconds = time.perf_counter() - t0
            stacked = stacked._replace(params=params)
            loss = logs.loss.sum(dim=0).cpu().numpy()
            self.phase_stats.append(dict(
                label=label, phase=phase + 1, epochs=epochs, seconds=seconds,
                first=float(loss[0]), last=float(loss[-1]),
                chol_launches=chol.launches - launches0,
                escalations=chol.escalations() - esc0,
            ))
            print(
                f"[{label}] phase {phase + 1}: epochs={epochs} "
                f"first/last neg-ELBO {loss[0]:.4f} / {loss[-1]:.4f}",
                flush=True,
            )

        # a NaN model would poison every later stage: fail fast
        finite = torch.stack([torch.isfinite(t).all() for t in tree_leaves(stacked.params)]).all()
        if not bool(finite):
            raise RuntimeError(
                f"[{label}] unconditioned training produced non-finite parameters "
                "(f32 numerical escape; check safe_cholesky escalation and output scaling)"
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
