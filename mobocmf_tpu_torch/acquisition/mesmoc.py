"""MESMOC acquisition over MFGP models
(counterpart of mobocmf_tpu/acquisition/mesmoc.py).

Max-value entropy search with constraints. For an objective, the
truncated-Gaussian entropy reduction given its best value y*:

    a(x) = clamp( 0.5 log(sigma^2 + sigma_n^2) - 0.5 log(sigma_trunc^2 + sigma_n^2), 0 )
    sigma_trunc^2 = sigma^2 * clamp(1 + (g - r) r, CLAMP_LB),
    g = (y* - mu)/sigma,  r = pdf(g) / (1 - cdf(g))

For a constraint, the feasibility probability 1 - Phi((t - mu)/sigma).
The coupled acquisition is the sum of the objective entropies times the
product of the constraint probabilities at the HIGHEST fidelity; the
fidelity is chosen by value over cost, as JESMOC does.

The search (`optimize_coupled_mes`) factors every model's train Gram once
per fidelity (models/mfgp.py::posterior_state, one K1 launch each) and
maximizes with acquisition/optimize.py::optimize_acqf_box.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from mobocmf_tpu_torch.acquisition.optimize import optimize_acqf_box
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.models import mfgp as G

CLAMP_LB = float(np.finfo(np.float32).eps)  # reference MESMOC_MFGP.py:19
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _objective_entropy(model: G.MFGPModel, best_value, fidelity: int, x: torch.Tensor,
                       state: Optional[G.MFGPPosteriorState] = None) -> torch.Tensor:
    mean, var = G.predict(model, x, fidelity, state=state)
    g = (best_value - mean) / torch.sqrt(var)
    cdf = torch.clamp(torch.special.ndtr(g), max=1.0 - CLAMP_LB)
    pdf = torch.exp(-0.5 * g * g - _LOG_SQRT_2PI)
    ratio = pdf / (1.0 - cdf)
    var_trunc = var * torch.clamp(1.0 + (g - ratio) * ratio, min=CLAMP_LB)
    sigma_n = G.noise(model.params)
    ent_cond = 0.5 * torch.log(var_trunc + sigma_n)
    ent_uncond = 0.5 * torch.log(var + sigma_n)
    return torch.clamp(ent_uncond - ent_cond, min=0.0)


def _constraint_prob(model: G.MFGPModel, threshold, fidelity: int, x: torch.Tensor,
                     state: Optional[G.MFGPPosteriorState] = None) -> torch.Tensor:
    """1 - Phi((t - mu)/sigma), with the UNCLAMPED cdf (the reference's
    constraint branch, MESMOC_MFGP.py:71), so a deeply infeasible point is
    exactly 0."""
    mean, var = G.predict(model, x, fidelity, state=state)
    return 1.0 - torch.special.ndtr((threshold - mean) / torch.sqrt(var))


def mes_forward(model: G.MFGPModel, value, fidelity: int, is_constraint: bool,
                x: torch.Tensor) -> torch.Tensor:
    if is_constraint:
        return _constraint_prob(model, value, fidelity, x)
    return _objective_entropy(model, value, fidelity, x)


def coupled_mes(obj_models, best_values, con_models, thresholds, fidelity: int,
                top_fidelity: int, x: torch.Tensor, obj_states=None,
                con_states=None) -> torch.Tensor:
    """Sum of the objective entropies at `fidelity` times the product of
    the constraint probabilities at `top_fidelity`, (N,)."""
    obj_states = obj_states or (None,) * len(obj_models)
    con_states = con_states or (None,) * len(con_models)
    acq = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for model, best, st in zip(obj_models, best_values, obj_states):
        acq = acq + _objective_entropy(model, best, fidelity, x, state=st)
    prob = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    for model, thr, st in zip(con_models, thresholds, con_states):
        prob = prob * _constraint_prob(model, thr, top_fidelity, x, state=st)
    return acq * prob


def optimize_coupled_mes(obj_models, best_values, con_models, thresholds, fidelity: int,
                         top_fidelity: int, generator: Optional[torch.Generator], input_dim: int,
                         num_restarts: int = 5, raw_samples: int = 200, maxiter: int = 200,
                         raw: Optional[torch.Tensor] = None):
    """Maximize coupled_mes over [0, 1]^d: (x (d,), value ()). Each model's
    posterior state is computed once, before the search."""
    like = obj_models[0].x_train
    with torch.no_grad():
        obj_states = tuple(G.posterior_state(m) for m in obj_models)
        con_states = tuple(G.posterior_state(m) for m in con_models)

    def acq(xx):
        return coupled_mes(obj_models, best_values, con_models, thresholds, fidelity,
                           top_fidelity, xx, obj_states, con_states)

    return optimize_acqf_box(acq, input_dim, generator, num_restarts=num_restarts,
                             raw_samples=raw_samples, maxiter=maxiter, dtype=like.dtype,
                             device=like.device, raw=raw)


class _MES_MFGP:
    def __init__(self, fidelity: int, model: G.MFGPModel, best_value: float,
                 is_constraint: bool):
        self.fidelity = fidelity
        self.model = model
        self.best_value = float(best_value)
        self.is_constraint = is_constraint

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim > 2:  # botorch-style (b, q=1, d) batches
            x = x[:, 0, :]
        return mes_forward(self.model, self.best_value, self.fidelity, self.is_constraint, x)


class MESMOC_MFGP:
    def __init__(
        self,
        objectives: Dict[str, G.MFGPModel],
        constraints: Dict[str, G.MFGPModel],
        input_dim: int,
        num_fidelities: int,
        best_objective_values: Dict[str, float],
        constraint_thresholds: Dict[str, float],
        standard_bounds=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        """The models live on `device` (`cuda` unless named); the search's
        raw samples come from a torch.Generator there, seeded `seed`."""
        self.device = resolve_device(device)
        self.standard_bounds = standard_bounds
        self.num_fidelities = num_fidelities
        self.input_dim = input_dim
        self.objectives = objectives
        self.constraints = constraints
        self.best_objective_values = best_objective_values
        self.constraint_thresholds = constraint_thresholds
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.acquisition_objs: Dict[int, Dict[str, _MES_MFGP]] = {}
        self.acquisition_cons: Dict[int, Dict[str, _MES_MFGP]] = {}
        self.costs_blackboxes: Dict[int, Dict[str, float]] = {}
        for n_f in range(num_fidelities):
            self.acquisition_objs[n_f] = {}
            self.acquisition_cons[n_f] = {}
            self.costs_blackboxes[n_f] = {"total": 0.0}
        # the last search's best value per fidelity searched
        self.last_values: Dict[int, float] = {}

    def add_blackbox(self, fidelity: int, blackbox_name: str, cost_evaluation: float = 1.0,
                     is_constraint: bool = False) -> _MES_MFGP:
        if not is_constraint:
            mes = _MES_MFGP(fidelity, self.objectives[blackbox_name],
                            self.best_objective_values[blackbox_name], False)
            self.acquisition_objs[fidelity][blackbox_name] = mes
            self.costs_blackboxes[fidelity]["total"] += cost_evaluation
            self.costs_blackboxes[fidelity][blackbox_name] = cost_evaluation
        else:
            mes = _MES_MFGP(fidelity, self.constraints[blackbox_name],
                            self.constraint_thresholds[blackbox_name], True)
            self.acquisition_cons[fidelity][blackbox_name] = mes
        return mes

    def _gather(self, fidelity: int):
        top = self.num_fidelities - 1
        objs = list(self.acquisition_objs[fidelity].values())
        cons = list(self.acquisition_cons[top].values())
        return (tuple(a.model for a in objs), tuple(a.best_value for a in objs),
                tuple(a.model for a in cons), tuple(a.best_value for a in cons), top)

    def coupled_acq(self, x: torch.Tensor, fidelity: int) -> torch.Tensor:
        if x.ndim > 2:
            x = x[:, 0, :]
        return coupled_mes(*self._gather(fidelity)[:4], fidelity, self.num_fidelities - 1, x)

    def get_nextpoint_coupled(self, iteration=None, verbose: bool = False):
        """(x (d,), fidelity): the best value over cost across fidelities."""
        best_weighted, best_x, best_fid = None, None, 0
        self.last_values = {}
        for fidelity in range(self.num_fidelities):
            obj_models, best_values, con_models, thresholds, top = self._gather(fidelity)
            if not obj_models:  # no objective registered at this fidelity
                continue
            x_f, value = optimize_coupled_mes(obj_models, best_values, con_models, thresholds,
                                              fidelity, top, self.generator, self.input_dim)
            self.last_values[fidelity] = float(value)
            weighted = float(value) / self.costs_blackboxes[fidelity]["total"]
            if best_weighted is None or weighted > best_weighted:
                best_weighted, best_x, best_fid = weighted, x_f.detach(), fidelity
        if best_x is None:
            raise ValueError("no objectives registered at any fidelity")
        if verbose:
            print(f"Iter: {iteration} Acquisition: "
                  f"{best_weighted * self.costs_blackboxes[best_fid]['total']} "
                  f"Evaluating fidelity {best_fid} at {best_x}")
        return best_x, best_fid
