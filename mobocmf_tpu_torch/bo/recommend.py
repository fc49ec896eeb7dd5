"""The model side of the per-iteration recommendation
(counterpart of mobocmf_tpu/bo/loop.py::_recommendation_model_pass).

On a grid at one fidelity: the per-objective unstandardized predictive
means, the latent feasibility probability of every constraint (likelihood
noise subtracted, reference toy_synthetic_2D_JESMOCMF.py:545-546), and the
feasible Pareto cull of the means. Objectives and constraints are stacked
into one model for one forward without gradients, so layer 0 of every
model runs through K2 (models/mfdgp.py::uses_k2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.moop.moop import pareto_front_mask


def recommendation_model_pass(
    obj_p: M.MFDGPParams,
    obj_c: M.MFDGPConsts,
    con_p: M.MFDGPParams,
    con_c: M.MFDGPConsts,
    config: M.MFDGPConfig,
    fidelity: int,
    grid: torch.Tensor,
    thr_std: torch.Tensor,
    obj_scale: torch.Tensor,
    feasibility_prob: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """obj_* / con_*: the stacked objective and constraint models (the
    constraint stack may be empty); grid (G, d); thr_std (C,) standardized
    thresholds; obj_scale (O, 2) the (mean, std) that unstandardize each
    objective. Returns (means (O, G), feasible (G,), pareto mask (G,))."""
    num_obj = obj_scale.shape[0]
    stacked = trainer.stack_models([M.MFDGPModel(obj_p, obj_c, config),
                                    M.MFDGPModel(con_p, con_c, config)])
    with torch.no_grad():
        mu, var = M.predict_for_acquisition(
            stacked.params, stacked.consts, config, grid, fidelity
        )
        means = mu[:num_obj] * obj_scale[:, 1:2] + obj_scale[:, 0:1]
        noise = M.likelihood_noise(stacked.params, stacked.consts, fidelity)[num_obj:]
        var_latent = torch.clamp(var[num_obj:] - noise[:, None], min=1e-12)
        p_feas = 1.0 - torch.special.ndtr((thr_std[:, None] - mu[num_obj:]) / torch.sqrt(var_latent))
        feasible = torch.all(p_feas > feasibility_prob, dim=0)
        mask = pareto_front_mask(means.mT, feasible)
    return means, feasible, mask
