"""Hyperparameter introspection (counterpart of mobocmf_tpu/util/describe.py).

Parity with MFDGPHiddenLayer.print_lengthscales_and_outputscale
(reference mfdgp_hidden_layer.py:191-224): the constrained kernel
hyperparameters and likelihood noise of every layer of one (B = 1) model
as a dict; the BO loop writes them to <log_dir>/params/*.txt.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.util.tree import tree_map


def _softplus(raw) -> np.ndarray:
    raw = np.asarray(raw, dtype=np.float64)
    return np.log1p(np.exp(-np.abs(raw))) + np.maximum(raw, 0.0)


def describe_hyperparams(model: M.MFDGPModel) -> Dict[str, Dict]:
    """One host copy of the model's parameters, then numpy."""
    params = tree_map(lambda t: t.detach().cpu().double().numpy()[0], model.params)
    noise_lower = model.consts.noise_lower.detach().cpu().double().numpy()[0]
    noise_upper = model.consts.noise_upper.detach().cpu().double().numpy()[0]

    out: Dict[str, Dict] = {}
    for ell, lp in enumerate(params.layers):
        if ell == 0:
            out[f"layer_{ell}"] = {
                "l0_lengthscale": _softplus(lp.kernel["raw_lengthscale"]),
                "l0_outputscale": float(_softplus(lp.kernel["raw_outputscale"])),
            }
        else:
            alpha_x1 = float(_softplus(lp.kernel["kx1"]["raw_outputscale"]))
            alpha_f = float(_softplus(lp.kernel["kf"]["raw_outputscale"]))
            out[f"layer_{ell}"] = {
                "lengthscale_x1": _softplus(lp.kernel["kx1"]["raw_lengthscale"]),
                "lengthscale_f": _softplus(lp.kernel["kf"]["raw_lengthscale"]),
                "lengthscale_x2": _softplus(lp.kernel["kx2"]["raw_lengthscale"]),
                "alpha_x1": alpha_x1,
                "alpha_f": alpha_f,
                "alpha_x1f": alpha_x1 * alpha_f,
                "alpha_x2": float(_softplus(lp.kernel["kx2"]["raw_outputscale"])),
                "nu_lin": float(_softplus(lp.kernel["klin"]["raw_variance"])),
            }
        # the Interval noise transform (core/constraints.py), in numpy
        lo, hi = noise_lower[ell], noise_upper[ell]
        raw = float(params.raw_noises[ell])
        out[f"layer_{ell}"]["likelihood_noise"] = float(lo + (hi - lo) / (1.0 + np.exp(-raw)))
    return out


def print_lengthscales_and_outputscale(model: M.MFDGPModel, custom_print=print):
    for layer_name, vals in describe_hyperparams(model).items():
        custom_print({layer_name: vals})
