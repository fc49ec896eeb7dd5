"""Multi-fidelity variational ELBO (counterpart of mobocmf_tpu/mlls/elbo.py).

    elbo = sum_i sum_{n: fid_n = i} E_q[log N(y_n | f_i(x_n), sigma_i^2)]
           - KL * num_batch / num_data

with the Gaussian expected log prob
-0.5 [log(2 pi sigma^2) + ((y - mu)^2 + var) / sigma^2]. Row weights (0/1)
mask padded rows; num_batch is then their sum. Everything is per blackbox:
y, fidelities and weights are (N,) shared or (B, N), results are (B,).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mobocmf_tpu_torch.models import mfdgp as M


def gaussian_expected_log_prob(y, mu, var, noise):
    """Per-point E_{q(f)}[log N(y | f, noise)]."""
    return -0.5 * (torch.log(2.0 * math.pi * noise) + ((y - mu) ** 2 + var) / noise)


def _data_term(params, consts, config, outs, y, fid, weights):
    data_term = 0.0
    for i in range(config.num_fidelities):
        mu, var = outs[i]
        noise = M.likelihood_noise(params, consts, i).unsqueeze(-1)
        ll = gaussian_expected_log_prob(y, mu, var, noise)
        sel = torch.where(fid == i, ll, torch.zeros_like(ll))
        if weights is not None:
            sel = sel * weights
        data_term = data_term + torch.sum(sel, dim=-1)
    return data_term


def elbo_terms(
    params: M.MFDGPParams,
    consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    fidelities: torch.Tensor,
    eps: torch.Tensor,
    num_data,
    weights: Optional[torch.Tensor] = None,
    states=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(elbo, scaled_kl) per blackbox, like VariationalELBOMF.forward."""
    if states is None:
        states = M.compute_layer_states(params, consts, config)
    outs = M.forward(params, consts, config, x, eps, states=states)
    num_batch = y.shape[-1] if weights is None else torch.sum(weights, dim=-1)
    data_term = _data_term(params, consts, config, outs, y, fidelities, weights)
    kl = M.kl_all_layers(params, consts, config, states=states)
    scaled_kl = kl * num_batch / num_data
    return data_term - scaled_kl, scaled_kl


def elbo_data_term(
    params: M.MFDGPParams,
    consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    fidelities: torch.Tensor,
    eps: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    states=None,
) -> torch.Tensor:
    """Data term only (the include_kl_term=False path)."""
    outs = M.forward(params, consts, config, x, eps, states=states)
    return _data_term(params, consts, config, outs, y, fidelities, weights)
