"""The deep multi-fidelity kernel of MFDGP layers > 0
(counterpart of mobocmf_tpu/kernels/deep_mf.py).

Over augmented inputs [x, f] (f = previous-layer output, last column):

    k([x,f],[x',f']) = k_x1(x,x') * (k_lin(f,f') + k_f(f,f')) + k_x2(x,x')

Initialization: k_x1.ls = 10*ls0, k_f.ls = 1, k_x2.ls = ls0, k_lin.var = 1,
outputscales (1, 1, 0.01). The `only_hf` variant keeps k_x2(x,x') alone.
Leading batch dims as in kernels/rbf.py.
"""

from __future__ import annotations

from typing import Dict

import torch

from mobocmf_tpu_torch.kernels import rbf


def init_deep_mf_params(init_lengthscale, input_dims_x: int, dtype=torch.float64) -> Dict:
    """Raw params for a deep layer kernel; `input_dims_x` is the dim of x."""
    ls0 = torch.as_tensor(init_lengthscale, dtype=dtype)
    return {
        "kx1": rbf.init_scale_rbf_params(ls0 * 10.0, 1.0, input_dims_x, dtype),
        "kf": rbf.init_scale_rbf_params(1.0, 1.0, 1, dtype),
        "kx2": rbf.init_scale_rbf_params(ls0, 0.01, input_dims_x, dtype),
        "klin": rbf.init_linear_params(1.0, dtype),
    }


def init_only_hf_params(init_lengthscale, input_dims_x: int, dtype=torch.float64) -> Dict:
    """only-HF ablation: k_x2 gets outputscale 1."""
    p = init_deep_mf_params(init_lengthscale, input_dims_x, dtype)
    p["kx2"] = rbf.init_scale_rbf_params(
        torch.as_tensor(init_lengthscale, dtype=dtype), 1.0, input_dims_x, dtype
    )
    return p


def _split(xf: torch.Tensor):
    return xf[..., :-1], xf[..., -1:]


def deep_mf_gram(params: Dict, xf1: torch.Tensor, xf2: torch.Tensor) -> torch.Tensor:
    x1, f1 = _split(xf1)
    x2, f2 = _split(xf2)
    kx1 = rbf.rbf_gram(params["kx1"], x1, x2)
    kf = rbf.rbf_gram(params["kf"], f1, f2)
    klin = rbf.linear_gram(params["klin"], f1, f2)
    kx2 = rbf.rbf_gram(params["kx2"], x1, x2)
    return kx1 * (klin + kf) + kx2


def deep_mf_diag(params: Dict, xf: torch.Tensor) -> torch.Tensor:
    x, f = _split(xf)
    kx1 = rbf.rbf_diag(params["kx1"], x)
    kf = rbf.rbf_diag(params["kf"], f)
    klin = rbf.linear_diag(params["klin"], f)
    kx2 = rbf.rbf_diag(params["kx2"], x)
    return kx1 * (klin + kf) + kx2


def only_hf_gram(params: Dict, xf1: torch.Tensor, xf2: torch.Tensor) -> torch.Tensor:
    x1, _ = _split(xf1)
    x2, _ = _split(xf2)
    return rbf.rbf_gram(params["kx2"], x1, x2)


def only_hf_diag(params: Dict, xf: torch.Tensor) -> torch.Tensor:
    x, _ = _split(xf)
    return rbf.rbf_diag(params["kx2"], x)
