"""Scale-RBF-ARD and linear kernels over raw-param dicts
(counterpart of mobocmf_tpu/kernels/rbf.py).

    k_scale_rbf(x, z) = outputscale * exp(-0.5 * sum_d ((x_d - z_d)/ls_d)^2)
    k_lin(x, z)       = variance * x @ z.T

Every function takes leading batch dims: a stacked model's raw params carry
a leading blackbox dim (raw_lengthscale (B, d), raw_outputscale (B,)), and
the inputs are (n, d) shared by all blackboxes or (B, n, d).
"""

from __future__ import annotations

from typing import Dict

import torch

from mobocmf_tpu_torch.core.constraints import Positive

_positive = Positive()


def init_scale_rbf_params(lengthscale, outputscale, ard_dims: int, dtype=torch.float64) -> Dict:
    """Raw params for outputscale * RBF_ard. `lengthscale` scalar or (d,)."""
    ls = torch.broadcast_to(torch.as_tensor(lengthscale, dtype=dtype), (ard_dims,))
    return {
        "raw_lengthscale": _positive.inverse(ls),
        "raw_outputscale": _positive.inverse(torch.as_tensor(outputscale, dtype=dtype)),
    }


def init_linear_params(variance, dtype=torch.float64) -> Dict:
    return {"raw_variance": _positive.inverse(torch.as_tensor(variance, dtype=dtype))}


def scale_rbf_constrained(params: Dict):
    return _positive.forward(params["raw_lengthscale"]), _positive.forward(
        params["raw_outputscale"]
    )


def rbf_gram(params: Dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """outputscale * exp(-0.5 ||(x1-x2)/ls||^2), shape (..., n1, n2), by the
    expansion trick ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b, clamped at 0."""
    ls, os_ = scale_rbf_constrained(params)
    ls = ls.unsqueeze(-2)
    a = x1 / ls
    b = x2 / ls
    sq_a = torch.sum(a * a, dim=-1, keepdim=True)
    sq_b = torch.sum(b * b, dim=-1, keepdim=True)
    d2 = torch.clamp(sq_a - 2.0 * (a @ b.mT) + sq_b.mT, min=0.0)
    return os_[..., None, None] * torch.exp(-0.5 * d2)


def rbf_diag(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """diag of rbf_gram(x, x): the outputscale at every point, (..., n)."""
    _, os_ = scale_rbf_constrained(params)
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) * os_[..., None]


def linear_gram(params: Dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    v = _positive.forward(params["raw_variance"])
    return v[..., None, None] * (x1 @ x2.mT)


def linear_diag(params: Dict, x: torch.Tensor) -> torch.Tensor:
    v = _positive.forward(params["raw_variance"])
    return v[..., None] * torch.sum(x * x, dim=-1)
