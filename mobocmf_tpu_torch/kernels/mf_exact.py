"""Multi-fidelity kernels of the exact-GP models MFGP and MFGP_lin
(counterpart of mobocmf_tpu/kernels/mf_exact.py).

MFKernel, over inputs whose LAST column is the 0-based fidelity:

    K = k_signal(x, x') + min(fid, fid') * k_noise(x, x')

with Interval(1e-3, 1e3) lengthscales and Interval(1e-3, 1e2)
outputscales (init 1.0 / 0.1).

MFKernel_lin, an AR(1)-style kernel with learnable correlations
rho in R^{F-1} (init 0.5):

    signal factor[i,j] = cp[fid_i] * cp[fid_j],  cp = [1, cumprod(rho)]
    noise factor[i,j]  = 1{min1based >= 2} + sum_{k=3}^{F-2} 1{min1based >= k} rho[k-2]^2
    K = signal_factor * k_signal + noise_factor * k_noise

The noise-factor loop runs `range(3, num_fidelities - 1)`, as the JAX
package's does (it replicates the reference's loop, which skips the last
rho^2 term for F >= 5); the port keeps that exactly.
"""

from __future__ import annotations

from typing import Dict

import torch

from mobocmf_tpu_torch.core.constraints import Interval
from mobocmf_tpu_torch.kernels import rbf

_LS_INTERVAL = Interval(1e-3, 1000.0)
_OS_INTERVAL = Interval(1e-3, 100.0)


def init_mf_kernel_params(init_lengthscale, input_dim_x: int, dtype=torch.float64) -> Dict:
    """Raw params for MFKernel (on the CPU). `input_dim_x` excludes the
    fidelity column."""
    ls = torch.broadcast_to(torch.as_tensor(init_lengthscale, dtype=dtype), (input_dim_x,))

    def os_(v):
        return _OS_INTERVAL.inverse(torch.as_tensor(v, dtype=dtype))

    return {
        "signal": {"raw_lengthscale": _LS_INTERVAL.inverse(ls), "raw_outputscale": os_(1.0)},
        "noise": {"raw_lengthscale": _LS_INTERVAL.inverse(ls), "raw_outputscale": os_(0.1)},
    }


def _interval_rbf_gram(p: Dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    ls = _LS_INTERVAL.forward(p["raw_lengthscale"])
    os_ = _OS_INTERVAL.forward(p["raw_outputscale"])
    a, b = x1 / ls, x2 / ls
    d2 = (torch.sum(a * a, -1, keepdim=True) - 2.0 * (a @ b.mT)
          + torch.sum(b * b, -1, keepdim=True).mT)
    return os_ * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def mf_kernel_constrained(params: Dict) -> Dict:
    return {
        "signal_ls": _LS_INTERVAL.forward(params["signal"]["raw_lengthscale"]),
        "signal_os": _OS_INTERVAL.forward(params["signal"]["raw_outputscale"]),
        "noise_ls": _LS_INTERVAL.forward(params["noise"]["raw_lengthscale"]),
        "noise_os": _OS_INTERVAL.forward(params["noise"]["raw_outputscale"]),
    }


def mf_kernel_gram(params: Dict, xf1: torch.Tensor, xf2: torch.Tensor) -> torch.Tensor:
    x1, fid1 = xf1[:, :-1], xf1[:, -1]
    x2, fid2 = xf2[:, :-1], xf2[:, -1]
    min_fid = torch.minimum(fid1[:, None], fid2[None, :])
    k_sig = _interval_rbf_gram(params["signal"], x1, x2)
    k_noi = _interval_rbf_gram(params["noise"], x1, x2)
    return k_sig + min_fid * k_noi


def mf_kernel_diag(params: Dict, xf: torch.Tensor) -> torch.Tensor:
    """diag K([x,f], [x,f]) without the O(M^2) Gram: an RBF at distance 0 is
    its outputscale, so diag = os_signal + fid * os_noise."""
    fid = xf[:, -1]
    os_sig = _OS_INTERVAL.forward(params["signal"]["raw_outputscale"])
    os_noi = _OS_INTERVAL.forward(params["noise"]["raw_outputscale"])
    return os_sig + fid * os_noi


def init_mf_lin_kernel_params(init_lengthscale, input_dim_x: int, num_fidelities: int,
                              dtype=torch.float64) -> Dict:
    """Raw params for MFKernel_lin (on the CPU)."""
    ls = torch.broadcast_to(torch.as_tensor(init_lengthscale, dtype=dtype), (input_dim_x,))
    return {
        "signal": rbf.init_scale_rbf_params(ls, 1.0, input_dim_x, dtype=dtype),
        "noise": rbf.init_scale_rbf_params(ls, 0.1, input_dim_x, dtype=dtype),
        "rho": 0.5 * torch.ones((num_fidelities - 1,), dtype=dtype),
    }


def mf_lin_kernel_gram(params: Dict, xf1: torch.Tensor, xf2: torch.Tensor,
                       num_fidelities: int) -> torch.Tensor:
    x1, fid1 = xf1[:, :-1], xf1[:, -1].to(torch.int64)
    x2, fid2 = xf2[:, :-1], xf2[:, -1].to(torch.int64)
    rho = params["rho"]
    cp = torch.cat([torch.ones((1,), dtype=rho.dtype, device=rho.device), torch.cumprod(rho, 0)])
    factor_signal = torch.outer(cp[fid1], cp[fid2])

    min1 = torch.minimum(fid1[:, None], fid2[None, :]) + 1  # 1-based min fidelity
    factor_noise = (min1 >= 2).to(rho.dtype)
    # the JAX package's range(3, num_fidelities - 1), exactly (module doc)
    for k in range(3, num_fidelities - 1):
        factor_noise = factor_noise + (min1 >= k).to(rho.dtype) * rho[k - 2] ** 2

    k_sig = rbf.rbf_gram(params["signal"], x1, x2)
    k_noi = rbf.rbf_gram(params["noise"], x1, x2)
    return factor_signal * k_sig + factor_noise * k_noi
