"""MFGP_lin: exact multi-fidelity GP with the AR(1)-style rho kernel
(counterpart of mobocmf_tpu/models/mfgp_lin.py).

A single exact GP over [x, fidelity] with MFKernel_lin (learnable
correlations rho, init 0.5; kernels/mf_exact.py), zero mean, Gaussian
likelihood noise init 0.1, fitted by Adam on the exact NLML
(models/exact_gp.py::adam_fit) with K1 as its factor.
`get_mean_function_high_fidelity` returns a numpy-facing closure (value,
or gradient by torch.autograd, per row) for use as a Pareto-set objective.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core.constraints import GreaterThan
from mobocmf_tpu_torch.core.distances import median_lengthscale_np
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.kernels import mf_exact
from mobocmf_tpu_torch.linalg.ops import add_jitter, cholesky
from mobocmf_tpu_torch.models.exact_gp import adam_fit, nll_from_chol
from mobocmf_tpu_torch.util.tree import tree_map

_NOISE_CONSTRAINT = GreaterThan(1e-4)


class MFGPLinParams(NamedTuple):
    kernel: Dict
    raw_noise: torch.Tensor


class MFGPLinModel(NamedTuple):
    params: MFGPLinParams
    x_train: torch.Tensor
    y_train: torch.Tensor
    num_fidelities: int
    input_dim: int
    jitter: float


def init_mfgp_lin(
    x_train,
    y_train,
    num_fidelities: int,
    jitter: float = 1e-8,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> MFGPLinModel:
    """An MFGP_lin on `device` (`cuda` unless named) in `dtype` (float32
    unless named); the median lengthscale on the host in float64."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    x_np = np.asarray(torch.as_tensor(x_train).detach().cpu().double())
    input_dim = x_np.shape[1] - 1
    init_ls = median_lengthscale_np(x_np[:, :input_dim])
    kernel = mf_exact.init_mf_lin_kernel_params(init_ls, input_dim, num_fidelities)
    raw_noise = _NOISE_CONSTRAINT.inverse(torch.tensor(0.1, dtype=torch.float64))
    params = tree_map(lambda t: t.to(device=device, dtype=dtype),
                      MFGPLinParams(kernel=kernel, raw_noise=raw_noise))
    return MFGPLinModel(
        params=params,
        x_train=torch.as_tensor(x_train, dtype=dtype, device=device),
        y_train=torch.as_tensor(y_train, dtype=dtype, device=device).reshape(-1),
        num_fidelities=num_fidelities,
        input_dim=input_dim,
        jitter=jitter,
    )


def _train_gram(params: MFGPLinParams, x: torch.Tensor, jitter: float,
                num_fidelities: int) -> torch.Tensor:
    k = mf_exact.mf_lin_kernel_gram(params.kernel, x, x, num_fidelities)
    return add_jitter(k, jitter) + _NOISE_CONSTRAINT.forward(params.raw_noise) * torch.eye(
        x.shape[0], dtype=x.dtype, device=x.device)


def nlml(params: MFGPLinParams, x: torch.Tensor, y: torch.Tensor, jitter: float,
         num_fidelities: int) -> torch.Tensor:
    """Exact negative log marginal likelihood."""
    return nll_from_chol(cholesky(_train_gram(params, x, jitter, num_fidelities)), y)


def nlml_model(params: MFGPLinParams, model: MFGPLinModel) -> torch.Tensor:
    return nlml(params, model.x_train, model.y_train, model.jitter, model.num_fidelities)


def fit_mfgp_lin(model: MFGPLinModel, num_iters: int = 500, lr: float = 0.05) -> MFGPLinModel:
    params = adam_fit(model.params, lambda p: nlml_model(p, model), num_iters, lr)
    return model._replace(params=params)


def predict(model: MFGPLinModel, x: torch.Tensor,
            fidelity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior latent mean and variance at [x, fidelity]; a (b, q, d)
    batch returns (b, q), every point predicted as a row."""
    if x.ndim == 3:
        b, q, d = x.shape
        mean, var = predict(model, x.reshape(b * q, d), fidelity)
        return mean.reshape(b, q), var.reshape(b, q)
    fid_col = torch.full((x.shape[0], 1), float(fidelity), dtype=x.dtype, device=x.device)
    return _predict_aug(model, torch.cat([x, fid_col], dim=1))


def _predict_aug(model: MFGPLinModel, x_aug: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kernel, nf = model.params.kernel, model.num_fidelities
    l = cholesky(_train_gram(model.params, model.x_train, model.jitter, nf))
    k_cross = mf_exact.mf_lin_kernel_gram(kernel, model.x_train, x_aug, nf)
    w = torch.linalg.solve_triangular(l, k_cross, upper=False)
    alpha = torch.linalg.solve_triangular(l, model.y_train[:, None], upper=False)
    mean = (w.mT @ alpha)[:, 0]
    k_diag = torch.diagonal(mf_exact.mf_lin_kernel_gram(kernel, x_aug, x_aug, nf))
    var = torch.clamp(k_diag - torch.sum(w * w, dim=0), min=1e-12)
    return mean, var


def get_mean_function_high_fidelity(model: MFGPLinModel):
    """Numpy-facing closure: the posterior mean at the highest fidelity, or
    its gradient per row (torch.autograd: the rows are independent, so the
    gradient of the sum is each row's own)."""
    top = model.num_fidelities - 1
    like = model.x_train

    def mean_function(x, gradient: bool = False):
        x = np.asarray(x, dtype=float)
        if x.ndim != 2:
            x = x.reshape(1, -1)
        xt = torch.as_tensor(x, dtype=like.dtype, device=like.device)
        if not gradient:
            with torch.no_grad():
                return predict(model, xt, top)[0].cpu().numpy()
        xt.requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(predict(model, xt, top)[0]), xt)
        return g.cpu().numpy()

    return mean_function
