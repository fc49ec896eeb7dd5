"""Minimal single-fidelity exact GP baseline
(counterpart of mobocmf_tpu/models/exact_gp.py): zero mean +
Scale(RBF-ARD), Gaussian likelihood, exact inference.

`adam_fit` is the Adam loop of the three exact-GP models (this one,
models/mfgp.py and models/mfgp_lin.py): torch.optim.Adam set as
optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8), one step per iteration on the
exact negative log marginal likelihood. Each step factors the N x N train
Gram once through K1 (linalg/ops.py::cholesky, no jitter ladder) and
differentiates it through `chol_pullback`; on the card the steps replay
one captured step (fit/graphs.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mobocmf_tpu_torch.core.constraints import GreaterThan
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.fit import graphs
from mobocmf_tpu_torch.kernels import rbf
from mobocmf_tpu_torch.linalg.ops import add_jitter, cholesky, logdet_from_chol
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map

_NOISE_CONSTRAINT = GreaterThan(1e-4)
LOG_2PI = math.log(2.0 * math.pi)


class ExactGPParams(NamedTuple):
    kernel: Dict
    raw_noise: torch.Tensor


class ExactGPModel(NamedTuple):
    params: ExactGPParams
    x_train: torch.Tensor
    y_train: torch.Tensor
    jitter: float


def adam_fit(params, loss: Callable, num_iters: int, lr: float):
    """`num_iters` Adam steps on loss(params) from `params` (a tree of
    tensors); returns the final params, detached. The steps run as one
    chunk through fit/graphs.py (the JAX package's one lax.scan): replayed
    from a captured step on the card, eagerly on the CPU. The loss draws
    nothing random."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = graphs.adam(leaves, lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss(params).backward()
        opt.step()

    steps = graphs.Steps(step, leaves[0].device, leaves)
    try:
        steps.run(num_iters)
    finally:
        steps.close()
    return tree_map(lambda t: t.detach(), params)


def nll_from_chol(l: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """0.5 (y^T K^-1 y + log|K| + n log 2 pi) from K's lower factor l."""
    alpha = torch.linalg.solve_triangular(l, y[:, None], upper=False)
    return 0.5 * (torch.sum(alpha**2) + logdet_from_chol(l) + y.shape[0] * LOG_2PI)


def init_exact_gp(
    x_train,
    y_train,
    initial_length_scale: float = 0.05,
    jitter: float = 1e-8,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> ExactGPModel:
    """An exact GP on `device` (`cuda` unless named) in `dtype` (float32
    unless named)."""
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    x_train = torch.as_tensor(x_train, dtype=dtype, device=device)
    y_train = torch.as_tensor(y_train, dtype=dtype, device=device).reshape(-1)
    kernel = rbf.init_scale_rbf_params(initial_length_scale, 1.0, x_train.shape[1], dtype=dtype)
    raw_noise = _NOISE_CONSTRAINT.inverse(torch.tensor(0.1, dtype=dtype))
    params = tree_map(lambda t: t.to(device), ExactGPParams(kernel=kernel, raw_noise=raw_noise))
    return ExactGPModel(params=params, x_train=x_train, y_train=y_train, jitter=jitter)


def _train_gram(params: ExactGPParams, x: torch.Tensor, jitter: float) -> torch.Tensor:
    k = add_jitter(rbf.rbf_gram(params.kernel, x, x), jitter)
    return k + _NOISE_CONSTRAINT.forward(params.raw_noise) * torch.eye(
        x.shape[0], dtype=x.dtype, device=x.device)


def nlml(params: ExactGPParams, x: torch.Tensor, y: torch.Tensor, jitter: float) -> torch.Tensor:
    return nll_from_chol(cholesky(_train_gram(params, x, jitter)), y)


def fit_exact_gp(model: ExactGPModel, num_iters: int = 500, lr: float = 0.05) -> ExactGPModel:
    params = adam_fit(
        model.params, lambda p: nlml(p, model.x_train, model.y_train, model.jitter), num_iters, lr)
    return model._replace(params=params)


def predict(model: ExactGPModel, x: torch.Tensor,
            noiseless: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    params = model.params
    l = cholesky(_train_gram(params, model.x_train, model.jitter))
    k_cross = rbf.rbf_gram(params.kernel, model.x_train, x)
    w = torch.linalg.solve_triangular(l, k_cross, upper=False)
    alpha = torch.linalg.solve_triangular(l, model.y_train[:, None], upper=False)
    mean = (w.mT @ alpha)[:, 0]
    var = torch.clamp(rbf.rbf_diag(params.kernel, x) - torch.sum(w * w, dim=0), min=1e-12)
    if not noiseless:
        var = var + _NOISE_CONSTRAINT.forward(params.raw_noise)
    return mean, var
