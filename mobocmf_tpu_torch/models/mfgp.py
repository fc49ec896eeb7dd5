"""MFGP: exact multi-fidelity GP with the min-fidelity kernel
(counterpart of mobocmf_tpu/models/mfgp.py).

A single exact GP over augmented inputs [x, fidelity] with

    K = k_signal(x, x') + min(fid, fid') * k_noise(x, x')

(kernels/mf_exact.py; median-heuristic lengthscales), a Gaussian
likelihood with noise init 0.1 and a zero mean. Fitting is Adam on the
exact NLML (models/exact_gp.py::adam_fit); every train-Gram factor goes
through K1 without the ladder (linalg/ops.py::cholesky). Pathwise RFF
posterior samples carry the reference's per-fidelity feature masks.

Padded rows: `row_valid` marks the real rows; the others get PAD_PENALTY
of extra observation noise, so their coupling to the posterior is
~k / PAD_PENALTY and one padded shape serves a whole campaign.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core.constraints import GreaterThan
from mobocmf_tpu_torch.core.distances import median_lengthscale_np
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.kernels import mf_exact
from mobocmf_tpu_torch.linalg.ops import add_jitter, cholesky
from mobocmf_tpu_torch.models.exact_gp import adam_fit, nll_from_chol
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.sampling.rff import host_dual_theta
from mobocmf_tpu_torch.util.tree import tree_map

# gpytorch GaussianLikelihood's default noise constraint
_NOISE_CONSTRAINT = GreaterThan(1e-4)
PAD_PENALTY = 1e6


class MFGPParams(NamedTuple):
    kernel: Dict
    raw_noise: torch.Tensor


class MFGPModel(NamedTuple):
    params: MFGPParams
    x_train: torch.Tensor  # (N, d+1), fidelity in the last column
    y_train: torch.Tensor  # (N,)
    num_fidelities: int
    input_dim: int  # x dims (without the fidelity)
    jitter: float
    # (N,) extra observation noise: 0 on real rows, PAD_PENALTY on padding
    row_penalty: Optional[torch.Tensor] = None


def init_mfgp(
    x_train,
    y_train,
    num_fidelities: int,
    type_lengthscale: TL = TL.MEDIAN,
    jitter: float = 1e-8,
    row_valid=None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> MFGPModel:
    """An MFGP on `device` (`cuda` unless named) in `dtype` (float32 unless
    named). The median lengthscale is computed on the host in float64 over
    the valid rows only. `type_lengthscale` is accepted for the reference's
    signature; the median heuristic is used, as in the JAX package."""
    del type_lengthscale
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    x_np = np.asarray(torch.as_tensor(x_train).detach().cpu().double())
    input_dim = x_np.shape[1] - 1
    rows = x_np if row_valid is None else x_np[np.asarray(row_valid).astype(bool)]
    init_ls = median_lengthscale_np(rows[:, :input_dim])
    kernel = mf_exact.init_mf_kernel_params(init_ls, input_dim, dtype=torch.float64)
    raw_noise = _NOISE_CONSTRAINT.inverse(torch.tensor(0.1, dtype=torch.float64))
    params = tree_map(lambda t: t.to(device=device, dtype=dtype),
                      MFGPParams(kernel=kernel, raw_noise=raw_noise))
    penalty = None
    if row_valid is not None:
        valid = torch.as_tensor(np.asarray(row_valid).astype(bool), device=device)
        penalty = torch.where(valid, torch.zeros((), dtype=dtype, device=device),
                              torch.full((), PAD_PENALTY, dtype=dtype, device=device))
    return MFGPModel(
        params=params,
        x_train=torch.as_tensor(x_train, dtype=dtype, device=device),
        y_train=torch.as_tensor(y_train, dtype=dtype, device=device).reshape(-1),
        num_fidelities=num_fidelities,
        input_dim=input_dim,
        jitter=jitter,
        row_penalty=penalty,
    )


def noise(params: MFGPParams) -> torch.Tensor:
    return _NOISE_CONSTRAINT.forward(params.raw_noise)


def _train_gram(params: MFGPParams, x: torch.Tensor, jitter: float,
                row_penalty: Optional[torch.Tensor]) -> torch.Tensor:
    k = mf_exact.mf_kernel_gram(params.kernel, x, x)
    k = add_jitter(k, jitter) + noise(params) * torch.eye(x.shape[0], dtype=x.dtype,
                                                          device=x.device)
    if row_penalty is not None:
        k = k + torch.diag(row_penalty)
    return k


def nlml(params: MFGPParams, x: torch.Tensor, y: torch.Tensor, jitter: float,
         row_penalty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact negative log marginal likelihood. A padded row adds a
    parameter-independent constant up to O(1 / PAD_PENALTY)."""
    return nll_from_chol(cholesky(_train_gram(params, x, jitter, row_penalty)), y)


def fit_mfgp(model: MFGPModel, num_iters: int = 500, lr: float = 0.05) -> MFGPModel:
    """Adam on the exact NLML (the reference delegates to botorch's fit)."""
    params = adam_fit(
        model.params,
        lambda p: nlml(p, model.x_train, model.y_train, model.jitter, model.row_penalty),
        num_iters, lr,
    )
    return model._replace(params=params)


class MFGPPosteriorState(NamedTuple):
    """The x-independent posterior pieces: l = chol(K_train + (jitter +
    noise) I), alpha = L^{-1} y. Callers that evaluate many candidate
    batches (the MESMOC search) compute it once."""

    l: torch.Tensor
    alpha: torch.Tensor


def posterior_state(model: MFGPModel) -> MFGPPosteriorState:
    l = cholesky(_train_gram(model.params, model.x_train, model.jitter, model.row_penalty))
    alpha = torch.linalg.solve_triangular(l, model.y_train[:, None], upper=False)
    return MFGPPosteriorState(l=l, alpha=alpha)


def predict(model: MFGPModel, x: torch.Tensor, fidelity: int,
            state: Optional[MFGPPosteriorState] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior latent (noiseless) mean and variance at [x, fidelity].
    A (b, q, d) batch returns (b, q): every point predicted as a row."""
    if x.ndim == 3:
        b, q, d = x.shape
        mean, var = predict(model, x.reshape(b * q, d), fidelity, state=state)
        return mean.reshape(b, q), var.reshape(b, q)
    fid_col = torch.full((x.shape[0], 1), float(fidelity), dtype=x.dtype, device=x.device)
    x_aug = torch.cat([x, fid_col], dim=1)
    kernel = model.params.kernel
    if state is None:
        state = posterior_state(model)
    k_cross = mf_exact.mf_kernel_gram(kernel, model.x_train, x_aug)  # (N, M)
    w = torch.linalg.solve_triangular(state.l, k_cross, upper=False)
    mean = (w.mT @ state.alpha)[:, 0]
    var = torch.clamp(mf_exact.mf_kernel_diag(kernel, x_aug) - torch.sum(w * w, dim=0), min=1e-12)
    return mean, var


# ---------------------------------------------------------------------------
# RFF pathwise sampling with per-fidelity feature masks
# ---------------------------------------------------------------------------


class MFGPSample(NamedTuple):
    w_signal: torch.Tensor
    b_signal: torch.Tensor
    alpha_signal: torch.Tensor
    w_noise: torch.Tensor
    b_noise: torch.Tensor
    alpha_noise: torch.Tensor
    theta: torch.Tensor  # (num_fid * F,): signal block + (num_fid - 1) noise blocks
    fidelity: int
    num_fidelities: int


class MFGPDraws(NamedTuple):
    """The random numbers of one sample: standard normals (F, d) for the
    signal and noise frequencies, U[0, 1) (F, 1) for their phases (scaled
    by 2 pi), and the numpy seed of the theta solve."""

    w_s: torch.Tensor
    b_s: torch.Tensor
    w_n: torch.Tensor
    b_n: torch.Tensor
    seed: int


def _phi(x, w, b, alpha, n_features: int) -> torch.Tensor:
    return torch.sqrt(2.0 * alpha / n_features) * torch.cos(w @ x.mT + b)


def sample_from_posterior(generator: Optional[torch.Generator], model: MFGPModel, fidelity: int,
                          n_features: int = 500,
                          draws: Optional[MFGPDraws] = None) -> MFGPSample:
    """Pathwise sample of the fidelity-`fidelity` process. The noise
    features are tiled (num_fidelities - 1) times; block t is active only
    for points whose fidelity is > t. The weights are solved on the host in
    float64 (sampling/rff.py::host_dual_theta, with S = 0 and the
    likelihood noise as sigma2). draws: default from `generator`."""
    c = mf_exact.mf_kernel_constrained(model.params.kernel)
    x_train = model.x_train
    dtype, device = x_train.dtype, x_train.device
    d = model.input_dim
    x_data, fid_data = x_train[:, :d], x_train[:, d]
    if draws is None:
        def normals():
            return torch.randn((n_features, d), generator=generator, dtype=dtype, device=device)

        def uniforms():
            return torch.rand((n_features, 1), generator=generator, dtype=dtype, device=device)

        w_s, b_s, w_n, b_n = normals(), uniforms(), normals(), uniforms()
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device).item())
        draws = MFGPDraws(w_s, b_s, w_n, b_n, seed)
    with torch.no_grad():
        w_s = draws.w_s.to(device=device, dtype=dtype) / c["signal_ls"]
        b_s = draws.b_s.to(device=device, dtype=dtype) * (2.0 * math.pi)
        w_n = draws.w_n.to(device=device, dtype=dtype) / c["noise_ls"]
        b_n = draws.b_n.to(device=device, dtype=dtype) * (2.0 * math.pi)
        phi_s = _phi(x_data, w_s, b_s, c["signal_os"], n_features)  # (F, N)
        phi_n = _phi(x_data, w_n, b_n, c["noise_os"], n_features)
        y = model.y_train
        if model.row_penalty is not None:
            # padded rows leave the dual solve exactly: zero their feature
            # columns and targets
            real = (model.row_penalty == 0).to(dtype)
            phi_s, phi_n, y = phi_s * real[None, :], phi_n * real[None, :], y * real
        blocks = [phi_n * ((model.num_fidelities - fid_data - 1) <= t).to(dtype)[None, :]
                  for t in range(model.num_fidelities - 1)]
        phi_full = torch.cat([phi_s] + blocks, dim=0)
        n = x_train.shape[0]
        theta = host_dual_theta(draws.seed, phi_full.cpu().numpy(), y.cpu().numpy(),
                                np.zeros((n, n)), float(noise(model.params)))
    return MFGPSample(
        w_signal=w_s, b_signal=b_s, alpha_signal=c["signal_os"].detach(),
        w_noise=w_n, b_noise=b_n, alpha_noise=c["noise_os"].detach(),
        theta=torch.as_tensor(theta, dtype=dtype, device=device),
        fidelity=fidelity, num_fidelities=model.num_fidelities,
    )


def eval_mfgp_sample(s: MFGPSample, x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 1:
        x = x[None, :]
    n_features = s.w_signal.shape[0]
    phi_s = _phi(x, s.w_signal, s.b_signal, s.alpha_signal, n_features)
    phi_n = _phi(x, s.w_noise, s.b_noise, s.alpha_noise, n_features)
    blocks = [phi_n * (1.0 if (s.num_fidelities - s.fidelity - 1) <= t else 0.0)
              for t in range(s.num_fidelities - 1)]
    return s.theta @ torch.cat([phi_s] + blocks, dim=0)
