"""Pathwise RFF samples of MFDGP layer posteriors and priors
(counterpart of mobocmf_tpu/sampling/rff.py).

A function sample is a tuple of per-layer feature weights; evaluation
chains the layers (layer ell consumes the previous layer's sampled value)
and is differentiable by autograd.

Feature maps (reference mfdgp_hidden_layer.py:288-292):
    phi(x) = sqrt(2 alpha / F) * cos(W x^T + b),  W ~ N(0,1)/lengthscale,
             b ~ U[0, 2 pi)
Posterior weights: the dual (QR / Woodbury) form of
    A = Phi Phi^T + sigma2 I,  m = A^{-1} Phi y,
    cov = sigma2 A^{-1} + A^{-1} Phi S Phi^T A^{-1},  theta = m + chol(cov) eps,
solved on the host in float64 (`host_dual_theta`). Deep layers use the
3-block feature concat
    Phi = [ phi_x1(x) * f * sqrt(nu_lin) ; phi_x1f([x, f]) ; phi_x2(x) ]
with b_x1f = b_x1 and W_x1f = [W_x1, W_f].

Randomness: W and b come from a torch.Generator, drawn model by model and
layer by layer; each theta gets its own numpy seed, drawn from the same
generator. `sample_posterior_stacked(..., draws=...)` takes the standard
normals, uniforms and seeds instead (the tests inject the JAX package's).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core import config as cfg
from mobocmf_tpu_torch.core.constraints import Positive
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.kernels.rbf import scale_rbf_constrained
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.parallel import sharding

_positive = Positive()


class Layer0Sample(NamedTuple):
    w: torch.Tensor  # (F, d)
    b: torch.Tensor  # (F, 1)
    alpha: torch.Tensor  # ()
    theta: torch.Tensor  # (F,)


class DeepLayerSample(NamedTuple):
    w_x1: torch.Tensor  # (F, d)
    w_x1f: torch.Tensor  # (F, d+1)
    w_x2: torch.Tensor  # (F, d)
    b_x1: torch.Tensor  # (F, 1)
    b_x2: torch.Tensor  # (F, 1)
    alpha_x1: torch.Tensor
    alpha_x1f: torch.Tensor
    alpha_x2: torch.Tensor
    nu_lin: torch.Tensor
    theta: torch.Tensor  # (3F,)


class MFDGPFunctionSample(NamedTuple):
    """One pathwise sample of the whole layer stack."""

    layers: Tuple  # Layer0Sample then a DeepLayerSample per layer > 0


class LayerDraws(NamedTuple):
    """The random numbers of one layer's sample: standard normals for the
    frequencies, U[0, 1) for the phases (scaled by 2 pi), the theta seed.
    Layer 0: normals (F, d), uniforms (F, 1). Deep layers: normals of
    W_x1 (F, d), W_f (F, 1), W_x2 (F, d) concatenated to (F, 2d+1);
    uniforms of b_x1, b_x2 concatenated to (F, 2)."""

    normals: torch.Tensor
    uniforms: torch.Tensor
    seed: int


def _phi(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, alpha, n_features: int):
    """(F, N) feature matrix, reference _phi_rbf (:288-292)."""
    return torch.sqrt(2.0 * alpha / n_features) * torch.cos(w @ x.mT + b)


def host_dual_theta(seed: int, phi, y, s_cov, sigma2: float = cfg.RFF_SIGMA2) -> np.ndarray:
    """Posterior RFF weights via the dual (QR / Woodbury) formulation, host f64.

    With the thin QR Phi = Q R (Q: F x M, R: M x M) and G = R R^T + sigma2 I,
    the reference's posterior N(m, cov) is

        m    = Q G^{-1} R y
        cov  = (I - Q Q^T) + Q C Q^T,   C = sigma2 G^{-1} + G^{-1} R S R^T G^{-1}
        theta = m + (eps1 - Q Q^T eps1) + Q chol(C) eps2

    with eps1 (F,) and eps2 (M,) from numpy's default_rng(seed)."""
    phi = np.asarray(phi, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    s_cov = np.asarray(s_cov, dtype=np.float64)
    f_dim = phi.shape[0]
    q, r = np.linalg.qr(phi)  # q (F, k), r (k, M), k = min(F, M)
    k = q.shape[1]
    g = r @ r.T + sigma2 * np.eye(k)
    g_inv = np.linalg.solve(g, np.eye(k))
    m = q @ (g_inv @ (r @ y))
    c = sigma2 * g_inv + g_inv @ r @ s_cov @ r.T @ g_inv
    c = 0.5 * (c + c.T)
    scale = max(float(np.mean(np.diag(c))), 1e-300)
    lc = None
    for rel in (0.0, 1e-12, 1e-9, 1e-6):
        try:
            lc = np.linalg.cholesky(c + rel * scale * np.eye(k))
            break
        except np.linalg.LinAlgError:
            continue
    if lc is None:
        raise np.linalg.LinAlgError("RFF dual covariance not factorizable")
    rng = np.random.default_rng(seed)
    eps1 = rng.standard_normal(f_dim)
    eps2 = rng.standard_normal(k)
    return m + (eps1 - q @ (q.T @ eps1)) + q @ (lc @ eps2)


def _deep_kernel_constrained(kernel):
    return dict(
        ls_x1=_positive.forward(kernel["kx1"]["raw_lengthscale"]),
        ls_f=_positive.forward(kernel["kf"]["raw_lengthscale"]),
        ls_x2=_positive.forward(kernel["kx2"]["raw_lengthscale"]),
        a_x1=_positive.forward(kernel["kx1"]["raw_outputscale"]),
        a_f=_positive.forward(kernel["kf"]["raw_outputscale"]),
        a_x2=_positive.forward(kernel["kx2"]["raw_outputscale"]),
        nu_lin=_positive.forward(kernel["klin"]["raw_variance"]),
    )


def draw_layers(
    generator: Optional[torch.Generator],
    num_fidelities: int,
    input_dims: int,
    n_features: int,
    dtype: torch.dtype,
    device,
) -> List[LayerDraws]:
    """One model's draws for every layer, in layer order."""
    out = []
    for ell in range(num_fidelities):
        cols = input_dims if ell == 0 else 2 * input_dims + 1
        normals = torch.randn((n_features, cols), generator=generator, dtype=dtype, device=device)
        uniforms = torch.rand(
            (n_features, 1 if ell == 0 else 2), generator=generator, dtype=dtype, device=device
        )
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator, device=device).item())
        out.append(LayerDraws(normals=normals, uniforms=uniforms, seed=seed))
    return out


def _deep_layer(draws: LayerDraws, c, d: int, theta) -> DeepLayerSample:
    """Deep-layer sample (reference :364-444 posterior, :446-514 prior)
    from its draws and constrained hyperparameters c (scalars)."""
    g = draws.normals
    w_x1 = g[:, :d] / c["ls_x1"]
    w_f = g[:, d : d + 1] / c["ls_f"]
    w_x2 = g[:, d + 1 :] / c["ls_x2"]
    two_pi = 2.0 * math.pi
    like = g[0, 0]
    return DeepLayerSample(
        w_x1=w_x1, w_x1f=torch.cat([w_x1, w_f], dim=1), w_x2=w_x2,
        b_x1=draws.uniforms[:, :1] * two_pi, b_x2=draws.uniforms[:, 1:] * two_pi,
        alpha_x1=torch.as_tensor(c["a_x1"], dtype=like.dtype, device=like.device),
        alpha_x1f=torch.as_tensor(c["a_x1"] * c["a_f"], dtype=like.dtype, device=like.device),
        alpha_x2=torch.as_tensor(c["a_x2"], dtype=like.dtype, device=like.device),
        nu_lin=torch.as_tensor(c["nu_lin"], dtype=like.dtype, device=like.device),
        theta=theta,
    )


def _deep_features(s: DeepLayerSample, x: torch.Tensor, f: torch.Tensor, n_features: int):
    """3-block deep feature matrix (3F, N); f is the previous-layer value."""
    xf = torch.cat([x, f[:, None]], dim=1)
    phi_x1 = _phi(x, s.w_x1, s.b_x1, s.alpha_x1, n_features)
    phi_x1f = _phi(xf, s.w_x1f, s.b_x1, s.alpha_x1f, n_features)
    phi_x2 = _phi(x, s.w_x2, s.b_x2, s.alpha_x2, n_features)
    return torch.cat([phi_x1 * f[None, :] * torch.sqrt(s.nu_lin), phi_x1f, phi_x2], dim=0)


def sample_posterior_stacked(
    generator: Optional[torch.Generator],
    params: M.MFDGPParams,
    consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    n_features: int = cfg.RFF_NUM_FEATURES,
    draws: Optional[Sequence[Sequence[LayerDraws]]] = None,
) -> List[MFDGPFunctionSample]:
    """Pathwise posterior sample of every layer of every stacked blackbox
    (reference sample_function_from_each_layer, mfdgp.py:264-275): one
    sample per blackbox. One batched layer-state pass factors every model's
    inducing chain; the feature matrices at the current dynamic inducing
    points are built on the device and the weights solved on the host in
    float64. draws: per model, per layer (default: from `generator`)."""
    z_x0 = consts.z_x[0]
    dtype, device = z_x0.dtype, z_x0.device
    num_models = params.raw_noises.shape[0]
    d = z_x0.shape[1]
    if draws is None:
        draws = [
            draw_layers(generator, config.num_fidelities, d, n_features, dtype, device)
            for _ in range(num_models)
        ]
    with torch.no_grad():
        states = M.compute_layer_states(params, consts, config)
        samples = []
        for i in range(num_models):
            layers = []
            for ell in range(config.num_fidelities):
                lp = params.layers[ell]
                st = states[ell]
                y = lp.variational.mean[i]
                ls_chol = torch.tril(lp.variational.chol_raw[i])
                if config.whitened:
                    # whitened q(v) -> function-value space: m = L_K m_w, L_S = L_K L_w
                    y = st.lk[i] @ y
                    ls_chol = st.lk[i] @ ls_chol
                s_cov = ls_chol @ ls_chol.mT
                dr = draws[i][ell]
                zero_theta = torch.zeros((0,), dtype=dtype, device=device)
                if ell == 0:
                    ls, alpha = scale_rbf_constrained({k: v[i] for k, v in lp.kernel.items()})
                    lay = Layer0Sample(
                        w=dr.normals / ls, b=dr.uniforms * (2.0 * math.pi), alpha=alpha,
                        theta=zero_theta,
                    )
                    phi = _phi(st.z, lay.w, lay.b, lay.alpha, n_features)
                else:
                    kernel_i = {
                        k: {kk: vv[i] for kk, vv in sub.items()} for k, sub in lp.kernel.items()
                    }
                    lay = _deep_layer(dr, _deep_kernel_constrained(kernel_i), d, zero_theta)
                    z = st.z[i]
                    phi = _deep_features(lay, z[:, :-1], z[:, -1], n_features)
                theta = host_dual_theta(
                    dr.seed, phi.cpu().numpy(), y.cpu().numpy(), s_cov.cpu().numpy()
                )
                layers.append(lay._replace(theta=torch.as_tensor(theta, dtype=dtype, device=device)))
            samples.append(MFDGPFunctionSample(layers=tuple(layers)))
    return samples


def sample_posterior(
    generator: Optional[torch.Generator],
    params: M.MFDGPParams,
    consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    n_features: int = cfg.RFF_NUM_FEATURES,
) -> MFDGPFunctionSample:
    """Pathwise posterior sample of a single (B = 1) model."""
    return sample_posterior_stacked(generator, params, consts, config, n_features)[0]


def sample_prior(
    generator: Optional[torch.Generator],
    input_dims: int,
    num_fidelities: int,
    n_features: int = cfg.RFF_NUM_FEATURES,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
) -> MFDGPFunctionSample:
    """Prior sample of the whole stack (reference
    sample_function_from_prior_each_layer, mfdgp.py:277-288; fixed prior
    hyperparameters, layer file :339-362 and :446-514), on `device`
    (`cuda` unless named)."""
    device = resolve_device(device)
    layers: List = []
    for ell, dr in enumerate(
        draw_layers(generator, num_fidelities, input_dims, n_features, dtype, device)
    ):
        if ell == 0:
            theta = torch.randn((n_features,), generator=generator, dtype=dtype, device=device)
            layers.append(Layer0Sample(
                w=dr.normals / (0.25 * input_dims), b=dr.uniforms * (2.0 * math.pi),
                alpha=torch.tensor(1.0, dtype=dtype, device=device), theta=theta,
            ))
        else:
            theta = torch.randn((3 * n_features,), generator=generator, dtype=dtype, device=device)
            c = dict(ls_x1=10 * 0.25 * input_dims, ls_f=1.0, ls_x2=0.25 * input_dims,
                     a_x1=1.0, a_f=1.0, a_x2=0.01, nu_lin=1.0)
            layers.append(_deep_layer(dr, c, input_dims, theta))
    return MFDGPFunctionSample(layers=tuple(layers))


def eval_sample(
    sample: MFDGPFunctionSample, x: torch.Tensor, layer: Optional[int] = None, mesh=None
) -> torch.Tensor:
    """Evaluate the sampled function at x (N, d) -> (N,), chaining layers.

    layer=None evaluates the top layer (the reference always consumes
    sample_function_from_each_layer()[-1]). mesh: `sample`'s layer 0 holds
    this rank's block of the features (parallel/sharding.py::
    shard_features), so its theta @ phi is a partial sum over the 'dp'
    ranks (summed there, differentiable in x)."""
    if x.ndim == 1:
        x = x[None, :]
    num_layers = len(sample.layers) if layer is None else layer + 1
    n_features = sample.layers[0].w.shape[0] * sharding.axis_size(mesh, "dp")
    f = None
    for ell in range(num_layers):
        s = sample.layers[ell]
        if ell == 0 and mesh is not None:
            grp = mesh.get_group("dp")
            feats = _phi(sharding.enter(x, grp), s.w, s.b, s.alpha, n_features)
            f = sharding.reduce(s.theta @ feats, grp)
            continue
        if ell == 0:
            feats = _phi(x, s.w, s.b, s.alpha, n_features)
        else:
            feats = _deep_features(s, x, f, n_features)
        f = s.theta @ feats
    return f


def eval_sample_scalar(sample: MFDGPFunctionSample, x_single: torch.Tensor) -> torch.Tensor:
    """Scalar evaluation at one point x_single (d,)."""
    return eval_sample(sample, x_single[None, :])[0]


def eval_sample_fn(sample: MFDGPFunctionSample, x: torch.Tensor) -> torch.Tensor:
    """Top-layer evaluator, the `fn` of moop.SampledFunction."""
    return eval_sample(sample, x)
