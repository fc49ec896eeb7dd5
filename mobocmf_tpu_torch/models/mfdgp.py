"""MFDGP: the multi-fidelity deep GP as plain functions on tensors
(counterpart of mobocmf_tpu/models/mfdgp.py).

One sparse-variational GP layer per fidelity; layer ell > 0 consumes
[x, f_{ell-1}(x)] under the deep MF kernel. State is split three ways, as
in the JAX package:
- MFDGPParams — trainable tensors (kernel raw params, variational means and
  Cholesky factors, raw likelihood noises);
- MFDGPConsts — inducing x-locations (shared by all blackboxes), fixed
  eval-mode normals, per-fidelity noise bounds;
- MFDGPConfig — plain Python config.

Blackboxes are stacked on a written-out leading dim B where the JAX package
uses vmap: every params leaf and the per-model consts (acq_eps (B, F, S),
noise bounds (B, F)) carry it, a single model has B = 1, and z_x (M_l, d)
is shared. Inputs x are (N, d) for all blackboxes or (B, N, d).

Semantics kept from the reference: the dynamic inducing chain (for
ell > 0 the last column of Z_ell is the previous layer's posterior mean at
its inducing x-locations, recomputed from the current parameters), the
per-fidelity Interval(1e-8, 0.1*y_std_f) noises, the nearest-same-fidelity
inducing values, the variational init, train-mode fresh normals vs
eval-mode fixed normals, and the 25x-tiled moment-matched acquisition
predictive.

K2 routing: layer 0 goes through K2 (linalg/fused_svgp.py, its own Gram
and factor at the jitter the state's K1 factor ended on) exactly when no
gradient is recorded and the model is unwhitened, for inputs shared by
all blackboxes (`uses_k2`): the acquisition screening and the
recommendation pass. Training, conditioned training and the L-BFGS loop
keep predict_diag_state. Layer 0 sees x tiled 25x in the acquisition
predictive; either route computes it on the untiled points and repeats
its output.

Inducing sharding (parallel/sharding.py::shard_inducing): consts with an
`inducing` group hold this rank's rows of each layer's z_x, and params its
rows of the variational means and Cholesky factors. The layer states then
compute the Gram row blocks Kzz[rows, :] and Kzx[rows, :] locally and
gather them, gather the variational rows, and factor the whole Kzz;
everything after the gathers runs whole on every rank, layer 0's K2
predictive included.
"""

from __future__ import annotations

import enum
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.linalg as spla
import torch

from mobocmf_tpu_torch.core import config as cfg
from mobocmf_tpu_torch.core.constraints import Interval
from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device, resolve_dtype
from mobocmf_tpu_torch.core.distances import median_lengthscale_np
from mobocmf_tpu_torch.kernels import deep_mf, rbf
from mobocmf_tpu_torch.linalg.fused_svgp import fused_rbf_svgp_forward
from mobocmf_tpu_torch.linalg.ops import (
    ladder_jitter, safe_cholesky_inv, safe_cholesky_level, tri_solve_lower)
from mobocmf_tpu_torch.models import svgp
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util.tree import tree_map


class TL(enum.Enum):
    """Type of lengthscale init (reference mfdgp.py:15-18)."""

    ONES = 1
    MEDIAN = 2
    CENTESIMAL = 3


class MFDGPLayerParams(NamedTuple):
    kernel: Dict
    variational: svgp.SVGPVariational


class MFDGPParams(NamedTuple):
    layers: Tuple[MFDGPLayerParams, ...]
    raw_noises: torch.Tensor  # (B, F)


class MFDGPConsts(NamedTuple):
    z_x: Tuple[torch.Tensor, ...]  # per layer, (M_l, d), shared by all blackboxes
    acq_eps: torch.Tensor  # (B, F, S) fixed eval-mode normals per layer
    noise_lower: torch.Tensor  # (B, F)
    noise_upper: torch.Tensor  # (B, F)


class MFDGPConfig(NamedTuple):
    num_fidelities: int
    only_hf: bool
    jitter: float
    num_samples_for_acquisition: int
    whitened: bool = False
    fix_kernel_params: bool = False


class MFDGPModel(NamedTuple):
    params: MFDGPParams
    consts: MFDGPConsts
    config: MFDGPConfig


def _layer_fns(layer_idx: int, only_hf: bool):
    if layer_idx == 0:
        return rbf.rbf_gram, rbf.rbf_diag
    if only_hf:
        return deep_mf.only_hf_gram, deep_mf.only_hf_diag
    return deep_mf.deep_mf_gram, deep_mf.deep_mf_diag


def likelihood_noise(params: MFDGPParams, consts: MFDGPConsts, layer: int) -> torch.Tensor:
    """Constrained noise of fidelity `layer`, one per blackbox."""
    iv = Interval(consts.noise_lower[..., layer], consts.noise_upper[..., layer])
    return iv.forward(params.raw_noises[..., layer])


# ---------------------------------------------------------------------------
# Initialization (host, float64)
# ---------------------------------------------------------------------------


def get_init_lengthscale(type_lengthscale: TL, inputs) -> np.ndarray:
    """Reference mfdgp.py:137-151."""
    inputs = np.asarray(inputs)
    d = inputs.shape[1]
    if type_lengthscale == TL.ONES:
        return np.ones((d,), dtype=inputs.dtype)
    if type_lengthscale == TL.MEDIAN:
        return np.asarray(median_lengthscale_np(inputs), dtype=inputs.dtype)
    if type_lengthscale == TL.CENTESIMAL:
        return 0.01 * np.ones((d,), dtype=inputs.dtype)
    raise ValueError("Wrong type of lengthscale.")


def find_good_initial_inducing_points_and_values(
    x_train: np.ndarray, y_train: np.ndarray, fidelities: np.ndarray, layer: int, only_hf: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-same-fidelity-neighbour inducing init (reference
    mfdgp.py:290-317): the x-locations and, per location, the target of the
    closest training point of this layer's fidelity."""
    fid = np.asarray(fidelities).reshape(-1)
    x_train = np.asarray(x_train)
    y_flat = np.asarray(y_train).reshape(-1)
    sel = fid == layer
    x_fid = x_train[sel]
    y_fid = y_flat[sel]
    z_x = x_train[sel] if only_hf else x_train
    d2 = (
        np.sum(z_x**2, 1, keepdims=True)
        - 2.0 * z_x @ x_fid.T
        + np.sum(x_fid**2, 1, keepdims=True).T
    )
    nearest = np.argmin(d2, axis=1)
    return z_x, y_fid[nearest]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(device="cpu", dtype=torch.float64)


def init_mfdgp(
    x_train,
    y_train,
    fidelities,
    num_fidelities: int,
    type_lengthscale: TL = TL.MEDIAN,
    num_samples_for_acquisition: int = cfg.NUM_SAMPLES_FOR_ACQUISITION,
    use_only_highest_fidelity: bool = False,
    jitter: Optional[float] = None,
    previously_trained: Optional[MFDGPModel] = None,
    whitened: bool = False,
    init_params_to_prior_and_fix_them: bool = False,
    whitened_init: str = "match",
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
    timings: Optional[Dict[str, float]] = None,
) -> MFDGPModel:
    """Build an MFDGP for one blackbox (B = 1) on `device` in `dtype`.

    The init math runs on the host in float64 (numpy and CPU tensors) and
    the finished model is shipped once. `generator` (a CPU
    torch.Generator) draws acq_eps; `previously_trained` (a B = 1 model)
    restores kernel params and acq_eps (warm start).

    whitened_init (whitened=True only): "match" converts the reference's
    unwhitened init into whitened coordinates exactly (m_w = L_K^{-1} m at
    the dynamic init Z); "prior" uses q(v) = N(0, I).

    init_params_to_prior_and_fix_them: kernel hyperparameters at fixed
    prior values (layer 0 lengthscale 0.25*d, deep layers ls_x1 = 2.5*d,
    ls_f = 1, ls_x2 = 0.25*d), excluded from training by the trainer.

    timings: a dict that gains the seconds of the warm-start fetch
    ("fetch", the previous model copied to the host), the host math
    ("host") and the ship to `device` ("ship"), the JAX package's
    INIT_TIMINGS (the BO loop's setup_breakdown.txt)."""
    if whitened_init not in ("match", "prior"):
        raise ValueError(f"whitened_init must be 'match' or 'prior', got {whitened_init!r}")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    if jitter is None:
        jitter = cfg.default_jitter(dtype)
    f64 = torch.float64
    t0 = time.perf_counter()
    if previously_trained is not None:
        prev_kernels = [tree_map(lambda a: _host(a[0]), lp.kernel)
                        for lp in previously_trained.params.layers]
        prev_acq_eps = _host(previously_trained.consts.acq_eps[0])
    t_fetch = time.perf_counter() - t0
    t0 = time.perf_counter()

    x_np = np.asarray(x_train, dtype=np.float64)
    y_np = np.asarray(y_train, dtype=np.float64).reshape(-1)
    fid_np = np.asarray(fidelities).reshape(-1)
    d = x_np.shape[1]
    y_high_std = float(np.std(y_np[fid_np == num_fidelities - 1]))

    def rounded(tree):
        # the model holds `dtype` values; host init math uses exactly those
        return tree_map(lambda a: torch.as_tensor(a, dtype=f64).to(dtype).to(f64), tree)

    kernels, means, chols, z_xs = [], [], [], []
    noise_lower, noise_upper, raw_noises = [], [], []
    chain_prev = None
    for ell in range(num_fidelities):
        z_x, values = find_good_initial_inducing_points_and_values(
            x_np, y_np, fid_np, ell, use_only_highest_fidelity
        )
        z_xs.append(z_x)
        init_ls = get_init_lengthscale(type_lengthscale, x_np[fid_np == ell])

        if previously_trained is not None:
            kparams = prev_kernels[ell]
        elif init_params_to_prior_and_fix_them:
            if ell == 0:
                kparams = rbf.init_scale_rbf_params(0.25 * d, 1.0, d)
            elif use_only_highest_fidelity:
                kparams = deep_mf.init_only_hf_params(np.full((d,), 0.25 * d), d)
            else:
                kparams = deep_mf.init_deep_mf_params(np.full((d,), 0.25 * d), d)
        elif ell == 0:
            kparams = rbf.init_scale_rbf_params(init_ls, 1.0, d)
        elif use_only_highest_fidelity:
            kparams = deep_mf.init_only_hf_params(init_ls, d)
        else:
            kparams = deep_mf.init_deep_mf_params(init_ls, d)
        kparams = rounded(kparams)
        gram, _ = _layer_fns(ell, use_only_highest_fidelity)
        eye = np.eye(z_x.shape[0])

        m0 = values.astype(np.float64)
        if whitened and whitened_init == "prior":
            mean, chol = np.zeros_like(m0), eye
            chain_prev = np.zeros_like(m0)
        else:
            if ell == num_fidelities - 1:
                z_full = z_x if ell == 0 else np.concatenate([z_x, values[:, None]], 1)
                zt = torch.as_tensor(z_full, dtype=f64)
                k0 = gram(kparams, zt, zt).numpy() + jitter * eye
                cov0 = k0 * (1e-2 * y_high_std**2) ** 2
            else:
                cov0 = 1e-8 * eye
            mean, chol = svgp.init_variational(m0, cov0)
        if whitened and whitened_init != "prior":
            # unwhitened init -> whitened coords at the DYNAMIC init Z (last
            # column = previous layer's chain mean), so the initial
            # posterior matches the unwhitened model exactly
            mean = torch.as_tensor(mean).to(dtype).to(f64).numpy()
            chol = torch.as_tensor(chol).to(dtype).to(f64).numpy()
            if ell == 0:
                z_dyn = z_x
            elif use_only_highest_fidelity:
                z_dyn = np.concatenate([z_x, np.zeros((z_x.shape[0], 1))], 1)
            else:
                z_dyn = np.concatenate([z_x, chain_prev[:, None]], 1)
            zt = torch.as_tensor(z_dyn, dtype=f64)
            lk = np.linalg.cholesky(gram(kparams, zt, zt).numpy() + jitter * eye)
            m_np = mean
            mean = spla.solve_triangular(lk, m_np, lower=True)
            chol = spla.solve_triangular(lk, chol, lower=True)
            chain_prev = m_np - jitter * spla.cho_solve((lk, True), m_np)
        kernels.append(kparams)
        means.append(mean)
        chols.append(chol)

        # per-fidelity likelihood (reference mfdgp.py:113-123)
        y_std_f = float(np.std(y_np[fid_np == ell]))
        lo, up = 1e-8, 0.1 * y_std_f
        noise_lower.append(lo)
        noise_upper.append(up)
        init_noise = 1e-2 * y_high_std if ell == num_fidelities - 1 else 1e-6
        raw_noises.append(Interval(lo, up).inverse(torch.tensor(init_noise, dtype=f64)))

    if previously_trained is not None:
        acq_eps = prev_acq_eps
    else:
        acq_eps = torch.randn(
            (num_fidelities, num_samples_for_acquisition), generator=generator, dtype=f64
        )

    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()

    def ship(a):
        return torch.as_tensor(a, dtype=f64).to(device=device, dtype=dtype).unsqueeze(0)

    layers = tuple(
        MFDGPLayerParams(
            kernel=tree_map(ship, k),
            variational=svgp.SVGPVariational(mean=ship(m), chol_raw=ship(c)),
        )
        for k, m, c in zip(kernels, means, chols)
    )
    params = MFDGPParams(layers=layers, raw_noises=ship(torch.stack(raw_noises)))
    consts = MFDGPConsts(
        z_x=tuple(torch.as_tensor(z).to(device=device, dtype=dtype) for z in z_xs),
        acq_eps=ship(acq_eps),
        noise_lower=ship(noise_lower),
        noise_upper=ship(noise_upper),
    )
    config = MFDGPConfig(
        num_fidelities=num_fidelities,
        only_hf=use_only_highest_fidelity,
        jitter=float(jitter),
        num_samples_for_acquisition=num_samples_for_acquisition,
        whitened=whitened,
        fix_kernel_params=init_params_to_prior_and_fix_them,
    )
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for k, v in (("fetch", t_fetch), ("host", t_host), ("ship", time.perf_counter() - t0)):
            timings[k] = timings.get(k, 0.0) + v
    return MFDGPModel(params=params, consts=consts, config=config)


# ---------------------------------------------------------------------------
# Forward / predictive
# ---------------------------------------------------------------------------


class LayerState(NamedTuple):
    """Per-layer inducing state of one forward pass: the Kzz factor and the
    solved variational quantities (svgp.solve_variational), shared by the
    predictive and the KL."""

    z: torch.Tensor  # (M, d) or (B, M, d+1)
    lk: torch.Tensor  # (B, M, M) chol(Kzz + jitter I)
    w_mean: torch.Tensor  # (B, M)
    w_ls: torch.Tensor  # (B, M, M)
    level: torch.Tensor  # (B,) jitter-ladder rung lk ended on (linalg/ops.py)
    lk_inv: Optional[torch.Tensor] = None  # explicit L^{-1}: inverse route, acquisition loops
    # inducing sharding: the group the rows of z are split over (z is whole
    # here) and the gathered variational parameters
    inducing: Optional[object] = None
    variational: Optional[svgp.SVGPVariational] = None


def compute_layer_states(
    params: MFDGPParams, consts: MFDGPConsts, config: MFDGPConfig, with_inv: bool = False
) -> List[LayerState]:
    """Resolve the dynamic inducing chain once per forward: Z_0 = z_x,
    Z_ell = [z_x, mu_{ell-1}(Z_{ell-1})], with the predictive mean at the
    inducing inputs m - jitter * (Kzz + jitter I)^{-1} m. One K1 launch per
    layer factorizes every blackbox's Kzz; a state differentiated in
    float64 also carries L^{-1} and multiplies by it where the others solve
    (`inverse_route`). Inducing-sharded consts (the module docstring)
    compute the Gram's row blocks and gather them."""
    states: List[LayerState] = []
    chain_mean = None
    group = getattr(consts, "inducing", None)
    for ell in range(config.num_fidelities):
        gram, _ = _layer_fns(ell, config.only_hf)
        lp = params.layers[ell]
        z_x = consts.z_x[ell]
        var = lp.variational
        if group is not None:
            z_x = sharding.all_gather(z_x, group, 0)
            gram = functools.partial(sharding.rows_gram, gram, grp=group)
            var = sharding.gather_variational(var, group)
        if ell == 0:
            z = z_x
        elif config.only_hf:
            z = torch.cat([z_x, torch.zeros_like(z_x[:, :1])], dim=1)
        else:
            z_b = z_x.expand(chain_mean.shape[:-1] + z_x.shape)
            z = torch.cat([z_b, chain_mean.unsqueeze(-1)], dim=-1)
        kzz = gram(lp.kernel, z, z)
        route = inverse_route(kzz)
        if route:
            lk, level, lk_inv = safe_cholesky_inv(kzz, config.jitter)
        else:
            lk, level = safe_cholesky_level(kzz, config.jitter)
            lk_inv = None
        w_mean, w_ls = svgp.solve_variational(var, lk, config.whitened, lk_inv)
        if with_inv and not route:
            eye = torch.eye(lk.shape[-1], dtype=lk.dtype, device=lk.device)
            lk_inv = torch.linalg.solve_triangular(lk, eye, upper=False)
        states.append(
            LayerState(z=z, lk=lk, w_mean=w_mean, w_ls=w_ls, level=level, lk_inv=lk_inv,
                       inducing=group, variational=None if group is None else var)
        )
        if ell + 1 < config.num_fidelities and not config.only_hf:
            m = var.mean
            inv = lk_inv if route else None  # with_inv's inverse leaves the solves
            if config.whitened:
                # mu(Z) = L m_w - jitter * L^{-T} m_w
                back = tri_solve_lower(lk, m.unsqueeze(-1), inv, trans=True)[..., 0]
                chain_mean = (lk @ m.unsqueeze(-1))[..., 0] - config.jitter * back
            else:
                # m - jitter * Kzz^{-1} m, reusing w_mean = L^{-1} m
                back = tri_solve_lower(lk, w_mean.unsqueeze(-1), inv, trans=True)[..., 0]
                chain_mean = m - config.jitter * back
    return states


def inverse_route(kzz: torch.Tensor) -> bool:
    """Whether compute_layer_states factors this Gram through the explicit
    inverse (linalg/ops.py::safe_cholesky_inv): when the state is being
    differentiated with respect to the model (grad mode on and the Gram
    requiring grad: training and conditioning) in float64. There every
    solve but L^{-1}'s own becomes a GEMM, backward included. Everything
    else keeps the solves: the searches and the polish are matched to the
    JAX package's iterates, and float32 is not faithful yet."""
    return torch.is_grad_enabled() and kzz.requires_grad and kzz.dtype == torch.float64



def uses_k2(config: MFDGPConfig, x: torch.Tensor) -> bool:
    """Layer 0 runs through K2 (linalg/fused_svgp.py) exactly when no
    gradient is being recorded and the model is unwhitened (K2 is forward
    only and unwhitened, as the TPU kernel), for inputs shared by every
    blackbox. That covers the acquisition screening and the recommendation
    pass; training and the L-BFGS loop keep predict_diag_state."""
    return not torch.is_grad_enabled() and not config.whitened and x.ndim == 2


def _layer0_k2(lp: MFDGPLayerParams, st: LayerState, config: MFDGPConfig, x: torch.Tensor):
    """Layer-0 predictive of every blackbox through K2, at the jitter the
    state's factor ended on (K2 climbs no ladder). The ladder's scale is the
    Gram's mean diagonal, the outputscale."""
    ls, os_ = rbf.scale_rbf_constrained(lp.kernel)
    jitter = ladder_jitter(config.jitter, st.level, os_)
    var = lp.variational if st.variational is None else st.variational
    return fused_rbf_svgp_forward(st.z, x, var.mean, torch.tril(var.chol_raw), ls, os_, jitter)


def forward(
    params: MFDGPParams,
    consts: MFDGPConsts,
    config: MFDGPConfig,
    x: torch.Tensor,
    eps: torch.Tensor,
    max_fidelity: Optional[int] = None,
    states: Optional[List[LayerState]] = None,
    tile: int = 1,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Propagate x through the layer stack (reference mfdgp.py:174-196).

    x: (N, d) or (B, N, d); eps: (B, F-1, N) or (F-1, N) standard normals
    sampling each layer's output before it feeds the next. Returns
    [(mu, var)] per layer, each (B, N). tile: x holds each point `tile`
    times in a row (row n*tile + i); layer 0's output is the same for the
    copies, so both routes compute it once per point and repeat it."""
    num_layers = config.num_fidelities if max_fidelity is None else max_fidelity + 1
    if states is None:
        states = compute_layer_states(params, consts, config)
    outputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    f_prev = None
    for ell in range(num_layers):
        gram, diag = _layer_fns(ell, config.only_hf)
        lp = params.layers[ell]
        st = states[ell]
        if st.inducing is not None:
            gram = functools.partial(sharding.rows_gram, gram, grp=st.inducing)
        if ell == 0:
            x0 = x[..., ::tile, :]
            if uses_k2(config, x):
                mu, var = _layer0_k2(lp, st, config, x0)
            else:
                mu, var = svgp.predict_diag_state(
                    gram, diag, lp.kernel, st.z, x0, st.lk, st.w_mean, st.w_ls, lk_inv=st.lk_inv
                )
            if tile > 1:
                mu = torch.repeat_interleave(mu, tile, dim=-1)
                var = torch.repeat_interleave(var, tile, dim=-1)
        else:
            prev = torch.zeros_like(f_prev) if config.only_hf else f_prev
            x_b = x.expand(prev.shape[:-1] + x.shape[-2:])
            x_in = torch.cat([x_b, prev.unsqueeze(-1)], dim=-1)
            mu, var = svgp.predict_diag_state(
                gram, diag, lp.kernel, st.z, x_in, st.lk, st.w_mean, st.w_ls, lk_inv=st.lk_inv
            )
        outputs.append((mu, var))
        if ell + 1 < num_layers:
            f_prev = mu + torch.sqrt(var) * eps[..., ell, :]
    return outputs


def kl_all_layers(
    params: MFDGPParams,
    consts: MFDGPConsts,
    config: MFDGPConfig,
    states: Optional[List[LayerState]] = None,
) -> torch.Tensor:
    """Summed KL of all layers, one per blackbox."""
    if states is None:
        states = compute_layer_states(params, consts, config)
    total = 0.0
    for ell in range(config.num_fidelities):
        st = states[ell]
        var = params.layers[ell].variational if st.variational is None else st.variational
        total = total + svgp.kl_state(var, st.lk, st.w_mean, st.w_ls, config.whitened)
    return total


def predict(
    params: MFDGPParams,
    consts: MFDGPConsts,
    config: MFDGPConfig,
    x: torch.Tensor,
    fidelity: int,
    eps: torch.Tensor,
    states: Optional[List[LayerState]] = None,
    tile: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive with likelihood noise at `fidelity` (reference mfdgp.py:220-235)."""
    outs = forward(params, consts, config, x, eps, max_fidelity=fidelity, states=states, tile=tile)
    mu, var = outs[fidelity]
    return mu, var + likelihood_noise(params, consts, fidelity).unsqueeze(-1)


def _acq_inputs(consts: MFDGPConsts, config: MFDGPConfig, x: torch.Tensor):
    """x tiled S times per point (row n*S + i) and the fixed per-layer
    acq_eps tiled across the points."""
    n = x.shape[-2]
    s = config.num_samples_for_acquisition
    x_tile = torch.repeat_interleave(x, s, dim=-2)
    tail = consts.acq_eps[..., 1:, :]
    eps = tail.repeat(*([1] * (tail.ndim - 1)), n)
    return x_tile, eps, n, s


def _moment_match(mu_t, var_t, n: int, s: int):
    """Mean and variance of the S-sample mixture per point. The JAX package
    computes E[var + mu^2] - E[mu]^2, which cancels in f32 at large output
    scales (mu ~ 1e2: the variance can come out <= 0); E[var] + E[(mu -
    E[mu])^2] is the same quantity and stays >= E[var] > 0."""
    mu_t = mu_t.reshape(mu_t.shape[:-1] + (n, s))
    var_t = var_t.reshape(var_t.shape[:-1] + (n, s))
    mu = torch.mean(mu_t, dim=-1)
    spread = torch.mean((mu_t - mu.unsqueeze(-1)) ** 2, dim=-1)
    return mu, torch.mean(var_t, dim=-1) + spread


def predict_for_acquisition(
    params: MFDGPParams,
    consts: MFDGPConsts,
    config: MFDGPConfig,
    x: torch.Tensor,
    fidelity: int,
    states: Optional[List[LayerState]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """25x-tiled eval-mode predictive + moment matching (reference
    mfdgp.py:237-262); deterministic through the fixed acq_eps. (B, n) each."""
    x_tile, eps, n, s = _acq_inputs(consts, config, x)
    mus_t, vars_t = predict(params, consts, config, x_tile, fidelity, eps, states=states, tile=s)
    return _moment_match(mus_t, vars_t, n, s)


def predict_for_acquisition_all(
    params: MFDGPParams,
    consts: MFDGPConsts,
    config: MFDGPConfig,
    x: torch.Tensor,
    states: Optional[List[LayerState]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """predict_for_acquisition at every fidelity from one all-layer forward:
    (mus, vars) of shape (B, F, n), row f equal to predict_for_acquisition(f)."""
    x_tile, eps, n, s = _acq_inputs(consts, config, x)
    outs = forward(params, consts, config, x_tile, eps, states=states, tile=s)
    mus_all, vars_all = [], []
    for f, (mu_t, var_t) in enumerate(outs):
        var_t = var_t + likelihood_noise(params, consts, f).unsqueeze(-1)
        mu, var = _moment_match(mu_t, var_t, n, s)
        mus_all.append(mu)
        vars_all.append(var)
    return torch.stack(mus_all, dim=-2), torch.stack(vars_all, dim=-2)


def sample_eps(
    generator: Optional[torch.Generator],
    config: MFDGPConfig,
    n: int,
    dtype: torch.dtype,
    device: DeviceLike,
    batch: Tuple[int, ...] = (),
) -> torch.Tensor:
    """Fresh train-mode propagation normals, shape batch + (F-1, n)."""
    shape = tuple(batch) + (max(config.num_fidelities - 1, 0), n)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)
