"""Carry an MFDGP's weights between the JAX package and the port, as numpy.

`model_from_numpy` takes params / consts laid out like the JAX package's
MFDGPParams / MFDGPConsts (nested tuples and dicts of numpy arrays, read by
position: params = (layers, raw_noises), layer = (kernel dict,
(mean, chol_raw)), consts = (z_x, acq_eps, noise_lower, noise_upper)) and
the config as a plain dict. A single model (raw_noises of shape (F,))
becomes a B = 1 port model; a stacked one (raw_noises (B, F)) keeps its B.
`model_to_numpy` is the inverse: the blackbox dim is dropped when B = 1.
`fitter_from_numpy` carries a whole fitter across: its training data, both
stacks of models, the thresholds and the Pareto solution.
`mfgp_from_numpy`, `mfgp_lin_from_numpy` and `exact_gp_from_numpy` build
the exact-GP models from params laid out like the JAX package's (kernel
dict, raw_noise) and their data.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.models import exact_gp as EG
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models import mfgp as G
from mobocmf_tpu_torch.models import mfgp_lin as GL
from mobocmf_tpu_torch.models.svgp import SVGPVariational
from mobocmf_tpu_torch.util.tree import tree_map


def model_from_numpy(
    params, consts, config: Dict, device: DeviceLike, dtype: torch.dtype
) -> M.MFDGPModel:
    device = resolve_device(device)
    stacked = np.asarray(params[1]).ndim == 2

    def t(a):
        out = torch.as_tensor(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)
        return out if stacked else out.unsqueeze(0)

    layers = tuple(
        M.MFDGPLayerParams(
            kernel=tree_map(t, dict(kernel)),
            variational=SVGPVariational(mean=t(var[0]), chol_raw=t(var[1])),
        )
        for kernel, var in params[0]
    )
    z_x, acq_eps, noise_lower, noise_upper = consts
    return M.MFDGPModel(
        params=M.MFDGPParams(layers=layers, raw_noises=t(params[1])),
        consts=M.MFDGPConsts(
            z_x=tuple(
                torch.as_tensor(np.array(z, dtype=np.float64)).to(device=device, dtype=dtype)
                for z in z_x
            ),
            acq_eps=t(acq_eps),
            noise_lower=t(noise_lower),
            noise_upper=t(noise_upper),
        ),
        config=M.MFDGPConfig(**dict(config)),
    )


def model_to_numpy(model: M.MFDGPModel) -> Tuple[M.MFDGPParams, M.MFDGPConsts, Dict]:
    """(params, consts, config dict) with numpy leaves."""
    single = model.params.raw_noises.shape[0] == 1

    def n(a):
        out = a.detach().cpu().numpy()
        return out[0] if single else out

    c = model.consts
    consts = M.MFDGPConsts(
        z_x=tuple(z.detach().cpu().numpy() for z in c.z_x),
        acq_eps=n(c.acq_eps),
        noise_lower=n(c.noise_lower),
        noise_upper=n(c.noise_upper),
    )
    return tree_map(n, model.params), consts, dict(model.config._asdict())


def fitter_from_numpy(
    num_fidelities: int,
    batch_size: int,
    x_train,
    fidelities,
    row_weights,
    num_real: int,
    objs: Sequence[Tuple],
    cons: Sequence[Tuple],
    thresholds: Sequence[float],
    pareto: Optional[Tuple] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    **fitter_kwargs,
):
    """A BlackBoxMFDGPFitter holding given models. x_train, fidelities,
    row_weights: the (padded) training rows as numpy; objs / cons: (name,
    params, consts, config dict, y) per blackbox, params and consts as for
    `model_from_numpy`; pareto: (pareto_set, pareto_front, mask, num_valid)
    or None. fitter_kwargs go to the constructor (schedule, polish, ...)."""
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
    from mobocmf_tpu_torch.moop.moop import ParetoSolution

    fitter = BlackBoxMFDGPFitter(num_fidelities, batch_size, device=device, dtype=dtype,
                                 **fitter_kwargs)
    dev = fitter.device

    def t(a, dt=dtype):
        return torch.as_tensor(np.array(a)).to(device=dev, dtype=dt)

    fitter._x_np = np.asarray(x_train, dtype=np.float64)
    fitter.x_train = t(x_train)
    fitter.fidelities = t(fidelities, torch.int32)
    fitter.row_weights = t(row_weights)
    fitter.num_real = int(num_real)
    for (name, params, consts, config, y), is_con in [(e, False) for e in objs] + [
        (e, True) for e in cons
    ]:
        model = model_from_numpy(params, consts, config, dev, dtype)
        if is_con:
            fitter.models_cons[name] = model
            fitter.con_names.append(name)
            fitter.ys_cons.append(t(y))
        else:
            fitter.models_objs[name] = model
            fitter.obj_names.append(name)
            fitter.ys_objs.append(t(y))
    fitter.thresholds_cons = [float(v) for v in thresholds]
    fitter.num_obj, fitter.num_con = len(fitter.obj_names), len(fitter.con_names)
    fitter.models_uncond_trained = True
    if pareto is not None:
        pset, pfront, mask, num_valid = pareto
        fitter.pareto_solution = ParetoSolution(
            t(pset), t(pfront), t(mask, torch.bool), int(num_valid)
        )
    return fitter


def _tensors(tree, device: DeviceLike, dtype: torch.dtype):
    device = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype),
        tree)


def mfgp_from_numpy(params, x_train, y_train, num_fidelities: int, jitter: float,
                    row_penalty=None, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32):
    """An MFGPModel from (kernel, raw_noise) and the data, as numpy."""
    kernel, raw_noise, x, y, pen = _tensors(
        (dict(params[0]), params[1], x_train, y_train, row_penalty), device, dtype)
    return G.MFGPModel(params=G.MFGPParams(kernel=kernel, raw_noise=raw_noise), x_train=x,
                       y_train=y.reshape(-1), num_fidelities=num_fidelities,
                       input_dim=x.shape[1] - 1, jitter=float(jitter), row_penalty=pen)


def mfgp_lin_from_numpy(params, x_train, y_train, num_fidelities: int, jitter: float,
                        device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """An MFGPLinModel from (kernel, raw_noise) and the data, as numpy."""
    kernel, raw_noise, x, y = _tensors((dict(params[0]), params[1], x_train, y_train),
                                       device, dtype)
    return GL.MFGPLinModel(params=GL.MFGPLinParams(kernel=kernel, raw_noise=raw_noise),
                           x_train=x, y_train=y.reshape(-1), num_fidelities=num_fidelities,
                           input_dim=x.shape[1] - 1, jitter=float(jitter))


def exact_gp_from_numpy(params, x_train, y_train, jitter: float, device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32):
    """An ExactGPModel from (kernel, raw_noise) and the data, as numpy."""
    kernel, raw_noise, x, y = _tensors((dict(params[0]), params[1], x_train, y_train),
                                       device, dtype)
    return EG.ExactGPModel(params=EG.ExactGPParams(kernel=kernel, raw_noise=raw_noise),
                           x_train=x, y_train=y.reshape(-1), jitter=float(jitter))
