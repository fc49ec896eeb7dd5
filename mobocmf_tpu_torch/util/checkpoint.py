"""Checkpoint and restore of a fitter (counterpart of
mobocmf_tpu/util/checkpoint.py, which writes orbax checkpoints).

A checkpoint is one `torch.save` file, `<path>/state.pt`, of plain dicts,
lists, tensors (on the CPU) and primitives, so `torch.load(...,
weights_only=True)` reads it: no class of the port is pickled. It holds
every model's params and consts (the NamedTuples as dicts, rebuilt on
load), the training data, and the same `meta` as the JAX package's: the
names, thresholds, `num_real`, `pad_data`, the `hyper` schedule, the model
config and the Pareto solution. The fitter's generator states go with it,
so a restored fitter continues the same random streams.
"""

from __future__ import annotations

import os
import warnings

import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.models.svgp import SVGPVariational
from mobocmf_tpu_torch.moop.moop import ParetoSolution

STATE_FILE = "state.pt"


def _plain(tree):
    """NamedTuples -> dicts, tuples -> lists, tensors -> CPU copies."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _model_state(model: M.MFDGPModel) -> dict:
    return {"params": _plain(model.params), "consts": _plain(model.consts)}


def save_fitter(path: str, fitter) -> None:
    os.makedirs(path, exist_ok=True)
    state = {
        "obj": [_model_state(fitter.models_objs[n]) for n in fitter.obj_names],
        "con": [_model_state(fitter.models_cons[n]) for n in fitter.con_names],
        "x_train": _plain(fitter.x_train),
        "fidelities": _plain(fitter.fidelities),
        "ys_objs": _plain(list(fitter.ys_objs)),
        "ys_cons": _plain(list(fitter.ys_cons)),
        "row_weights": _plain(fitter.row_weights),
        "generator": fitter.generator.get_state(),
        "host_generator": fitter.host_generator.get_state(),
        "device_type": fitter.device.type,
    }
    meta = {
        "num_real": int(fitter.num_real),
        "pad_data": bool(fitter.pad_data),
        "obj_names": list(fitter.obj_names),
        "con_names": list(fitter.con_names),
        "thresholds_cons": [float(t) for t in fitter.thresholds_cons],
        "num_fidelities": int(fitter.num_fidelities),
        "batch_size": int(fitter.batch_size),
        "models_uncond_trained": bool(fitter.models_uncond_trained),
        # the full schedule, so a restored fitter trains and samples as the
        # campaign configured it
        "hyper": {
            "lr_1": float(fitter.lr_1),
            "lr_2": float(fitter.lr_2),
            "num_epochs_1": int(fitter.num_epochs_1),
            "num_epochs_2": int(fitter.num_epochs_2),
            "pareto_set_size": int(fitter.pareto_set_size),
            "opt_grid_size": int(fitter.opt_grid_size),
            "eps": float(fitter.eps),
            "polish": str(fitter.polish),
            "whitened": bool(fitter.whitened),
            "whitened_init": str(fitter.whitened_init),
            "type_lengthscale": fitter.type_lengthscale.name,
        },
        "config": [dict(fitter.models_objs[fitter.obj_names[0]].config._asdict())]
        if fitter.obj_names
        else [],
        "dtype": str(fitter.dtype).replace("torch.", ""),
    }
    sol = fitter.pareto_solution
    if sol is not None:
        state["pareto_set"] = _plain(sol.pareto_set)
        state["pareto_front"] = _plain(sol.pareto_front)
        state["pareto_mask"] = _plain(sol.mask)
        meta["pareto_num_valid"] = int(sol.num_valid)
    torch.save({"state": state, "meta": meta}, os.path.join(path, STATE_FILE))


def restore_fitter(path: str, device: DeviceLike = None):
    """A fresh BlackBoxMFDGPFitter rebuilt from `path` on `device` (`cuda`
    unless named), in the saved dtype. The generator states are restored
    when the device type is the one saved (a CUDA generator's state does
    not fit a CPU generator)."""
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

    device = resolve_device(device)
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state, meta = blob["state"], blob["meta"]
    dtype = getattr(torch, meta["dtype"])

    hyper = dict(meta["hyper"])
    hyper["type_lengthscale"] = TL[hyper["type_lengthscale"]]
    fitter = BlackBoxMFDGPFitter(
        num_fidelities=int(meta["num_fidelities"]), batch_size=int(meta["batch_size"]),
        pad_data=bool(meta["pad_data"]), device=device, dtype=dtype, **hyper,
    )

    def dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device)

    fitter.obj_names = list(meta["obj_names"])
    fitter.con_names = list(meta["con_names"])
    fitter.thresholds_cons = list(meta["thresholds_cons"])
    fitter.models_uncond_trained = bool(meta["models_uncond_trained"])
    fitter.x_train = dev(state["x_train"])
    fitter._x_np = state["x_train"].double().numpy()
    fitter.fidelities = dev(state["fidelities"])
    fitter.row_weights = dev(state["row_weights"])
    fitter.num_real = int(meta["num_real"])
    fitter.ys_objs = [dev(y) for y in state["ys_objs"]]
    fitter.ys_cons = [dev(y) for y in state["ys_cons"]]
    fitter.num_obj, fitter.num_con = len(fitter.obj_names), len(fitter.con_names)
    if state["device_type"] == device.type:
        fitter.generator.set_state(state["generator"])
        fitter.host_generator.set_state(state["host_generator"])
    else:
        warnings.warn(
            f"restore_fitter: saved on {state['device_type']}, restored on {device.type}; "
            "the generators start from the fitter's seed, not the saved streams"
        )

    config = M.MFDGPConfig(**meta["config"][0]) if meta["config"] else None

    def rebuild(ms: dict) -> M.MFDGPModel:
        p, c = ms["params"], ms["consts"]

        def kernel(k):
            return {n: kernel(v) if isinstance(v, dict) else dev(v) for n, v in k.items()}

        params = M.MFDGPParams(
            layers=tuple(
                M.MFDGPLayerParams(
                    kernel=kernel(lp["kernel"]),
                    variational=SVGPVariational(
                        mean=dev(lp["variational"]["mean"]),
                        chol_raw=dev(lp["variational"]["chol_raw"]),
                    ),
                )
                for lp in p["layers"]
            ),
            raw_noises=dev(p["raw_noises"]),
        )
        consts = M.MFDGPConsts(
            z_x=tuple(dev(z) for z in c["z_x"]),
            acq_eps=dev(c["acq_eps"]),
            noise_lower=dev(c["noise_lower"]),
            noise_upper=dev(c["noise_upper"]),
        )
        return M.MFDGPModel(params=params, consts=consts, config=config)

    for n, ms in zip(fitter.obj_names, state["obj"]):
        fitter.models_objs[n] = rebuild(ms)
    for n, ms in zip(fitter.con_names, state["con"]):
        fitter.models_cons[n] = rebuild(ms)

    if "pareto_set" in state:
        fitter.pareto_solution = ParetoSolution(
            pareto_set=dev(state["pareto_set"]),
            pareto_front=dev(state["pareto_front"]),
            mask=dev(state["pareto_mask"]),
            num_valid=int(meta["pareto_num_valid"]),
        )
    return fitter
