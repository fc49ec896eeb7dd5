"""General host-side helpers of the examples
(counterpart of mobocmf_tpu/util/util.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.core.distances import compute_dist  # noqa: F401 (the JAX module's name)


def create_path(folder: str):
    if not os.path.exists(folder):
        os.makedirs(folder)


def save_pickle(folder: str, filename: str, content):
    create_path(folder)
    with open(os.path.join(folder, filename), "wb") as fw:
        pickle.dump(content, fw)


def read_pickle(folder: str, filename: str):
    with open(os.path.join(folder, filename), "rb") as fr:
        return pickle.load(fr)


def triu_indices(n: int, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) of the upper triangle from diagonal `offset` on."""
    rows, cols = torch.triu_indices(n, n, offset=offset)
    return rows, cols


def preprocess_outputs(*args, device: DeviceLike = None):
    """Identity standardization (the reference hard-codes mean 0 / std 1:
    'do not standardize the outputs. Otherwise linear dependencies are
    broken'): each output as a float64 tensor on `device` (`cuda` unless
    named), then the mean and std."""
    device = resolve_device(device)
    y_mean, y_std = 0.0, 1.0
    y_train = [torch.as_tensor((np.asarray(y) - y_mean) / y_std, dtype=torch.float64,
                               device=device) for y in args]
    y_train.extend([y_mean, y_std])
    return y_train[:]


def preprocess_outputs_two_fidelities(y_low, y_high, device: DeviceLike = None):
    y_low, y_high, y_mean, y_std = preprocess_outputs(y_low, y_high, device=device)
    return y_low, y_high, y_mean, y_std


def standardize_outputs(y_low, y_high):
    """The standardization the examples apply (shared mean and std across
    fidelities), on numpy arrays."""
    stacked = np.vstack([np.asarray(y_high).reshape(-1, 1), np.asarray(y_low).reshape(-1, 1)])
    y_mean, y_std = float(stacked.mean()), float(stacked.std())
    return (
        (np.asarray(y_low) - y_mean) / y_std,
        (np.asarray(y_high) - y_mean) / y_std,
        y_mean,
        y_std,
    )


def reset_random_state(seed: int):
    """Seed numpy's global generator, as the JAX package does. torch is not
    seeded: the port draws from explicit torch.Generators."""
    np.random.seed(seed)
