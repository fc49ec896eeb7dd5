"""Bucketed shape padding (numpy copy of mobocmf_tpu/fit/bucketing.py).

The row count N is rounded up to a geometric bucket (multiples of 16 up to
64, then the step doubles each octave) and padded with rows far outside the
unit box (x_pad[i] = 100 + 10*i on every coordinate), fidelity -1 (no
layer), target 0 and row weight 0. Because the inducing set is the training
inputs, padding also pads the inducing set.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_FIDELITY = -1


def next_bucket(n: int) -> int:
    """Smallest bucket >= n."""
    if n <= 8:
        return 8
    step, cap = 16, 64
    while n > cap:
        step *= 2
        cap *= 2
    return ((n + step - 1) // step) * step


def pad_inputs_np(
    x: np.ndarray, fidelities: np.ndarray, target: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (x, fidelities) with far-away rows up to `target` rows. Returns
    (x_padded, fidelities_padded, row_weights), weights 1 real / 0 pad."""
    n, d = x.shape
    extra = target - n
    if extra < 0:
        raise ValueError(f"target {target} < rows {n}")
    if extra == 0:
        return x, fidelities, np.ones((n,), dtype=x.dtype)
    pad_x = 100.0 + 10.0 * np.arange(extra, dtype=x.dtype)[:, None] * np.ones((1, d), dtype=x.dtype)
    x_p = np.concatenate([x, pad_x], axis=0)
    fid_p = np.concatenate(
        [
            np.asarray(fidelities).reshape(-1).astype(np.int32),
            np.full((extra,), PAD_FIDELITY, dtype=np.int32),
        ]
    )
    w = np.concatenate([np.ones((n,), dtype=x.dtype), np.zeros((extra,), dtype=x.dtype)])
    return x_p, fid_p, w


def pad_rows_np(a: np.ndarray, target: int, fill: float = 0.0) -> np.ndarray:
    """Pad the leading axis of a numpy array with `fill`."""
    extra = target - a.shape[0]
    if extra <= 0:
        return a
    pad_shape = (extra,) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)], axis=0)
