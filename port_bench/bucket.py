"""The training rows' padding, a frozen copy of
mobocmf_tpu_torch/fit/bucketing.py (`next_bucket`, `pad_inputs_np`): the
row count is rounded up to a geometric bucket (multiples of 16 up to 64,
the step doubling each octave after) with rows far outside the unit box
(100 + 10 i on every coordinate), fidelity -1 and row weight 0. The
inducing inputs are the training rows, padded alike."""

from __future__ import annotations

import numpy as np


def next_bucket(n: int) -> int:
    if n <= 8:
        return 8
    step, cap = 16, 64
    while n > cap:
        step *= 2
        cap *= 2
    return ((n + step - 1) // step) * step


def pad(x: np.ndarray, fid: np.ndarray):
    """(x, fidelities, row weights) padded to next_bucket(rows)."""
    n, d = x.shape
    extra = next_bucket(n) - n
    pad_x = 100.0 + 10.0 * np.arange(extra, dtype=np.float64)[:, None] * np.ones((1, d))
    return (np.concatenate([x, pad_x]), np.concatenate([fid, np.full(extra, -1)]).astype(int),
            np.concatenate([np.ones(n), np.zeros(extra)]))
