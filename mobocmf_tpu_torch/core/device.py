"""Device resolution for the port's entry points.

Entry points run on `cuda` unless the caller names another device. With no
GPU and no device named they raise: the port never carries on quietly on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    """float32 (the card's working type) unless the caller asks for another."""
    return torch.float32 if dtype is None else dtype
