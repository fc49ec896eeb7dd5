"""Parameter constraint transforms, raw <-> constrained
(counterpart of mobocmf_tpu/core/constraints.py).

Softplus `Positive` for kernel lengthscales / outputscales / linear-kernel
variances, sigmoid `Interval` for likelihood noises, `GreaterThan`. The
formulas are written as in the JAX package (not torch.sigmoid /
F.softplus) so both packages round alike in the f64 parity tests.
"""

from __future__ import annotations

import dataclasses

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """Exact inverse of softplus, log(expm1(y)); y itself above 20."""
    big = y > 20.0
    return torch.where(big, y, torch.log(torch.expm1(torch.where(big, torch.ones_like(y), y))))


@dataclasses.dataclass(frozen=True)
class Positive:
    """constrained = softplus(raw)."""

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        return softplus(raw)

    def inverse(self, value: torch.Tensor) -> torch.Tensor:
        return inv_softplus(value)


@dataclasses.dataclass(frozen=True)
class Interval:
    """constrained = lower + (upper-lower) * sigmoid(raw).

    lower/upper are floats or tensors broadcastable against raw."""

    lower: object
    upper: object

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        return self.lower + (self.upper - self.lower) * torch.reciprocal(1.0 + torch.exp(-raw))

    def inverse(self, value: torch.Tensor) -> torch.Tensor:
        t = (value - self.lower) / (self.upper - self.lower)
        t = torch.clamp(t, 1e-12, 1.0 - 1e-12)
        return torch.log(t) - torch.log1p(-t)


@dataclasses.dataclass(frozen=True)
class GreaterThan:
    """constrained = lower + softplus(raw)."""

    lower: float

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        return self.lower + softplus(raw)

    def inverse(self, value: torch.Tensor) -> torch.Tensor:
        return inv_softplus(value - self.lower)
