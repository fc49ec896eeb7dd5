"""Distances and the median-heuristic lengthscale (counterpart of
mobocmf_tpu/core/distances.py).

`compute_dist` is the squared Euclidean distance matrix by the expansion
trick, `cdist` the Euclidean distances between two sets (the squares
clamped at 0 before the root). The median lengthscale is sqrt(median of
the strictly-upper-triangular squared distances), clamped at 0 and falling
back to 1 for a degenerate set.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_dist(x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance matrix, (n, n)."""
    sq = torch.sum(x * x, dim=1, keepdim=True)
    return sq - 2.0 * (x @ x.T) + sq.T


def cdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix between two point sets, (n1, n2)."""
    sq1 = torch.sum(x1 * x1, dim=1, keepdim=True)
    sq2 = torch.sum(x2 * x2, dim=1, keepdim=True)
    d2 = sq1 - 2.0 * (x1 @ x2.T) + sq2.T
    return torch.sqrt(torch.clamp(d2, min=0.0))


def median_lengthscale_np(x) -> np.ndarray:
    """Host-numpy median lengthscale; model init calls it on per-fidelity
    row subsets."""
    x = np.asarray(x)
    n = x.shape[0]
    sq = np.sum(x**2, axis=1, keepdims=True)
    d2 = sq - 2.0 * (x @ x.T) + sq.T
    iu, ju = np.triu_indices(n, k=1)
    vals = d2[iu, ju]
    if vals.size == 0:
        return np.asarray(1.0)
    med = np.maximum(np.median(vals), 0.0)
    return np.sqrt(med) if med > 0.0 else np.asarray(1.0)


def median_lengthscale(x: torch.Tensor) -> torch.Tensor:
    """Tensor counterpart of median_lengthscale_np, on x's device.

    torch.median returns the lower of the two middle values, so the mean of
    the two middle order statistics is taken explicitly (numpy's median)."""
    n = x.shape[0]
    if n < 2:
        return torch.ones((), dtype=x.dtype, device=x.device)
    d2 = compute_dist(x)
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    vals = torch.sort(d2[iu, ju]).values
    k = vals.shape[0]
    med = 0.5 * (vals[(k - 1) // 2] + vals[k // 2])
    med = torch.clamp(med, min=0.0)
    return torch.where(med > 0.0, torch.sqrt(med), torch.ones_like(med))
