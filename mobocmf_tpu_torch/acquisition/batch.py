"""q-batch candidate selection (counterpart of mobocmf_tpu/acquisition/batch.py).

The reference only supports q=1 (optimize_acqf(q=1), JESMOC_MFDGP.py:159).
A batch is chosen by sequential greedy maximization with a
local-penalization repulsion term: after each pick, later maximizations of
the same acquisition are penalized near the points already chosen, which
spreads the batch without retraining conditioned models per pick.

    a_k(x) = a(x) * prod_{j<k} [1 - exp(-||x - x_j||^2 / (2 rho^2))]

rho defaults to 5 % of the box diagonal. Each pick is one multi-start
L-BFGS search (acquisition/optimize.py); its screening runs without
gradients, so an MFDGP acquisition's layer 0 goes through K2 there.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mobocmf_tpu_torch.acquisition.optimize import optimize_acqf_box
from mobocmf_tpu_torch.fit import graphs
from mobocmf_tpu_torch.util import heartbeat

# unfilled batch slots live far outside the unit box: their penalty factor
# is exactly 1 and, unlike NaN padding, they cannot poison a gradient
PAD_VALUE = 1e6


def penalized_acq(acq_fn: Callable, chosen: torch.Tensor, rho: float) -> Callable:
    """Repulsion-penalized acquisition; `chosen` is (k, d), PAD_VALUE-padded."""

    def fn(x: torch.Tensor) -> torch.Tensor:  # (N, d) -> (N,)
        base = acq_fn(x)
        d2 = torch.sum((x[:, None, :] - chosen[None, :, :]) ** 2, dim=-1)  # (N, k)
        pen = 1.0 - torch.exp(-d2 / (2.0 * rho**2))
        return base * graphs.prod(pen, dim=1)

    return fn


def optimize_acqf_batch(
    acq_fn: Callable[[torch.Tensor], torch.Tensor],
    input_dim: int,
    q: int,
    generator: Optional[torch.Generator],
    num_restarts: int = 5,
    raw_samples: int = 200,
    maxiter: int = 200,
    rho: Optional[float] = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy q-batch maximization over [0, 1]^d: (X (q, d), values (q,))."""
    if rho is None:
        rho = 0.05 * (input_dim**0.5)
    if device is None and generator is not None:
        device = generator.device
    chosen = torch.full((q, input_dim), PAD_VALUE, dtype=dtype, device=device)
    values = torch.zeros((q,), dtype=dtype, device=device)
    for k in range(q):
        x_k, v_k = optimize_acqf_box(
            penalized_acq(acq_fn, chosen, rho), input_dim, generator,
            num_restarts=num_restarts, raw_samples=raw_samples, maxiter=maxiter,
            dtype=dtype, device=device,
        )
        chosen = chosen.clone()
        chosen[k] = x_k.detach()
        values[k] = v_k.detach()
        heartbeat.beat(f"batch:pick{k}")
    return chosen, values
