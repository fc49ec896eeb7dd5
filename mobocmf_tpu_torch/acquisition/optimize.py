"""Multi-start acquisition maximization over the unit box
(counterpart of mobocmf_tpu/acquisition/optimize.py).

Replaces botorch's optimize_acqf(q=1, num_restarts=5, raw_samples=200,
options={"maxiter": 200}) of the reference acquisitions
(JESMOC_MFDGP.py:159-160), as the JAX package does:
1. score `raw_samples` uniform points, without gradients (so each model's
   layer 0 runs through K2, models/mfdgp.py::uses_k2);
2. take the top `num_restarts` per surface as starts (deterministic top-k);
3. run optax's L-BFGS (acquisition/lbfgs.py) in the unconstrained box
   x = sigmoid(z), every start of every surface one lane of one batched
   search: the lanes' objectives are independent, so one evaluation and
   one backward of their sum give every lane its own value and gradient.
   A lane stops as the JAX package's loop does, once max|g| <= gtol
   (scipy L-BFGS-B's pgtol contract) or after `maxiter` iterations, so the
   iterates are the JAX package's; on the card its pieces are replayed
   from CUDA graphs, as the JAX package's loop is one jitted program;
4. return the best point seen per surface, the raw screening values
   included as a floor (a failed line search cannot regress). A lane that
   ends on a non-finite value is never the candidate: at f32 a lane can
   end on NaN (a NaN gradient makes its direction NaN, and optax's step of
   0 along it is NaN too), which the JAX package's argmax would return,
   since NaN sorts above every number.
`lbfgs.last_stats` describes the last search.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mobocmf_tpu_torch.acquisition.lbfgs import lbfgs_lanes


def _logit(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


def optimize_acqf_box_multi(
    acq_all_fn: Callable[[torch.Tensor], torch.Tensor],
    n_out: int,
    input_dim: int,
    generator: Optional[torch.Generator],
    num_restarts: int = 5,
    raw_samples: int = 200,
    maxiter: int = 200,
    gtol: float = 1e-5,
    dtype: torch.dtype = torch.float64,
    device=None,
    raw: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize `n_out` acquisition surfaces sharing one evaluator.

    acq_all_fn: (N, d) -> (n_out, N), pointwise in N. The screening is
    shared (one evaluation scores every surface) and all n_out x
    num_restarts lanes run in one batched L-BFGS. raw: the (raw_samples, d)
    screening points (default: uniform from `generator`). mesh: the mesh
    whose collectives acq_all_fn runs (None: none), which decides whether
    the L-BFGS pieces are captured (acquisition/lbfgs.py). Returns
    (xs (n_out, d), values (n_out,))."""
    if raw is None:
        dev = device if device is not None else (generator.device if generator is not None else None)
        raw = torch.rand((raw_samples, input_dim), generator=generator, dtype=dtype, device=dev)
    with torch.no_grad():
        raw_vals = acq_all_fn(raw)  # (n_out, raw_samples)
    top_vals, top_idx = torch.topk(raw_vals, num_restarts, dim=1)  # (n_out, R)
    starts = raw[top_idx]  # (n_out, R, d)
    lanes = n_out * num_restarts
    lane_out = torch.arange(n_out, device=raw.device).repeat_interleave(num_restarts)
    rows = torch.arange(lanes, device=raw.device)

    def neg_acq(z):  # (lanes, d) -> (lanes,)
        return -acq_all_fn(torch.sigmoid(z))[lane_out, rows]

    z = lbfgs_lanes(neg_acq, _logit(starts.reshape(lanes, input_dim)), maxiter, gtol,
                    collectives=mesh)
    xs = torch.sigmoid(z)
    with torch.no_grad():
        vals = acq_all_fn(xs)[lane_out, rows]
    all_x = torch.cat([xs.reshape(n_out, num_restarts, input_dim), starts], dim=1)  # (n_out, 2R, d)
    all_v = torch.cat([vals.reshape(n_out, num_restarts), top_vals], dim=1)
    best = torch.argmax(torch.nan_to_num(all_v, nan=-torch.inf), dim=1)
    take = torch.arange(n_out, device=raw.device)
    return all_x[take, best], all_v[take, best]


def optimize_acqf_box(
    acq_fn: Callable[[torch.Tensor], torch.Tensor],
    input_dim: int,
    generator: Optional[torch.Generator],
    num_restarts: int = 5,
    raw_samples: int = 200,
    maxiter: int = 200,
    gtol: float = 1e-5,
    dtype: torch.dtype = torch.float64,
    device=None,
    raw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize acq_fn ((N, d) -> (N,)) over [0, 1]^d: (x_best (d,), value ())."""
    xs, vals = optimize_acqf_box_multi(
        lambda x: acq_fn(x)[None], 1, input_dim, generator, num_restarts, raw_samples,
        maxiter, gtol, dtype, device, raw,
    )
    return xs[0], vals[0]
