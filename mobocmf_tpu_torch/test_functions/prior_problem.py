"""Feasibility-calibrated problems sampled from the MFDGP prior
(counterpart of mobocmf_tpu/test_functions/prior_problem.py).

Ground-truth objectives and constraints are RFF draws from an untrained
MFDGP prior; each constraint is rejection-sampled until 10-90 % of a probe
grid is feasible (reference toy_synthetic_2D_JESMOCMF.py:50-96), with a
floor on the joint feasible fraction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.sampling import rff


def sample_problem(
    generator: torch.Generator,
    d: int = 2,
    num_constraints: int = 2,
    num_fidelities: int = 2,
    max_tries: int = 30,
    probe: Optional[np.ndarray] = None,
    min_joint_feasible: float = 0.05,
    dtype: torch.dtype = torch.float64,
    device: DeviceLike = None,
):
    """Prior-sampled objectives (two) and feasibility-calibrated constraints.

    Returns (objs, cons): lists of `rff.MFDGPFunctionSample` ground-truth
    functions (evaluate with `rff.eval_sample(s, x, layer=fidelity)`) on
    `device` (`cuda` unless named; `generator` lives there too). Every
    draw, the 500-point probe included when `probe` is None, comes from
    `generator`, so the problem is a function of its seed."""
    device = resolve_device(device)
    objs = [
        rff.sample_prior(generator, d, num_fidelities, dtype=dtype, device=device)
        for _ in range(2)
    ]
    if probe is None:
        probe = torch.rand(
            (500, d), generator=generator, dtype=torch.float64, device=device
        ).cpu().numpy()
    probe_t = torch.as_tensor(probe, dtype=dtype, device=device)
    cons: List = []
    joint_feas = np.ones(probe.shape[0], dtype=bool)
    while len(cons) < num_constraints:
        for _ in range(max_tries):
            cand = rff.sample_prior(generator, d, num_fidelities, dtype=dtype, device=device)
            vals = rff.eval_sample(cand, probe_t).cpu().numpy()
            frac = float((vals >= 0).mean())
            if 0.1 <= frac <= 0.9 and (joint_feas & (vals >= 0)).mean() >= min_joint_feasible:
                cons.append(cand)
                joint_feas &= vals >= 0
                break
        else:
            raise ValueError("could not sample a constraint with 10-90% feasibility")
    return objs, cons
