"""The comparison that decides `correct`: the numbers that hold the
program's outputs against the reference's, each with its limit (the
cell's file under port_bench/limits/).

Of the phase's first three steps, from the initial model on both sides:

- loss: the largest relative gap of a logged loss (per blackbox and step,
  or the conditioned phase's total per step) from the reference's;
- kl: the same for the scaled KL of each training step;
- grad: Adam's first gradient, by the worst leaf: the gap between the
  norms of the program's and the reference's gradient of each leaf of each
  blackbox, over the larger of the reference leaf's norm and the median
  leaf's;
- change: the same for the parameters' change over the three steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by round-off alone).

Of the window's tail, the reference starting from the program's state
before it: loss_tail, kl_tail and change_tail, alike (the leaves chosen by
the reference's gradient at the tail's first step).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _norms(d: Dict[str, torch.Tensor]) -> Dict[tuple, float]:
    """The norm of each leaf of each blackbox (leaves carry a leading blackbox dim)."""
    out = {}
    for k, v in d.items():
        v = v.detach().double().cpu()
        for b in range(v.shape[0]):
            out[(k, b)] = float(torch.linalg.vector_norm(v[b]))
    return out


def _median(vals):
    vals = sorted(v for v in vals if v > 0)
    if not vals:
        return 0.0
    n = len(vals)
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep=None) -> float:
    p, r = _norms(prog), _norms(ref)
    med = _median(r.values())
    keys = [k for k in r if keep is None or k in keep]
    if not keys:
        return 0.0
    gaps = [abs(p[k] - r[k]) / max(r[k], med) for k in keys]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> set:
    r = _norms(ref_grad)
    med = _median(r.values())
    return {k for k, v in r.items() if v >= 1e-3 * med}


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.detach().double().cpu(), ref.detach().double().cpu()
    return float(torch.max(torch.abs(p - r) / torch.abs(r)))


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    out = {}
    for part in ("", "_tail"):
        for name in ("loss", "kl"):
            if name + part in ref:
                out[name + part] = rel_gap(prog[name + part], ref[name + part])
        out["change" + part] = leaf_gap(prog["change" + part], ref["change" + part],
                                        moving_leaves(ref["grad" + part]))
    out["grad"] = leaf_gap(prog["grad"], ref["grad"])
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite fails)."""
    return all(name in nums and nums[name] <= lim for name, lim in limits.items())
