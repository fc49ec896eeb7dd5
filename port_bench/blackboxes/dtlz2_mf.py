"""DTLZ2 (Deb, Thiele, Laumanns and Zitzler, "Scalable multi-objective
optimization test problems", 2002; BoTorch's `DTLZ2`) with F fidelities, a
frozen copy of the program's mobocmf_tpu_torch/test_functions/synthetic.py::
dtlz2 and mobocmf_tpu_torch/examples/example_dtlz2_2048.py::mf_objective.

The configuration's `num_objectives` objectives `obj1`.. on [0, 1]^d (d at
least num_objectives - 1), no constraints. Level F - 1 is the exact
function; level l below it adds 0.1 (F - 1 - l) mean(sin(6 pi x)) +
0.05 (F - 1 - l), the example's distortion at F = 3.
"""

from __future__ import annotations

from typing import List

import numpy as np

from port_bench.problems import Blackbox


def dtlz2(x, num_objectives: int = 4):
    """DTLZ2 objectives on [0,1]^d, d >= num_objectives - 1."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    m = num_objectives
    g = np.sum((x[:, m - 1:] - 0.5) ** 2, axis=1)
    out = np.empty((x.shape[0], m))
    for i in range(m):
        f = 1.0 + g
        for j in range(m - 1 - i):
            f = f * np.cos(0.5 * np.pi * x[:, j])
        if i > 0:
            f = f * np.sin(0.5 * np.pi * x[:, m - 1 - i])
        out[:, i] = f
    return out


def make(config: dict, device) -> List[Blackbox]:
    k, top = config["num_objectives"], config["num_fidelities"] - 1

    def objective(i):
        def distort(xs, level):
            xs = np.atleast_2d(np.asarray(xs, dtype=float))
            base = dtlz2(xs, k)[:, i]
            if level == top:
                return base
            amp = 0.1 * (top - level)
            return base + amp * np.mean(np.sin(6.0 * np.pi * xs), axis=1) + 0.05 * (top - level)

        return [lambda xs, level=level: distort(xs, level) for level in range(top + 1)]

    return [Blackbox(f"obj{i + 1}", False, 0.0, objective(i)) for i in range(k)]
