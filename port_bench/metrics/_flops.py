"""Floating-point operations the work of a cell needs, from its shapes and
the window's counts alone (never from the program's counters), and the
published peaks of one NVIDIA H100 SXM and K1's least time (copied from
chip_smoke.py's `PEAK_FLOPS`, `PEAK_BYTES_PER_S` and `chol_bound_ms`):
67 TFLOP/s float64, the peak of its FP64 tensor cores, which cuBLAS's
dgemm and dtrsm use; 67 TFLOP/s float32 outside the tensor cores (the
configurations' float32 turns TF32 off); 3.35 TB/s of HBM3.

An operation is a floating-point add or multiply; an exp, a log or a
square root counts as one. A triangular operand counts its triangle only:
a solve L^-1 B with L m x m lower costs m^2 per column of B, a product of
two triangular factors a third of the dense one. The counts are of what
the mathematics needs, not of what a kernel happens to execute, so they
stand when a later change fuses or removes a kernel.

Shapes: B stacked blackboxes, F layers (fidelities), m inducing points
(= padded training rows), d input dimensions; layer 0's kernel is a
scale-RBF on x, each deeper layer's the deep multi-fidelity kernel on
[x, f].
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES_PER_S = 3.35e12  # HBM3
WORD_BYTES = {"float32": 4, "float64": 8}


def entry_flops(layer: int, d: int) -> float:
    """One kernel entry: a scale-RBF on d dims takes 3d + 2 (differences,
    scales, squares and sum, exp, outputscale); the deep kernel two of
    them on x, one on f (5), the linear term (2) and the combination (3)."""
    rbf = 3 * d + 2
    return rbf if layer == 0 else 2 * rbf + 5 + 2 + 3


def layer_state_flops(layer: int, m: int, d: int) -> float:
    """One blackbox's layer state: the Gram's lower triangle, its factor
    m^3/3, L^-1 [mean | L_S] (m^2 for the mean, m^3/3 for the triangular
    L_S) and the inducing chain's back solve (m^2 + 2m)."""
    gram = m * (m + 1) / 2 * entry_flops(layer, d)
    return gram + m**3 / 3 + m**2 + m**3 / 3 + m**2 + 2 * m


def predictive_flops(layer: int, m: int, n: int, d: int) -> float:
    """One blackbox's marginal predictive at n points from its state: the
    cross Gram m n entries, w = L^-1 K_zx (m^2 n), the lower-triangular
    W_ls^T w (m^2 n), the mean, the two column sums of squares and the
    variance (8 m n)."""
    return m * n * entry_flops(layer, d) + 2.0 * m * m * n + 8.0 * m * n


def kl_flops(m: int) -> float:
    """One layer's KL from its state: the triangle of W_ls squared, the
    mean's square, two log-determinants."""
    return m * (m + 1) / 2 * 2 + 2 * m + 4 * m


def chol_backward_flops(m: int) -> float:
    """The factor's pullback: L^T L_bar (m^3/3) and two triangular solves
    with m columns (m^3 each)."""
    return m**3 / 3 + 2.0 * m**3


def step_flops(B: int, F: int, m: int, n: int, d: int) -> float:
    """One Adam step of B stacked models on n rows (full batch): every
    layer's state, predictive at the rows and KL, the backward (twice the
    forward, the factor's pullback in place of the factor's twice), the
    expected log-likelihood (10 n per layer) and Adam (10 per parameter)."""
    per = 0.0
    for layer in range(F):
        fwd = layer_state_flops(layer, m, d) + predictive_flops(layer, m, n, d) + kl_flops(m)
        per += 3 * fwd - 2 * m**3 / 3 + chol_backward_flops(m) + 10 * n
        params = m * m + m + (2 * d + 5 if layer else d + 1)
        per += 10 * params
    return B * per


def train_step_flops(s: dict) -> float:
    return step_flops(s["B"], s["F"], s["m"], s["m"], s["d"])


def cond_step_flops(s: dict) -> float:
    """A conditioned step: the forward at [batch; Pareto set; 10 x_tilde]
    rows, plus theta and omega (20 per Pareto row and x_tilde point and
    model)."""
    rows = s["m"] + s["P"] + 10
    return step_flops(s["B"], s["F"], s["m"], rows, s["d"]) + 20.0 * s["B"] * s["P"] * 10


def chol_bound_s(batch: int, n: int, dtype: str) -> float:
    """Least time of one K1 launch on `batch` matrices: n^3/3 flops and
    2 n^2 words each (chip_smoke.py::chol_bound_ms)."""
    return max(batch * n**3 / 3.0 / PEAK_FLOPS[dtype],
               batch * 2.0 * n * n * WORD_BYTES[dtype] / PEAK_BYTES_PER_S)
