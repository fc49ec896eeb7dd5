"""Synthetic multi-fidelity test functions (numpy copy of
mobocmf_tpu/test_functions/synthetic.py).

Forrester, non-linear sin, Branin, step, and the scale-config problems
(Branin-Currin with the disk constraint, Hartmann-6, DTLZ2). All are numpy
functions of (n, d) or (n,) inputs: they model external blackboxes,
evaluated on the host.
"""

from __future__ import annotations

import numpy as np


# -- reference fixtures (forrester.py:3-29) -----------------------------------


def forrester_mf1(x, sd=0):
    x = np.asarray(x, dtype=float).reshape(-1, 1)
    n = x.shape[0]
    fval = ((6 * x - 2) ** 2) * np.sin(12 * x - 4)
    noise = np.zeros((n, 1)) if sd == 0 else np.random.normal(0, sd, n).reshape(n, 1)
    return fval.reshape(n, 1) + noise


def forrester_mf0(x, sd=0):
    x = np.asarray(x, dtype=float).reshape(-1, 1)
    high = forrester_mf1(x, 0)
    return 0.5 * high + 10 * (x[:, [0]] - 0.5) + 5 + np.random.randn(x.shape[0], 1) * sd


# -- non_linear_sin.py:3-15 -----------------------------------------------------


def non_linear_sin_mf0(x, sd=0):
    x = np.asarray(x, dtype=float)
    return np.sin(8 * np.pi * x) + np.random.randn(*x.shape) * sd


def non_linear_sin_mf1(x, sd=0):
    x = np.asarray(x, dtype=float)
    return (x - np.sqrt(2)) * non_linear_sin_mf0(x, 0) ** 2 + np.random.randn(*x.shape) * sd


# -- toy_functions.py:3-23 -------------------------------------------------------


def step_function(x):
    return np.sign(np.asarray(x, dtype=float))


def branin(x):
    x = np.asarray(x, dtype=float)
    if x.ndim != 2:
        raise ValueError("branin takes a 2-D array")
    if x.shape[0] != 2:
        x = x.T
    if x.shape[0] != 2:
        raise ValueError("The shape of x is not 2D.")
    x1, x2 = x[0], x[1]
    b = 5.1 / (4 * np.pi**2)
    c = 5 / np.pi
    t = 1 / (8 * np.pi)
    return (x2 - b * x1**2 + c * x1 - 6) ** 2 + 10 * (1 - t) * np.cos(x1) + 10


# -- scale-config problems (BASELINE.json configs #3-#5) --------------------------


def branin_scaled(x):
    """Branin on [0,1]^2 (standard rescaling)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    x1 = 15.0 * x[:, 0] - 5.0
    x2 = 15.0 * x[:, 1]
    return branin(np.stack([x1, x2]))


def branin_scaled_low(x):
    """Low-fidelity Branin (Perdikaris et al. 2017 pairing): a warped,
    shifted version of the high-fidelity surface on [0,1]^2."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    hf = branin_scaled(x)
    return (
        10.0 * np.sqrt(np.maximum(hf, 0.0))
        + 2.0 * (x[:, 0] - 0.5)
        - 3.0 * (3.0 * x[:, 1] - 1.0)
        - 1.0
    )


def disk_constraint(x, radius: float = 0.5):
    """c(x) = r^2 - ||x - 0.5||^2 (feasible where >= 0): the standard disk
    constraint used with constrained Branin-Currin benchmarks."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return radius**2 - np.sum((x - 0.5) ** 2, axis=1)


def currin(x):
    """Currin exponential on [0,1]^2 (Branin-Currin pairing)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    x1, x2 = x[:, 0], np.maximum(x[:, 1], 1e-12)
    a = 1 - np.exp(-1.0 / (2 * x2))
    b = (2300 * x1**3 + 1900 * x1**2 + 2092 * x1 + 60) / (
        100 * x1**3 + 500 * x1**2 + 4 * x1 + 20
    )
    return a * b


def currin_low(x):
    """Low-fidelity Currin (Xiong et al. smoothing)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    d = 0.05
    xs = [
        x + np.array([d, d]), np.clip(x + np.array([d, -d]), 0, 1),
        x + np.array([-d, d]), np.clip(x + np.array([-d, -d]), 0, 1),
    ]
    return 0.25 * sum(currin(np.clip(xx, 0.0, 1.0)) for xx in xs)


def hartmann6(x):
    """Hartmann-6 on [0,1]^6 (minimization)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    alpha = np.array([1.0, 1.2, 3.0, 3.2])
    a = np.array(
        [
            [10, 3, 17, 3.5, 1.7, 8],
            [0.05, 10, 17, 0.1, 8, 14],
            [3, 3.5, 1.7, 10, 17, 8],
            [17, 8, 0.05, 10, 0.1, 14],
        ]
    )
    p = 1e-4 * np.array(
        [
            [1312, 1696, 5569, 124, 8283, 5886],
            [2329, 4135, 8307, 3736, 1004, 9991],
            [2348, 1451, 3522, 2883, 3047, 6650],
            [4047, 8828, 8732, 5743, 1091, 381],
        ]
    )
    inner = np.einsum("ij,nij->ni", a, (x[:, None, :] - p[None, :, :]) ** 2)
    return -np.einsum("i,ni->n", alpha, np.exp(-inner))


def hartmann6_low(x, bias: float = 0.5):
    """Degraded Hartmann-6 as the low fidelity (perturbed alpha)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return hartmann6(x) + bias * np.sin(4.0 * np.pi * x[:, 0])


def dtlz2(x, num_objectives: int = 4):
    """DTLZ2 objectives on [0,1]^d, d >= num_objectives - 1."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    m = num_objectives
    k = x.shape[1] - m + 1
    g = np.sum((x[:, m - 1 :] - 0.5) ** 2, axis=1)
    out = np.empty((x.shape[0], m))
    for i in range(m):
        f = 1.0 + g
        for j in range(m - 1 - i):
            f = f * np.cos(0.5 * np.pi * x[:, j])
        if i > 0:
            f = f * np.sin(0.5 * np.pi * x[:, m - 1 - i])
        out[:, i] = f
    return out
