"""Global numerical configuration (counterpart of mobocmf_tpu/core/config.py).

The reference runs float64 with a 2e-6 jitter on kernel matrices; the card
runs float32 with a widened jitter, the CPU parity tests float64.
"""

from __future__ import annotations

import dataclasses

import torch

# Jitter added to K(Z,Z) before Cholesky: the reference's 2e-6 in f64,
# widened for f32 where 2e-6 is only ~17x machine eps.
JITTER_F64 = 2e-6
JITTER_F32 = 1e-5

# Acquisition: eval-mode samples per test point (reference mfdgp.py:23).
NUM_SAMPLES_FOR_ACQUISITION = 25

# Variance floor for predictive variances (numerical safety only).
MIN_VARIANCE = 1e-12

# RFF pathwise sampling: features per block and the weight-posterior
# regularizer (reference mfdgp_hidden_layer.py:288-307).
RFF_NUM_FEATURES = 500
RFF_SIGMA2 = 1e-6


def default_jitter(dtype: torch.dtype) -> float:
    if dtype == torch.float64:
        return JITTER_F64
    return JITTER_F32


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Hyperparameters of the two-phase and conditioned trainers; the
    defaults are BlackBoxMFDGPFitter's (fit/fitter.py)."""

    lr_1: float = 0.003
    lr_2: float = 0.001
    num_epochs_1: int = 5000
    num_epochs_2: int = 15000
    pareto_set_size: int = 50
    opt_grid_size: int = 1000
    eps: float = 1e-8
