"""mobocmf_tpu_torch: the PyTorch / CUDA port of mobocmf_tpu.

The JAX package `mobocmf_tpu` is the reference; this package mirrors its
module layout (core/, kernels/, linalg/, models/, mlls/, fit/,
test_functions/, sampling/, moop/, acquisition/, bo/, parallel/) so each module's
counterpart is found by name. It imports torch, numpy and scipy only —
never jax, and nothing of `mobocmf_tpu`.

Ported so far: the MFDGP model and its ELBO, two-phase stacked training
through `BlackBoxMFDGPFitter`, RFF Pareto sampling (MOOP, SLSQP or device
polish), conditioned training, the JESMOC all-fidelity candidate search
(`JESMOC_MFDGP`) with q > 1 batches, the random baseline, and the BO loop
(`bo/loop.py::run_bo_loop`: log files and resume, recommendation scoring,
checkpoints, warm start), the exact-GP models and MESMOC
(`models/mfgp.py`, `models/mfgp_lin.py`, `models/exact_gp.py`,
`acquisition/mesmoc.py`), with two hand-written CUDA kernels: the blocked
Cholesky (K1, `linalg/chol.py`, `csrc/chol.cu`) and the fused RBF-SVGP
predictive (K2, `linalg/fused_svgp.py`, `csrc/fused_svgp.cu`), and the
device mesh (`parallel/`: the JAX package's sharding on torch.distributed,
one process per rank, and its multi-device dry run). Entry scripts: `python -m mobocmf_tpu_torch.examples.toy_synthetic_2D_JESMOCMF`
and the other `examples/` modules, and `python -m mobocmf_tpu_torch.bench`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no device named they raise (core/device.py).
"""

import torch

# TF32 is the Hopper analogue of the TPU's bf16 matmul passes: it makes the
# expansion-trick Grams indefinite (mobocmf_tpu/linalg/fused_svgp.py:13-15).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter  # noqa: E402
from mobocmf_tpu_torch.models.mfdgp import (  # noqa: E402
    MFDGPConfig,
    MFDGPConsts,
    MFDGPModel,
    MFDGPParams,
    TL,
    init_mfdgp,
)

MFDGP = MFDGPModel

__all__ = [
    "BlackBoxMFDGPFitter",
    "MFDGP",
    "MFDGPConfig",
    "MFDGPConsts",
    "MFDGPModel",
    "MFDGPParams",
    "TL",
    "init_mfdgp",
]
