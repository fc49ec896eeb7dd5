"""K2: the fused RBF-SVGP predictive for a batch of layer states
(counterpart of mobocmf_tpu/linalg/fused_svgp.py).

For every state s, with z (M, d) and x (N, d) shared:

    K   = os_s * exp(-0.5 ||(z_i - z_j) / ls_s||^2) + jitter_s * I
    L   = chol(K)                     (one attempt, no jitter ladder)
    W   = L^{-1} [K_zx | L_S | m]
    mu  = W_kzx^T W_m
    var = max(os_s - colsum(W_kzx^2) + colsum((W_ls^T W_kzx)^2), 1e-12)

Unwhitened and forward only. The inputs are divided by the lengthscale and
differenced directly (no expansion trick), as in the TPU kernel.

`fused_rbf_svgp_forward` launches the hand-written kernels of
csrc/fused_svgp.cu on a CUDA tensor and runs `fused_rbf_svgp_forward_plain`,
the same contract in PyTorch ops, on a CPU tensor. There is no fallback from
one to the other. A state whose Gram does not factorize gives NaN.

`plan(m, n, batch, dtype)` is the launch plan of the kernel's two solves
(the [L_S | m] solve and the predictive): each block keeps a stripe of W
columns, all M rows, in shared memory, so W is the widest of 32, 16, 8, 4
whose stripe and one diagonal block of L fit a block, narrowed while a
wider one leaves SMs without a predictive block. Both solves take that
width. It mirrors csrc/fused_svgp.cu::solve_smem_bytes, which the launch
checks.

Counters: each wrapper call that launches the kernels adds to
util/counters.py's "k2.launches" (KERNELS_PER_CALL device kernels a call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from mobocmf_tpu_torch.core.config import MIN_VARIANCE
from mobocmf_tpu_torch.linalg import chol
from mobocmf_tpu_torch.linalg.chol import cholesky_plain, launch_error
from mobocmf_tpu_torch.util import counters

# device kernels per call: Gram + factor, the [L_S | m] solve, the predictive
KERNELS_PER_CALL = 3

_C_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# csrc/fused_svgp.cu: stripe widths; the H100's SM count
WIDTHS = (32, 16, 8, 4)
SMS = 132


class Plan(NamedTuple):
    """Launch plan of both solves: the stripe width and the dynamic shared
    memory per block. The grids are (ceil((M + 1) / width), B) for the
    [L_S | m] solve and (ceil(N / width), B) for the predictive."""

    width: int
    smem_bytes: int


def solve_smem_bytes(m: int, width: int, itemsize: int) -> int:
    """The stripe (m x width) and one 32 x 33 diagonal block."""
    return itemsize * (m * width + chol.NB * (chol.NB + 1))


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, batch: int, dtype: torch.dtype) -> Plan:
    """The plan of the two solve launches for B = batch states of M = m
    inducing points at N = n inputs (plain Python). Both take one stripe
    width: the predictive runs beside the [L_S | m] solve (a programmatic
    dependent launch) and the two share the SMs, so W is the widest of 32,
    16, 8, 4 that fits a block and still gives the predictive one block
    per SM (B * ceil(N / W) >= SMS); the narrowest that fits where none
    does."""
    itemsize = torch.finfo(dtype).bits // 8
    fits = [w for w in WIDTHS
            if solve_smem_bytes(m, w, itemsize) + chol.STATIC_SMEM_BYTES <= chol.MAX_SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(f"fused_rbf_svgp_forward: no stripe of M = {m} rows fits a block")
    w = next((w for w in fits if -(-n // w) * batch >= SMS), fits[-1])
    return Plan(w, solve_smem_bytes(m, w, itemsize))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||^2 by direct differences: (B, M, d), (B, N, d) -> (B, M, N)."""
    diff = a.unsqueeze(-2) - b.unsqueeze(-3)
    return torch.sum(diff * diff, dim=-1)


def fused_rbf_svgp_forward_plain(
    z: torch.Tensor,
    x: torch.Tensor,
    mean: torch.Tensor,
    ls_chol: torch.Tensor,
    lengthscale: torch.Tensor,
    outputscale: torch.Tensor,
    jitter: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on a batch of B states: z (M, d),
    x (N, d), mean (B, M), ls_chol (B, M, M) lower, lengthscale (B, d),
    outputscale (B,), jitter (B,). Returns (mu, var), each (B, N)."""
    ls = lengthscale.unsqueeze(-2)
    a = z / ls
    b = x / ls
    os_ = outputscale[:, None, None]
    kzz = os_ * torch.exp(-0.5 * _sq_dist(a, a))
    kzx = os_ * torch.exp(-0.5 * _sq_dist(a, b))
    lk, _ = cholesky_plain(kzz, jitter, False)
    n, m = x.shape[0], z.shape[0]
    rhs = torch.cat([kzx, torch.tril(ls_chol), mean.unsqueeze(-1)], dim=-1)
    w_all = torch.linalg.solve_triangular(lk, rhs, upper=False)
    w, w_ls, w_m = w_all[..., :n], w_all[..., n : n + m], w_all[..., -1]
    mu = torch.sum(w * w_m.unsqueeze(-1), dim=-2)
    v1 = torch.sum(w * w, dim=-2)
    bmat = w_ls.mT @ w
    v2 = torch.sum(bmat * bmat, dim=-2)
    return mu, torch.clamp(outputscale[:, None] - v1 + v2, min=MIN_VARIANCE)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C launch function of the kernels for `dtype`, typed."""
    from mobocmf_tpu_torch import _build

    lib = _build.load("fused_svgp")
    fn = lib.mobocmf_fused_svgp_f32 if dtype == torch.float32 else lib.mobocmf_fused_svgp_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(z, x, mean, ls_chol, lengthscale, outputscale, jitter, sp: Plan = None):
    batch, m = mean.shape
    n, d = x.shape
    sp = plan(m, n, batch, z.dtype) if sp is None else sp
    fn = _entry(z.dtype)
    new = functools.partial(torch.empty, dtype=z.dtype, device=z.device)
    fac, wls = new((batch, m, m)), new((batch, m, m + 1))
    mu, var = new((batch, n)), new((batch, n))
    pl = chol.plan(m, z.dtype)  # the Gram's factor runs under K1's plan
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(
            z.data_ptr(), x.data_ptr(), mean.data_ptr(), ls_chol.data_ptr(),
            lengthscale.data_ptr(), outputscale.data_ptr(), jitter.data_ptr(),
            fac.data_ptr(), wls.data_ptr(), mu.data_ptr(), var.data_ptr(),
            batch, m, n, d, pl.cluster, int(pl.resident), pl.smem_bytes,
            sp.width, sp.smem_bytes, stream,
        )
    if err != 0:
        raise launch_error("fused_rbf_svgp_forward", err)
    counters.add("k2.launches")
    return mu, var


def fused_rbf_svgp_forward(
    z: torch.Tensor,
    x: torch.Tensor,
    mean: torch.Tensor,
    ls_chol: torch.Tensor,
    lengthscale: torch.Tensor,
    outputscale: torch.Tensor,
    jitter,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive (mu, var) of unwhitened RBF SVGP layer states at x.

    Batched: z (M, d), x (N, d), mean (B, M), ls_chol (B, M, M) lower,
    lengthscale (B, d), outputscale (B,), jitter a float or (B,); returns
    (B, N) each. Single state, as the JAX function takes it: mean (M,),
    ls_chol (M, M), lengthscale (d,), outputscale (), jitter (); returns
    (N,) each. float32 or float64. Forward only: inputs must not require
    grad."""
    single = mean.ndim == 1
    if single:
        mean, ls_chol = mean.unsqueeze(0), ls_chol.unsqueeze(0)
        lengthscale, outputscale = lengthscale.reshape(1, -1), outputscale.reshape(1)
    batch, m = mean.shape
    n, d = x.shape
    if z.shape != (m, d) or ls_chol.shape != (batch, m, m) or lengthscale.shape != (batch, d) \
            or outputscale.shape != (batch,):
        raise ValueError(
            "fused_rbf_svgp_forward: shapes z (M, d), x (N, d), mean (B, M), ls_chol (B, M, M), "
            f"lengthscale (B, d), outputscale (B,); got z {tuple(z.shape)}, x {tuple(x.shape)}, "
            f"mean {tuple(mean.shape)}, ls_chol {tuple(ls_chol.shape)}, "
            f"lengthscale {tuple(lengthscale.shape)}, outputscale {tuple(outputscale.shape)}"
        )
    if z.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_rbf_svgp_forward: float32 or float64 only, got {z.dtype}")
    args = [z, x, mean, ls_chol, lengthscale, outputscale]
    if any(t.dtype != z.dtype or t.device != z.device for t in args):
        raise ValueError("fused_rbf_svgp_forward: inputs must share one dtype and device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise ValueError("fused_rbf_svgp_forward: forward only (call it under torch.no_grad())")
    if isinstance(jitter, torch.Tensor):
        jit = jitter.to(dtype=z.dtype, device=z.device).reshape(-1).expand(batch)
    else:
        jit = torch.full((batch,), float(jitter), dtype=z.dtype, device=z.device)
    args = [t.contiguous() for t in args] + [jit.contiguous()]
    if z.device.type == "cuda":
        mu, var = _launch(*args)
    elif z.device.type == "cpu":
        mu, var = fused_rbf_svgp_forward_plain(*args)
    else:
        raise ValueError(f"fused_rbf_svgp_forward: unsupported device {z.device}")
    return (mu[0], var[0]) if single else (mu, var)
