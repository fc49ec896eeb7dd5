"""Linear-algebra helpers shared by the GP layers
(counterpart of mobocmf_tpu/linalg/ops.py).

`safe_cholesky` factorizes through K1 (linalg/chol.py). In float32 the
escalating-jitter ladder runs inside the kernel; in float64 it is one plain
factorization at the caller's jitter (the reference's 2e-6). Its backward
is evaluated on the final finite factor only (`chol_pullback`), as a
torch.autograd.Function, so failed attempts never enter autograd.
`cholesky` is the exact-GP models' factor: K1 with no jitter and no
ladder, through the same Function.

Convention: JAX's solve_triangular(l.T, b, lower=False) is
torch.linalg.solve_triangular(l.mT, b, upper=True) here.
"""

from __future__ import annotations

import torch

from mobocmf_tpu_torch.linalg.chol import cholesky as k1_cholesky


def add_jitter(k: torch.Tensor, jitter: float) -> torch.Tensor:
    return k + jitter * torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)


def chol_pullback(l: torch.Tensor, l_bar: torch.Tensor) -> torch.Tensor:
    """VJP of K -> chol(K) evaluated at a FINITE factor L:
    K_bar = 0.5 (C + C^T), C = L^{-T} phi(L^T L_bar) L^{-1},
    phi = tril with halved diagonal."""
    p = l.mT @ l_bar
    phi = torch.tril(p) - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    x1 = torch.linalg.solve_triangular(l.mT, phi, upper=True)
    c = torch.linalg.solve_triangular(l.mT, x1.mT, upper=True).mT
    return 0.5 * (c + c.mT)


class _SafeCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, jitter, ladder):
        # (k + k^T) / 2 first, as jnp.linalg.cholesky symmetrizes its input:
        # a Gram from the expansion trick is symmetric only to rounding, and
        # the factor of an ill-conditioned Kzz amplifies that difference
        l, level = k1_cholesky((k + k.mT) / 2, jitter, ladder=ladder)
        ctx.save_for_backward(l)
        ctx.mark_non_differentiable(level)
        return l, level

    @staticmethod
    def backward(ctx, l_bar, _level_bar):
        (l,) = ctx.saved_tensors
        return chol_pullback(l, l_bar), None, None


def _diag_scale(k: torch.Tensor) -> torch.Tensor:
    """Per-matrix mean |diagonal|, detached (shape k.shape[:-2])."""
    return torch.mean(torch.abs(torch.diagonal(k.detach(), dim1=-2, dim2=-1)), dim=-1)


def safe_cholesky_level(k: torch.Tensor, jitter):
    """Cholesky of k + jitter*I with the escalating-jitter ladder in f32,
    and the ladder rung each matrix ended on (int32, not differentiable).

    f64: one plain factorization at exactly `jitter` (rung 0). f32: the
    jitter is floored at 4*eps*scale and a failed matrix escalates 100x
    twice with 256*eps*scale / sqrt(eps)*scale floors (see linalg/chol.py;
    `ladder_jitter` rebuilds the jitter a rung stands for).
    `jitter` is a float or a per-matrix tensor."""
    return _SafeCholesky.apply(k.contiguous(), jitter, k.dtype != torch.float64)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of k as it is: no jitter, no ladder (the JAX
    package's linalg.ops.cholesky). A matrix that fails to factorize gives
    NaN, and nothing raises. Differentiable through `chol_pullback`."""
    return _SafeCholesky.apply(k.contiguous(), None, False)[0]


def safe_cholesky(k: torch.Tensor, jitter) -> torch.Tensor:
    """The factor of safe_cholesky_level."""
    return safe_cholesky_level(k, jitter)[0]


def ladder_jitter(jitter: float, level: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The jitter safe_cholesky_level factorized with at ladder rung
    `level`, for matrices of mean |diagonal| `scale` (cholesky_plain's
    formula). f64 (no ladder): exactly `jitter`."""
    if scale.dtype == torch.float64:
        return torch.full_like(scale, jitter)
    eps = torch.finfo(scale.dtype).eps
    j = torch.clamp(4.0 * eps * scale, min=jitter)
    j1 = torch.maximum(100.0 * j, 256.0 * eps * scale)
    j2 = torch.maximum(100.0 * j1, eps**0.5 * scale)
    return torch.where(level == 0, j, torch.where(level == 1, j1, j2))


def safe_cholesky_rel(k: torch.Tensor, rel: float) -> torch.Tensor:
    """safe_cholesky with jitter relative to the mean diagonal."""
    return safe_cholesky(k, rel * _diag_scale(k))


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given lower Cholesky L."""
    y = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def tri_solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(l, b, upper=False)


def logdet_from_chol(l: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(l, dim1=-2, dim2=-1))), dim=-1)
