"""Sparse-variational GP layer: predictive + KL as plain functions
(counterpart of mobocmf_tpu/models/svgp.py).

Unwhitened (reference semantics, q(u) = N(m, S) in function-value space):

    A   = Kzz^{-1} Kzx,  mu = A^T m,  var = diag(Kxx) - diag(Kxz A) + diag(A^T S A)
    KL(q || N(0, Kzz)) = 0.5 [tr(Kzz^{-1} S) + m^T Kzz^{-1} m - M + logdet Kzz - logdet S]

Whitened (u = L_K v, q(v) = N(m_w, S_w)): the KL drops the Kzz terms.
S = L L^T with L = tril(chol_raw). Every function takes a leading blackbox
dim on its tensors (or none).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mobocmf_tpu_torch.core.config import MIN_VARIANCE
from mobocmf_tpu_torch.linalg.ops import logdet_from_chol, safe_cholesky, splits, tri_solve_lower

KernelGram = Callable[[Dict, torch.Tensor, torch.Tensor], torch.Tensor]
KernelDiag = Callable[[Dict, torch.Tensor], torch.Tensor]


class SVGPVariational(NamedTuple):
    """Variational parameters of one layer: mean (..., M), chol_raw (..., M, M)."""

    mean: torch.Tensor
    chol_raw: torch.Tensor


def init_variational(mean: np.ndarray, cov: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """q(u) = N(mean, cov) on the host in float64: returns (mean, chol).

    The init covariances have eigenvalues down to ~1e-13, which a float32
    factorization cannot take, so this always runs in numpy f64. An exactly
    diagonal positive covariance (every non-top layer, 1e-8*I) takes the
    square root of its diagonal; otherwise a tiny RELATIVE jitter escalates
    until the f64 factorization succeeds."""
    cov = np.asarray(cov, dtype=np.float64)
    diag = np.diag(cov)
    if not np.any(cov - np.diag(diag)) and bool(np.all(diag > 0)):
        return mean, np.diag(np.sqrt(diag))
    scale = float(np.mean(diag))
    for rel in (0.0, 1e-12, 1e-9, 1e-6, 1e-3):
        try:
            return mean, np.linalg.cholesky(cov + rel * scale * np.eye(cov.shape[0]))
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError("init covariance not factorizable")


def solve_variational(
    var: SVGPVariational, lk: torch.Tensor, whitened: bool,
    lk_inv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_mean, w_ls): L^{-1} m and L^{-1} L_S unwhitened (one multi-RHS
    solve, or one product given lk_inv = L^{-1}; two products where the
    inverse route's products split, the second told that L_S is lower),
    m_w and L_S whitened."""
    ls = torch.tril(var.chol_raw)
    if whitened:
        return var.mean, ls
    if lk_inv is not None and splits(lk):
        return (tri_solve_lower(lk, var.mean.unsqueeze(-1), lk_inv)[..., 0],
                tri_solve_lower(lk, ls, lk_inv, b_lower=True))
    rhs = torch.cat([var.mean.unsqueeze(-1), ls], dim=-1)
    sol = tri_solve_lower(lk, rhs, lk_inv)
    return sol[..., 0], sol[..., 1:]


def predict_diag_state(
    kernel_gram: KernelGram,
    kernel_diag: KernelDiag,
    kparams: Dict,
    z: torch.Tensor,
    x: torch.Tensor,
    lk: torch.Tensor,
    w_mean: torch.Tensor,
    w_ls: torch.Tensor,
    lk_inv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal predictive q(f(x)) from a precomputed layer state:

        w = L^{-1} Kzx,  mu = w^T w_mean,
        var = diag(Kxx) - colsum(w^2) + colsum((w_ls^T w)^2)

    lk_inv: optional explicit L^{-1}, turning the per-x solve into a matmul."""
    kzx = kernel_gram(kparams, z, x)
    w = tri_solve_lower(lk, kzx, lk_inv)
    mu = (w.mT @ w_mean.unsqueeze(-1))[..., 0]
    kxx = kernel_diag(kparams, x)
    v1 = torch.sum(w * w, dim=-2)
    b = w_ls.mT @ w
    v2 = torch.sum(b * b, dim=-2)
    return mu, torch.clamp(kxx - v1 + v2, min=MIN_VARIANCE)


def predict_mean(
    kernel_gram: KernelGram,
    kparams: Dict,
    var: SVGPVariational,
    z: torch.Tensor,
    x: torch.Tensor,
    jitter: float,
    lk: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean only, unwhitened (the dynamic inducing-point chain's
    quantity), and the factor lk = chol(Kzz + jitter I) it used (K1,
    computed when not given): mu = (L^{-1} Kzx)^T L^{-1} m."""
    if lk is None:
        lk = safe_cholesky(kernel_gram(kparams, z, z), jitter)
    w = tri_solve_lower(lk, kernel_gram(kparams, z, x))
    lm = tri_solve_lower(lk, var.mean.unsqueeze(-1))
    return (w.mT @ lm)[..., 0], lk


def kl_state(
    var: SVGPVariational,
    lk: torch.Tensor,
    w_mean: torch.Tensor,
    w_ls: torch.Tensor,
    whitened: bool,
) -> torch.Tensor:
    """KL(q || prior) from the precomputed state; the unwhitened prior
    N(0, Kzz + jitter I) adds logdet Kzz."""
    trace_term = torch.sum(w_ls * w_ls, dim=(-2, -1))
    maha = torch.sum(w_mean * w_mean, dim=-1)
    logdet_s = logdet_from_chol(torch.tril(var.chol_raw))
    core = trace_term + maha - var.mean.shape[-1] - logdet_s
    if not whitened:
        core = core + logdet_from_chol(lk)
    return 0.5 * core


def predict_diag(
    kernel_gram: KernelGram,
    kernel_diag: KernelDiag,
    kparams: Dict,
    var: SVGPVariational,
    z: torch.Tensor,
    x: torch.Tensor,
    lk: torch.Tensor,
    whitened: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal predictive of one layer given its factor lk = chol(Kzz + jitter I),
    in either parameterization (predict_diag / predict_diag_whitened of the
    JAX package)."""
    w_mean, w_ls = solve_variational(var, lk, whitened)
    return predict_diag_state(kernel_gram, kernel_diag, kparams, z, x, lk, w_mean, w_ls)


def kl_divergence(var: SVGPVariational, lk: torch.Tensor, whitened: bool = False) -> torch.Tensor:
    """KL of one layer given its factor (kl_divergence / kl_divergence_whitened)."""
    w_mean, w_ls = solve_variational(var, lk, whitened)
    return kl_state(var, lk, w_mean, w_ls, whitened)
