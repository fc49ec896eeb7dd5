"""Linear-algebra helpers shared by the GP layers
(counterpart of mobocmf_tpu/linalg/ops.py).

`safe_cholesky` factorizes through K1 (linalg/chol.py). In float32 the
escalating-jitter ladder runs inside the kernel; in float64 it is one plain
factorization at the caller's jitter (the reference's 2e-6). Its backward
is evaluated on the final finite factor only (`chol_pullback`), as a
torch.autograd.Function, so failed attempts never enter autograd.
`cholesky` is the exact-GP models' factor: K1 with no jitter and no
ladder, through the same Function. `safe_cholesky_inv` adds the explicit
inverse L^{-1} (one triangular solve) and differentiates both outputs with
GEMMs on the saved L and L^{-1}; `tri_solve_lower(l, b, l_inv)` is the
product with L^{-1} in place of the solve, differentiated by GEMMs too,
so such a caller runs one triangular solve a factor, backward included.

Counters (util/counters.py): each `safe_cholesky_inv` call adds to
"inv.states", and "inv.gemm_flops" counts the operations of the GEMMs the
inverse route runs (2 rows inner cols for each matrix of a batched
product, from the operands' shapes at the call): `_SolveByInverse`'s
product, its refinement and its backward, L^{-1}'s own adjoint and
`chol_pullback` given the inverse.

Structured products (`_product`): every product the route counts has a
triangular operand (L, L^{-1}, L_S = tril(chol_raw), phi, and products or
residuals of lower factors, whose zero triangles are exact zeros) or an
output of which the caller keeps the lower triangle. From m = 2 GEMM_LEAF
rows up, such a product splits into 2 x 2 blocks, recursively, skips the
block products with a zero operand block and the output blocks not kept,
and issues each remaining block product as one batched GEMM into a view of
one output; below, it is the one GEMM of before. "inv.gemm_flops" counts
what was issued, block by block; "inv.gemm_skipped" the dense-equivalent
operations left out.

Convention: JAX's solve_triangular(l.T, b, lower=False) is
torch.linalg.solve_triangular(l.mT, b, upper=True) here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mobocmf_tpu_torch.linalg.chol import cholesky as k1_cholesky
from mobocmf_tpu_torch.util import counters

# a structured product splits while its half-block has at least this many
# rows: twice at m = 2048, never at m <= 1023
GEMM_LEAF = 512


def _flops(a: torch.Tensor, b: torch.Tensor) -> int:
    batch = math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    return 2 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, its operations added to the inverse route's GEMM counter."""
    counters.add("inv.gemm_flops", _flops(a, b))
    return a @ b


def splits(l: torch.Tensor) -> bool:
    """Whether the structured products on a factor l's rows split into
    blocks (half of m at least GEMM_LEAF); below, each is one GEMM."""
    return l.shape[-1] // 2 >= GEMM_LEAF


def _split_size(a, b, kind_a: str, kind_b: str, lower_out: bool) -> int:
    """The size of a product's structured dimensions: the rows of a
    triangular a or of a lower-only output, else the columns of a
    triangular b; 0 for a dense product."""
    if kind_a != "dense" or lower_out:
        return a.shape[-2]
    return b.shape[-1] if kind_b != "dense" else 0


def _block_kind(kind: str, i: int, j: int) -> Optional[str]:
    """Block (i, j) of an operand split in two both ways: its own kind on
    the diagonal, dense or None (zero) off it."""
    if kind == "dense" or i == j:
        return kind
    return "dense" if (i > j) == (kind == "lower") else None


def _blocks(out, a, b, kind_a, kind_b, lower_out, leaf, accumulate) -> int:
    """out = a @ b, or out += a @ b with `accumulate`, by blocks on 3-d
    views (`_product`); returns the operations issued."""
    size = _split_size(a, b, kind_a, kind_b, lower_out)
    if size // 2 < leaf:
        if accumulate:
            out.baddbmm_(a, b)
        else:
            torch.bmm(a, b, out=out)
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    halves = [slice(0, size // 2), slice(size // 2, size)]
    rows = halves if kind_a != "dense" or lower_out else [slice(None)]
    inner = halves if kind_a != "dense" or kind_b != "dense" else [slice(None)]
    cols = halves if kind_b != "dense" or lower_out else [slice(None)]
    issued = 0
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            if lower_out and i < j:
                continue
            terms = [(s, _block_kind(kind_a, i, k), _block_kind(kind_b, k, j))
                     for k, s in enumerate(inner)]
            terms = [t for t in terms if t[1] is not None and t[2] is not None]
            if not terms and not accumulate:
                out[:, r, c].zero_()
            for n, (s, ka, kb) in enumerate(terms):
                issued += _blocks(out[:, r, c], a[:, r, s], b[:, s, c], ka, kb,
                                  lower_out and i == j, leaf, accumulate or n > 0)
    return issued


def _product(a: torch.Tensor, b: torch.Tensor, kind_a: str = "dense", kind_b: str = "dense",
             lower_out: bool = False, leaf: Optional[int] = None) -> torch.Tensor:
    """a @ b for operands of a known structure: "lower" or "upper" (square,
    the other triangle exactly zero) or "dense". With `lower_out` only the
    output's lower triangle is computed, and the caller takes its tril.
    While the structured dimensions' half is at least `leaf` rows
    (GEMM_LEAF), a 2 x 2 block split skips the block products with a zero
    operand and the output blocks not kept, recursing on the diagonal
    blocks; below that it is `_gemm(a, b)`."""
    leaf = GEMM_LEAF if leaf is None else leaf
    if _split_size(a, b, kind_a, kind_b, lower_out) // 2 < leaf:
        return _gemm(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.empty(batch + (a.shape[-2], b.shape[-1]), dtype=a.dtype, device=a.device)
    issued = _blocks(out.view((-1,) + out.shape[-2:]),
                     a.expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:]),
                     b.expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:]),
                     kind_a, kind_b, lower_out, leaf, False)
    counters.add("inv.gemm_flops", issued)
    counters.add("inv.gemm_skipped", _flops(a, b) - issued)
    return out


def add_jitter(k: torch.Tensor, jitter: float) -> torch.Tensor:
    return k + jitter * torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)


def chol_pullback(l: torch.Tensor, l_bar: torch.Tensor,
                  l_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VJP of K -> chol(K) evaluated at a FINITE factor L:
    K_bar = 0.5 (C + C^T), C = L^{-T} phi(L^T L_bar) L^{-1},
    phi = tril with halved diagonal. Given l_inv = L^{-1}, C is two GEMMs
    in place of two triangular solves (all three products are the inverse
    route's structured ones: L^T L_bar to its lower triangle, then upper
    times lower, then dense times lower)."""
    if l_inv is None:
        p = l.mT @ l_bar
    else:
        p = _product(l.mT, l_bar, "upper", lower_out=True)
    phi = torch.tril(p) - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    if l_inv is None:
        x1 = torch.linalg.solve_triangular(l.mT, phi, upper=True)
        c = torch.linalg.solve_triangular(l.mT, x1.mT, upper=True).mT
    else:
        c = _product(_product(l_inv.mT, phi, "upper", "lower"), l_inv, kind_b="lower")
    return 0.5 * (c + c.mT)


def _factor(k, jitter, ladder):
    # (k + k^T) / 2 first, as jnp.linalg.cholesky symmetrizes its input:
    # a Gram from the expansion trick is symmetric only to rounding, and
    # the factor of an ill-conditioned Kzz amplifies that difference
    return k1_cholesky((k + k.mT) / 2, jitter, ladder=ladder)


class _SafeCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, jitter, ladder):
        l, level = _factor(k, jitter, ladder)
        ctx.save_for_backward(l)
        ctx.mark_non_differentiable(level)
        return l, level

    @staticmethod
    def backward(ctx, l_bar, _level_bar):
        (l,) = ctx.saved_tensors
        return chol_pullback(l, l_bar), None, None


class _SafeCholeskyInv(torch.autograd.Function):
    """(L, level, L^{-1}): _SafeCholesky's factor and its inverse by one
    triangular solve. Backward, GEMMs only: an adjoint G of L^{-1} itself
    adds -tril(L^{-T} G L^{-T}) to L_bar (torch's solve_triangular backward
    at B = I), then chol_pullback through the saved inverse. Products with
    L^{-1} taken through `tri_solve_lower` send their adjoint to L_bar
    instead, and G stays None."""

    @staticmethod
    def forward(ctx, k, jitter, ladder):
        l, level = _factor(k, jitter, ladder)
        eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
        l_inv = torch.linalg.solve_triangular(l, eye, upper=False)
        ctx.save_for_backward(l, l_inv)
        ctx.mark_non_differentiable(level)
        ctx.set_materialize_grads(False)
        return l, level, l_inv

    @staticmethod
    def backward(ctx, l_bar, _level_bar, l_inv_bar):
        l, l_inv = ctx.saved_tensors
        if l_bar is None:
            l_bar = torch.zeros_like(l)
        if l_inv_bar is not None:
            y = _product(l_inv.mT, l_inv_bar, "upper")
            l_bar = l_bar - torch.tril(_product(y, l_inv.mT, kind_b="upper", lower_out=True))
        return chol_pullback(l, l_bar, l_inv), None, None


class _SolveByInverse(torch.autograd.Function):
    """W = L^{-1} B (L^{-T} B with `trans`) by GEMMs with the inverse,
    differentiated as torch's solve_triangular is, by GEMMs:
    B_bar = L^{-T} W_bar and L_bar = -tril(B_bar W^T) (with `trans`,
    B_bar = L^{-1} W_bar and L_bar = -tril(W B_bar^T)). The inverse gets
    no adjoint: its dependence on L is in L_bar.

    W = X B alone errs by the inverse's own error times B, up to cond(L)
    times the solve's; one refinement step, W + X (B - L W), brings it to
    the solve's. Unrefined, the float64 steps of an ill-conditioned model
    drift 3-4x further apart under a change of summation order (the 'dp'
    mesh against one process, tests/test_torch_sharding.py).

    Every product is a structured one (`_product`): X and L are triangular,
    a lower B (`b_lower`) makes W and the residual lower too (without
    `trans`), and L_bar is a lower-only output."""

    @staticmethod
    def forward(ctx, l, l_inv, b, trans, b_lower):
        x, a = (l_inv.mT, l.mT) if trans else (l_inv, l)
        tri = "upper" if trans else "lower"
        kind_w = "lower" if b_lower and not trans else "dense"
        w = _product(x, b, tri, "lower" if b_lower else "dense")
        w = w + _product(x, b - _product(a, w, tri, kind_w), tri, kind_w)
        ctx.save_for_backward(l_inv, w)
        ctx.trans = trans
        ctx.w_lower = kind_w == "lower"
        return w

    @staticmethod
    def backward(ctx, w_bar):
        l_inv, w = ctx.saved_tensors
        trans = ctx.trans
        b_bar = _product(l_inv if trans else l_inv.mT, w_bar, "lower" if trans else "upper")
        l_bar = None
        if ctx.needs_input_grad[0]:
            kind_wt = "upper" if ctx.w_lower else "dense"
            l_bar = -torch.tril(_product(w, b_bar.mT, lower_out=True) if trans
                                else _product(b_bar, w.mT, kind_b=kind_wt, lower_out=True))
        return l_bar, None, b_bar if ctx.needs_input_grad[2] else None, None, None


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


def safe_cholesky_inv(k: torch.Tensor, jitter):
    """safe_cholesky_level's factor and rung, and the factor's inverse
    L^{-1} (lower): (l, level, l_inv), differentiable through l and l_inv
    by GEMMs alone (`_SafeCholeskyInv`). Multiply by l_inv through
    `tri_solve_lower(l, b, l_inv)`."""
    out = _SafeCholeskyInv.apply(k.contiguous(), jitter, k.dtype != torch.float64)
    counters.add("inv.states")
    return out


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


def tri_solve_lower(l: torch.Tensor, b: torch.Tensor, l_inv: Optional[torch.Tensor] = None,
                    trans: bool = False, b_lower: bool = False) -> torch.Tensor:
    """L^{-1} b, or L^{-T} b with `trans`: a triangular solve, or given
    l_inv = L^{-1} GEMMs: one where nothing differentiates l (the
    acquisition's states, outside "inv.gemm_flops"), else
    `_SolveByInverse`'s refined product and its GEMM backward, whose
    structured products skip the zero triangle of b where `b_lower` says b
    is lower triangular (the two other routes take b as it is)."""
    if l_inv is None:
        return torch.linalg.solve_triangular(l.mT if trans else l, b, upper=trans)
    if torch.is_grad_enabled() and l.requires_grad:
        return _SolveByInverse.apply(l, l_inv, b, trans, b_lower)
    return (l_inv.mT if trans else l_inv) @ b


def logdet_from_chol(l: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(l, dim1=-2, dim2=-1))), dim=-1)
