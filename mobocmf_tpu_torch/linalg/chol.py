"""K1: batched Cholesky with the escalating-jitter ladder
(counterpart of mobocmf_tpu/linalg/chol.py and of the ladder in
mobocmf_tpu/linalg/ops.py::_chol_escalate / _rescue).

`cholesky(a, jitter, ladder)` factorizes every matrix of a (B, n, n) batch
(or one (n, n) matrix) after adding its jitter to the diagonal. On a CUDA
tensor it launches the hand-written kernel of csrc/chol.cu, which runs the
whole ladder on the card (no host read per factorization); on a CPU tensor
it runs `cholesky_plain`, the same contract in plain PyTorch. There is no
fallback from one to the other.

Contract of both: the lower factor with a zeroed strict upper triangle; a
matrix that fails to factorize (after the ladder, if asked) has a NaN
diagonal from the failed pivot on — the plain version NaN-fills it whole —
and neither raises. With `ladder`, the starting jitter is floored at
4*eps*scale and a failed matrix restarts at
j1 = max(100*j0, 256*eps*scale), then j2 = max(100*j1, sqrt(eps)*scale),
scale = mean |diag(a)|, exactly _rescue's per-element semantics.

`plan(n, dtype)` is the launch plan of the kernel for one n x n matrix:
the cluster size (8 thread blocks up to n = 256, 16 above), the storage of
the working factor (the cluster's shared memory where the lower triangle
in 32x32 tiles fits, else the output buffer in L2) and the dynamic shared
memory per block. It mirrors csrc/chol_factor.cuh::smem_bytes, which the
launch checks; K2 (linalg/fused_svgp.py) factorizes under the same plan.

Counters: each launch adds to util/counters.py's "k1.launches" (CUDA path
only). `escalations()` counts factorizations that climbed the ladder,
summed on the device without a host read until asked, into one
persistent tensor per device that a captured step adds into in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from mobocmf_tpu_torch.util import counters

# per device: factorizations that climbed the ladder (int64, one element;
# never replaced: graphs add into it)
_escalated: Dict[torch.device, torch.Tensor] = {}

_C_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# csrc/chol_factor.cuh: tile edge, tiles per outer panel, update unit rows,
# and the staging workspace in words (two slices of UNIT x (NB + 1), the
# diagonal tile, its reciprocal pivots)
NB, OUTER, UNIT = 32, 4, 64
WORK_WORDS = 2 * UNIT * (NB + 1) + NB * (NB + 1) + NB
# shared memory a block may use on an H100 (opt-in limit), and a bound on
# the kernels' static shared memory (the reduction slots)
MAX_SMEM_PER_BLOCK = 232_448
STATIC_SMEM_BYTES = 128
# returned by the C launch when the card cannot hold one cluster of the plan
NOT_SCHEDULABLE = -2


class Plan(NamedTuple):
    """Launch plan of K1 (and K2's factor) for one n x n matrix."""

    cluster: int  # thread blocks per matrix
    resident: bool  # the factor in the cluster's shared memory (else in L2)
    smem_bytes: int  # dynamic shared memory per block
    outer: int = OUTER  # 32-wide tiles per outer panel


def smem_bytes(n: int, itemsize: int, cluster: int, resident: bool) -> int:
    """Dynamic shared memory per block: the staging workspace, and with the
    resident storage the block's share of the lower triangle's tiles."""
    nt = -(-n // NB)
    slots = -(-(nt * (nt + 1) // 2) // cluster)
    return itemsize * (WORK_WORDS + (slots * NB * NB if resident else 0))


@functools.lru_cache(maxsize=None)
def plan(n: int, dtype: torch.dtype) -> Plan:
    """The kernel's plan for an n x n matrix of `dtype` (plain Python)."""
    itemsize = torch.finfo(dtype).bits // 8
    cluster = 8 if n <= 256 else 16
    resident = smem_bytes(n, itemsize, cluster, True) + STATIC_SMEM_BYTES <= MAX_SMEM_PER_BLOCK
    return Plan(cluster, resident, smem_bytes(n, itemsize, cluster, resident))


def launch_error(what: str, err: int) -> RuntimeError:
    if err == NOT_SCHEDULABLE:
        return RuntimeError(f"{what}: the card cannot hold one thread-block cluster of the plan")
    return RuntimeError(f"{what}: the CUDA kernel failed to launch (CUDA error {err})")


def max_active_clusters(pl: Plan, dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters of the kernel under `pl` (CUDA only)."""
    from mobocmf_tpu_torch import _build

    fn = _build.load("chol").mobocmf_chol_max_clusters
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(int(dtype == torch.float64), pl.cluster, int(pl.resident), pl.smem_bytes)


def escalations() -> int:
    """Factorizations that needed a ladder step in this process."""
    return int(sum(int(t.item()) for t in _escalated.values()))


def _jitter_vector(jitter, batch: int, like: torch.Tensor) -> torch.Tensor:
    if jitter is None:
        return torch.zeros((batch,), dtype=like.dtype, device=like.device)
    if isinstance(jitter, torch.Tensor):
        return jitter.to(dtype=like.dtype, device=like.device).expand(batch).contiguous()
    return torch.full((batch,), float(jitter), dtype=like.dtype, device=like.device)


def _attempt(a: torch.Tensor, j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    l, info = torch.linalg.cholesky_ex(a + j[:, None, None] * eye)
    ok = (info == 0) & torch.isfinite(torch.diagonal(l, dim1=-2, dim2=-1)).all(-1)
    l = torch.where(ok[:, None, None], l, torch.full_like(l, float("nan")))
    return l, ok


def cholesky_plain(
    a: torch.Tensor, jitter: torch.Tensor, ladder: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on a (B, n, n) batch with a (B,)
    jitter: returns (l, level), level = ladder rung used per matrix."""
    level = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    if not ladder:
        return _attempt(a, jitter)[0], level
    eps = torch.finfo(a.dtype).eps
    scale = torch.mean(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)
    j = torch.maximum(jitter, 4.0 * eps * scale)
    l, ok = _attempt(a, j)
    for rung, floor in ((1, 256.0 * eps), (2, eps**0.5)):
        if bool(ok.all()):
            break
        j = torch.where(ok, j, torch.maximum(100.0 * j, floor * scale))
        level = torch.where(ok, level, torch.full_like(level, rung))
        l, ok = _attempt(a, j)
    return l, level


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The C launch function of the kernel for `dtype`, typed."""
    from mobocmf_tpu_torch import _build

    lib = _build.load("chol")
    fn = lib.mobocmf_chol_f32 if dtype == torch.float32 else lib.mobocmf_chol_f64
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(a: torch.Tensor, jitter: torch.Tensor, ladder: bool, pl: Plan = None):
    if not a.is_contiguous():
        raise ValueError("cholesky: the CUDA kernel takes a contiguous (B, n, n) tensor")
    pl = plan(a.shape[-1], a.dtype) if pl is None else pl
    fn = _entry(a.dtype)
    out = torch.empty_like(a)
    level = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), out.data_ptr(), jitter.data_ptr(), level.data_ptr(),
            a.shape[0], a.shape[-1], int(ladder), pl.cluster, int(pl.resident), pl.smem_bytes,
            pl.outer, stream,
        )
    if err != 0:
        raise launch_error("cholesky", err)
    counters.add("k1.launches")
    return out, level


def cholesky(
    a: torch.Tensor, jitter=None, ladder: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor of a + jitter*I for each matrix of a.

    a: (B, n, n) or (n, n), float32 or float64, on the CPU or a CUDA device.
    jitter: None (no jitter), a float, or a (B,) tensor of per-matrix
    jitters. ladder: climb the escalating-jitter ladder on failure.
    Returns (l, level) with level the (B,) or () int32 ladder rung used.
    """
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2] or a.shape[-1] == 0:
        raise ValueError(f"cholesky: expected (B, n, n) or (n, n), got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cholesky: float32 or float64 only, got {a.dtype}")
    single = a.ndim == 2
    a3 = a.unsqueeze(0) if single else a
    jit = _jitter_vector(jitter, a3.shape[0], a3)
    if a.device.type == "cuda":
        l, level = _launch(a3, jit, ladder)
    elif a.device.type == "cpu":
        l, level = cholesky_plain(a3, jit, ladder)
    else:
        raise ValueError(f"cholesky: unsupported device {a.device}")
    if ladder:
        count = _escalated.get(a.device)
        if count is None:
            count = _escalated[a.device] = torch.zeros((), dtype=torch.int64, device=a.device)
        count.add_(torch.sum(level > 0))
    return (l[0], level[0]) if single else (l, level)

