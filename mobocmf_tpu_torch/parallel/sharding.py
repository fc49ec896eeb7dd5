"""Multi-device sharding on torch.distributed (counterpart of
mobocmf_tpu/parallel/sharding.py).

The JAX package is single-controller GSPMD: a `Mesh` and `NamedSharding`s
place the arrays and XLA inserts the collectives. PyTorch runs one process
per rank (parallel/launch.py), so the port is explicit SPMD: the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the JAX package's axis
names and order,
- 'bb' — blackboxes: stacked objective and constraint models, each rank
         holding a contiguous slice of the stack;
- 'dp' — data / grid points: ELBO rows, the MOOP grid, the inducing rows
         (`shard_inducing`) and the RFF features (`shard_features`);
work is split by hand and the collectives are written out on
`mesh.get_group(axis)`. DTensor is not used: it has no sharding rule for
the Cholesky, the triangular solves or the kernels' ctypes launches, which
take plain local tensors. Functions that GSPMD shards through their
arrays take `mesh=None` in the port; with None nothing here runs.

Autograd through collectives (the rules every sharded path follows): a
sharded path's loss is either a LOCAL part whose sum over the ranks is the
objective, followed by an explicit all-reduce of the gradients
(fit/trainer.py, fit/conditioned.py), or a value that every rank holds
WHOLE after a collective. For the second kind three functions mark the
boundaries of a region of sharded work inside replicated work (the
identity / all-reduce pair of tensor parallelism):
- `enter(t)`: a replicated value entering the region; identity forward,
  its gradient all-reduced backward (each rank's region saw only its part);
- `gather(t)`: a sharded value leaving the region whole; all-gather
  forward, backward this rank's block of the (whole, replicated) gradient;
- `reduce(t)`: a region's partial sum leaving it whole; all-reduce
  forward, identity backward.
torch.distributed.nn.functional's all_gather sums the gradient over the
ranks instead (its loss convention is the first kind), which would count a
replicated loss once per rank.

Transport: every collective goes through `_collective`, which adds its
host seconds to `seconds` and counts it as util/counters.py's
"collectives" (a collective captured into a CUDA graph counts at each
replay, which adds no host seconds). Gloo takes CUDA tensors for the collectives used
here (all_reduce, all_gather_into_tensor, broadcast): it stages them
through host memory itself, so ranks sharing one card over gloo exchange
through the host and NCCL ranks card to card (`transport`).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device
from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.util.tree import tree_map

AXES = ("bb", "dp")

# seconds spent in collective calls in this process (host clock: a gloo
# call returns when it is done, an NCCL call when it is queued on the
# stream)
seconds = 0.0


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, bb: int = 1, axis_names=AXES,
              device: DeviceLike = None):
    """Mesh over (bb, dp) with dp = n_devices / bb, over every rank of the
    initialized process group (parallel/launch.py): each rank runs the
    program, so a mesh spans the group. device: `cuda` unless named."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(mobocmf_tpu_torch/parallel/launch.py)")
    world = dist.get_world_size()
    n = n_devices or world
    if n % bb != 0:
        raise ValueError(f"{n} devices not divisible by bb={bb}")
    if n != world:
        raise ValueError(f"a mesh spans every rank of the group: {n} devices, "
                         f"world size {world}")
    return DeviceMesh(device.type, torch.arange(n).reshape(bb, n // bb),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_root(mesh) -> bool:
    """The mesh's first rank (always, without a mesh)."""
    return mesh is None or dist.get_rank() == 0


def transport(mesh) -> str:
    """How the mesh's collectives move data: 'nccl' card to card, 'host'
    for gloo (CUDA tensors staged through host memory by gloo), 'none'
    without a mesh."""
    if mesh is None:
        return "none"
    return "nccl" if dist.get_backend() == "nccl" else "host"


def capture_rule(mesh) -> Tuple[bool, str]:
    """Whether a phase whose step runs collectives on `mesh` (a mesh or
    one of its groups; None: no collectives) is replayed from a CUDA graph,
    and why. Chosen from the backend up front, never a retry: NCCL
    collectives can be captured, gloo's cannot (they synchronize with the
    host)."""
    if mesh is None:
        return True, "no mesh"
    backend = dist.get_backend()
    if backend == "nccl":
        return True, "nccl collectives are captured"
    return False, f"{backend} collectives synchronize with the host and cannot be captured"


def block(n: int, parts: int, index: int) -> slice:
    """The `index`-th of `parts` contiguous near-equal blocks of range(n)
    (torch.tensor_split's)."""
    q, r = divmod(n, parts)
    start = index * q + min(index, r)
    return slice(start, start + q + (index < r))


# ---------------------------------------------------------------------------
# Collectives (plain: no autograd)
# ---------------------------------------------------------------------------


def _collective(fn: Callable[[], None]) -> None:
    global seconds
    t0 = time.perf_counter()
    fn()
    seconds += time.perf_counter() - t0
    counters.add("collectives")


def all_reduce(t: torch.Tensor, grp) -> torch.Tensor:
    """Sum of t over the group, in place (t must be contiguous)."""
    _collective(lambda: dist.all_reduce(t, group=grp))
    return t


def all_gather(t: torch.Tensor, grp, dim: int = 0) -> torch.Tensor:
    """Every rank's t (all of one shape) concatenated along `dim` in rank order."""
    size = dist.get_world_size(grp)
    dim = dim % t.ndim
    t0 = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((size * t0.shape[0],) + t0.shape[1:], dtype=t.dtype, device=t.device)
    _collective(lambda: dist.all_gather_into_tensor(out, t0, group=grp))
    return torch.cat([p.movedim(0, dim) for p in out.chunk(size, dim=0)], dim=dim)


def broadcast(t: torch.Tensor, src: int = 0, grp=None) -> torch.Tensor:
    """Rank `src`'s t on every rank, in place."""
    _collective(lambda: dist.broadcast(t, src=src, group=grp))
    return t


def broadcast_object(mesh, obj):
    """The mesh's first rank's `obj` (picklable) on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    _collective(lambda: dist.broadcast_object_list(box, src=0))
    return box[0]


def local_rows(t: torch.Tensor, grp, dim: int = 0) -> torch.Tensor:
    """This rank's block of t along `dim` (the length divisible by the group)."""
    size, rank = dist.get_world_size(grp), dist.get_rank(grp)
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


# ---------------------------------------------------------------------------
# Collectives with autograd (the boundaries of a sharded region)
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.grp), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, dim):
        ctx.dim, ctx.n, ctx.rank = dim, t.shape[dim], dist.get_rank(grp)
        return all_gather(t, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        return all_reduce(t.detach().contiguous().clone(), grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(t: torch.Tensor, grp) -> torch.Tensor:
    """A replicated value entering a sharded region: identity; backward,
    the gradient summed over the group."""
    return _Enter.apply(t, grp)


def gather(t: torch.Tensor, grp, dim: int = 0) -> torch.Tensor:
    """A sharded value leaving its region whole (equal blocks, rank order);
    backward, this rank's block of the replicated gradient."""
    return _Gather.apply(t, grp, dim % t.ndim)


def reduce(t: torch.Tensor, grp) -> torch.Tensor:
    """A region's partial sum leaving it whole: summed over the group;
    backward, the identity."""
    return _Reduce.apply(t, grp)


# ---------------------------------------------------------------------------
# Placement helpers (the JAX module's functions)
# ---------------------------------------------------------------------------


def shard_rows(mesh, x: torch.Tensor, axis: str = "dp") -> Tuple[torch.Tensor, int]:
    """This rank's contiguous block of the rows of x (N, ...) over `axis`,
    N padded up to a multiple of the axis by repeating the last row (the
    JAX package's padding: the blocks in rank order are its padded
    array), and the padded length."""
    k = axis_size(mesh, axis)
    pad = (-x.shape[0]) % k
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])], dim=0)
    n = x.shape[0] // k
    r = axis_rank(mesh, axis)
    return x[r * n:(r + 1) * n], x.shape[0]


def replicate(mesh, tree):
    """Every tensor of `tree` as the mesh's first rank holds it, on every
    rank (new tensors; other leaves are kept)."""
    if mesh is None:
        return tree
    return tree_map(lambda t: broadcast(t.detach().clone().contiguous())
                    if isinstance(t, torch.Tensor) else t, tree)


def sharded_grid_eval(fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                      grid: torch.Tensor, mesh) -> np.ndarray:
    """Evaluate callables over a large grid, rows sharded over 'dp': each
    'dp' rank evaluates its row block without gradients, and an all-gather
    over 'dp' assembles the result (ranks on other 'bb' coordinates repeat
    the work, as in JAX). The hot MOOP path: a grid of 1000 * d^2 points
    times the objective and constraint samples. Returns the same
    (len(fns), N) float64 array on every rank."""
    with torch.no_grad():
        if mesh is None:
            return torch.stack([f(grid) for f in fns]).cpu().numpy().astype(np.float64)
        local, _ = shard_rows(mesh, grid)
        vals = torch.stack([f(local) for f in fns])
        full = all_gather(vals, mesh.get_group("dp"), dim=1)[:, :grid.shape[0]]
    return full.cpu().numpy().astype(np.float64)


class InducingShardedConsts(NamedTuple):
    """MFDGPConsts whose z_x hold this rank's rows of each layer's inducing
    inputs; `inducing` is the group they are split over
    (models/mfdgp.py::compute_layer_states reads it)."""

    z_x: Tuple[torch.Tensor, ...]
    acq_eps: torch.Tensor
    noise_lower: torch.Tensor
    noise_upper: torch.Tensor
    inducing: object


def shard_inducing(mesh, params, consts, axis: str = "dp"):
    """Inducing-dimension tensor parallelism: each rank keeps its row block
    of every per-layer quantity that carries the inducing axis m (z_x rows,
    variational means, variational Cholesky rows); kernel parameters and
    noises stay whole. A model so split computes its Gram row blocks
    Kzz[rows, :] and Kzx[rows, :] locally and gathers them, and factors
    the gathered m x m Kzz whole with K1 (the JAX docstring's split: the
    Gram and Knm work sharded, the Cholesky and the solves gathered). Pays
    off at m >= 2048. m must divide by the axis. The port's params always
    carry the leading blackbox dim (B = 1 for one model). Returns
    (params, consts); `unshard_inducing` undoes it."""
    grp = mesh.get_group(axis)
    k = axis_size(mesh, axis)
    for z in consts.z_x:
        if z.shape[0] % k:
            raise ValueError(f"{z.shape[0]} inducing rows do not divide over {axis}={k}")
    layers = tuple(
        lp._replace(variational=lp.variational._replace(
            mean=local_rows(lp.variational.mean, grp, -1).clone(),
            chol_raw=local_rows(lp.variational.chol_raw, grp, -2).clone()))
        for lp in params.layers
    )
    sharded = InducingShardedConsts(
        z_x=tuple(local_rows(z, grp, 0).clone() for z in consts.z_x),
        acq_eps=consts.acq_eps, noise_lower=consts.noise_lower,
        noise_upper=consts.noise_upper, inducing=grp,
    )
    return params._replace(layers=layers), sharded


def unshard_inducing(params, consts):
    """The whole params of an inducing-sharded model (no autograd)."""
    grp = consts.inducing
    layers = tuple(
        lp._replace(variational=lp.variational._replace(
            mean=all_gather(lp.variational.mean, grp, -1),
            chol_raw=all_gather(lp.variational.chol_raw, grp, -2)))
        for lp in params.layers
    )
    return params._replace(layers=layers)


def rows_gram(gram: Callable, kparams, z: torch.Tensor, x: torch.Tensor, grp) -> torch.Tensor:
    """gram(kparams, z, x) of an inducing-sharded layer: this rank computes
    the rows of its block of z (z and x whole and replicated) and the
    blocks are gathered, so every rank holds the whole Gram."""
    kp = tree_map(lambda t: enter(t, grp), kparams)
    z_in = enter(z, grp)
    x_in = z_in if x is z else enter(x, grp)
    return gather(gram(kp, local_rows(z_in, grp, -2), x_in), grp, -2)


def gather_variational(var, grp):
    """A sharded layer's variational mean and Cholesky rows, whole."""
    return var._replace(mean=gather(var.mean, grp, -1), chol_raw=gather(var.chol_raw, grp, -2))


# ---------------------------------------------------------------------------
# The RFF feature dimension over 'dp'
# ---------------------------------------------------------------------------


def shard_features(mesh, sample, axis: str = "dp"):
    """An RFF function sample (sampling/rff.py) whose layer 0 keeps this
    rank's block of the F feature rows of w, b and theta; the deep layers'
    theta is a concat of three F-blocks and stays whole, as in JAX. Its
    evaluation (`rff.eval_sample(..., mesh=mesh)`) sums theta @ phi over
    the ranks. F must divide by the axis."""
    lay0 = sample.layers[0]
    k = axis_size(mesh, axis)
    if lay0.w.shape[0] % k:
        raise ValueError(f"{lay0.w.shape[0]} features do not divide over {axis}={k}")
    grp = mesh.get_group(axis)
    lay0 = lay0._replace(w=local_rows(lay0.w, grp, 0), b=local_rows(lay0.b, grp, 0),
                         theta=local_rows(lay0.theta, grp, 0))
    return sample._replace(layers=(lay0,) + tuple(sample.layers[1:]))
