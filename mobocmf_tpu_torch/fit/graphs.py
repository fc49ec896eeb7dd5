"""Optimizer steps replayed from one CUDA graph: the port's counterpart of
the JAX package's `jax.jit` + `lax.scan` over a phase
(mobocmf_tpu/fit/trainer.py::train_phase_carry, fit/conditioned.py::
train_conditioned_carry, models/exact_gp.py::_fit_exact_gp_run).

A phase's step is a closure with no arguments. What changes from one step
to the next (the random draws) it reads from buffers allocated once for
the phase, at the position of a one-element device tensor (`StepIndex`);
it writes its loss into the phase's log buffers at that position and then
advances the position. Nothing random is drawn inside a step: the caller
fills the buffers for a chunk of steps before the chunk runs.

`Steps.run(n)` runs n steps. On a CUDA device its first call runs WARMUP
steps eagerly on a side stream (the first one builds and loads K1 and
allocates the optimizer's state), then captures one step with
torch.cuda.graph, and replays the graph for the rest; later calls only
replay. On the CPU the same steps run eagerly. Either way the chunking,
the draws and the logs are the caller's one code path; only how a step is
issued differs. A capture or a replay that fails raises: there is no
eager path on the card to fall back to.

A step that runs collectives over gloo (a mesh of ranks that share one
card) cannot be captured: gloo synchronizes with the host. Such a phase
is made uncaptured up front (`capture=False`, from
parallel/sharding.py::capture_rule, with the reason kept in
`capture_reason`), and every step then runs eagerly on the card.

`Trainable` holds a phase's parameters, gradient masks and Adam, per leaf
or, under MOBOCMF_FLAT_ADAM=1 (the JAX package's optax.flatten(optax.adam)
switch, read when a phase builds its optimizer), as one flat tensor.

Counters (util/counters.py): what a step issues while it is being
captured goes to the recorded tally; `Steps` keeps the recorded tally's
difference over its captured step and adds it to the ran tally once per
replay, and each capture sets `inv_gemm_flops_per_step` to the inverse
route's GEMM operations per replay. (K2 runs only without gradients,
never inside a captured step.) `close()` frees the graph and its memory
pool at the end of the phase.

The candidate searches and the MOOP's device polish run their L-BFGS
(acquisition/lbfgs.py) as four pieces, each a `Steps` of its own with
`run(1)` per piece run: the value recomputed where not finite, an
iteration's prologue, one line-search step, the epilogue. Their K1
launches (the layer states) and K2 launches (the raw-sample screening)
come before the lanes start, outside the graphs: a search still launches
K1 / K2 2 / 2. `prod` is torch.prod for a captured step.
"""

from __future__ import annotations

import copy
import os
import time
from collections import Counter
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.util.profiling import span
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map, tree_unflatten

# eager steps before the capture: the first builds and loads K1, allocates
# the Adam state and the cuBLAS workspace; the second runs on warm caches
WARMUP = 2

# seconds of every Steps' warm-up and capture in this process: a reader
# that holds no Steps (the benchmark's capture_s.* over a cell's one
# phase) reads it here
setup_seconds = 0.0
# the inverse route's GEMM operations ("inv.gemm_flops") per replay of the
# last graph captured in this process, set at each capture:
# the benchmark's inv_gemm_roofline.* reads it here, as capture_s.* reads
# setup_seconds (Python arithmetic on shapes at capture; a replay adds none)
inv_gemm_flops_per_step = 0


def adam(leaves: Iterable[torch.Tensor], lr: float,
         state: Optional[dict] = None) -> torch.optim.Adam:
    """torch.optim.Adam set as optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8),
    continuing from `state` (a state_dict) when given. On the card it is
    capturable: the step count and the bias corrections stay on the device,
    so a graph can replay the update. torch keeps a capturable step count in
    float32, which puts the bias corrections ~1e-8 off at f64; here it has
    the parameters' dtype, as the eager path's host arithmetic."""
    leaves = list(leaves)
    cuda = leaves[0].is_cuda
    opt = torch.optim.Adam(leaves, lr=lr, eps=1e-8, capturable=cuda)
    if state is not None:
        _check_state(state, leaves)
        opt.load_state_dict(copy.deepcopy(state))
    if cuda:
        for p in leaves:
            st = opt.state[p]
            if st:
                st["step"] = st["step"].to(p.dtype)
            else:
                st.update(step=torch.zeros((), dtype=p.dtype, device=p.device),
                          exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
    return opt


def _check_state(state: dict, leaves: List[torch.Tensor]) -> None:
    """A carried Adam state must be one for these tensors: a per-leaf state
    handed to a flat phase, or the reverse, raises rather than restarting."""
    count = sum(len(g["params"]) for g in state["param_groups"])
    fits = count == len(leaves) and all(
        tuple(st["exp_avg"].shape) == tuple(leaves[i].shape)
        for i, st in state["state"].items() if "exp_avg" in st)
    if not fits:
        raise ValueError(
            f"an Adam state of {count} tensor(s) handed to a phase of {len(leaves)} "
            f"(MOBOCMF_FLAT_ADAM={os.environ.get('MOBOCMF_FLAT_ADAM', '0')}): a carried state "
            "is accepted only under the setting that made it")


def flat_adam() -> bool:
    """The JAX package's MOBOCMF_FLAT_ADAM switch (fit/trainer.py::
    make_adam), read when a phase builds its optimizer: "1" hands Adam one
    flat tensor."""
    return os.environ.get("MOBOCMF_FLAT_ADAM", "0") == "1"


class Trainable:
    """A training or conditioned phase's parameter tree, its 0/1 gradient
    masks (one factor per leaf) and the Adam that updates it. (The exact-GP
    fits stay per leaf, as the JAX package's never flatten.)

    Per leaf (the default): each leaf is a tensor of its own, one of Adam's
    parameters, masked by its own factor. Flat (`flat_adam()`): the leaves
    are one flat tensor, Adam's only parameter, masked by one flat mask;
    `tree()` gives them as views of it, made anew for every forward so that
    the backward reaches the flat tensor's `.grad`. `tensors` are what Adam
    updates; their gradients (`grads()`) are what a mesh all-reduces."""

    def __init__(self, params, masks: Sequence[float], lr: float, state: Optional[dict] = None):
        leaves = [t.detach() for t in tree_leaves(params)]
        self.like = params
        self.flat = flat_adam()
        if self.flat:
            self.shapes = [t.shape for t in leaves]
            self.sizes = [t.numel() for t in leaves]
            flat = torch.cat([t.reshape(-1) for t in leaves])
            self.tensors = [flat.requires_grad_(True)]
            mask = None
            if any(m != 1.0 for m in masks):
                mask = torch.cat([torch.full((n,), float(m), dtype=flat.dtype, device=flat.device)
                                  for n, m in zip(self.sizes, masks)])
            self.masks = [mask]
        else:
            self.tensors = [t.clone().requires_grad_(True) for t in leaves]
            self.masks = [None if m == 1.0 else m for m in masks]
            self._tree = tree_unflatten(params, self.tensors)
        self.opt = adam(self.tensors, lr, state)

    def _views(self, flat: torch.Tensor):
        return tree_unflatten(self.like, [v.view(s) for v, s in
                                          zip(flat.split(self.sizes), self.shapes)])

    def tree(self):
        """The parameter tree the loss differentiates."""
        return self._views(self.tensors[0]) if self.flat else self._tree

    def values(self):
        """The parameters now, detached (each leaf its own tensor)."""
        if self.flat:
            return tree_map(lambda t: t.clone(), self._views(self.tensors[0].detach()))
        return tree_map(lambda t: t.detach(), self._tree)

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.tensors]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Mask the gradients, then one Adam update."""
        for p, m in zip(self.tensors, self.masks):
            if p.grad is not None and m is not None:
                p.grad.mul_(m)
        self.opt.step()


class StepIndex:
    """The position of the current step in a chunk's buffers: a one-element
    int64 tensor on the device, read and advanced inside the step."""

    def __init__(self, device: torch.device):
        self.t = torch.zeros((1,), dtype=torch.int64, device=device)

    def take(self, buf: torch.Tensor) -> torch.Tensor:
        """buf[position] (a copy, indexed on the device)."""
        return buf.index_select(0, self.t)[0]

    def put(self, buf: torch.Tensor, dim: int, value: torch.Tensor) -> None:
        """buf[..., position, ...] = value along `dim`, in place."""
        buf.index_copy_(dim, self.t, value.detach().unsqueeze(dim))

    def advance(self) -> None:
        self.t.add_(1)

    def reset(self) -> None:
        self.t.zero_()


def prod(t: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.prod over `dim` as a chain of products: prod's backward counts
    the zeros on the host, which a step captured into a CUDA graph cannot."""
    shape = t.shape[:dim] + t.shape[dim + 1:]
    out = torch.ones(shape, dtype=t.dtype, device=t.device)
    for part in t.unbind(dim):
        out = out * part
    return out


class Steps:
    """Runs a step closure n times per `run(n)`: eagerly on the CPU, from
    one captured CUDA graph on the card (eagerly there too when `capture`
    is False; `capture_reason` says why either way). `warmup_seconds` is
    the time the eager steps before the capture took and `capture_seconds`
    the capture's (each with its synchronizations: set-up only, never a
    replayed chunk's), `pool_bytes` the device memory the capture left
    allocated to the graph's pool, `replays` the graph's replays, `steps`
    every step run and `counts` what its runs added to util/counters.py's
    ran tally, by name. Each run is a `graphs.run` span
    (util/profiling.py)."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 leaves: Optional[Iterable[torch.Tensor]] = None, capture: bool = True,
                 capture_reason: str = "no mesh"):
        self.step = step
        self.device = torch.device(device)
        self.leaves = list(leaves or ())
        self.capture = capture
        self.capture_reason = capture_reason
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.warmup_seconds = 0.0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.steps = 0
        self.counts: Counter = Counter()
        self._warm = 0
        self._per_replay: Counter = Counter()

    def run(self, n: int) -> None:
        if n <= 0:
            return
        self.steps += n
        before = counters.ran.copy()
        with span("graphs.run"):
            self._dispatch(n)
        self.counts.update(counters.ran - before)

    def _dispatch(self, n: int) -> None:
        if self.device.type != "cuda" or not self.capture:
            for _ in range(n):
                self.step()
            return
        done = 0
        if self.graph is None:
            done = min(WARMUP - self._warm, n)
            if done:
                with span("graphs.warmup"):
                    self._warm_up(done)
            if done == n:
                return
            with span("graphs.capture"):
                self._capture()
        with span("graphs.replay"):
            for _ in range(n - done):
                self.graph.replay()
        self.replays += n - done
        for name, count in self._per_replay.items():
            counters.add(name, count * (n - done))

    def _warm_up(self, n: int) -> None:
        global setup_seconds
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self._warm += n
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(n):
                self.step()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.warmup_seconds += seconds
        setup_seconds += seconds

    def _capture(self) -> None:
        global setup_seconds, inv_gemm_flops_per_step
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        before = counters.recorded.copy()
        graph = torch.cuda.CUDAGraph()
        # the step's first backward allocates its gradients from the graph's
        # pool (PyTorch's whole-network capture)
        for p in self.leaves:
            p.grad = None
        allocated = torch.cuda.memory_allocated(self.device)
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            self.step()
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        setup_seconds += self.capture_seconds
        self.pool_bytes = torch.cuda.memory_allocated(self.device) - allocated
        self._per_replay = counters.recorded - before
        inv_gemm_flops_per_step = self._per_replay["inv.gemm_flops"]
        self.graph = graph

    def close(self) -> None:
        """Free the graph and its memory pool (the gradients it allocated)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        for p in self.leaves:
            p.grad = None
