"""Phase accounting, spans and traces of a pipeline
(counterpart of mobocmf_tpu/util/profiling.py).

`phase_timer` wraps a pipeline phase with wall-clock accounting; given the
phase's result it synchronizes the devices its tensors live on before
reading the clock (where the JAX package calls block_until_ready), so
queued device work counts in the phase that queued it. `span` names a
stretch of the program's host work on torch.profiler's clock, the clock of
the device events, while a profiler records; otherwise it costs one flag
read. `trace` records a torch.profiler trace (CPU and, where present, CUDA
activity) and writes it as a Chrome trace under `log_dir`. The kernels'
device-timing helpers are another module: mobocmf_tpu_torch/profiling.py.

The program's spans, all on the host and outside any captured step (a span
inside a step closure would be recorded once, at the capture, and never by
a replay):
- fit/graphs.py::Steps: `graphs.run` around each run(n); inside it on the
  card `graphs.warmup` (the eager steps), `graphs.capture` and
  `graphs.replay` (one span around a run's loop of replays);
- fit/trainer.py: `train.draw` (a chunk's draws), `train.stage` (their
  copies into the phase's buffers), `train.log` (the chunk's log read
  out), `train.check` (the parameters' finiteness read on the host);
- fit/conditioned.py: `cond.draw`, `cond.stage`, `cond.log` likewise;
- acquisition/lbfgs.py: `lbfgs.fresh`, `lbfgs.prologue`, `lbfgs.step`,
  `lbfgs.epilogue` around each piece's run, `lbfgs.read` around the
  host's reads of the lanes' flags.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

from mobocmf_tpu_torch.util.tree import tree_leaves

_PHASE_TIMES: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)


def _synchronize(result) -> None:
    for dev in {t.device for t in tree_leaves(result) if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase_timer(name: str, result=None, verbose: bool = True):
    """result: a tensor or a tree of tensors whose devices are synchronized
    before the clock is read."""
    t0 = time.perf_counter()
    yield
    if result is not None:
        _synchronize(result)
    dt = time.perf_counter() - t0
    _PHASE_TIMES[name] += dt
    _PHASE_COUNTS[name] += 1
    if verbose:
        print(f"[timing] {name}: {dt:.3f}s")


def phase_report() -> Dict[str, Dict]:
    return {
        k: {"total_s": _PHASE_TIMES[k], "count": _PHASE_COUNTS[k]}
        for k in _PHASE_TIMES
    }


def reset_phase_times():
    _PHASE_TIMES.clear()
    _PHASE_COUNTS.clear()


# the one context `span` hands out while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the block `name` in torch.profiler's trace
    (record_function) while a profiler is recording; otherwise a shared
    no-op context: one flag read (torch's own, set while a profile is
    active), nothing allocated."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written to
    <log_dir>/trace.json (open in chrome://tracing or Perfetto). The
    program's spans (`span`, the module docstring) appear in it on the
    host's rows beside the device's kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
