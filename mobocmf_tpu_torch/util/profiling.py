"""Phase accounting and traces of a pipeline
(counterpart of mobocmf_tpu/util/profiling.py).

`phase_timer` wraps a pipeline phase with wall-clock accounting; given the
phase's result it synchronizes the devices its tensors live on before
reading the clock (where the JAX package calls block_until_ready), so
queued device work counts in the phase that queued it. `trace` records a
torch.profiler trace (CPU and, where present, CUDA activity) and writes it
as a Chrome trace under `log_dir`. The kernels' device-timing helpers are
another module: mobocmf_tpu_torch/profiling.py.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

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


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written to
    <log_dir>/trace.json (open in chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
