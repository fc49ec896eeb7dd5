"""Timing helpers shared by chip_smoke.py and the profiling scripts
(profile_chol.py, profile_k2.py, profile_pareto.py), K2's test problem, and
`patched`, which swaps a module attribute for the length of a with block.
Need a CUDA device to time; `missing_events` and `patched` are plain
Python. A pipeline's phase accounting and traces are another module:
mobocmf_tpu_torch/util/profiling.py.

Device times come from torch.profiler, which can drop events (on an H100
it dropped the first kernel of a cycle, in some sessions after another
session). Each round of calls therefore starts with a short sentinel
kernel that is not counted, and a session whose kernel counts do not add
up to whole calls is run again; after `TRIES` such sessions the time is
refused (RuntimeError), never summed from what arrived.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import Counter
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

TRIES = 5
# torch.cuda._sleep's kernel, launched first in every round, never counted
SENTINEL = "spin_kernel"


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def k2_problem(batch, m, n, d, seed, dtype, dev):
    """The JAX kernel test's well-posed problem (tests/test_fused_svgp_kernel.py:
    19-35: lengthscale 0.15, outputscale 1.3, jitter 1e-2), batched."""
    rng = np.random.default_rng(seed)
    vals = (
        rng.uniform(size=(m, d)), rng.uniform(size=(n, d)), rng.normal(size=(batch, m)),
        np.tril(rng.normal(size=(batch, m, m)) * 0.05) + 0.3 * np.eye(m),
        np.full((batch, d), 0.15), np.full((batch,), 1.3), np.full((batch,), 1e-2),
    )
    return [torch.as_tensor(v, dtype=dtype, device=dev) for v in vals]


def loop_ms(fn: Callable, reps: int) -> float:
    """Time per call of a loop of `reps` calls (CUDA events, host time
    included), after two untimed calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def missing_events(counts: Mapping[str, int], calls: int,
                   expect: Optional[Mapping[str, int]] = None) -> str:
    """What a profiler session of `calls` calls lacks, or "" when it is
    whole: counts maps each kernel or copy name to the events recorded.
    Every name must come a whole number of times per call, and the names
    that contain each key of `expect` exactly expect[key] times per call."""
    if not counts:
        return "no device events"
    short = [f"{name[:60]} x{c}" for name, c in counts.items() if c % calls]
    for key, per_call in (expect or {}).items():
        got = sum(c for name, c in counts.items() if key in name)
        if got != per_call * calls:
            short.append(f"{key} x{got}, want {per_call * calls}")
    return "; ".join(short)


def _session(fn: Callable, calls: int) -> List[Tuple[str, int, int]]:
    """(name, start, end) of each device event of `calls` calls of fn under
    torch.profiler. A first round of `calls` calls runs traced and is
    thrown away (the profiler's warm-up): the first kernels of a session
    can go unrecorded. Each round starts with the sentinel kernel, and the
    host waits a millisecond on either side of each cycle's boundary."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        for _ in range(2):
            time.sleep(1e-3)
            torch.cuda._sleep(10000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(1e-3)
            prof.step()
    return [(evt.name, evt.time_range.start, evt.time_range.end) for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA and SENTINEL not in evt.name]


def per_kernel_us(fn: Callable, calls: int,
                  expect: Optional[Mapping[str, int]] = None) -> Dict[str, float]:
    """Device time per call, in us, of each kernel or copy `fn` launches,
    summed over `calls` calls under torch.profiler; under "span" the time
    from a call's first kernel to the end of its last (launches may
    overlap), averaged over the calls. `expect` maps a substring of kernel
    names to the launches per call that carry it. A session with events
    missing (`missing_events`) is run again, up to TRIES sessions; then
    RuntimeError."""
    for _ in range(TRIES):
        events = _session(fn, calls)
        lack = missing_events(Counter(name for name, _, _ in events), calls, expect)
        if not lack:
            break
        print(f"[profiling] session run again, events missing: {lack}", file=sys.stderr,
              flush=True)
    else:
        raise RuntimeError(f"torch.profiler lost events in {TRIES} sessions: {lack}")
    out: Dict[str, float] = {}
    for name, start, end in events:
        out[name] = out.get(name, 0.0) + (end - start) / calls
    per_call = len(events) // calls
    spans = sorted((start, end) for _, start, end in events)
    out["span"] = sum(max(e for _, e in spans[i:i + per_call]) - spans[i][0]
                      for i in range(0, len(spans), per_call)) / calls
    return out


def device_ms(fn: Callable, reps: int, name: str = "", launches: Optional[int] = None) -> float:
    """Device time per call of `fn` in ms: the time of the card's kernels
    and copies whose name contains `name` (all of them by default), under
    torch.profiler (per_kernel_us; `launches`: the kernels per call whose
    name contains `name`, checked). Unlike a CUDA-event time over a loop of
    calls, it does not count the host's time between launches."""
    us = per_kernel_us(fn, reps, None if launches is None else {name: launches})
    return sum(t for k, t in us.items() if k != "span" and name in k) / 1e3
