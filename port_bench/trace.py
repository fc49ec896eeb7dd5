"""The traced window: torch.profiler over a slice of the cell's own work,
with the dropped-event guard of mobocmf_tpu_torch/profiling.py (copied:
a sentinel kernel opens every round, the profiler's first round is thrown
away, and a session is run again when its events are not whole), and the
reduction of the trace to busy time, idle gaps and the breakdown.

The guard here: the slice is run in two sessions of identical work (the
same shapes and steps), and the
kernel counts by name must agree between them; else both are run again,
up to TRIES times, after which the trace is refused (RuntimeError).

The work's device events are those between a sentinel launched before it
and one launched after it, not those inside its host span: in a trace the
device's clock can stand apart from the host's by milliseconds to a few
hundred of them (m = 2048, a 2.8 s slice), which moved the previous
round's last kernels into the span, or this round's first ones out of it.
They are moved onto the host's clock by setting the first sentinel's end
at the span's start. Each round waits GAP seconds before its sentinel, so
the profiler has begun to record when the work starts.
"""

from __future__ import annotations

import sys
import time
from collections import Counter
from typing import Callable, List, Tuple

import torch

TRIES = 5
GAP = 0.3  # seconds before each round's first sentinel
SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel, never counted
WINDOW = "bench.window"  # the host span of the traced work, ending in a synchronize

Event = Tuple[str, float, float]  # name, start s, end s


def _session(fn: Callable[[], None], device) -> Tuple[List[Event], List[Event], float]:
    """One session: a thrown-away round, then the kept round. Returns the
    kept round's work (`work`), the harness's host spans ("bench.*") and
    the window's length: the host span from the work's start to the
    synchronize after it, on the trace's own clock."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        for _ in range(2):
            time.sleep(GAP)
            torch.cuda._sleep(10000)
            torch.cuda.synchronize(device)
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize(device)
            torch.cuda._sleep(10000)
            torch.cuda.synchronize(device)
            time.sleep(1e-3)
            prof.step()
    dev, host = [], []
    for evt in prof.events():
        r = evt.time_range
        item = (evt.name, r.start * 1e-6, r.end * 1e-6)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sentinels; not the device-side copies of
            # the host's annotations (record_function spans, profiler steps)
            if not (evt.name.startswith(("bench.", "ProfilerStep"))
                    or getattr(evt, "is_user_annotation", False)):
                dev.append(item)
        elif evt.name.startswith("bench."):
            host.append(item)
    _, ws, we = next(h for h in host if h[0] == WINDOW)
    return work(dev, ws), host, we - ws


def work(dev: List[Event], start: float) -> List[Event]:
    """The device events between the last two sentinels, the round's, moved
    by the first one's end onto `start` (the host span's); none where a
    sentinel is missing."""
    spins = sorted((s, e) for n, s, e in dev if SENTINEL in n)
    if len(spins) < 2:
        return []
    (_, opened), (closed, _) = spins[-2:]
    shift = start - opened
    return [(n, s + shift, e + shift) for n, s, e in dev
            if SENTINEL not in n and s >= opened and e <= closed]


def traced(fn: Callable[[], None], device) -> Tuple[List[Event], List[Event], float]:
    last = None
    for _ in range(TRIES):
        a = _session(fn, device)
        b = _session(fn, device)
        ca, cb = Counter(n for n, _, _ in a[0]), Counter(n for n, _, _ in b[0])
        if ca == cb and ca:
            return b
        last = "; ".join(f"{n[:60]} {ca[n]}/{cb[n]}" for n in set(ca) | set(cb) if ca[n] != cb[n])
        print(f"[trace] sessions disagree, run again: {last or 'no device events'}",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"torch.profiler lost events in {TRIES} pairs of sessions: {last}")


def union(events: List[Event]) -> List[Tuple[float, float]]:
    spans = sorted((s, e) for _, s, e in events)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def breakdown(events: List[Event], host: List[Event], busy: List[Tuple[float, float]]) -> dict:
    """The 10 device operations that took most time (summed by name) and
    the 10 longest idle gaps between device work, each named by the
    innermost harness span running on the host at the gap's middle."""
    by_name: Counter = Counter()
    for n, s, e in events:
        by_name[n] += e - s
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inside = [(he - hs, n) for n, hs, he in host if hs <= mid <= he]
        gaps.append([min(inside)[1] if inside else "outside the harness's spans", s1 - e0])
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, t] for n, t in by_name.most_common(10)], "idle_gaps": gaps[:10]}
