"""Run a function on W ranks of one torch.distributed group (the port's
counterpart of __graft_entry__.py::dryrun_multichip's self-provisioning:
JAX asks XLA for n virtual devices in one process, PyTorch runs one
process per rank).

`Group(world_size, device)` (device: `cuda` unless named) spawns the ranks (torch.multiprocessing,
spawn), gives them a free local port and initializes the process group on
each, with its backend chosen up front from the device count and printed:
- `gloo` on the CPU;
- `nccl` when each rank has a card of its own (rank r on cuda:r);
- `gloo` with CUDA tensors when the ranks share one card (all on the
  device named), since NCCL refuses two ranks on one GPU.
`Group.run(fn, *args)` runs fn(*args) on every rank and returns each
rank's result in rank order. fn must be importable by name (a module-level
function) and return plain data (numbers, numpy arrays, CPU tensors).

A rank that dies inside a collective hangs the others for ever, so a run
fails as a whole: when a rank raises or exits, or the ranks pass the run's
wall-clock limit, every rank is killed and RuntimeError names the rank,
its exit code and the tail of its output. Each rank's standard output and
error go to a file of its own (`Group.output(rank)`).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device

TAIL_CHARS = 4000


def choose_backend(world_size: int, device) -> str:
    """gloo on the CPU; nccl when every rank has a card of its own; gloo
    with CUDA tensors when the ranks share one card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, backend: str, device) -> torch.device:
    """The device rank `rank` runs on: its own card under nccl, the named
    device otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else (device.index or 0))


def _rank_main(rank, world_size, port, backend, device, threads, timeout_s, log_path,
               tasks, results):
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    results.put((rank, "ready", None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                out = fn(*args)
            except BaseException:  # reported to the parent, which kills the group
                text = traceback.format_exc()
                print(text, flush=True)
                results.put((rank, "error", text))
                continue
            results.put((rank, "ok", out))
    finally:
        dist.destroy_process_group()


class Group:
    """W ranks of one process group, alive until `close()`. `timeout_s`
    bounds every run (and the start); a run that passes it kills the
    group."""

    def __init__(self, world_size: int, device: DeviceLike = None, timeout_s: float = 600.0,
                 threads: Optional[int] = None):
        self.world_size = int(world_size)
        self.device = resolve_device(device)
        self.backend = choose_backend(self.world_size, self.device)
        self.timeout_s = float(timeout_s)
        shared = (self.device.type == "cuda" and self.backend == "gloo"
                  and self.world_size > 1)
        print(f"[launch] {self.world_size} ranks on {self.device.type} over {self.backend}"
              + (" (ranks share one card)" if shared else ""), flush=True)
        self._dir = tempfile.mkdtemp(prefix="mobocmf_ranks_")
        ctx = torch.multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        port = free_port()
        self._procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, self.world_size, port, self.backend, str(self.device), threads,
                      max(self.timeout_s, 60.0), self._log(r), self._tasks[r], self._results),
                daemon=True,
            )
            for r in range(self.world_size)
        ]
        for p in self._procs:
            p.start()
        self._closed = False
        self._collect("ready", self.timeout_s)

    def _log(self, rank: int) -> str:
        return os.path.join(self._dir, f"rank{rank}.log")

    def output(self, rank: int) -> str:
        """Everything rank `rank` has written to its standard output and error."""
        try:
            with open(self._log(rank), errors="replace") as fh:
                return fh.read()
        except OSError:
            return ""

    def _fail(self, what: str, rank: Optional[int]) -> None:
        self.kill()
        ranks = range(self.world_size) if rank is None else [rank]
        tails = "".join(
            f"\n--- rank {r} (exit code {self._procs[r].exitcode}), last output:\n"
            f"{self.output(r)[-TAIL_CHARS:]}" for r in ranks)
        self._cleanup()
        raise RuntimeError(f"[launch] {what}; every rank was killed{tails}")

    def _collect(self, kind: str, timeout_s: float) -> List[Any]:
        got = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < self.world_size:
            try:
                rank, status, value = self._results.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(self._procs):
                    if p.exitcode is not None:
                        self._fail(f"rank {r} exited with code {p.exitcode}", r)
                if time.monotonic() > deadline:
                    missing = sorted(set(range(self.world_size)) - set(got))
                    self._fail(f"ranks {missing} did not finish within {timeout_s:.0f} s", None)
                continue
            if status == "error":
                self._fail(f"rank {rank} raised", rank)
            if status != kind:
                self._fail(f"rank {rank} answered {status!r}, expected {kind!r}", rank)
            got[rank] = value
        return [got[r] for r in range(self.world_size)]

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None) -> List[Any]:
        """fn(*args) on every rank; the results in rank order."""
        if self._closed:
            raise RuntimeError("[launch] the group is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect("ok", self.timeout_s if timeout_s is None else timeout_s)

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)

    def _cleanup(self) -> None:
        self._closed = True
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self) -> None:
        """Stop the ranks (each leaves its process group), killing any that
        does not end within 30 s."""
        if self._closed:
            return
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + 30.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        self.kill()
        self._cleanup()

    def __enter__(self) -> "Group":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run(fn: Callable, world_size: int, *args, device: DeviceLike = None, timeout_s: float = 600.0,
        threads: Optional[int] = None) -> List[Any]:
    """fn(*args) on `world_size` fresh ranks; each rank's result, in rank order."""
    with Group(world_size, device, timeout_s, threads) as group:
        return group.run(fn, *args)
