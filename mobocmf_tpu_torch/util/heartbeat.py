"""In-process stall watchdog for long campaigns
(counterpart of mobocmf_tpu/util/heartbeat.py, a copy: the port imports
nothing of the JAX package).

Host-side loops call `beat(tag)` at natural boundaries (training phases,
acquisition picks, BO phase transitions). A gap of `timeout_s` with no beat
means the process is stuck (a device call that never returns, a hung
collective): the watchdog prints the last beat's tag, which names the
phase that hung, and `os._exit`s with code 86. Campaign log dirs are
appended once per iteration, so the exit is resume-safe: a runner retries
and the loop replays the evaluated points.

Opt-in: nothing starts unless `start(timeout_s)` is called (run_bo_loop
starts it when `BOConfig.stall_timeout_s` or `MOBOCMF_STALL_TIMEOUT_S` is
set). `beat()` is a plain assignment when inactive.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

EXIT_CODE = 86

_lock = threading.Lock()
_last_beat: float = 0.0
_last_tag: str = "start"
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def beat(tag: str = "") -> None:
    """Record liveness. GIL-atomic assignments; cheap enough for host loops."""
    global _last_beat, _last_tag
    _last_beat = time.monotonic()
    if tag:
        _last_tag = tag


def stop() -> None:
    """Disarm the watchdog (mainly for tests)."""
    global _thread
    _stop.set()
    t = _thread
    if t is not None:
        t.join(timeout=5.0)
    _thread = None


def start(timeout_s: float, poll_s: Optional[float] = None) -> None:
    """Arm the watchdog: no beat for `timeout_s` seconds => os._exit(86).

    Idempotent per process (restarting replaces the timeout). The monitor is
    a daemon thread, so a normally-exiting process never waits on it.
    """
    global _thread
    with _lock:
        stop()
        _stop.clear()
        beat("armed")
        poll = poll_s if poll_s is not None else max(timeout_s / 4.0, 0.05)

        def _monitor() -> None:
            while not _stop.wait(poll):
                gap = time.monotonic() - _last_beat
                if gap > timeout_s:
                    print(
                        f"[watchdog] no progress for {gap:.0f}s "
                        f"(timeout {timeout_s:.0f}s); last beat: '{_last_tag}'. "
                        f"Presumed hung — exiting {EXIT_CODE} (campaign log "
                        "dirs are resume-safe).",
                        file=sys.stderr,
                        flush=True,
                    )
                    os._exit(EXIT_CODE)

        _thread = threading.Thread(
            target=_monitor, name="mobocmf-stall-watchdog", daemon=True
        )
        _thread.start()
