"""The program's counts of the work it issues, by name: kernel launches,
collectives and the inverse route's work.

`add(name, n)` adds n where the work was issued. Work issued while the
current stream is being captured into a CUDA graph runs only when the
graph is replayed, so it goes to the `recorded` tally instead of `ran`;
the graph's owner (fit/graphs.py::Steps) takes the recorded tally's
difference over its captured step and adds it to `ran` once per replay.
`get(name)` reads `ran`; `reset()` clears both.

The names:
- "k1.launches": K1 launches (linalg/chol.py, the CUDA path only);
- "k2.launches": K2 wrapper calls that launched its kernels
  (linalg/fused_svgp.py, KERNELS_PER_CALL device kernels each);
- "collectives": collectives issued (parallel/sharding.py);
- "inv.states": layer states built through the explicit inverse
  (linalg/ops.py::safe_cholesky_inv);
- "inv.gemm_flops": the operations of the inverse route's GEMMs, and
  "inv.gemm_skipped": the dense-equivalent operations its structured
  products left out (linalg/ops.py).
"""

from __future__ import annotations

from collections import Counter

import torch

ran: Counter = Counter()
recorded: Counter = Counter()


def add(name: str, n: int = 1) -> None:
    capturing = torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()
    (recorded if capturing else ran)[name] += n


def get(name: str) -> int:
    return ran[name]


def reset() -> None:
    ran.clear()
    recorded.clear()
