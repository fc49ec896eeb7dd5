"""Readings that the limits of port_bench/limits/ are set from, on the card
at a cell's own size (not run by the benchmark's own runs):

    python3 -m port_bench.calibrate --workload <name> --seeds 1,2,... \
        [--control 1,2,3] [--faults frozen,late_frozen,half_batch,altered \
        --fault-seeds 1,2,3] [--out readings.jsonl]

For each seed: the program's numbers (the harness's set-up and a short
window, then the comparison with the float64 reference). With --control:
the control's numbers: the program's own float32 path (the precision
below the configurations' float64; the reference itself computed in
float32 cannot factor these kernel matrices and gives no number), run on
the same seed and held against the float64 reference alike. With
--faults: the program's numbers with each fault of faults.py planted.
--seconds: the window before the tail. One JSON line per reading; all in
one process, the cell's set-up paid per run.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from port_bench import cells, compare, faults
from port_bench.run import ROOT, inputs, load_json


# the program's own path at the precision below a float64 configuration's:
# float32, at the jitter the program takes for float32 (core/config.py)
LOWER = {"float64": {"dtype": "float32", "jitter": 1e-05}}


def _numbers(config, traffic, seed, device, seconds):
    cell = cells.build(config, traffic, seed, device)
    cell.window(seconds)
    prog = cell.program()
    cell.close()
    nums = compare.numbers(prog, cell.reference(torch.float64, device))
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return nums


def reading(workload, seed, device, control=False, fault=None, seconds=0.5, overrides=None):
    """The program's numbers at `seed` (with `fault` planted), and with
    `control` the control's: the program's own float32 path (LOWER) run on
    the same seed and judged alike against the float64 reference."""
    config, traffic = inputs(load_json(ROOT / "BENCHMARK.json"), workload, overrides)[:2]
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = {"workload": workload, "seed": seed, "fault": fault,
               "program": _numbers(config, traffic, seed, device, seconds)}
    if control:
        low = dict(config, **LOWER[config["dtype"]])
        try:
            out["control"] = _numbers(low, traffic, seed, device, seconds)
        except (RuntimeError, torch.linalg.LinAlgError) as e:  # a control that crashes has failed
            out["control"] = {"error": str(e)[:200]}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seconds", type=float, default=0.5)
    a = p.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    device = torch.device(a.device)
    if device.type == "cuda":
        from mobocmf_tpu_torch import _build
        _build.build()
    out = open(a.out, "a") if a.out else None
    jobs = [(s, s in ints(a.control), None) for s in ints(a.seeds)]
    jobs += [(s, False, f) for f in a.faults.split(",") if f for s in ints(a.fault_seeds)]
    for seed, control, fault in jobs:
        try:
            line = reading(a.workload, seed, device, control, fault, a.seconds)
        except Exception as e:  # a fault may crash the program: that is a reading too
            line = {"workload": a.workload, "seed": seed, "fault": fault,
                    "error": f"{type(e).__name__}: {str(e)[:300]}"}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
