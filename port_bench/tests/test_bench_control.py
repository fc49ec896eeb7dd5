"""The control on the card, at each cell's own size: the program's own
float32 path (the precision below the configurations' float64; the
reference itself computed in float32 cannot factor these kernel matrices
and gives no number) must come out not correct, where the float64 program
comes out correct.

    python -m pytest port_bench/tests/test_bench_control.py -m cuda
"""

import json

import pytest
import torch

from port_bench import calibrate, compare
from port_bench import run as R

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from mobocmf_tpu_torch import _build
    _build.build()
    limits = json.loads((R.HERE / "limits" / f"{workload}.json").read_text())
    r = calibrate.reading(workload, 2**31 + 7, torch.device("cuda"), control=True, seconds=0.2)
    assert compare.judge(r["program"], limits)
    assert "error" in r["control"] or not compare.judge(r["control"], limits)
