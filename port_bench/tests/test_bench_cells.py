"""A tiny CPU rehearsal of each cell through the harness (run.run with the
CPU in place of the card), the last line's contract, and the faults of
faults.py turning `correct` false."""

import json
import math

import pytest
import torch

from port_bench import run as R
from port_bench.tests._small import SEED, for_workload, small

BENCH = json.loads((R.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def bench_file(tmp_path):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(BENCH))
    return path


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearsal_and_last_line(workload, bench_file):
    res = R.run(workload, SEED, 0.3, 0, device="cpu", overrides=for_workload(workload),
                bench_file=bench_file)
    assert list(res)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {e["name"]: e["unit"] for e in BENCH["end_to_end"]
            if workload in e.get("workloads", [workload])}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 and math.isfinite(v["value"]) for v in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checked"].values())
    json.dumps(res)


def test_seed_gives_the_same_inputs():
    from port_bench import problems
    cfg = json.loads((R.ROOT / "port_bench/configs/b128_f64.json").read_text())
    cfg.update(small(cfg)["config"])
    a, b = problems.design(cfg, SEED, "cpu"), problems.design(cfg, SEED, "cpu")
    assert (a.x == b.x).all() and all((u == v).all() for u, v in zip(a.ys, b.ys))


@pytest.mark.parametrize("fault", ["frozen", "late_frozen", "half_batch", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_turns_correct_false(workload, fault, bench_file):
    from port_bench import faults
    with faults.FAULTS[fault]():
        res = R.run(workload, SEED, 0.3, 0, device="cpu", overrides=for_workload(workload),
                bench_file=bench_file)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_late_fault_shows_only_in_the_tail(workload, bench_file):
    """A fault that leaves the first three steps alone passes every number
    of theirs and fails the tail's."""
    from port_bench import faults
    with faults.late_frozen():
        res = R.run(workload, SEED, 0.3, 0, device="cpu", overrides=for_workload(workload),
                bench_file=bench_file)
    checked = res["checked"]
    assert all(c["value"] <= c["limit"] for n, c in checked.items() if not n.endswith("_tail"))
    assert checked["change_tail"]["value"] > checked["change_tail"]["limit"]


def test_traced_run_on_the_cpu_reads_its_tail(bench_file, monkeypatch):
    """--trace 1's path up to the trace (the profiler needs the card): the
    tail after the traced slice is compared like the window's."""
    from port_bench import trace

    def untraced(fn, device):
        fn()
        return [("elementwise", 0.0, 1e-3), ("chol_kernel", 1e-3, 2e-3)], [], 0.01

    monkeypatch.setattr(trace, "traced", untraced)
    res = R.run("b128_f64.train", SEED, 0.3, 1, device="cpu",
                overrides=for_workload("b128_f64.train"), bench_file=bench_file)
    assert res["correct"] is True and "change_tail" in res["checked"]
    assert "mfu.train" in res["metrics"] and "train_steps_per_s" not in res["metrics"]


@pytest.mark.parametrize("workload", CELLS)
def test_flat_adam_state_reads_as_per_leaf(workload, bench_file, monkeypatch):
    """Adam's state kept as one flat tensor (MOBOCMF_FLAT_ADAM=1) is read
    leaf by leaf alike: the cell still comes out correct."""
    monkeypatch.setenv("MOBOCMF_FLAT_ADAM", "1")
    res = R.run(workload, SEED, 0.3, 0, device="cpu", overrides=for_workload(workload),
                bench_file=bench_file)
    assert res["correct"] is True
