"""The set-up readers capture_s.*: they read the program's counter of its
phases' warm-up and capture seconds (fit/graphs.py::setup_seconds), only in
their own kind of cell, fall silent on a program without the counter, and
reach a traced run's line."""

import json

from port_bench import run as R
from port_bench.tests._small import SEED, for_workload

SHAPES = dict(B=4, F=2, m=128, d=2, P=50, dtype="float64")


def _ctx(kind):
    return R.Ctx(kind, SHAPES, dict(steps=20), [("elementwise", 0.0, 1e-3)], 0.1, 1e-3)


def test_readers_read_the_counter_in_their_kind(monkeypatch):
    from mobocmf_tpu_torch.fit import graphs
    monkeypatch.setattr(graphs, "setup_seconds", 2.5)
    assert R.reader("capture_s.train")(_ctx("train")) == 2.5
    assert R.reader("capture_s.cond")(_ctx("cond")) == 2.5
    assert R.reader("capture_s.train")(_ctx("cond")) is None
    assert R.reader("capture_s.cond")(_ctx("train")) is None
    monkeypatch.delattr(graphs, "setup_seconds")
    assert R.reader("capture_s.train")(_ctx("train")) is None
    assert R.reader("capture_s.cond")(_ctx("cond")) is None


def test_traced_cond_run_reports_its_capture(tmp_path, monkeypatch):
    """--trace 1 on the CPU (the profiler's trace stood in for): the line
    carries capture_s.cond, 0 where nothing is captured."""
    from port_bench import trace

    def untraced(fn, device):
        fn()
        return [("elementwise", 0.0, 1e-3)], [], 0.01

    monkeypatch.setattr(trace, "traced", untraced)
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text((R.ROOT / "BENCHMARK.json").read_text())
    res = R.run("b128_f64.cond", SEED, 0.3, 1, device="cpu",
                overrides=for_workload("b128_f64.cond"), bench_file=bench)
    assert res["metrics"]["capture_s.cond"] == {"value": 0.0, "unit": "s"}
    assert "capture_s.train" not in res["metrics"]
    json.dumps(res)
