"""BENCHMARK.json against the benchmark's contract, and the harness's files
found by name: every configuration file, traffic file, limits file and
per-layer reader that an entry names exists."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


def test_each_cell_reports_what_it_must():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for name in cells:
        e2e = [e["name"] for e in BENCH["end_to_end"] if name in e.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if name in m["workloads"]]
        assert layer and all(m["moves"] in e2e for m in layer)


def test_files_found_by_name():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert all(k in cfg["published"] for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert (ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "port_bench" / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["per_layer"]:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").exists()


def test_command_stays_inside_paths():
    cmd = BENCH["command"]
    assert cmd[:3] == ["python3", "-m", "port_bench.run"] and len(cmd) <= 32
