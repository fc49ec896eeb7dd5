"""One run of one cell of the benchmark of mobocmf_tpu_torch:

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card. The workload's
entry in BENCHMARK.json names its configuration (port_bench/configs/) and
its traffic (port_bench/traffic/); its limits are port_bench/limits/
<workload>.json; its per-layer metrics' readers port_bench/metrics/
<metric>.py. A run:

1. set-up (`setup_s`, from the process's start): imports, the kernels
   through the program's build (their libraries stay under the checkout's
   build/kernels/), the data and the model from the seed, the phase object
   and its first steps, a warm-up on the cell's own shapes;
2. the window: `--seconds` of the cell's traffic, its last steps a chunk
   of their own (`--trace 0`), or a slice of it under torch.profiler and
   then those last steps (`--trace 1`);
3. the comparison with the plain reference (port_bench/reference/), after
   the program's state is freed;
4. numbers compared beside their limits on standard error, and one JSON
   line on standard output.
It exits with another code than 0, printing no result, without a CUDA
card (or with fewer than the cell asks for), or when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# every cache the program or torch writes stays at a fixed place in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "2")

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mobocmf_tpu")
END_TO_END = {"train": "train_steps_per_s", "cond": "cond_steps_per_s"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def inputs(bench: dict, workload: str, overrides: dict = None):
    """The workload's configuration, traffic and limits, found by the names
    BENCHMARK.json gives; `overrides` replaces entries of the first two."""
    spec = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{spec['traffic']}.json")
    config.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    return config, traffic, load_json(HERE / "limits" / f"{workload}.json")


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a per-layer reader reads: the cell's kind and shapes, the traced
    window's counts, device events (name, start s, end s), wall clock and
    busy time."""

    def __init__(self, kind, shapes, counts, events, window_s, busy_s):
        self.kind, self.shapes, self.counts = kind, shapes, counts
        self.events, self.window_s, self.busy_s = events, window_s, busy_s


def shapes_of(cell) -> dict:
    c, d = cell.config, cell.data
    from port_bench.bucket import next_bucket
    return dict(B=len(d.names), F=c["num_fidelities"], m=next_bucket(d.x.shape[0]), d=c["d"],
                P=c["pareto_set_size"], dtype=c["dtype"])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: int, device="cuda",
        bench_file: Path = ROOT / "BENCHMARK.json", overrides: dict = None) -> dict:
    """One run; returns the result line (the caller prints it). `device`
    other than cuda and `overrides` (entries replacing the configuration's
    and the traffic's) are for the CPU rehearsal in the tests."""
    from port_bench import cells, compare
    from port_bench import trace as tr

    bench = load_json(bench_file)
    config, traffic, limits = inputs(bench, workload, overrides)
    dev = torch.device(device)
    # a float32 configuration states float32, not TF32 (the float64 ones are untouched by it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        from mobocmf_tpu_torch import _build
        _build.build()

    t_build = time.perf_counter()
    cell = cells.build(config, traffic, seed, dev)
    cells.sync(dev)
    setup_s = time.perf_counter() - T_START
    last = T_START
    for stage, t in [("imports, kernels' build or load", t_build)] + cell.marks:
        print(f"[setup] {stage}: {t - last:.3f} s", file=sys.stderr)
        last = t
    kind = traffic["kind"]
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        counts = cell.window(seconds)
        ends = cell.chunk_ends
        print("[window] steps per second of each chunk (host clock; a training chunk ends in a "
              "synchronize): " + " ".join(f"{n}:{n / (t - t0):.2f}" for (_, t0), (n, t) in
                                         zip(ends, ends[1:])), file=sys.stderr)
        result["metrics"][END_TO_END[kind]] = {"value": counts["steps"] / counts["seconds"],
                                               "unit": "steps/s"}
        result["attempted"] = counts["steps"]
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        info = {}
    else:
        events, host, wall = tr.traced(lambda: cell.steps(traffic["trace_steps"]), dev)
        busy = tr.union(events)
        busy_s = sum(e - s for s, e in busy)
        counts = dict(steps=traffic["trace_steps"])
        cell.tail()
        result["attempted"] = counts["steps"]
        ctx = Ctx(kind, shapes_of(cell), counts, events, wall, busy_s)
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        info = dict(busy_s=busy_s, window_s=wall)
        result["breakdown"] = tr.breakdown(events, host, busy)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's outputs, then its state freed before the reference runs
    prog = cell.program()
    cell.close()
    ref = cell.reference(torch.float64, dev)
    del cell
    gc.collect()
    nums = compare.numbers(prog, ref)
    result["correct"] = compare.judge(nums, limits)
    result["device"] = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                            kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                            count=1, memory_peak_bytes=int(peak), **info)
    result["checked"] = {name: {"value": nums.get(name), "limit": lim}
                         for name, lim in limits.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"[bench] BENCHMARK.json has no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    print(f"[bench] {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr, flush=True)
    result = run(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"[bench] loaded modules of JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 4
    for name, c in result["checked"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
