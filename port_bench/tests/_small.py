"""The tiny sizes the CPU rehearsals run at: 20 points at the lowest
fidelity and 8 at each other (m = 32 at two fidelities, 48 at three)."""

SMALL = {"config": {"n_low": 20, "n_high": 8},
         "traffic": {"warmup_steps": 3, "pareto_grid": 100}}
SEED = 2**31 + 12345


def small(config: dict) -> dict:
    """The overrides that shrink `config`: its `n_per_fidelity` where it
    gives one, else `n_low` and `n_high`; the traffic alike for all."""
    sizes = ({"n_per_fidelity": [20] + [8] * (config["num_fidelities"] - 1)}
             if "n_per_fidelity" in config else SMALL["config"])
    return {"config": dict(sizes), "traffic": dict(SMALL["traffic"])}


def for_workload(workload: str, bench_file=None) -> dict:
    """small() of the workload's configuration in BENCHMARK.json."""
    from port_bench import run
    bench = run.load_json(bench_file or run.ROOT / "BENCHMARK.json")
    return small(run.inputs(bench, workload)[0])
