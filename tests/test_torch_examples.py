"""The port's example entry points, each run as `python -m` on the CPU at
a tiny size (--device cpu, where they run float64; one iteration): the log files and
finite outputs. Each runs in a subprocess on one intra-op thread (small
ops: several threads only slow them down on this CPU)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "example_mesmoc_mfgp": (["--iters", "1"], 2, 1,
                            ["observed_hypervolumes.txt", "recommendation_hv.txt"]),
    "example_branin_currin_512": (["--fast", "--iters", "1", "--n-init", "40"], 2, 1,
                                  ["observed_hypervolumes.txt", "phase_seconds.txt"]),
    "example_batch_bo_10d": (["--fast", "--iters", "1", "--q", "2"], 10, 2,
                             ["observed_hypervolumes.txt", "phase_seconds.txt"]),
    "example_dtlz2_2048": (["--fast", "--iters", "1", "--n-init", "40"], 6, 1,
                           ["observed_hypervolumes.txt", "phase_seconds.txt"]),
}
FIDELITIES = {"example_dtlz2_2048": 3}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, d, points, logs = CASES[name]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", f"mobocmf_tpu_torch.examples.{name}", *args, "--device", "cpu",
         "--log-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "final:" in out.stdout
    pts = np.loadtxt(tmp_path / "points_evaluated.txt", ndmin=2)
    assert pts.shape == (points, d) and bool(((pts >= 0) & (pts <= 1)).all())
    fids = np.loadtxt(tmp_path / "fidelities_evaluated.txt", ndmin=1)
    assert fids.shape == (points,) and set(fids.tolist()) <= set(range(FIDELITIES.get(name, 2)))
    for log in logs:
        rows = np.loadtxt(tmp_path / log, ndmin=2)
        assert rows.shape[0] == 1 and bool(np.isfinite(rows).all()), (log, rows)


PIPELINES = {
    "example_synthetic_2D": ([], ["checkpoint round-trip (unconditioned) OK: predictions equal",
                                  "checkpoint round-trip (conditioned) OK: predictions equal"]),
    "example_acquisition_mfdgp_forrester": (["--fast"], [
        "fitter pickle round-trip OK: predictions equal",
        "jesmoc pickle round-trip OK: predictions equal"]),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_example_runs_on_the_cpu(name):
    """The two examples that save, restore or pickle the fitter between its
    phases: the round-trip lines, a finite conditioned loss and finite,
    non-negative acquisition maxima. The Pareto points and MOOP attempts
    are printed, not required: with standardized thresholds the MOOP's
    rule can leave such a problem with no feasible point."""
    args, lines = PIPELINES[name]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", f"mobocmf_tpu_torch.examples.{name}", *args, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout.splitlines()
    for line in lines:
        assert line in text, out.stdout[-4000:]
    print([s for s in text if s.startswith("pareto points")])
    loss = [float(s.split(":")[1]) for s in text if s.startswith("conditioned loss:")]
    assert len(loss) == 1 and np.isfinite(loss[0])
    maxima = [float(m) for s in text if s.startswith(("acq ", "coupled "))
              for m in re.findall(r"max=(\S+?);?(?:\s|$)", s)]
    assert len(maxima) >= 2 and all(np.isfinite(m) and m >= 0.0 for m in maxima), maxima


@pytest.mark.parametrize("argv,want", [
    ([], "float64"), (["--dtype", "float64"], "float64"), (["--dtype", "float32"], "float32"),
    (["--dtype", "float64", "--fast"], "float64"),
])
def test_dtlz2_dtype_reaches_the_config(argv, want):
    """example_dtlz2_2048's --dtype is the BOConfig's dtype (parsed, not
    run); without it the CPU runs float64."""
    import torch

    from mobocmf_tpu_torch.examples import example_dtlz2_2048 as ex

    config = ex.make_config(ex.parse_args(argv + ["--device", "cpu"]), torch.device("cpu"))
    assert config.dtype == getattr(torch, want) and config.num_fidelities == 3
