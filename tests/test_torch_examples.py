"""The port's example entry points, each run as `python -m` on the CPU at
a tiny size (--device cpu, where they run float64; one iteration): the log files and
finite outputs. Each runs in a subprocess on one intra-op thread (small
ops: several threads only slow them down on this CPU)."""

import os
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
