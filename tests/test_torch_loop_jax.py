"""Both packages' run_bo_loop on the same numpy blackboxes and initial
design at the --fast test size, two iterations each: the same log files
with the same columns and row counts, and each package resumes the other's
log directory, replaying its points and fidelities exactly and extending
every file by one row. (Kept apart from tests/test_torch_loop.py so that
the JAX loop's compiles run in a worker of their own.)"""

import os
import shutil

import numpy as np
import pytest
import torch

from mobocmf_tpu.bo import loop as JL
from mobocmf_tpu_torch.bo import loop as PL
from test_torch_loop import FAST, blackboxes, initial_design
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
COMMON = dict(FAST, num_bo_iterations=2, track_recommendation=True,
              recommendation_grid_size=100, hv_reference=np.array([3.0, 3.0]))


def _run(pkg, log_dir, iterations):
    x, fid = initial_design()
    kw = dict(COMMON, num_bo_iterations=iterations, log_dir=str(log_dir))
    if pkg is PL:
        kw.update(device="cpu", dtype=F64)
    return pkg.run_bo_loop(blackboxes(pkg), x, fid, pkg.BOConfig(**kw))


def _shapes(log_dir):
    return {name: np.loadtxt(os.path.join(log_dir, name), ndmin=2).shape
            for name in sorted(os.listdir(log_dir))}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Two iterations of each package, each in its own log directory."""
    root = tmp_path_factory.mktemp("campaigns")
    _run(JL, root / "jax", 2)
    _run(PL, root / "port", 2)
    return root


def test_both_packages_write_the_same_log_files(campaigns):
    want, got = _shapes(campaigns / "jax"), _shapes(campaigns / "port")
    assert list(got) == list(want) == [
        "fidelities_evaluated.txt", "hypervolume_solution.txt", "hypervolumes.txt",
        "iteration_seconds.txt", "observed_hypervolumes.txt", "pareto_resamples.txt",
        "phase_seconds.txt", "points_evaluated.txt", "process_starts.txt",
        "setup_breakdown.txt",
    ]
    assert got == want
    assert got["phase_seconds.txt"] == (2, 8) and got["hypervolumes.txt"] == (2, 6)
    phases = np.loadtxt(campaigns / "port" / "phase_seconds.txt")
    np.testing.assert_array_equal(phases[:, :2], [[0, 12], [1, 13]])
    assert np.isfinite(phases).all() and (phases[:, 2:] >= 0).all()


@pytest.mark.parametrize("writer,reader", [(JL, PL), (PL, JL)], ids=["port-resumes-jax",
                                                                     "jax-resumes-port"])
def test_cross_resume(campaigns, tmp_path, capsys, writer, reader):
    src = campaigns / ("jax" if writer is JL else "port")
    dst = tmp_path / "resumed"
    shutil.copytree(src, dst)
    before = _shapes(dst)
    capsys.readouterr()
    state = _run(reader, dst, 3)
    out = capsys.readouterr().out
    assert "[resume] replayed 2 evaluated points (2 iterations)" in out
    assert "[BO iter 0]" not in out and "[BO iter 2]" in out
    x0, fid0 = initial_design()
    np.testing.assert_array_equal(state.x[:12], x0)
    np.testing.assert_array_equal(state.x[12:14], np.loadtxt(src / "points_evaluated.txt"))
    np.testing.assert_array_equal(state.fidelities[12:14],
                                  np.loadtxt(src / "fidelities_evaluated.txt").astype(int))
    assert state.x.shape == (15, 2) and state.fidelities.shape == (15,)
    np.testing.assert_array_equal(state.hypervolumes[:2],
                                  np.loadtxt(src / "observed_hypervolumes.txt"))
    after = _shapes(dst)
    assert list(after) == list(before)
    for name, (rows, cols) in before.items():
        assert after[name] == (rows + 1, cols), name
    np.testing.assert_array_equal(np.loadtxt(dst / "process_starts.txt"), [0, 2])
    assert np.loadtxt(dst / "phase_seconds.txt")[-1, 0] == 2
