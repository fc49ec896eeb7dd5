"""util/util.py and util/profiling.py of the port: the helpers against the
JAX package's (1e-12), and the cases of tests/test_profiling.py."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.util import util as JU
from mobocmf_tpu_torch.util import util as PU
from mobocmf_tpu_torch.util.profiling import phase_report, phase_timer, reset_phase_times, trace
from torch_threads import one_intra_op_thread  # noqa: F401


def test_pickles_and_paths(tmp_path):
    folder = str(tmp_path / "a" / "b")
    PU.create_path(folder)
    assert os.path.isdir(folder)
    PU.save_pickle(folder, "x.pkl", {"k": [1, 2.5]})
    assert PU.read_pickle(folder, "x.pkl") == {"k": [1, 2.5]}
    assert JU.read_pickle(folder, "x.pkl") == {"k": [1, 2.5]}


@pytest.mark.parametrize("n,offset", [(5, 0), (6, 1), (4, 2)])
def test_triu_indices(n, offset):
    rows, cols = PU.triu_indices(n, offset)
    want_r, want_c = JU.triu_indices(n, offset)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_c))


def test_compute_dist_and_outputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3))
    np.testing.assert_allclose(PU.compute_dist(torch.as_tensor(x)).numpy(),
                               np.asarray(JU.compute_dist(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)
    y_low, y_high = rng.normal(size=9), rng.normal(size=4)
    for got, want in zip(PU.standardize_outputs(y_low, y_high),
                         JU.standardize_outputs(y_low, y_high)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    got = PU.preprocess_outputs(y_low, y_high, device="cpu")
    want = JU.preprocess_outputs(y_low, y_high)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert got[2:] == want[2:]
    got = PU.preprocess_outputs_two_fidelities(y_low, y_high, device="cpu")
    want = JU.preprocess_outputs_two_fidelities(y_low, y_high)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert got[2:] == want[2:]


def test_reset_random_state_seeds_numpy_as_the_jax_package():
    PU.reset_random_state(3)
    a = np.random.uniform(size=4)
    JU.reset_random_state(3)
    np.testing.assert_array_equal(a, np.random.uniform(size=4))


def test_phase_timer_accumulates_and_synchronizes():
    reset_phase_times()
    with phase_timer("unit_sleep", verbose=False):
        time.sleep(0.05)
    x = torch.ones((64, 64))
    with phase_timer("unit_matmul", result={"x": x}, verbose=False):
        x = x @ x
    rep = phase_report()
    assert rep["unit_sleep"]["count"] == 1
    assert rep["unit_sleep"]["total_s"] >= 0.05
    assert "unit_matmul" in rep
    with phase_timer("unit_sleep", verbose=False):
        time.sleep(0.01)
    assert phase_report()["unit_sleep"]["count"] == 2
    reset_phase_times()
    assert phase_report() == {}


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        torch.ones((16, 16)) @ torch.ones((16, 16))
    found = []
    for _, _, files in os.walk(d):
        found.extend(files)
    assert found, "trace context produced no profile files"


def test_fit_config_matches_jax():
    """core/config.py::FitConfig: the JAX package's fields and defaults,
    frozen like it, and the port fitter's constructor defaults."""
    import dataclasses
    import inspect

    from mobocmf_tpu.core.config import FitConfig as JFitConfig
    from mobocmf_tpu_torch.core.config import FitConfig
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

    assert dataclasses.asdict(FitConfig()) == dataclasses.asdict(JFitConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        FitConfig().lr_1 = 0.1
    defaults = inspect.signature(BlackBoxMFDGPFitter).parameters
    for name, value in dataclasses.asdict(FitConfig()).items():
        assert defaults[name].default == value, name
