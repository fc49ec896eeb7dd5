"""The port's BO loop: its helpers and recommendation scoring against the
JAX package at f64, and every option of run_bo_loop for one iteration on
the CPU at the JAX package's --fast test size (5 + 8 epochs, grid 25, 6
Pareto points; tests/test_integration_jesmoc.py:128-170).

The runs of both packages' loops, the log-file comparison and the
cross-resume are in tests/test_torch_loop_jax.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.bo import loop as JL
from mobocmf_tpu.fit.fitter import BlackBoxMFDGPFitter as JFitter
from mobocmf_tpu_torch.bo import loop as PL
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter as PFitter
from mobocmf_tpu_torch.models.convert import fitter_from_numpy
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _bowl(shift, offset):
    return lambda xs: (np.atleast_2d(xs)[:, 0] - shift) ** 2 + np.atleast_2d(xs)[:, 1] ** 2 + offset


def blackboxes(pkg, constraints=True):
    """Two objectives (each fidelity a shifted bowl) and one constraint
    feasible on the left half of the box, as numpy functions."""
    bbs = [pkg.Blackbox("obj1", [_bowl(0.25, 0.3), _bowl(0.25, 0.0)]),
           pkg.Blackbox("obj2", [_bowl(0.75, 0.3), _bowl(0.75, 0.0)])]
    if constraints:
        con = lambda xs: 0.55 - np.atleast_2d(xs)[:, 0]  # noqa: E731
        bbs.append(pkg.Blackbox("con1", [con, con], is_constraint=True, threshold=0.0))
    return bbs


def initial_design(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(12, 2)), np.concatenate([np.zeros(8), np.ones(4)]).astype(int)


FAST = dict(num_epochs_1=5, num_epochs_2=8, opt_grid_size=25, pareto_set_size=6, seed=1,
            acq_maxiter=60, acq_raw_samples=50)


def port_config(log_dir, **kw):
    return PL.BOConfig(**{**FAST, "num_bo_iterations": 1, "log_dir": str(log_dir),
                          "device": "cpu", "dtype": F64, **kw})


def _state(pkg, seed):
    rng = np.random.default_rng(seed)
    n = 30
    fid = (rng.uniform(size=n) < 0.6).astype(int)
    ys = {"obj1": rng.normal(size=n), "obj2": rng.normal(size=n),
          "con1": rng.normal(size=n) + 0.3}
    return pkg.BOState(x=rng.uniform(size=(n, 2)), fidelities=fid, ys=ys, hypervolumes=[])


@pytest.mark.parametrize("ref", [None, (3.0, 2.5)], ids=["default-ref", "fixed-ref"])
@pytest.mark.parametrize("constraints", [True, False])
def test_standardize_and_observed_hypervolume_match_jax(ref, constraints):
    ref = None if ref is None else np.asarray(ref)
    for seed in range(3):
        sj, sp = _state(JL, seed), _state(PL, seed)
        for name in sj.ys:
            for a, b in zip(PL._standardize(sp.ys[name]), JL._standardize(sj.ys[name])):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        want = JL._observed_hypervolume(blackboxes(JL, constraints), sj,
                                        JL.BOConfig(hv_reference=ref))
        got = PL._observed_hypervolume(blackboxes(PL, constraints), sp,
                                       PL.BOConfig(hv_reference=ref, device="cpu"))
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # a constant output standardizes with std 1
    assert PL._standardize(np.full(4, 2.0))[2] == 1.0
    none = PL.BOState(x=np.zeros((2, 2)), fidelities=np.zeros(2, int),
                      ys={"obj1": np.zeros(2), "obj2": np.zeros(2), "con1": np.zeros(2)},
                      hypervolumes=[])
    assert PL._observed_hypervolume(blackboxes(PL), none, PL.BOConfig(device="cpu")) == 0.0


@pytest.fixture(scope="module")
def jax_fitter():
    """A JAX fitter trained a few epochs on the standardized outputs of the
    test blackboxes, with the per-blackbox (mean, std)."""
    x, fid = initial_design(3)
    bbs = blackboxes(JL)
    f = JFitter(2, x.shape[0], num_epochs_1=5, num_epochs_2=8, seed=2, pad_data=True)
    stats = {}
    for bb in bbs:
        y = np.where(fid == 0, bb.fns[0](x), bb.fns[1](x))
        y_std, mean, std = JL._standardize(y)
        stats[bb.name] = (mean, std)
        thr = (bb.threshold - mean) / std if bb.is_constraint else 0.0
        f.initialize_mfdgp(jnp.asarray(x), jnp.asarray(y_std)[:, None], jnp.asarray(fid),
                           bb.name, threshold_constraint=thr, is_constraint=bb.is_constraint)
    f.train_mfdgps()
    return f, stats


def port_fitter(jf):
    """A JAX fitter carried across (models, data, thresholds, Pareto
    solution) as numpy."""
    import jax

    def entry(name, is_con, y):
        m = jf.get_model(name, is_con)
        return (name, jax.tree.map(np.asarray, m.params), jax.tree.map(np.asarray, m.consts),
                m.config._asdict(), np.asarray(y).reshape(-1))

    s = jf.pareto_solution
    return fitter_from_numpy(
        jf.num_fidelities, jf.batch_size, np.asarray(jf.x_train), np.asarray(jf.fidelities),
        np.asarray(jf.row_weights), jf.num_real,
        [entry(n, False, y) for n, y in zip(jf.obj_names, jf.ys_objs)],
        [entry(n, True, y) for n, y in zip(jf.con_names, jf.ys_cons)], jf.thresholds_cons,
        None if s is None else (np.asarray(s.pareto_set), np.asarray(s.pareto_front),
                                np.asarray(s.mask), s.num_valid),
        device="cpu", dtype=F64,
    )


@pytest.mark.parametrize("constraints", [True, False])
def test_recommend_and_score_matches_jax(jax_fitter, constraints):
    """The same models, the same grid seed: the same recommended set
    (exact), feasibility flag and counts, and HVs to rtol 1e-9."""
    jf, stats = jax_fitter
    pf = port_fitter(jf)
    want = JL.recommend_and_score(jf, blackboxes(JL, constraints), stats, JL.BOConfig(),
                                  grid_size=300, seed=11)
    got = PL.recommend_and_score(pf, blackboxes(PL, constraints), stats,
                                 PL.BOConfig(device="cpu"), grid_size=300, seed=11)
    np.testing.assert_array_equal(got.rec_set, want.rec_set)
    assert (got.feasible, got.num_infeasible, got.num_points_final, got.num_points_initial) == (
        want.feasible, want.num_infeasible, want.num_points_final, want.num_points_initial)
    np.testing.assert_allclose([got.hv, got.hv_optimal], [want.hv, want.hv_optimal], rtol=1e-9)
    assert got.num_points_final >= 1 and got.hv_optimal >= got.hv > 0
    assert (got.num_points_initial > got.num_points_final) or not constraints or got.feasible


def _rows(path):
    return np.loadtxt(path, ndmin=2)


def _run(tmp_path, capsys, **kw):
    x, fid = initial_design()
    cfg = port_config(tmp_path, **kw)
    state = PL.run_bo_loop(blackboxes(PL), x, fid, cfg)
    return state, capsys.readouterr().out


def test_loop_q2_dump_params_and_plots(tmp_path, capsys):
    """q=2: two distinct points at one fidelity, one iteration; the
    hyperparameter dumps and both plots are written."""
    state, out = _run(tmp_path, capsys, q=2, dump_params=True, plot_surfaces=True)
    assert state.x.shape == (14, 2)
    new, fids = state.x[12:], state.fidelities[12:]
    assert fids[0] == fids[1] and np.abs(new[0] - new[1]).max() > 1e-6
    assert _rows(tmp_path / "points_evaluated.txt").shape == (2, 2)
    assert _rows(tmp_path / "fidelities_evaluated.txt").shape == (2, 1)
    assert _rows(tmp_path / "observed_hypervolumes.txt").shape == (1, 1)
    for name in ("obj1", "obj2", "con1"):
        text = (tmp_path / "params" / f"{name}_iter0.txt").read_text()
        assert text.startswith("layer_0: {'l0_lengthscale'") and "layer_1:" in text
    assert sorted(os.listdir(tmp_path / "plots")) == ["acquisition_iter0.pdf",
                                                      "predictive_iter0.pdf"]
    assert "plotting failed" not in out
    # a q=2 log dir refuses a resume under q=3
    with pytest.raises(ValueError, match="not a multiple of q=3"):
        _run(tmp_path, capsys, q=3, num_bo_iterations=2)


@pytest.mark.parametrize("consumers", [False, True], ids=["no-consumers", "recommendation"])
def test_loop_random_baseline(tmp_path, capsys, monkeypatch, consumers):
    """The random baseline trains nothing unless something consumes the
    models (here the recommendation scoring), and never samples a Pareto
    solution or conditions."""
    trained = []
    inner = PFitter.train_mfdgps
    monkeypatch.setattr(PFitter, "train_mfdgps", lambda self: trained.append(1) or inner(self))
    state, out = _run(tmp_path, capsys, acquisition="random", track_recommendation=consumers,
                      recommendation_grid_size=100)
    assert state.x.shape == (13, 2) and bool(((state.x >= 0) & (state.x <= 1)).all())
    assert len(trained) == int(consumers)
    # columns: it, n, setup, train, pareto, cond, acq, recommend
    phases = _rows(tmp_path / "phase_seconds.txt")[0]
    assert phases.shape == (8,) and phases[4] == phases[5] == 0.0
    assert (phases[3] > 0) == consumers
    assert not (tmp_path / "pareto_resamples.txt").exists()
    assert (tmp_path / "hypervolumes.txt").exists() == consumers
    assert "Evaluating fidelity" in out


def test_loop_warm_start_and_whitened(tmp_path, capsys, monkeypatch):
    """Two whitened iterations with warm start: the second iteration's
    models start from the first's trained kernels."""
    seen = []
    inner = PFitter.initialize_mfdgp

    def spy(self, *a, previously_trained_model=None, **k):
        seen.append(previously_trained_model)
        return inner(self, *a, previously_trained_model=previously_trained_model, **k)

    monkeypatch.setattr(PFitter, "initialize_mfdgp", spy)
    state, out = _run(tmp_path, capsys, whitened=True, warm_start=True, num_bo_iterations=2)
    assert state.x.shape == (14, 2) and len(state.hypervolumes) == 2
    assert seen[:3] == [None] * 3 and all(m is not None for m in seen[3:6])
    assert all(m.config.whitened for m in seen[3:6])
    assert _rows(tmp_path / "phase_seconds.txt").shape == (2, 8)
    assert np.isfinite(_rows(tmp_path / "observed_hypervolumes.txt")).all()


def test_loop_device_polish(tmp_path, capsys):
    state, out = _run(tmp_path, capsys, polish="device")
    assert state.x.shape == (13, 2)
    tries = _rows(tmp_path / "pareto_resamples.txt")
    assert tries.shape == (1, 3) and tries[0, 2] >= 1


def test_loop_store_and_load_models(tmp_path, capsys, monkeypatch):
    """Checkpoints of both fitters per iteration; a later run of the same
    iteration restores them instead of training."""
    _run(tmp_path / "a", capsys, store_models_in_disk=True)
    assert sorted(os.listdir(tmp_path / "a" / "models" / "iter0")) == ["cond", "uncond"]
    os.makedirs(tmp_path / "b")
    os.rename(tmp_path / "a" / "models", tmp_path / "b" / "models")
    monkeypatch.setattr(PFitter, "train_mfdgps", lambda self: pytest.fail("retrained"))
    state, out = _run(tmp_path / "b", capsys, load_models_from_disk=True)
    assert f"[BO iter 0] restored models from {tmp_path / 'b' / 'models' / 'iter0'}" in out
    assert state.x.shape == (13, 2)
    assert "phases: acq=" in out  # no setup, train, Pareto or conditioning timed
    # a missing checkpoint retrains, as the JAX package does
    monkeypatch.undo()
    _, out = _run(tmp_path / "c", capsys, load_models_from_disk=True)
    assert "model restore failed" in out and "retraining" in out


def test_boconfig_validates_like_jax():
    with pytest.raises(ValueError, match="acquisition"):
        PL.BOConfig(acquisition="Random")
    with pytest.raises(ValueError, match="polish"):
        PL.BOConfig(polish="slsqp ")
    jax_fields = {f for f in JL.BOConfig.__dataclass_fields__}
    port_fields = {f for f in PL.BOConfig.__dataclass_fields__}
    assert port_fields == jax_fields | {"device", "dtype"}
    for name in jax_fields:
        assert getattr(PL.BOConfig(), name) == getattr(JL.BOConfig(), name) or name in (
            "type_lengthscale",)
    assert PL.BOConfig().type_lengthscale.name == JL.BOConfig().type_lengthscale.name
