"""The port's checkpoints (torch.save of plain dicts, read back with
weights_only=True) and hyperparameter dumps.

A save -> restore round trip is bitwise, the generator states included, so
a restored fitter's next Pareto sample is the unrestored one's.
describe_hyperparams on a model carried across from the JAX package
matches the JAX package's to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu.util.describe import describe_hyperparams as j_describe
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
from mobocmf_tpu_torch.models.convert import model_from_numpy
from mobocmf_tpu_torch.models.mfdgp import TL
from mobocmf_tpu_torch.util import checkpoint
from mobocmf_tpu_torch.util.describe import describe_hyperparams, print_lengthscales_and_outputscale
from mobocmf_tpu_torch.util.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _fitter(**kw):
    rng = np.random.default_rng(0)
    n = 12
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    args = dict(num_epochs_1=2, num_epochs_2=3, opt_grid_size=20, pareto_set_size=5,
                device="cpu", dtype=F64, pad_data=True, seed=3)
    f = BlackBoxMFDGPFitter(2, n, **{**args, **kw})
    f.initialize_mfdgp(x, np.sin(3 * x[:, 0]) + x[:, 1], fid, "obj1")
    f.initialize_mfdgp(x, np.cos(2 * x[:, 1]), fid, "obj2")
    f.initialize_mfdgp(x, 0.5 - x[:, 0], fid, "con1", threshold_constraint=0.1,
                       is_constraint=True)
    return f


def _assert_same_fitter(a, b):
    assert (a.obj_names, a.con_names, a.thresholds_cons) == (b.obj_names, b.con_names,
                                                             b.thresholds_cons)
    assert (a.num_real, a.pad_data, a.batch_size, a.dtype) == (b.num_real, b.pad_data,
                                                               b.batch_size, b.dtype)
    for reg_a, reg_b in ((a.models_objs, b.models_objs), (a.models_cons, b.models_cons)):
        for name in reg_a:
            ma, mb = reg_a[name], reg_b[name]
            assert ma.config == mb.config
            la, lb = tree_leaves(ma.params) + tree_leaves(ma.consts), \
                tree_leaves(mb.params) + tree_leaves(mb.consts)
            assert len(la) == len(lb)
            for u, v in zip(la, lb):
                assert u.dtype == v.dtype and torch.equal(u, v)
    for u, v in zip([a.x_train, a.fidelities, a.row_weights] + a.ys_objs + a.ys_cons,
                    [b.x_train, b.fidelities, b.row_weights] + b.ys_objs + b.ys_cons):
        assert u.dtype == v.dtype and torch.equal(u, v)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.host_generator.get_state(), b.host_generator.get_state())


def test_round_trip_is_bitwise_and_continues_the_streams(tmp_path):
    f = _fitter()
    f.train_mfdgps()
    cond = f.copy_uncond()
    cond.sample_and_store_pareto_solution()
    checkpoint.save_fitter(str(tmp_path / "ck"), cond)
    blob = torch.load(tmp_path / "ck" / checkpoint.STATE_FILE, weights_only=True)
    assert set(blob) == {"state", "meta"}
    restored = checkpoint.restore_fitter(str(tmp_path / "ck"), device="cpu")
    _assert_same_fitter(cond, restored)
    for a, b in zip(cond.pareto_solution[:3], restored.pareto_solution[:3]):
        assert torch.equal(a, b)
    assert cond.pareto_solution.num_valid == restored.pareto_solution.num_valid
    # the next Pareto sample of each is the same, draw for draw
    s1 = cond.sample_and_store_pareto_solution()
    s2 = restored.sample_and_store_pareto_solution()
    for a, b in zip(s1[:3], s2[:3]):
        assert torch.equal(a, b)
    # and the restored fitter runs the rest of the pipeline
    restored.train_conditioned_mfdgps()
    assert restored.phase_stats[-1]["label"] == "COND"


def test_meta_carries_the_schedule(tmp_path):
    f = _fitter(lr_1=0.007, lr_2=0.0004, num_epochs_1=3, num_epochs_2=4, pareto_set_size=7,
                opt_grid_size=33, eps=1e-7, type_lengthscale=TL.ONES, polish="device",
                whitened=True, whitened_init="prior", pad_data=False)
    checkpoint.save_fitter(str(tmp_path / "ckh"), f)
    r = checkpoint.restore_fitter(str(tmp_path / "ckh"), device="cpu")
    assert (r.lr_1, r.lr_2, r.num_epochs_1, r.num_epochs_2) == (0.007, 0.0004, 3, 4)
    assert (r.pareto_set_size, r.opt_grid_size, r.eps) == (7, 33, 1e-7)
    assert (r.polish, r.whitened, r.whitened_init) == ("device", True, "prior")
    assert r.type_lengthscale == TL.ONES and r.pad_data is False
    assert r.pareto_solution is None
    _assert_same_fitter(f, r)
    r.train_mfdgps()
    assert [st["epochs"] for st in r.phase_stats] == [3, 4]


def test_restore_on_another_device_type_warns(tmp_path, monkeypatch):
    f = _fitter()
    checkpoint.save_fitter(str(tmp_path / "ckd"), f)
    blob = torch.load(tmp_path / "ckd" / checkpoint.STATE_FILE, weights_only=True)
    blob["state"]["device_type"] = "cuda"
    torch.save(blob, tmp_path / "ckd" / checkpoint.STATE_FILE)
    with pytest.warns(UserWarning, match="saved on cuda"):
        r = checkpoint.restore_fitter(str(tmp_path / "ckd"), device="cpu")
    assert torch.equal(r.models_objs["obj1"].params.raw_noises,
                       f.models_objs["obj1"].params.raw_noises)


@pytest.mark.parametrize("num_fidelities", [2, 3])
def test_describe_hyperparams_matches_jax(num_fidelities, capsys):
    rng = np.random.default_rng(num_fidelities)
    n = 15
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % num_fidelities
    y = np.sin(3 * x[:, 0]) * x[:, 1]
    jm = JM.init_mfdgp(jax.random.key(0), jnp.asarray(x), jnp.asarray(y)[:, None],
                       jnp.asarray(fid), num_fidelities)
    # move the kernels off their init so every entry is a distinct number
    jm = jm._replace(params=jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape)), jm.params))
    pm = model_from_numpy(jax.tree.map(np.asarray, jm.params), jax.tree.map(np.asarray, jm.consts),
                          jm.config._asdict(), "cpu", F64)
    want, got = j_describe(jm), describe_hyperparams(pm)
    assert list(got) == list(want) == [f"layer_{i}" for i in range(num_fidelities)]
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k], rtol=1e-12, atol=0)
    print_lengthscales_and_outputscale(pm)
    assert capsys.readouterr().out.count("layer_") == num_fidelities
