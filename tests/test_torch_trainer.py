"""Stacked two-phase training: the port's trainer against
mobocmf_tpu.fit.trainer.train_phase_stacked_chunked at f64.

The JAX trainer draws its propagation eps (and minibatch permutations)
from a key chain: fold_in(key, chunk) split over models (trainer.py:494),
split over epochs (:243), then split again per epoch (:203-204 full batch,
:213 minibatch). The test re-derives those draws with jax.random and hands
them to the port, so both run the same trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.fit import fitter as jfitter
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu_torch.fit import bucketing, fitter, trainer
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.convert import model_from_numpy, model_to_numpy
from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _problem(n_real=14, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_real, 2))
    fid = (np.arange(n_real) % 2).astype(np.int32)
    ys = np.stack([
        np.sin(5 * x[:, 0]) + x[:, 1] + 0.2 * fid,
        np.cos(3 * x[:, 1]) * x[:, 0] - 0.1 * fid,
        0.25 - np.sum((x - 0.5) ** 2, axis=1),
    ])
    return x, ys, fid


def _padded(x, ys, fid):
    target = bucketing.next_bucket(x.shape[0])
    xp, fp, w = bucketing.pad_inputs_np(x, fid, target)
    ysp = np.stack([bucketing.pad_rows_np(y, target) for y in ys])
    return xp, ysp, fp, w


def _jax_stack(x, ys, fid):
    models = [
        JM.init_mfdgp(jax.random.key(i), jnp.asarray(x), jnp.asarray(y)[:, None],
                      jnp.asarray(fid), 2)
        for i, y in enumerate(ys)
    ]
    return jtrainer.stack_models(models)


def _port_model(sp, sc, config):
    return model_from_numpy(
        jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, sc), config._asdict(), "cpu", F64
    )


def _jax_draws(key, num_models, num_epochs, n, nf, perm=False, padded=None, chunk=0):
    """The eps (and permutations) train_phase_stacked_chunked draws for its
    chunk number `chunk` of num_epochs epochs."""
    keys = jax.random.split(jax.random.fold_in(key, chunk), num_models)
    eps, perms = [], []
    for km in keys:
        e_m, p_m = [], []
        for ke in jax.random.split(km, num_epochs):
            kperm, keps = jax.random.split(ke)
            e_m.append(np.asarray(jax.random.normal(keps, (nf, padded or n), dtype=jnp.float64)))
            if perm:
                p_m.append(np.asarray(jax.random.permutation(kperm, n)))
        eps.append(e_m)
        perms.append(p_m)
    eps = torch.as_tensor(np.array(eps)).transpose(0, 1).contiguous()
    perms = torch.as_tensor(np.array(perms)).transpose(0, 1).contiguous() if perm else None
    return eps, perms


def _assert_params_close(port_params, jax_params, rtol, atol):
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jax_params))
    pl = tree_leaves(port_params)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b.numpy(), a, rtol=rtol, atol=atol)


def test_two_phase_stacked_training_matches_jax():
    """3 blackboxes, padded to the 16 bucket, 20 + 20 full-batch epochs.

    Losses and params at rtol 1e-7; the params' atol 1e-9 covers entries
    that Adam moves from (near) zero, where a relative bound means nothing."""
    x, ys, fid = _problem()
    xp, ysp, fp, w = _padded(x, ys, fid)
    sp, sc, config = _jax_stack(xp, ysp, fp)
    pm = _port_model(sp, sc, config)
    n, nm, epochs = xp.shape[0], 3, 20
    num_data = float(x.shape[0])
    xj, ysj, fj, wj = (jnp.asarray(a) for a in (xp, ysp, fp, w))
    xt, yst, ft, wt = (torch.as_tensor(a) for a in (xp, ysp, fp, w))

    for phase, (lr, kind) in enumerate([(0.003, "fix_variational_hypers"), (0.001, "all_free")]):
        key = jax.random.key(100 + phase)
        sp, logs_j = jtrainer.train_phase_stacked_chunked(
            sp, sc, config, xj, ysj, fj, key, nm, epochs, lr, kind, n, wj,
            jnp.asarray(num_data),
        )
        eps, _ = _jax_draws(key, nm, epochs, n, 1)
        params, logs_p = trainer.train_phase_stacked(
            pm, xt, yst, ft, epochs, lr, kind, n, wt, torch.tensor(num_data, dtype=F64), eps=eps,
        )
        pm = pm._replace(params=params)
        np.testing.assert_allclose(logs_p.loss.numpy(), np.asarray(logs_j.loss), rtol=1e-7)
        np.testing.assert_allclose(logs_p.kl.numpy(), np.asarray(logs_j.kl), rtol=1e-7)
        _assert_params_close(pm.params, sp, rtol=1e-7, atol=1e-9)
    # phase 1 froze the variational Cholesky and the noises
    assert float(logs_p.loss[:, -1].sum()) < float(logs_p.loss[:, 0].sum())


def test_minibatch_training_matches_jax():
    """One phase on 3 minibatches (the last one padded), permutations and
    eps from the JAX key chain."""
    x, ys, fid = _problem(n_real=16, seed=1)
    sp, sc, config = _jax_stack(x, ys, fid)
    pm = _port_model(sp, sc, config)
    n, nm, epochs, bsz = x.shape[0], 3, 4, 6
    key = jax.random.key(7)
    sp, logs_j = jtrainer.train_phase_stacked_chunked(
        sp, sc, config, jnp.asarray(x), jnp.asarray(ys), jnp.asarray(fid), key, nm, epochs,
        0.003, "all_free", bsz,
    )
    eps, perms = _jax_draws(key, nm, epochs, n, 1, perm=True, padded=18)
    params, logs_p = trainer.train_phase_stacked(
        pm, torch.as_tensor(x), torch.as_tensor(ys), torch.as_tensor(fid), epochs, 0.003,
        "all_free", bsz, eps=eps, perms=perms,
    )
    np.testing.assert_allclose(logs_p.loss.numpy(), np.asarray(logs_j.loss), rtol=1e-7)
    _assert_params_close(params, sp, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("kind", ["fix_variational_hypers", "all_free", "fix_cond"])
def test_masks_match_jax(kind):
    x, ys, fid = _problem()
    jm = JM.init_mfdgp(jax.random.key(0), jnp.asarray(x), jnp.asarray(ys[0])[:, None],
                       jnp.asarray(fid), 2, init_params_to_prior_and_fix_them=True)
    pm = model_from_numpy(jax.tree.map(np.asarray, jm.params), jax.tree.map(np.asarray, jm.consts),
                          jm.config._asdict(), "cpu", F64)
    jmask = jax.tree.leaves(jtrainer.build_mask(jm.params, kind, jm.config))
    pmask = tree_leaves(trainer.build_mask(pm.params, kind, pm.config))
    assert [float(np.asarray(a).reshape(-1)[0]) for a in jmask] == pmask


def test_fitter_end_to_end_with_padding():
    """The port's fitter: same padded init as the JAX fitter, finite
    training, per-model access, snapshot, acquisition predictive."""
    x, ys, fid = _problem(n_real=13, seed=2)
    kw = dict(num_fidelities=2, batch_size=100, num_epochs_1=8, num_epochs_2=8, pad_data=True)
    jf = jfitter.BlackBoxMFDGPFitter(**kw)
    pf = fitter.BlackBoxMFDGPFitter(**kw, device="cpu", dtype=F64)
    names = [("branin", False), ("currin", False), ("disk", True)]
    for (name, is_con), y in zip(names, ys):
        jf.initialize_mfdgp(x, y, fid, name, is_constraint=is_con, threshold_constraint=0.0)
        pf.initialize_mfdgp(x, y, fid, name, is_constraint=is_con, threshold_constraint=0.0)
    assert pf.x_train.shape == (16, 2) and pf.num_real == 13
    np.testing.assert_array_equal(pf.row_weights.numpy(), np.asarray(jf.row_weights))
    for name, is_con in names:
        jm, pm = jf.get_model(name, is_con), pf.get_model(name, is_con)
        params, _, config = model_to_numpy(pm)
        assert config == jm.config._asdict()
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jm.params)), tree_leaves(params)):
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12)

    before = pf.copy_uncond()
    pf.train_mfdgps()
    assert pf.models_uncond_trained and not before.models_uncond_trained
    assert [s["phase"] for s in pf.phase_stats] == [1, 2]
    assert all(np.isfinite(s["last"]) for s in pf.phase_stats)
    assert pf.phase_stats[-1]["last"] < pf.phase_stats[0]["first"]
    # the snapshot still holds the untrained models
    assert not torch.equal(before.get_model("branin").params.raw_noises,
                           pf.get_model("branin").params.raw_noises)
    stacked = trainer.stack_models([pf.get_model(n, c) for n, c in names])
    grid = torch.as_tensor(np.random.default_rng(0).uniform(size=(9, 2)))
    mus, var = M.predict_for_acquisition_all(stacked.params, stacked.consts, stacked.config, grid)
    assert mus.shape == (3, 2, 9)
    assert bool(torch.isfinite(mus).all()) and bool((var > 0).all())


@pytest.mark.parametrize("dtype,batch_size,per_epoch", [
    (F64, 14, 2), (F64, 5, 6), (torch.float32, 14, 0),
], ids=["f64-full-batch", "f64-minibatch", "f32"])
def test_phase_counts_its_layer_states_through_the_inverse(dtype, batch_size, per_epoch):
    """`steps_stats`' inv_states: F layer states an update through the
    explicit inverse at float64 (3 minibatches an epoch at 5 of 14 rows),
    none at float32; util/counters.py's "inv.states" moves by as much. The
    route's GEMM operations per step likewise: the counter over the 3
    epochs."""
    x, ys, fid = _problem()
    models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                           device="cpu", dtype=dtype) for i, y in enumerate(ys)]
    stats = {}
    counters.reset()
    trainer.train_phase_stacked_chunked(
        trainer.stack_models(models), torch.as_tensor(x, dtype=dtype),
        torch.as_tensor(ys, dtype=dtype), torch.as_tensor(fid), 3, 1e-3, "all_free", batch_size,
        generator=torch.Generator().manual_seed(1), stats=stats)
    assert stats["inv_states"] == counters.get("inv.states") == 3 * per_epoch
    assert stats["inv_gemm_flops_per_step"] == counters.get("inv.gemm_flops") / 3
    assert (stats["inv_gemm_flops_per_step"] > 0) == (per_epoch > 0)


def test_b128_step_splits_no_product():
    """At m = 128 (the b128 cells' width) no structured product of the
    inverse route splits: a training step skips nothing."""
    x, ys, fid = _problem(n_real=128, seed=2)
    models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                           device="cpu", dtype=F64) for i, y in enumerate(ys)]
    stats = {}
    counters.reset()
    trainer.train_phase_stacked_chunked(
        trainer.stack_models(models), torch.as_tensor(x), torch.as_tensor(ys),
        torch.as_tensor(fid), 1, 1e-3, "all_free", 128,
        generator=torch.Generator().manual_seed(1), stats=stats)
    assert stats["inv_gemm_flops_per_step"] > 0
    assert stats["inv_gemm_skipped_per_step"] == 0 == counters.get("inv.gemm_skipped")


def test_split_products_train_as_the_dense_route(monkeypatch):
    """Three float64 training steps (F = 3, m = 48) with the inverse route's
    products split two levels deep (a leaf of 8) against the same steps
    unsplit: losses and KL terms to 1e-10 relative (Adam's normalized
    update makes parameters whose gradient is at rounding level move apart
    by more than the products' rounding); the split skips about half of
    the dense count and issues the rest."""
    from mobocmf_tpu_torch.linalg import ops

    rng = np.random.default_rng(3)
    x = rng.uniform(size=(48, 6))
    fid = np.repeat(np.arange(3), [24, 12, 12])
    ys = np.stack([np.cos(x[:, 0]) + x[:, 1], np.sin(x[:, 2]) * x[:, 3]])
    runs = []
    for leaf in (ops.GEMM_LEAF, 8):
        monkeypatch.setattr(ops, "GEMM_LEAF", leaf)
        models = [M.init_mfdgp(x, y, fid, 3, generator=torch.Generator().manual_seed(i),
                               device="cpu", dtype=F64) for i, y in enumerate(ys)]
        stats = {}
        _, logs = trainer.train_phase_stacked_chunked(
            trainer.stack_models(models), torch.as_tensor(x), torch.as_tensor(ys),
            torch.as_tensor(fid), 3, 1e-3, "all_free", 48,
            generator=torch.Generator().manual_seed(1), stats=stats)
        runs.append(([logs.loss, logs.kl], stats))
    (dense, dense_stats), (split, split_stats) = runs
    for got, want in zip(split, dense):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel < 1e-10, rel
    assert dense_stats["inv_gemm_skipped_per_step"] == 0
    issued, skipped = split_stats["inv_gemm_flops_per_step"], split_stats["inv_gemm_skipped_per_step"]
    assert issued + skipped == dense_stats["inv_gemm_flops_per_step"]
    assert 0.4 < issued / (issued + skipped) < 0.6


def test_fitter_rejects_mismatched_inputs():
    x, ys, fid = _problem()
    pf = fitter.BlackBoxMFDGPFitter(2, 100, device="cpu", dtype=F64)
    pf.initialize_mfdgp(x, ys[0], fid, "a")
    with pytest.raises(ValueError):
        pf.initialize_mfdgp(x + 1.0, ys[1], fid, "b")


def _jax_phase_draws(key, num_epochs, n, nf, bsz=None):
    """The draws of the JAX package's single-model train_phase
    (trainer.py:203-214, :243): per epoch split(key_e) -> (perm key, eps
    key); the minibatch path draws eps over the padded rows."""
    padded = n if bsz is None else bsz * -(-n // bsz)
    eps, perms = [], []
    for ke in jax.random.split(key, num_epochs):
        kperm, keps = jax.random.split(ke)
        eps.append(np.asarray(jax.random.normal(keps, (nf, padded), dtype=jnp.float64)))
        if bsz is not None:
            perms.append(np.asarray(jax.random.permutation(kperm, n)))
    return torch.as_tensor(np.array(eps)), (torch.as_tensor(np.array(perms)) if perms else None)


@pytest.mark.parametrize("bsz", [None, 5])
def test_train_phase_single_model_matches_jax(bsz):
    """train_phase of one model (full batch and 3 minibatches), the JAX
    key chain's draws injected: losses and params at rtol 1e-7 / atol 1e-9."""
    x, ys, fid = _problem(n_real=12, seed=3)
    jm = JM.init_mfdgp(jax.random.key(1), jnp.asarray(x), jnp.asarray(ys[0])[:, None],
                       jnp.asarray(fid), 2)
    key = jax.random.key(5)
    n = x.shape[0]
    p_j, logs_j = jtrainer.train_phase(jm.params, jm.consts, jm.config, jnp.asarray(x),
                                       jnp.asarray(ys[0]), jnp.asarray(fid), key, 4, 0.003,
                                       "all_free", bsz or n)
    eps, perms = _jax_phase_draws(key, 4, n, 1, bsz)
    pm = _port_model(jm.params, jm.consts, jm.config)
    p_p, logs_p = trainer.train_phase(pm, torch.as_tensor(x), torch.as_tensor(ys[0]),
                                      torch.as_tensor(fid), 4, 0.003, "all_free", bsz or n,
                                      eps=eps, perms=perms)
    assert logs_p.loss.shape == (4,)
    np.testing.assert_allclose(logs_p.loss.numpy(), np.asarray(logs_j.loss), rtol=1e-7)
    _assert_params_close(tree_map(lambda t: t[0], p_p), p_j, rtol=1e-7, atol=1e-9)


def test_train_mfdgp_two_phase_matches_jax():
    """The reference's single-model schedule: 6 epochs with the variational
    hypers fixed, then 6 all free, each phase's draws from JAX's split key."""
    x, ys, fid = _problem(n_real=12, seed=4)
    jm = JM.init_mfdgp(jax.random.key(2), jnp.asarray(x), jnp.asarray(ys[1])[:, None],
                       jnp.asarray(fid), 2)
    key = jax.random.key(9)
    n = x.shape[0]
    jm2, log1_j, log2_j = jtrainer.train_mfdgp_two_phase(
        jm, jnp.asarray(x), jnp.asarray(ys[1]), jnp.asarray(fid), key, 6, 6, 0.003, 0.001, n)
    k1, k2 = jax.random.split(key)
    draws = (_jax_phase_draws(k1, 6, n, 1), _jax_phase_draws(k2, 6, n, 1))
    pm = _port_model(jm.params, jm.consts, jm.config)
    pm2, log1_p, log2_p = trainer.train_mfdgp_two_phase(
        pm, torch.as_tensor(x), torch.as_tensor(ys[1]), torch.as_tensor(fid), None, 6, 6, 0.003,
        0.001, n, draws=draws)
    np.testing.assert_allclose(log1_p.loss.numpy(), np.asarray(log1_j.loss), rtol=1e-7)
    np.testing.assert_allclose(log2_p.loss.numpy(), np.asarray(log2_j.loss), rtol=1e-7)
    _assert_params_close(tree_map(lambda t: t[0], pm2.params), jm2.params, rtol=1e-7, atol=1e-9)
