"""Conditioned (theta / omega) training in the port against the JAX package
at f64. The JAX loss draws x_tilde and the propagation normals from its
key; the tests re-derive those draws (conditioned.py:128-130, 203-233) and
hand them to the port. The port's two forms of the loss (fused, and the
three forwards of MOBOCMF_FUSED_COND=0) are held to the JAX package's
fused result, the same math on the same draws (tests/test_torch_variants.py
holds the three forwards to the JAX package's own)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.fit import conditioned as JC
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import fitter as pfitter
from mobocmf_tpu_torch.models.convert import model_from_numpy
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def test_theta_and_omega_factors_match_jax():
    rng = np.random.default_rng(0)
    k, c, p, j = 2, 2, 5, 10
    mean, var = rng.normal(size=p), rng.uniform(0.1, 2.0, size=p)
    mask = np.array([True, True, False, True, True])
    got = C.loss_theta_factors(torch.as_tensor(mean), torch.as_tensor(var), 0.3, 1e-8,
                               torch.as_tensor(mask))
    want = JC.loss_theta_factors(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(0.3), 1e-8,
                                 jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    args = [rng.normal(size=(k, j)), rng.uniform(0.1, 2, size=(k, j)), rng.normal(size=(c, j)),
            rng.uniform(0.1, 2, size=(c, j)), rng.normal(size=c), rng.normal(size=(p, k))]
    got = C.loss_omega_factors(*[torch.as_tensor(a) for a in args], torch.as_tensor(mask), 1e-8)
    want = JC.loss_omega_factors(*[jnp.asarray(a) for a in args], jnp.asarray(mask), 1e-8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def _setup(num_con, seed=11, n=12, p=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    fid = (np.arange(n) % 2).astype(int)
    ys = rng.normal(size=(2 + num_con, n))
    models = [JM.init_mfdgp(jax.random.key(i), jnp.asarray(x), jnp.asarray(y[:, None]),
                            jnp.asarray(fid), 2) for i, y in enumerate(ys)]
    op, oc, config = jtrainer.stack_models(models[:2])
    if num_con:
        cp, cc, _ = jtrainer.stack_models(models[2:])
    else:
        cp = jax.tree.map(lambda a: a[:0], op)
        cc = oc._replace(acq_eps=oc.acq_eps[:0], noise_lower=oc.noise_lower[:0],
                         noise_upper=oc.noise_upper[:0])
    rw = np.concatenate([np.ones(n - 2), np.zeros(2)])
    jdata = JC.ConditionedData(
        x=jnp.asarray(x), ys_obj=jnp.asarray(ys[:2]), ys_con=jnp.asarray(ys[2:]),
        fidelities=jnp.asarray(fid), pareto_set=jnp.asarray(rng.uniform(size=(p, 2))),
        pareto_front=jnp.asarray(rng.normal(size=(p, 2))),
        front_mask=jnp.asarray([True, True, True, False]),
        thresholds=jnp.asarray(rng.normal(size=num_con) * 0.3), row_weights=jnp.asarray(rw),
    )
    pdata = C.ConditionedData(*[torch.as_tensor(np.asarray(a)) for a in jdata])

    def port(params, consts):
        return model_from_numpy(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, consts),
                                config._asdict(), "cpu", F64)

    return (op, cp, oc, cc, config, jdata), (port(op, oc), port(cp, cc), pdata)


def _jax_step_draws(key, num_obj, num_con, b, p, d=2, fm1=1):
    """x_tilde and eps of conditioned_loss(key) (fused path)."""
    k_xt, k_rest = jax.random.split(key)
    x_tilde = jax.random.uniform(k_xt, (JC.NUM_OMEGA_POINTS, d), dtype=jnp.float64)
    keys = jax.random.split(k_rest, 6)
    n10 = JC.NUM_OMEGA_POINTS
    eps_o = jnp.concatenate([jax.random.normal(keys[0], (num_obj, fm1, b), dtype=jnp.float64),
                             jax.random.normal(keys[1], (num_obj, fm1, p), dtype=jnp.float64),
                             jax.random.normal(keys[4], (num_obj, fm1, n10), dtype=jnp.float64)], -1)
    eps_c = jnp.concatenate([jax.random.normal(keys[2], (num_con, fm1, b), dtype=jnp.float64),
                             jax.random.normal(keys[3], (num_con, fm1, p), dtype=jnp.float64),
                             jax.random.normal(keys[5], (num_con, fm1, n10), dtype=jnp.float64)], -1)
    return (torch.as_tensor(np.asarray(x_tilde)), torch.as_tensor(np.asarray(eps_o)),
            torch.as_tensor(np.asarray(eps_c)))


@functools.lru_cache(maxsize=None)
def _jax_fused_loss(num_con):
    """JAX conditioned_loss(fused=True) and its gradient, once per problem."""
    (op, cp, oc, cc, config, jdata), _ = _setup(num_con)
    n = jdata.x.shape[0]

    def jloss(ps):
        return JC.conditioned_loss(ps[0], ps[1], oc, cc, config, jdata, jax.random.key(7), 1e-8,
                                   jnp.arange(n), jdata.row_weights, fused=True)

    return jax.value_and_grad(jloss)((op, cp))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three-forward"])
@pytest.mark.parametrize("num_con", [2, 0])
def test_conditioned_loss_value_and_gradients_match_jax(num_con, fused):
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(num_con)
    n = jdata.x.shape[0]
    key = jax.random.key(7)
    l_j, g_j = _jax_fused_loss(num_con)
    x_tilde, eps_o, eps_c = _jax_step_draws(key, 2, num_con, n, 4)
    po = tree_map(lambda t: t.clone().requires_grad_(True), pm_o.params)
    pc = tree_map(lambda t: t.clone().requires_grad_(True), pm_c.params)
    loss = C.conditioned_loss(po, pc, pm_o.consts, pm_c.consts, pm_o.config, pdata, 1e-8,
                              torch.arange(n), pdata.row_weights, x_tilde, eps_o, eps_c,
                              fused=fused)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-9)
    # gradients at 1e-9 of each leaf's scale: entries that cancel in the
    # sums (|g| ~ 1e-3 of the leaf's largest) carry the packages' ~1e-13
    # factor differences at a larger relative size
    for jg, leaf in zip(jax.tree.leaves(g_j), tree_leaves((po, pc))):
        want = np.asarray(jg)
        got = np.zeros(leaf.shape) if leaf.grad is None else leaf.grad.numpy()
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * max(scale, 1.0))


@functools.lru_cache(maxsize=None)
def _jax_fused_training(iters, lr):
    (op, cp, oc, cc, config, jdata), _ = _setup(2, seed=3)
    return JC.train_conditioned(op, cp, oc, cc, config, jdata, jax.random.key(21), iters, lr,
                                1e-8, jdata.x.shape[0], fused=True)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three-forward"])
def test_train_conditioned_matches_jax(fused):
    """Five full-batch steps with the JAX key chain's draws
    (train_conditioned_carry: split over iterations, then (batch, loss))."""
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(2, seed=3)
    n, iters, lr = jdata.x.shape[0], 5, 0.01
    key = jax.random.key(21)
    op_j, cp_j, losses_j = _jax_fused_training(iters, lr)
    draws = []
    for k in jax.random.split(key, iters):
        _, kl = jax.random.split(k)
        x_tilde, eps_o, eps_c = _jax_step_draws(kl, 2, 2, n, 4)
        draws.append(C.StepDraws(None, x_tilde, torch.cat([eps_o, eps_c])))
    op_p, cp_p, losses_p = C.train_conditioned(
        pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata, None, iters, lr,
        1e-8, n, draws=draws, fused=fused)
    np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_j), rtol=1e-7)
    for a, b in zip(jax.tree.leaves((op_j, cp_j)), tree_leaves((op_p, cp_p))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7, atol=1e-9)


def test_shared_inducing_inputs_are_required():
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(2)
    bad = pm_c.consts._replace(z_x=tuple(z + 0.1 for z in pm_c.consts.z_x))
    with pytest.raises(ValueError, match="identical inducing inputs"):
        C.train_conditioned_chunked(pm_o.params, pm_c.params, pm_o.consts, bad, pm_o.config,
                                    pdata, None, 2, 1e-3, 1e-8, 12)


@pytest.mark.parametrize("with_con", [True, False])
def test_fitter_pareto_and_conditioned_training_end_to_end(with_con):
    """sample_and_store_pareto_solution then train_conditioned_mfdgps on a
    tiny padded problem: a finite Pareto solution, finite decreasing loss,
    variational parameters moved, kernel parameters and noises frozen."""
    rng = np.random.default_rng(5)
    n = 13
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    f = pfitter.BlackBoxMFDGPFitter(2, n, num_epochs_1=3, num_epochs_2=6, opt_grid_size=20,
                                    pareto_set_size=5, pad_data=True, device="cpu", dtype=F64)
    f.initialize_mfdgp(x, np.sin(4 * x[:, 0]), fid, "o1")
    f.initialize_mfdgp(x, np.cos(3 * x[:, 1]), fid, "o2")
    if with_con:
        f.initialize_mfdgp(x, 0.3 - np.sum((x - 0.5) ** 2, 1), fid, "c", is_constraint=True)
    f.train_mfdgps()
    before = f.copy_uncond()
    sol = f.sample_and_store_pareto_solution()
    assert sol.num_valid >= 1 and f.pareto_tries >= 1
    assert f.pareto_set.shape == (5, 2) and f.pareto_front.shape == (5, 2)
    assert bool(torch.isfinite(sol.pareto_front[sol.mask]).all())
    f.train_conditioned_mfdgps()
    cond = f.phase_stats[-1]
    assert cond["label"] == "COND" and cond["epochs"] == 6
    assert np.isfinite(cond["last"]) and cond["last"] < cond["first"]
    for name, is_con in [("o1", False), ("o2", False)] + ([("c", True)] if with_con else []):
        old, new = before.get_model(name, is_con).params, f.get_model(name, is_con).params
        assert not torch.equal(old.layers[0].variational.mean, new.layers[0].variational.mean)
        for a, b in zip(tree_leaves(old.layers[1].kernel), tree_leaves(new.layers[1].kernel)):
            assert torch.equal(a, b)
        assert torch.equal(old.raw_noises, new.raw_noises)
    assert f.num_con == int(with_con)
