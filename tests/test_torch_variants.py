"""The JAX package's three step-time switches in the port, at f64 on the
CPU, each against the JAX package's path under the same switch and
against the port's default path:

- MOBOCMF_FUSED_COND=0: the three-forward conditioned loss (value and
  gradients, full batch and minibatch, 0 and 1 constraints, a padded
  Pareto row; the chunked phase across chunk boundaries);
- MOBOCMF_FLAT_ADAM=1: Adam on one flat tensor (25 epochs against the
  JAX package's flat Adam and the port's per-leaf Adam; the carried state);
- MOBOCMF_ACQ_INV=0: acquisition states without L^{-1} (gains and the
  all-fidelity search: in tests/test_torch_acquisition.py, beside the
  trained fitters they share);

and that the port reads each variable when the JAX package does, with its
default. Also core/distances.py's compute_dist and cdist."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.acquisition import jesmoc as JJ
from mobocmf_tpu.core import distances as JD
from mobocmf_tpu.fit import conditioned as JC
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu_torch.acquisition import jesmoc as PJ
from mobocmf_tpu_torch.core import distances as PD
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import graphs, trainer
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from test_torch_chunked import _cond_draws
from test_torch_conditioned import _jax_step_draws, _setup
from test_torch_trainer import _port_model
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def flat_adam(monkeypatch):
    """Set MOBOCMF_FLAT_ADAM for the JAX package and the port: both read it
    when a phase builds its optimizer."""
    return lambda on: monkeypatch.setenv("MOBOCMF_FLAT_ADAM", "1" if on else "0")


# ---------------------------------------------------------------------------
# MOBOCMF_FUSED_COND=0: the three-forward conditioned loss
# ---------------------------------------------------------------------------


def _grads_close(got_leaves, want_tree):
    """Each leaf's gradient at 1e-9 of its own scale (as
    test_torch_conditioned.py: entries that cancel in the sums carry the
    packages' ~1e-13 factor differences)."""
    for jg, leaf in zip(jax.tree.leaves(want_tree), got_leaves):
        want = np.asarray(jg)
        got = np.zeros(leaf.shape) if leaf.grad is None else leaf.grad.numpy()
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * max(scale, 1.0))


@pytest.mark.parametrize("minibatch", [False, True], ids=["full-batch", "minibatch"])
@pytest.mark.parametrize("num_con", [1, 0])
def test_three_forward_loss_matches_jax_unfused(num_con, minibatch):
    """JAX conditioned_loss(fused=False) and the port's fused=False on the
    JAX draws (the padded Pareto row masked; the minibatch holds the two
    padded data rows): value and gradients at 1e-9 relative."""
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(num_con)
    n = jdata.x.shape[0]
    bidx = np.array([0, 3, 5, 7, 10, 11]) if minibatch else np.arange(n)
    bw = np.asarray(jdata.row_weights)[bidx]
    key = jax.random.key(13)

    def jloss(ps):
        return JC.conditioned_loss(ps[0], ps[1], oc, cc, config, jdata, key, 1e-8,
                                   jnp.asarray(bidx), jnp.asarray(bw), fused=False)

    l_j, g_j = jax.jit(jax.value_and_grad(jloss))((op, cp))
    x_tilde, eps_o, eps_c = _jax_step_draws(key, 2, num_con, len(bidx), 4)
    po = tree_map(lambda t: t.clone().requires_grad_(True), pm_o.params)
    pc = tree_map(lambda t: t.clone().requires_grad_(True), pm_c.params)
    loss = C.conditioned_loss(po, pc, pm_o.consts, pm_c.consts, pm_o.config, pdata, 1e-8,
                              torch.as_tensor(bidx), torch.as_tensor(bw), x_tilde, eps_o, eps_c,
                              fused=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-9)
    _grads_close(tree_leaves((po, pc)), g_j)


@pytest.mark.parametrize("fused,forwards", [(True, 1), (False, 3)])
def test_forward_calls_per_loss(monkeypatch, fused, forwards):
    """One M.forward per loss evaluation fused, three unfused, and one set of
    layer states (one K1 launch per layer on the card) either way."""
    (_, _, _, _, _, jdata), (pm_o, pm_c, pdata) = _setup(1)
    n = jdata.x.shape[0]
    x_tilde, eps_o, eps_c = _jax_step_draws(jax.random.key(2), 2, 1, n, 4)
    calls = {"forward": 0, "states": 0}
    forward, states = M.forward, trainer.states_stacked

    def count(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(M, "forward", count("forward", forward))
    monkeypatch.setattr(trainer, "states_stacked", count("states", states))
    C.conditioned_loss(pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata,
                       1e-8, torch.arange(n), pdata.row_weights, x_tilde, eps_o, eps_c,
                       fused=fused)
    assert calls == {"forward": forwards, "states": 1}


def test_chunked_three_forward_phase_matches_jax(monkeypatch):
    """MOBOCMF_FUSED_COND=0 in both packages (their FUSED_COND_DEFAULT,
    which train_conditioned_chunked reads at the call), 4 steps as chunks of
    2 + 2 with the JAX key chain's draws: the losses at 1e-9 relative;
    the trained parameters at tests/test_torch_chunked.py's bounds."""
    for mod in (jtrainer, trainer):
        monkeypatch.setattr(mod, "chunk_size_for", lambda m: 2)
    for mod in (JC, C):
        monkeypatch.setattr(mod, "FUSED_COND_DEFAULT", False)
    num_con = 1
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(num_con, seed=3)
    n, key = jdata.x.shape[0], jax.random.key(23)
    op_j, cp_j, losses_j = JC.train_conditioned_chunked(op, cp, oc, cc, config, jdata, key, 4,
                                                        0.01, 1e-8, n)
    forwards = []
    forward = M.forward
    monkeypatch.setattr(M, "forward", lambda *a, **kw: forwards.append(1) or forward(*a, **kw))
    op_p, cp_p, losses_p = C.train_conditioned_chunked(
        pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata, None, 4, 0.01,
        1e-8, n, draws=_cond_draws(key, num_con, n)[:4])
    assert len(forwards) == 3 * 4
    np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_j), rtol=1e-9)
    for a, b in zip(jax.tree.leaves((op_j, cp_j)), tree_leaves((op_p, cp_p))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7, atol=1e-9)


def test_three_forward_phase_equals_fused_phase():
    """The port's two forms on the same draws, 6 minibatch steps: the same
    math, losses and parameters at 1e-9 relative."""
    (_, _, _, _, _, jdata), (pm_o, pm_c, pdata) = _setup(1, seed=4)
    chunk = C.draw_chunk(torch.Generator().manual_seed(6), pdata, pm_o.config, 5, 6)
    draws = [C.StepDraws(chunk.batch_idx[i], chunk.x_tilde[i], chunk.eps[i]) for i in range(6)]
    out = [C.train_conditioned(pm_o.params, pm_c.params, pm_o.consts, pm_c.consts,
                               pm_o.config, pdata, None, 6, 0.01, 1e-8, 5, draws=draws,
                               fused=fused) for fused in (True, False)]
    np.testing.assert_allclose(out[1][2].numpy(), out[0][2].numpy(), rtol=1e-9)
    for a, b in zip(tree_leaves(out[1][:2]), tree_leaves(out[0][:2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# MOBOCMF_FLAT_ADAM=1: Adam on one flat tensor
# ---------------------------------------------------------------------------


def _single_problem(seed=0, n=12, d=2):
    """tests/test_trainer_variants.py's problem: the JAX model and the port's
    copy (a stack of one)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    fid = (np.arange(n) % 2).astype(int)
    y = rng.normal(size=(n, 1))
    jm = JM.init_mfdgp(jax.random.key(seed), jnp.asarray(x), jnp.asarray(y), jnp.asarray(fid), 2)
    pm = _port_model(*jtrainer.stack_models([jm]))
    return x, y[:, 0], fid, jm, pm


def _phase_eps(key, epochs, n):
    """train_phase_carry's full-batch draws: split over epochs, then the
    second half of each epoch key's split."""
    return torch.stack([torch.as_tensor(np.asarray(jax.random.normal(
        jax.random.split(ke)[1], (1, n), dtype=jnp.float64))) for ke in jax.random.split(key,
                                                                                        epochs)])


def _flat_run(pm, x, y, fid, epochs, eps, opt_state=None):
    """One single-model phase through the port's carry: (params, state, loss)."""
    params, state, logs = trainer.train_phase_stacked_carry(
        pm, torch.as_tensor(x), torch.as_tensor(y)[None], torch.as_tensor(fid), epochs, 0.003,
        "all_free", x.shape[0], eps=eps[:, None], opt_state=opt_state)
    return params, state, logs.loss[0]


def test_flat_adam_matches_jax_and_per_leaf(flat_adam):
    """25 full-batch epochs: the port's flat Adam against the port's
    per-leaf Adam (losses and parameters at rtol 1e-9, atol 1e-11, as
    tests/test_trainer_variants.py) and against the JAX package's under
    MOBOCMF_FLAT_ADAM=1 (losses at rtol 1e-9; parameters at the two
    packages' post-Adam bounds of tests/test_torch_trainer.py, rtol 1e-7 /
    atol 1e-9: Adam moves entries from ~0, where it scales the packages'
    ~1e-13 factor differences, 7e-9 relative seen on one of 144); the flat
    phase's optimizer holds one tensor, the per-leaf one every leaf."""
    x, y, fid, jm, pm = _single_problem()
    key, epochs = jax.random.key(3), 25
    eps = _phase_eps(key, epochs, x.shape[0])
    flat_adam(True)
    p_j, _, logs_j = jtrainer.train_phase_carry(
        jm.params, jm.consts, jm.config, jnp.asarray(x), jnp.asarray(y), jnp.asarray(fid), key,
        epochs, 0.003, "all_free", x.shape[0])
    p_flat, state_flat, loss_flat = _flat_run(pm, x, y, fid, epochs, eps)
    flat_adam(False)
    p_leaf, state_leaf, loss_leaf = _flat_run(pm, x, y, fid, epochs, eps)
    assert len(state_flat["param_groups"][0]["params"]) == 1
    assert len(state_leaf["param_groups"][0]["params"]) == len(tree_leaves(pm.params)) > 1
    np.testing.assert_allclose(loss_flat.numpy(), np.asarray(logs_j.loss), rtol=1e-9)
    np.testing.assert_allclose(loss_flat.numpy(), loss_leaf.numpy(), rtol=1e-9)
    for a, b, c in zip(jax.tree.leaves(p_j), tree_leaves(p_flat), tree_leaves(p_leaf)):
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(b.numpy()[0], np.asarray(a), rtol=1e-7, atol=1e-9)


def test_flat_adam_state_carries_and_rejects_the_other_setting(flat_adam):
    """The flat state of one chunk is accepted by the next and used (a
    continued run differs from a fresh one); handed to a per-leaf phase, or
    a per-leaf state to a flat one, it raises ValueError."""
    x, y, fid, _, pm = _single_problem(seed=1)
    eps = _phase_eps(jax.random.key(6), 20, x.shape[0])
    flat_adam(True)
    p_a, state, _ = _flat_run(pm, x, y, fid, 10, eps[:10])
    pm_a = pm._replace(params=p_a)
    p_cont, _, _ = _flat_run(pm_a, x, y, fid, 10, eps[10:], opt_state=state)
    p_fresh, _, _ = _flat_run(pm_a, x, y, fid, 10, eps[10:])
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(p_cont), tree_leaves(p_fresh))) > 0.0
    flat_adam(False)
    with pytest.raises(ValueError, match="MOBOCMF_FLAT_ADAM=0"):
        _flat_run(pm_a, x, y, fid, 1, eps[:1], opt_state=state)
    _, leaf_state, _ = _flat_run(pm, x, y, fid, 2, eps[:2])
    flat_adam(True)
    with pytest.raises(ValueError, match="MOBOCMF_FLAT_ADAM=1"):
        _flat_run(pm_a, x, y, fid, 1, eps[:1], opt_state=leaf_state)


@pytest.mark.parametrize("fused", [True, False])
def test_flat_adam_conditioned_phase_equals_per_leaf(flat_adam, fused):
    """The conditioned phase (fix_cond masks: the flat mask freezes the
    kernel parameters and noises) under flat Adam against per-leaf Adam on
    the same draws, 6 steps; its state carries into a second chunk and is
    refused by a per-leaf phase."""
    (_, _, _, _, _, jdata), (pm_o, pm_c, pdata) = _setup(1, seed=5)
    n = jdata.x.shape[0]
    chunk = C.draw_chunk(torch.Generator().manual_seed(8), pdata, pm_o.config, n, 6)
    draws = [C.StepDraws(None, chunk.x_tilde[i], chunk.eps[i]) for i in range(6)]

    def run(state=None, steps=slice(0, 6)):
        return C.train_conditioned_carry(
            pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata, None,
            len(draws[steps]), 0.01, 1e-8, n, opt_state=state, draws=draws[steps], fused=fused)

    flat_adam(False)
    op_l, cp_l, _, losses_l = run()
    flat_adam(True)
    op_f, cp_f, state, losses_f = run()
    assert len(state["param_groups"][0]["params"]) == 1
    np.testing.assert_allclose(losses_f.numpy(), losses_l.numpy(), rtol=1e-9)
    for a, b in zip(tree_leaves((op_f, cp_f)), tree_leaves((op_l, cp_l))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)
    frozen = [(a.layers[1].kernel, b.layers[1].kernel) for a, b in ((op_f, pm_o.params),
                                                                    (cp_f, pm_c.params))]
    for a, b in zip(*map(tree_leaves, zip(*frozen))):
        assert torch.equal(a, b)
    run(state, slice(0, 2))
    flat_adam(False)
    with pytest.raises(ValueError, match="a carried state"):
        run(state, slice(0, 2))


def test_trainable_flat_views_and_masks(flat_adam):
    """graphs.Trainable under MOBOCMF_FLAT_ADAM=1: one flat tensor with a
    gradient, the tree's leaves views of it in tree_leaves' order, the
    masks one flat 0/1 tensor; values() copies."""
    flat_adam(True)
    params = {"b": torch.ones(2, 3, dtype=F64), "a": (torch.zeros(4, dtype=F64), None)}
    tr = graphs.Trainable(params, [0.0, 1.0], 0.1)
    assert tr.flat and len(tr.tensors) == 1 and tr.tensors[0].shape == (10,)
    tree = tr.tree()
    assert tree["b"].shape == (2, 3) and tree["a"][1] is None
    (tree["a"][0].sum() * 2 + tree["b"].sum()).backward()
    np.testing.assert_array_equal(tr.grads()[0].numpy(), [2.0] * 4 + [1.0] * 6)
    np.testing.assert_array_equal(tr.masks[0].numpy(), [0.0] * 4 + [1.0] * 6)
    tr.step()
    vals = tr.values()
    assert torch.equal(vals["a"][0], params["a"][0]) and bool((vals["b"] < 1.0).all())
    assert vals["b"].untyped_storage().data_ptr() != tr.tensors[0].untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# When the variables are read
# ---------------------------------------------------------------------------


def test_switches_read_as_the_jax_package_reads_them():
    """One subprocess with all three variables set off their defaults: each
    package's settings agree, at import (FUSED_COND, ACQ_INV) and when a
    phase builds its optimizer (FLAT_ADAM); then each default back."""
    code = textwrap.dedent("""
        import json, os
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        import torch
        from mobocmf_tpu.acquisition import jesmoc as JJ
        from mobocmf_tpu.fit import conditioned as JC
        from mobocmf_tpu.fit import trainer as JT
        from mobocmf_tpu_torch.acquisition import jesmoc as PJ
        from mobocmf_tpu_torch.fit import conditioned as PC
        from mobocmf_tpu_torch.fit import graphs

        def jax_flat():
            state = JT.make_adam(0.1).init({"a": jnp.zeros(2), "b": jnp.zeros(3)})
            return jax.tree.leaves(state[0].mu)[0].shape == (5,)

        def port_flat():
            params = {"a": torch.zeros(2), "b": torch.zeros(3)}
            return len(graphs.Trainable(params, [1.0, 1.0], 0.1).tensors) == 1

        out = dict(fused=[JC.FUSED_COND_DEFAULT, PC.FUSED_COND_DEFAULT],
                   inv=[JJ.ACQ_INV_SOLVES, PJ.ACQ_INV_SOLVES], flat=[jax_flat(), port_flat()])
        os.environ["MOBOCMF_FLAT_ADAM"] = "0"
        out["flat_after"] = [jax_flat(), port_flat()]
        print(json.dumps(out))
    """)
    env = dict(os.environ, MOBOCMF_FUSED_COND="0", MOBOCMF_FLAT_ADAM="1", MOBOCMF_ACQ_INV="0",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    assert got == ('{"fused": [false, false], "inv": [false, false], "flat": [true, true], '
                   '"flat_after": [false, false]}')
    assert C.FUSED_COND_DEFAULT is JC.FUSED_COND_DEFAULT is True
    assert PJ.ACQ_INV_SOLVES is JJ.ACQ_INV_SOLVES is True
    assert os.environ.get("MOBOCMF_FLAT_ADAM", "0") == "0" and not graphs.flat_adam()


# ---------------------------------------------------------------------------
# core/distances.py
# ---------------------------------------------------------------------------


def test_compute_dist_and_cdist_match_jax():
    """Against the JAX functions at f64 (rtol 1e-12, atol 1e-12), with
    duplicate rows, where cdist's clamp keeps the root of a rounding
    negative at 0."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(size=(9, 3))
    x1[4] = x1[1]
    x2 = np.concatenate([rng.uniform(size=(5, 3)), x1[:2] * (1 + 1e-16)])
    np.testing.assert_allclose(PD.compute_dist(torch.as_tensor(x1)).numpy(),
                               np.asarray(JD.compute_dist(jnp.asarray(x1))), rtol=1e-12,
                               atol=1e-12)
    got = PD.cdist(torch.as_tensor(x1), torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(got, np.asarray(JD.cdist(jnp.asarray(x1), jnp.asarray(x2))),
                               rtol=1e-12, atol=1e-12)
    assert np.isfinite(got).all() and got.min() >= 0.0
    np.testing.assert_allclose(got, np.linalg.norm(x1[:, None] - x2[None], axis=-1), atol=1e-7)
