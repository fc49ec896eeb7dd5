"""Phases in bounded chunks: the port's train_phase_stacked_chunked and
train_conditioned_chunked against the JAX package's at f64 on the CPU,
across chunk boundaries (chunk_size_for patched to 2 in both packages, so
5 steps run as 2 + 2 + 1), with each chunk's draws re-derived from the JAX
key chain (fold_in(key, chunk)); and the chunk-level behaviour of the
port: chunking equals one carry bitwise, the chunk ladder equals the JAX
one at every edge, one heartbeat per chunk, and a NaN raises at the end of
the chunk that made it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.fit import conditioned as JC
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.util import heartbeat
from mobocmf_tpu_torch.util.tree import tree_leaves
from test_torch_conditioned import _jax_step_draws, _setup
from test_torch_trainer import _assert_params_close, _jax_draws, _jax_stack, _padded, \
    _port_model, _problem
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
SIZES = [2, 2, 1]


@pytest.fixture
def chunks_of_two(monkeypatch):
    monkeypatch.setattr(jtrainer, "chunk_size_for", lambda m: 2)
    monkeypatch.setattr(trainer, "chunk_size_for", lambda m: 2)


@pytest.fixture
def beats(monkeypatch):
    tags = []
    monkeypatch.setattr(heartbeat, "beat", lambda tag="": tags.append(tag))
    return tags


def _chunked_draws(key, nm, n, perm=False, padded=None):
    eps, perms = zip(*[_jax_draws(key, nm, sz, n, 1, perm=perm, padded=padded, chunk=ci)
                       for ci, sz in enumerate(SIZES)])
    return torch.cat(eps), torch.cat(perms) if perm else None


@pytest.mark.parametrize("minibatch", [False, True], ids=["full-batch", "minibatch"])
def test_chunked_training_matches_jax(chunks_of_two, minibatch):
    """5 epochs as 2 + 2 + 1 chunks: full batch on the 16 bucket (3
    blackboxes, padded rows), or 3 minibatches of 6 on 16 rows."""
    if minibatch:
        x, ys, fid = _problem(n_real=16, seed=1)
        w, bsz, padded = None, 6, 18
    else:
        x, ys, fid, w = _padded(*_problem())
        bsz, padded = x.shape[0], None
    sp, sc, config = _jax_stack(x, ys, fid)
    pm = _port_model(sp, sc, config)
    n, nm, key = x.shape[0], 3, jax.random.key(31)
    nd = None if w is None else float(w.sum())
    sp, logs_j = jtrainer.train_phase_stacked_chunked(
        sp, sc, config, jnp.asarray(x), jnp.asarray(ys), jnp.asarray(fid), key, nm, 5, 0.003,
        "all_free", bsz, None if w is None else jnp.asarray(w),
        None if nd is None else jnp.asarray(nd),
    )
    eps, perms = _chunked_draws(key, nm, n, perm=minibatch, padded=padded)
    params, logs_p = trainer.train_phase_stacked_chunked(
        pm, torch.as_tensor(x), torch.as_tensor(ys), torch.as_tensor(fid), 5, 0.003, "all_free",
        bsz, None if w is None else torch.as_tensor(w),
        None if nd is None else torch.tensor(nd, dtype=F64), eps=eps, perms=perms,
    )
    np.testing.assert_allclose(logs_p.loss.numpy(), np.asarray(logs_j.loss), rtol=1e-7)
    np.testing.assert_allclose(logs_p.kl.numpy(), np.asarray(logs_j.kl), rtol=1e-7)
    _assert_params_close(params, sp, rtol=1e-7, atol=1e-9)


def _cond_draws(key, num_con, n):
    draws = []
    for ci, sz in enumerate(SIZES):
        for k in jax.random.split(jax.random.fold_in(key, ci), sz):
            _, kl = jax.random.split(k)
            x_tilde, eps_o, eps_c = _jax_step_draws(kl, 2, num_con, n, 4)
            draws.append(C.StepDraws(None, x_tilde, torch.cat([eps_o, eps_c])))
    return draws


@pytest.mark.parametrize("num_con", [2, 0])
def test_chunked_conditioned_matches_jax(chunks_of_two, num_con):
    (op, cp, oc, cc, config, jdata), (pm_o, pm_c, pdata) = _setup(num_con, seed=3)
    n, key = jdata.x.shape[0], jax.random.key(23)
    op_j, cp_j, losses_j = JC.train_conditioned_chunked(op, cp, oc, cc, config, jdata, key, 5,
                                                        0.01, 1e-8, n)
    op_p, cp_p, losses_p = C.train_conditioned_chunked(
        pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata, None, 5, 0.01,
        1e-8, n, draws=_cond_draws(key, num_con, n))
    np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_j), rtol=1e-7)
    for a, b in zip(jax.tree.leaves((op_j, cp_j)), tree_leaves((op_p, cp_p))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7, atol=1e-9)


def _port_problem(minibatch):
    x, ys, fid = _problem(n_real=16, seed=4)
    pm = _port_model(*_jax_stack(x, ys, fid))
    bsz = 6 if minibatch else 16
    eps, perms = trainer.draw_chunk(torch.Generator().manual_seed(5), pm.config, 5, 3, 16, bsz,
                                    F64, "cpu")
    args = (pm, torch.as_tensor(x), torch.as_tensor(ys), torch.as_tensor(fid), 5, 0.003,
            "all_free", bsz)
    return args, eps, perms


@pytest.mark.parametrize("minibatch", [False, True], ids=["full-batch", "minibatch"])
def test_chunking_equals_one_carry_bitwise(chunks_of_two, minibatch):
    args, eps, perms = _port_problem(minibatch)
    p_chunk, log_chunk = trainer.train_phase_stacked_chunked(*args, eps=eps, perms=perms)
    p_one, _, log_one = trainer.train_phase_stacked_carry(*args, eps=eps, perms=perms)
    for a, b in zip(tree_leaves(p_chunk) + list(log_chunk), tree_leaves(p_one) + list(log_one)):
        assert torch.equal(a, b)
    # two carries of 3 + 2 epochs with the Adam state handed over: the same
    p3, state, log3 = trainer.train_phase_stacked_carry(
        *args[:4], 3, *args[5:], eps=eps[:3], perms=None if perms is None else perms[:3])
    p2, _, log2 = trainer.train_phase_stacked_carry(
        args[0]._replace(params=p3), *args[1:4], 2, *args[5:], eps=eps[3:],
        perms=None if perms is None else perms[3:], opt_state=state)
    for a, b in zip(tree_leaves(p2), tree_leaves(p_one)):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([log3.loss, log2.loss], dim=1), log_one.loss)


def test_conditioned_chunking_equals_one_carry_bitwise(chunks_of_two):
    _, (pm_o, pm_c, pdata) = _setup(2, seed=6, n=14)
    args = (pm_o.params, pm_c.params, pm_o.consts, pm_c.consts, pm_o.config, pdata, None, 5,
            0.01, 1e-8, 8)
    chunk = C.draw_chunk(torch.Generator().manual_seed(2), pdata, pm_o.config, 8, 5)
    draws = [C.StepDraws(*(t[i] for t in chunk)) for i in range(5)]
    op_c, cp_c, l_c = C.train_conditioned_chunked(*args, draws=draws)
    op_1, cp_1, _, l_1 = C.train_conditioned_carry(*args, draws=draws)
    assert torch.equal(l_c, l_1)
    for a, b in zip(tree_leaves((op_c, cp_c)), tree_leaves((op_1, cp_1))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 16, 255, 256, 257, 767, 768, 769, 1535, 1536, 1537, 2048,
                               3071, 3072, 3073, 8192])
def test_chunk_size_for_matches_jax(m):
    assert trainer.chunk_size_for(m) == jtrainer.chunk_size_for(m)
    assert trainer._CHUNK_LADDER == jtrainer._CHUNK_LADDER
    assert trainer._CHUNK_MIN == jtrainer._CHUNK_MIN


def test_heartbeat_per_chunk(chunks_of_two, beats):
    args, eps, perms = _port_problem(False)
    trainer.train_phase_stacked_chunked(*args, eps=eps)
    _, (pm_o, pm_c, pdata) = _setup(0, seed=7)
    C.train_conditioned_chunked(pm_o.params, pm_c.params, pm_o.consts, pm_c.consts,
                                pm_o.config, pdata, torch.Generator().manual_seed(0), 5, 0.01,
                                1e-8, 12)
    assert beats == [f"train:chunk{i}" for i in range(3)] + [f"cond:chunk{i}" for i in range(3)]


def test_nan_mid_phase_raises_at_the_next_chunk_end(chunks_of_two, beats):
    """A NaN draw at epoch 3 (the second chunk: epochs 2-3) poisons the
    parameters; the phase raises at the end of that chunk, not later."""
    args, eps, _ = _port_problem(False)
    eps = eps.clone()
    eps[3, 0, 0, 0] = float("nan")
    with pytest.raises(RuntimeError, match=r"\[train\] chunk 1: unconditioned training "
                                           r"produced non-finite parameters"):
        trainer.train_phase_stacked_chunked(*args, eps=eps)
    assert beats == ["train:chunk0", "train:chunk1"]
