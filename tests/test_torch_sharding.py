"""The port's mesh (mobocmf_tpu_torch/parallel/) against the JAX package's
sharding on its 8 virtual devices (tests/test_sharding.py) and against the
port's unsharded paths, at f64.

The port runs one process per rank: a module-scoped group of 8 gloo ranks
on the CPU (each on one intra-op thread) runs the sharded side, the
functions of tests/torch_mesh_ranks.py, on meshes (2, 4) and (1, 8); JAX
and the unsharded port run in this process. Tolerances are stated per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu.moop.moop import MOOP as JMOOP
from mobocmf_tpu.parallel import sharding as jsharding
from mobocmf_tpu_torch.acquisition import jesmoc
from mobocmf_tpu_torch.bo import loop as PL
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.mlls.elbo import elbo_terms
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.convert import model_to_numpy
from mobocmf_tpu_torch.parallel import dryrun, launch
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
WORLD = 8


@pytest.fixture(scope="module")
def ranks():
    with launch.Group(WORLD, "cpu", timeout_s=240, threads=1) as group:
        yield group


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _model(n, d, nf, ys, seed=0, fid=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    fid = (np.arange(n) % nf).astype(np.int32) if fid is None else fid
    y = np.stack([f(x) for f in ys])
    models = [M.init_mfdgp(x, yi, fid, nf, generator=torch.Generator().manual_seed(i),
                           device="cpu", dtype=F64) for i, yi in enumerate(y)]
    return x, y, fid, trainer.stack_models(models)


def _targets(k):
    return [lambda x, i=i: np.sin((i + 2) * x[:, 0]) + 0.5 * x[:, -1] * i for i in range(k)]


@pytest.mark.parametrize("bb", [2, 1])
def test_make_mesh_shapes(ranks, bb):
    """(bb, dp) = (2, 4) and (1, 8) as the JAX package's make_mesh(8, bb);
    rank r sits at (r // dp, r % dp); bb = 3 does not divide 8."""
    jm = jsharding.make_mesh(8, bb=bb)
    dp = jm.shape["dp"]
    got = ranks.run(R.mesh_shape, bb)
    for r, (sbb, sdp, rbb, rdp, rank) in enumerate(got):
        assert (sbb, sdp) == (jm.shape["bb"], dp) and rank == r
        assert (rbb, rdp) == (r // dp, r % dp)
    assert all("not divisible by bb=3" in msg for msg in ranks.run(R.mesh_rejects, 3))


def test_shard_rows_pads_and_shards(ranks):
    """The blocks in rank order are the JAX package's padded sharded array."""
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    want = np.asarray(jsharding.shard_rows(jsharding.make_mesh(8, bb=1), jnp.asarray(x)))
    got = ranks.run(R.shard_rows, 1, x)
    assert all(padded == want.shape[0] == 16 for _, padded in got)
    np.testing.assert_array_equal(np.concatenate([b for b, _ in got]), want)


@pytest.mark.parametrize("bb", [1, 2])
def test_sharded_grid_eval_matches_jax(ranks, bb):
    """rtol 1e-12: the same elementwise functions of the same rows."""
    grid = np.random.default_rng(0).uniform(size=(37, 2))
    fns = [lambda x: jnp.sin(3 * x[:, 0]) + x[:, 1], lambda x: jnp.prod(x, axis=1)]
    want = jsharding.sharded_grid_eval(fns, jnp.asarray(grid), jsharding.make_mesh(8, bb=bb))
    for got in ranks.run(R.grid_eval, bb, grid):
        assert got.shape == (2, 37)
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("polish", ["slsqp", "none"])
def test_sharded_moop_matches_jax(ranks, polish):
    """tests/test_sharding.py's problem with JAX's grid injected: every rank
    returns the front of JAX's MOOP(mesh=...), rtol 1e-10."""
    jmesh = jsharding.make_mesh(8, bb=1)

    def f1(x):
        return (x[:, 0] - 0.3) ** 2 + x[:, 1] ** 2

    def f2(x):
        return (x[:, 0] - 0.7) ** 2 + x[:, 1] ** 2

    def c1(x):
        return 0.6 - x[:, 1]

    inputs = np.random.default_rng(1).uniform(size=(4, 2))
    key = jax.random.key(0)
    sol, _, _ = JMOOP([f1, f2], [c1], input_dim=2, grid_size=100, pareto_set_size=8,
                      feasible_values=np.zeros(1), polish=polish, mesh=jmesh
                      ).compute_pareto_solution_from_samples(inputs, key)
    grid = np.asarray(jax.random.uniform(jax.random.split(key)[0], (200, 2)), dtype=float)
    for pset, pfront, nv in ranks.run(R.moop, 1, inputs, grid, polish):
        assert nv == int(sol.num_valid)
        np.testing.assert_allclose(pfront, np.asarray(sol.pareto_front), rtol=1e-10)
        np.testing.assert_allclose(pset, np.asarray(sol.pareto_set), rtol=1e-10, atol=1e-12)


def test_stacked_training_on_bb_mesh_matches_jax(ranks):
    """tests/test_sharding.py's stacked training on a (2, 4) mesh: one model
    per 'bb' rank, two rows per 'dp' rank, JAX's per-model key chains
    injected. Losses and params at rtol 1e-7 (atol 1e-9 for entries Adam
    moves from ~0), as tests/test_torch_trainer.py."""
    rng = np.random.default_rng(2)
    n, d = 8, 2
    x = rng.uniform(size=(n, d))
    fid = np.arange(n) % 2
    ys = [rng.normal(size=(n, 1)) for _ in range(2)]
    models = [JM.init_mfdgp(jax.random.key(i), jnp.asarray(x), jnp.asarray(ys[i]),
                            jnp.asarray(fid), 2) for i in range(2)]
    sp, sc, config = jtrainer.stack_models(models)
    ys2 = np.stack([rng.normal(size=n) for _ in range(2)])
    keys = jax.random.split(jax.random.key(3), 2)
    out, logs = jtrainer.train_phase_stacked_jit(
        sp, sc, config, jnp.asarray(x), jnp.asarray(ys2), jnp.asarray(fid), keys, 3, 0.003,
        "all_free", n)
    # the JAX trainer's full-batch draws (trainer.py:203, :243) per model
    eps = np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.split(ke)[1], (1, n),
                                               dtype=jnp.float64))
                  for ke in jax.random.split(km, 3)])
        for km in keys], axis=1)
    model_np = (jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, sc), config._asdict())
    want = [np.asarray(a) for a in jax.tree.leaves(out)]
    for leaves, loss, _ in ranks.run(R.train_stacked, 2, model_np, x, ys2, fid, 3, 0.003,
                                     "all_free", n, eps):
        np.testing.assert_allclose(loss, np.asarray(logs.loss), rtol=1e-7)
        for a, b in zip(leaves, want):
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("batch_size", [24, 7])
def test_dp_training_matches_unsharded(ranks, batch_size):
    """Two phases over a (2, 4) mesh (full batch, and minibatches whose
    columns split unevenly over 'dp') against the unsharded trainer on the
    same draws: losses rtol 1e-9; params at tests/test_sharding.py's
    post-Adam bounds, rtol 1e-4 / atol 5e-8 (Adam divides by the root of
    second moments near 0, which scales the rows' summation order: 5e-9 seen
    on entries of 3e-4 after 4 steps)."""
    x, ys, fid, stacked = _model(24, 2, 2, _targets(4), seed=4)
    eps, perms = trainer.draw_chunk(torch.Generator().manual_seed(5), stacked.config, 4, 4, 24,
                                    batch_size, F64, "cpu")
    params, logs = trainer.train_phase_stacked(stacked, _t(x), _t(ys), _t(fid), 4, 0.01,
                                               "all_free", batch_size, eps=eps, perms=perms)
    got = ranks.run(R.train_stacked, 2, model_to_numpy(stacked), x, ys, fid, 4, 0.01,
                    "all_free", batch_size, eps.numpy(), None if perms is None else perms.numpy())
    for leaves, loss, kl in got:
        np.testing.assert_allclose(loss, logs.loss.numpy(), rtol=1e-9)
        np.testing.assert_allclose(kl, logs.kl.numpy(), rtol=1e-9)
        for a, b in zip(leaves, tree_leaves(params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-8)


def test_dp_gradients_match_unsharded(ranks):
    """Each 'dp' rank's rows, the gradients summed over 'dp': the whole
    data's loss (rtol 1e-10) and gradient (each leaf at rtol 1e-8 and 1e-9
    of its largest entry). The untrained models' Kzz (variational
    covariance 1e-8 I, jitter 2e-6) are ill conditioned, so solving 3 rows'
    Kzx instead of 24 moves the rounding by ~cond x eps: 1e-9 of the
    noises' gradients and 5e-10 of the means' largest seen."""
    x, ys, fid, stacked = _model(24, 2, 2, _targets(2), seed=6)
    eps = M.sample_eps(torch.Generator().manual_seed(7), stacked.config, 24, F64, "cpu", (2,))
    params = tree_map(lambda t: t.clone().requires_grad_(True), stacked.params)
    elbo, _ = elbo_terms(params, stacked.consts, stacked.config, _t(x), _t(ys), _t(fid), eps,
                         torch.tensor(24.0, dtype=F64), weights=torch.ones(24, dtype=F64))
    loss = -torch.sum(elbo)
    loss.backward()
    for grads, total in ranks.run(R.dp_gradients, 1, model_to_numpy(stacked), x, ys, fid,
                                  eps.numpy(), 24.0):
        assert total == pytest.approx(float(loss.detach()), rel=1e-10)
        for g, p in zip(grads, tree_leaves(params)):
            want = p.grad.numpy()
            np.testing.assert_allclose(g, want, rtol=1e-8, atol=1e-9 * np.abs(want).max())


def test_inducing_sharded_step_matches_replicated(ranks):
    """tests/test_sharding.py's inducing-dimension case (m = 256, d = 3, two
    models, one step) on a (1, 8) mesh against the replicated step on the
    same draws: loss rtol 1e-9, params rtol 1e-4 / atol 5e-8 (the JAX
    test's bounds)."""
    m = 256
    x, ys, fid, stacked = _model(m, 3, 2, [lambda x: np.sin(3 * x[:, 0]),
                                           lambda x: np.cos(2 * x[:, 1])], seed=0)
    eps, _ = trainer.draw_chunk(torch.Generator().manual_seed(7), stacked.config, 1, 2, m, m,
                                F64, "cpu")
    params, logs = trainer.train_phase_stacked(stacked, _t(x), _t(ys), _t(fid), 1, 0.001,
                                               "all_free", m, eps=eps)
    for leaves, loss in ranks.run(R.inducing_step, 1, model_to_numpy(stacked), x, ys, fid, 1,
                                  0.001, "all_free", eps.numpy()):
        np.testing.assert_allclose(loss, logs.loss.numpy(), rtol=1e-9)
        for a, b in zip(leaves, tree_leaves(params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-8)


def test_inducing_sharded_predictive_takes_k2(ranks):
    """A no-grad forward of an inducing-sharded model (m = 256, d = 3, two
    fidelities, two models) on a (1, 8) mesh runs layer 0 through K2's
    route on the gathered state, once per forward, and equals the
    unsharded forward (rtol 1e-10, atol 1e-12 of the output's scale)."""
    m = 256
    x, ys, fid, stacked = _model(m, 3, 2, [lambda x: np.sin(3 * x[:, 0]),
                                           lambda x: np.cos(2 * x[:, 1])], seed=0)
    xq = np.random.default_rng(5).uniform(size=(40, 3))
    eps = np.random.default_rng(6).normal(size=(2, 1, 40))
    with torch.no_grad():
        want = M.forward(stacked.params, stacked.consts, stacked.config, _t(xq), _t(eps))
    for got, k2_calls in ranks.run(R.inducing_predictive, 1, model_to_numpy(stacked), xq, eps):
        assert k2_calls == 1
        for (mu, var), (mu0, var0) in zip(got, want):
            for a, b in ((mu, mu0.numpy()), (var, var0.numpy())):
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12 * np.abs(b).max())


def _conditioned_problem():
    x, ys, fid, stacked = _model(16, 2, 2, _targets(4), seed=8)
    obj, con = trainer.select_model(stacked, 0, 2), trainer.select_model(stacked, 2, 4)
    rng = np.random.default_rng(9)
    p = 6
    data = C.ConditionedData(
        _t(x), _t(ys[:2]), _t(ys[2:]), _t(fid), _t(rng.uniform(size=(p, 2))),
        _t(rng.normal(size=(p, 2))), torch.as_tensor(np.arange(p) < 5),
        _t(np.array([0.1, -0.2])), _t((np.arange(16) < 14).astype(float)))
    return obj, con, data


@pytest.mark.parametrize("batch_size", [16, 6])
@pytest.mark.parametrize("bb", [2, 1])
def test_conditioned_over_bb_dp_matches_unsharded(ranks, bb, batch_size):
    """The conditioned phase over (bb, dp) = (2, 4) and (1, 8), full batch and
    minibatch, on the same draws: losses rtol 1e-9, params at the post-Adam
    bounds rtol 1e-4 / atol 5e-8 (as test_dp_training_matches_unsharded).
    Covers the global weight sum, the once-counted Pareto and x_tilde terms
    and omega's gather over 'bb'."""
    obj, con, data = _conditioned_problem()
    chunk = C.draw_chunk(torch.Generator().manual_seed(10), data, obj.config, batch_size, 4)
    draws = [C.StepDraws(None if chunk.batch_idx is None else chunk.batch_idx[i],
                         chunk.x_tilde[i], chunk.eps[i]) for i in range(4)]
    op, cp, losses = C.train_conditioned(obj.params, con.params, obj.consts, con.consts,
                                         obj.config, data, None, 4, 0.001, 1e-8, batch_size,
                                         draws=draws)
    data_np = [None if a is None else a.numpy() for a in data]
    draws_np = [tuple(None if a is None else a.numpy() for a in d) for d in draws]
    want = tree_leaves(op) + tree_leaves(cp)
    for ol, cl, got in ranks.run(R.conditioned, bb, model_to_numpy(obj), model_to_numpy(con),
                                 data_np, batch_size, draws_np, 4, 0.001, 1e-8):
        np.testing.assert_allclose(got, losses.numpy(), rtol=1e-9)
        for a, b in zip(ol + cl, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-8)


def test_three_forward_conditioned_over_bb_dp_matches_unsharded(ranks):
    """MOBOCMF_FUSED_COND=0's three-forward loss over (bb, dp) = (2, 4),
    minibatches of 6, against the unsharded three-forward phase on the same
    draws, at test_conditioned_over_bb_dp_matches_unsharded's bounds: the
    same three rules hold with x_tilde's own forward."""
    obj, con, data = _conditioned_problem()
    chunk = C.draw_chunk(torch.Generator().manual_seed(11), data, obj.config, 6, 4)
    draws = [C.StepDraws(chunk.batch_idx[i], chunk.x_tilde[i], chunk.eps[i]) for i in range(4)]
    op, cp, losses = C.train_conditioned(obj.params, con.params, obj.consts, con.consts,
                                         obj.config, data, None, 4, 0.001, 1e-8, 6, draws=draws,
                                         fused=False)
    data_np = [None if a is None else a.numpy() for a in data]
    draws_np = [tuple(a.numpy() for a in d) for d in draws]
    want = tree_leaves(op) + tree_leaves(cp)
    for ol, cl, got in ranks.run(R.conditioned, 2, model_to_numpy(obj), model_to_numpy(con),
                                 data_np, 6, draws_np, 4, 0.001, 1e-8, False):
        np.testing.assert_allclose(got, losses.numpy(), rtol=1e-9)
        for a, b in zip(ol + cl, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-8)


def test_flat_adam_training_over_bb_dp_matches_unsharded(ranks, monkeypatch):
    """MOBOCMF_FLAT_ADAM=1 on every rank and here: stacked minibatch training
    over (bb, dp) = (2, 4), one flat gradient all-reduced over 'dp', against
    the unsharded flat phase on the same draws, at
    test_dp_training_matches_unsharded's bounds."""
    monkeypatch.setenv("MOBOCMF_FLAT_ADAM", "1")
    x, ys, fid, stacked = _model(24, 2, 2, _targets(4), seed=4)
    eps, perms = trainer.draw_chunk(torch.Generator().manual_seed(6), stacked.config, 4, 4, 24,
                                    7, F64, "cpu")
    params, logs = trainer.train_phase_stacked(stacked, _t(x), _t(ys), _t(fid), 4, 0.01,
                                               "fix_variational_hypers", 7, eps=eps, perms=perms)
    got = ranks.run(R.train_stacked, 2, model_to_numpy(stacked), x, ys, fid, 4, 0.01,
                    "fix_variational_hypers", 7, eps.numpy(), perms.numpy(), True)
    for leaves, loss, kl in got:
        np.testing.assert_allclose(loss, logs.loss.numpy(), rtol=1e-9)
        np.testing.assert_allclose(kl, logs.kl.numpy(), rtol=1e-9)
        for a, b in zip(leaves, tree_leaves(params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=5e-8)


def test_gains_and_search_over_bb_match_unsharded(ranks):
    """The pair stack (4 blackboxes, 2 per 'bb' rank) on a (2, 4) mesh: the
    gains and the gradient of their sum in x at rtol 1e-7 / atol 1e-9 (the
    untrained factors are ill conditioned, and a rank solves 4 of the 8
    models' systems in one batch: 7e-8 seen), the all-fidelity search from
    the same raw points by value (rtol 1e-6), and every rank's search
    identical (its line searches took the same branches)."""
    x, ys, fid, su = _model(16, 2, 2, _targets(4), seed=11)
    sc = su._replace(params=tree_map(lambda t: t * 1.01, su.params))
    args = (su.params, su.consts, sc.params, sc.consts, su.config)
    rng = np.random.default_rng(12)
    grid, raw = rng.uniform(size=(9, 2)), rng.uniform(size=(20, 2))
    gains, grads = [], []
    for f in range(2):
        xg = _t(grid).requires_grad_(True)
        g = jesmoc.coupled_acq_stacked(*args, f, xg)
        torch.sum(g).backward()
        gains.append(g.detach().numpy())
        grads.append(xg.grad.numpy())
    xs0, vals0 = jesmoc.optimize_coupled_jes_all_fidelities(
        *args, None, 2, num_restarts=2, raw_samples=20, maxiter=25, raw=_t(raw))
    got = ranks.run(R.jes, 2, (model_to_numpy(su), model_to_numpy(sc)), grid, raw, 25)
    for g, gr, xs, vals in got:
        np.testing.assert_allclose(g, np.stack(gains), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(gr, np.stack(grads), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(vals, vals0.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(xs, got[0][2])
        np.testing.assert_array_equal(vals, got[0][3])


def test_rff_feature_sharding(ranks):
    """Layer-0 features over 'dp' (8 of 64 per rank): the values and their
    gradient in x equal the whole sample's, rtol 1e-12 / 1e-10."""
    grid = np.random.default_rng(13).uniform(size=(11, 2))
    for v, g, v0, g0 in ranks.run(R.rff_features, 1, 14, 64, grid):
        np.testing.assert_allclose(v, v0, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g, g0, rtol=1e-10, atol=1e-13)


def test_bo_loop_mesh_writes_the_unsharded_logs(ranks, tmp_path):
    """One tiny iteration of run_bo_loop with BOConfig.mesh on a (1, 8) mesh:
    rank 0 writes the unsharded loop's file set with its values (rtol
    1e-8), and every rank ends with the same BOState."""
    kw = dict(num_epochs_1=5, num_epochs_2=8, opt_grid_size=25, pareto_set_size=6, seed=1,
              acq_maxiter=30, acq_raw_samples=30, num_bo_iterations=1)
    rng = np.random.default_rng(0)
    x, fid = rng.uniform(size=(12, 2)), np.concatenate([np.zeros(8), np.ones(4)]).astype(int)
    ref_dir, mesh_dir = tmp_path / "ref", tmp_path / "mesh"
    ref = PL.run_bo_loop(R.loop_blackboxes(), x, fid,
                         PL.BOConfig(**kw, log_dir=str(ref_dir), device="cpu", dtype=F64))
    states = ranks.run(R.bo_loop, 1, x, fid, kw, str(mesh_dir))
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in mesh_dir.iterdir()) == names
    for name in ("points_evaluated.txt", "fidelities_evaluated.txt",
                 "observed_hypervolumes.txt", "pareto_resamples.txt", "process_starts.txt"):
        np.testing.assert_allclose(np.loadtxt(mesh_dir / name), np.loadtxt(ref_dir / name),
                                   rtol=1e-8)
    for sx, sf, sys_, shv in states:
        np.testing.assert_array_equal(sx, states[0][0])
        np.testing.assert_array_equal(sf, ref.fidelities)
        np.testing.assert_allclose(sx, ref.x, rtol=1e-8)
        for k in ref.ys:
            np.testing.assert_array_equal(sys_[k], states[0][2][k])
        assert shv == states[0][3]


def test_dryrun_tiny_on_the_pool(ranks):
    """The dry run's body (the JAX dry run's stages) on a (2, 4) mesh held to
    the unsharded body in this process (parallel/dryrun.py's tolerances), at
    the dry run's f64: the tiny problem's f32 ELBO (noises 1e-6, 16 rows of
    random targets) is off by 0.3 % from one summation order to another."""
    outs = ranks.run(dryrun._rank, "tiny", 2, "cpu")
    ref = dryrun.body(dryrun.TINY, 2, 4, None, torch.device("cpu"))
    rows = dryrun.compare(outs, ref, torch.device("cpu"))
    assert len(rows) == WORLD and all(r["transport"] == "host" for r in rows)
    assert all(not ph["captured"] for ph in outs[0]["phases"])


def test_launcher_raises_on_a_failed_rank_and_on_a_hung_one():
    """A rank that raises, or that hangs past the run's limit, fails the run
    naming the rank, and every rank is killed."""
    with pytest.raises(RuntimeError, match=r"rank 1 raised(.|\n)*fails on purpose"):
        launch.run(R.fail, 2, device="cpu", timeout_s=60, threads=1)
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] did not finish within 3 s"):
        launch.run(R.hang, 2, device="cpu", timeout_s=3, threads=1)
