"""The port's CUDA path on the card: K1 and K2 against their plain versions,
a short f64 training run on the card against the same run on the CPU, and
the K2 route of the acquisition predictive against the plain route.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.linalg import chol, fused_svgp, ops
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.util.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 and K2 kernels run on the card only")
    return torch.device("cuda")


def _spd(batch, n, seed, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((batch, n, n), generator=g, dtype=torch.float64)
    a = a @ a.mT / n + torch.eye(n, dtype=torch.float64)
    return a.to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch,n", [(1, 128), (3, 200), (4, 384), (3, 512)])
def test_kernel_matches_plain(cuda_device, dtype, batch, n):
    a = _spd(batch, n, n, dtype, cuda_device)
    jit = torch.full((batch,), 1e-6, dtype=dtype, device=cuda_device)
    counters.reset()
    got, level = chol.cholesky(a, jitter=jit, ladder=True)
    assert counters.get("k1.launches") == 1
    want, want_level = chol.cholesky_plain(a, jit, True)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < (1e-5 if dtype == torch.float32 else 1e-12), rel
    assert torch.equal(level, want_level)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


def _check_against_plain(a, jit, got, level, dtype):
    want, want_level = chol.cholesky_plain(a, jit, True)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    a_j = a.double() + jit.double()[:, None, None] * eye
    recon = ((got.double() @ got.double().mT - a_j).abs().max() / a_j.abs().max()).item()
    tol_rel, tol_recon = (1e-4, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
    assert rel < tol_rel and recon < tol_recon, (rel, recon)
    assert torch.equal(level, want_level)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


# both sides of the resident / L2 boundary of plan(), both cluster sizes,
# ragged n and n below one tile
@pytest.mark.parametrize("dtype,batch,n,cluster,resident", [
    (torch.float32, 2, 1, 8, True),
    (torch.float32, 2, 31, 8, True),
    (torch.float32, 3, 256, 8, True),
    (torch.float32, 3, 512, 16, True),
    (torch.float32, 2, 1000, 16, True),
    (torch.float32, 2, 1024, 16, True),
    (torch.float32, 2, 1280, 16, False),
    (torch.float64, 2, 200, 8, True),
    (torch.float64, 2, 512, 16, True),
    (torch.float64, 2, 768, 16, True),
    (torch.float64, 2, 1024, 16, False),
])
def test_kernel_plan_storage_and_cluster(cuda_device, dtype, batch, n, cluster, resident):
    pl = chol.plan(n, dtype)
    assert (pl.cluster, pl.resident) == (cluster, resident)
    assert chol.max_active_clusters(pl, dtype) >= 1
    a = _spd(batch, n, n + 1, dtype, cuda_device)
    jit = torch.full((batch,), 1e-6, dtype=dtype, device=cuda_device)
    counters.reset()
    got, level = chol.cholesky(a, jitter=jit, ladder=True)
    assert counters.get("k1.launches") == 1
    _check_against_plain(a, jit, got, level, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [200, 384])
@pytest.mark.parametrize("cluster", [8, 16])
def test_kernel_forced_storage_agrees(cuda_device, dtype, n, cluster):
    """The same matrices through both storages and both cluster sizes."""
    a = _spd(3, n, 5, dtype, cuda_device)
    jit = torch.full((3,), 1e-6, dtype=dtype, device=cuda_device)
    size = torch.finfo(dtype).bits // 8
    for resident in (True, False):
        pl = chol.Plan(cluster, resident, chol.smem_bytes(n, size, cluster, resident))
        got, level = chol._launch(a, jit, True, pl)
        _check_against_plain(a, jit, got, level, dtype)


def test_kernel_nan_on_indefinite_and_ladder(cuda_device):
    a = _spd(3, 256, 1, torch.float32, cuda_device)
    a[1, 100, 100] = -1.0e4
    l, level = chol.cholesky(a, jitter=1e-6, ladder=False)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    assert bool(torch.isnan(diag[1, 100:]).all())
    assert bool(torch.isfinite(l[[0, 2]]).all())
    l, level = chol.cholesky(a, jitter=1e-6, ladder=True)
    assert level.tolist() == [0, 2, 0]
    # a matrix with a small negative eigenvalue climbs one rung and ends finite
    w, v = torch.linalg.eigh(_spd(1, 256, 2, torch.float64, "cpu")[0])
    w[0] = -1e-5 * w.mean()
    k = ((v * w) @ v.T).to(device=cuda_device, dtype=torch.float32)
    l, level = chol.cholesky(k, jitter=2e-6, ladder=True)
    want, want_level = chol.cholesky_plain(k[None], torch.full((1,), 2e-6, device=cuda_device), True)
    assert level.item() == 1 == want_level.item()
    assert bool(torch.isfinite(l).all())


def test_safe_cholesky_gradient_on_card_matches_cpu(cuda_device):
    k = _spd(2, 96, 3, torch.float64, "cpu")
    w = torch.linspace(0.0, 1.0, 96, dtype=torch.float64)
    grads = []
    for dev in ("cpu", cuda_device):
        kk = k.to(dev).clone().requires_grad_(True)
        torch.sum(torch.sin(ops.safe_cholesky(kk, 2e-6)) * w.to(dev)).backward()
        grads.append(kk.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-10, atol=1e-12)


def test_f64_training_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    fid = np.arange(40) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    eps = torch.randn((6, 2, 1, 40), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    runs = []
    for dev in ("cpu", cuda_device):
        models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        model = trainer.stack_models(models)
        counters.reset()
        params, logs = trainer.train_phase_stacked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), 6, 0.003, "all_free", 40, eps=eps.to(dev),
        )
        if dev != "cpu":
            assert counters.get("k1.launches") == 2 * 6
        runs.append(logs.loss.cpu())
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-8, atol=0.0)


def _k2_problem(batch, m, n, d, dtype, device):
    rng = np.random.default_rng(m + n)
    vals = (rng.uniform(size=(m, d)), rng.uniform(size=(n, d)), rng.normal(size=(batch, m)),
            np.tril(rng.normal(size=(batch, m, m)) * 0.05) + 0.3 * np.eye(m),
            np.full((batch, d), 0.15), np.full((batch,), 1.3), np.full((batch,), 1e-2))
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in vals]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch,m,n,d", [(1, 128, 128, 3), (1, 100, 150, 3), (8, 128, 200, 2),
                                         (6, 512, 200, 2), (2, 77, 45, 1)])
def test_k2_matches_plain(cuda_device, dtype, batch, m, n, d):
    args = _k2_problem(batch, m, n, d, dtype, cuda_device)
    counters.reset()
    with torch.no_grad():
        mu, var = fused_svgp.fused_rbf_svgp_forward(*args)
        mu_p, var_p = fused_svgp.fused_rbf_svgp_forward_plain(*args)
    torch.cuda.synchronize()
    assert counters.get("k2.launches") == 1
    tol = 2e-3 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(mu, mu_p, rtol=tol, atol=tol)
    torch.testing.assert_close(var, var_p, rtol=tol, atol=tol)


# every stripe width, forced, with ragged M and N (the last
# panel shorter than 32 rows, the last stripe narrower than W)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [32, 16, 8, 4])
@pytest.mark.parametrize("batch,m,n", [(2, 100, 45), (3, 257, 70), (1, 31, 5)])
def test_k2_every_stripe_width(cuda_device, dtype, width, batch, m, n):
    args = _k2_problem(batch, m, n, 2, dtype, cuda_device)
    size = torch.finfo(dtype).bits // 8
    sp = fused_svgp.Plan(width, fused_svgp.solve_smem_bytes(m, width, size))
    with torch.no_grad():
        mu, var = fused_svgp._launch(*args, sp=sp)
        mu_p, var_p = fused_svgp.fused_rbf_svgp_forward_plain(*args)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(mu, mu_p, rtol=tol, atol=tol)
    torch.testing.assert_close(var, var_p, rtol=tol, atol=tol)


# the plan's own choice at the main path's shapes and at each M the plan
# narrows the stripe for
@pytest.mark.parametrize("dtype,batch,m,n", [
    (torch.float32, 6, 512, 1000), (torch.float32, 3, 512, 1000), (torch.float32, 3, 1024, 200),
    (torch.float32, 3, 2048, 200), (torch.float64, 3, 1024, 200), (torch.float32, 3, 490, 199),
])
def test_k2_plan_shapes(cuda_device, dtype, batch, m, n):
    args = _k2_problem(batch, m, n, 2, dtype, cuda_device)
    with torch.no_grad():
        mu, var = fused_svgp.fused_rbf_svgp_forward(*args)
        mu_p, var_p = fused_svgp.fused_rbf_svgp_forward_plain(*args)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(mu, mu_p, rtol=tol, atol=tol)
    torch.testing.assert_close(var, var_p, rtol=tol, atol=tol)


def test_k2_rejects_a_plan_that_cannot_launch(cuda_device):
    args = _k2_problem(1, 64, 10, 2, torch.float32, cuda_device)
    good = fused_svgp.plan(64, 10, 1, torch.float32)
    short = good._replace(smem_bytes=good.smem_bytes - 4)
    with torch.no_grad(), pytest.raises(RuntimeError, match="failed to launch"):
        fused_svgp._launch(*args, sp=short)


def test_k2_nan_on_a_failed_factor(cuda_device):
    args = _k2_problem(2, 64, 10, 2, torch.float32, cuda_device)
    args[6][1] = -10.0  # a negative jitter makes the second Gram indefinite
    with torch.no_grad():
        mu, var = fused_svgp.fused_rbf_svgp_forward(*args)
    assert bool(torch.isfinite(mu[0]).all()) and bool(torch.isnan(mu[1]).any())
    assert bool(torch.isnan(var[1]).any())


def test_acquisition_predictive_k2_route_matches_plain_f64(cuda_device):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(30, 2))
    fid = np.arange(30) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                           device=cuda_device, dtype=torch.float64) for i, y in enumerate(ys)]
    model = trainer.stack_models(models)
    xq = torch.as_tensor(x[:9] + 0.01, device=cuda_device)
    counters.reset()
    with torch.no_grad():
        via_k2 = M.predict_for_acquisition_all(model.params, model.consts, model.config, xq)
    assert counters.get("k2.launches") == 1
    plain = M.predict_for_acquisition_all(model.params, model.consts, model.config, xq)
    for a, b in zip(via_k2, plain):
        torch.testing.assert_close(a, b.detach(), rtol=1e-9, atol=1e-12)


def _bowl(shift, offset):
    return lambda xs: (np.atleast_2d(xs)[:, 0] - shift) ** 2 + np.atleast_2d(xs)[:, 1] ** 2 + offset


def test_bo_loop_fast_iteration_on_card(cuda_device, tmp_path):
    """One --fast-sized iteration of run_bo_loop on the card, with the
    recommendation: K1 trains, K2 screens and recommends, the logs are
    written."""
    from mobocmf_tpu_torch.bo import loop

    con = lambda xs: 0.55 - np.atleast_2d(xs)[:, 0]  # noqa: E731
    bbs = [loop.Blackbox("obj1", [_bowl(0.25, 0.3), _bowl(0.25, 0.0)]),
           loop.Blackbox("obj2", [_bowl(0.75, 0.3), _bowl(0.75, 0.0)]),
           loop.Blackbox("con1", [con, con], is_constraint=True, threshold=0.0)]
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(12, 2))
    fid = np.concatenate([np.zeros(8), np.ones(4)]).astype(int)
    config = loop.BOConfig(num_bo_iterations=1, num_epochs_1=5, num_epochs_2=8, opt_grid_size=25,
                           pareto_set_size=6, seed=1, log_dir=str(tmp_path),
                           track_recommendation=True, recommendation_grid_size=200)
    counters.reset()
    state = loop.run_bo_loop(bbs, x, fid, config)
    assert counters.get("k1.launches") > 2 * (5 + 8) and counters.get("k2.launches") >= 2
    assert state.x.shape == (13, 2) and bool(((state.x >= 0) & (state.x <= 1)).all())
    phases = np.loadtxt(tmp_path / "phase_seconds.txt")
    assert phases.shape == (8,) and np.isfinite(phases).all() and phases[3] > 0
    assert np.loadtxt(tmp_path / "hypervolumes.txt").shape == (6,)


def _card_fitter(device):
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(12, 2))
    fid = np.arange(12) % 2
    f = BlackBoxMFDGPFitter(2, 12, num_epochs_1=3, num_epochs_2=3, opt_grid_size=20,
                            pareto_set_size=5, pad_data=True, seed=3, device=device)
    f.initialize_mfdgp(x, np.sin(3 * x[:, 0]) + x[:, 1], fid, "obj1")
    f.initialize_mfdgp(x, np.cos(2 * x[:, 1]), fid, "obj2")
    f.initialize_mfdgp(x, 0.5 - x[:, 0], fid, "con1", is_constraint=True)
    f.train_mfdgps()
    return f


def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    from mobocmf_tpu_torch.util import checkpoint
    from mobocmf_tpu_torch.util.tree import tree_leaves

    f = _card_fitter(cuda_device)
    checkpoint.save_fitter(str(tmp_path / "ck"), f)
    r = checkpoint.restore_fitter(str(tmp_path / "ck"))
    assert r.device.type == "cuda" and r.dtype == torch.float32
    for name in f.obj_names:
        for a, b in zip(tree_leaves(f.models_objs[name]), tree_leaves(r.models_objs[name])):
            if isinstance(a, torch.Tensor):
                assert b.device.type == "cuda" and torch.equal(a, b)
    assert torch.equal(f.generator.get_state(), r.generator.get_state())
    s1 = f.sample_and_store_pareto_solution()
    s2 = r.sample_and_store_pareto_solution()
    for a, b in zip(s1[:3], s2[:3]):
        assert torch.equal(a, b)


def test_device_polish_on_card_matches_cpu_f64(cuda_device):
    """The device polish of one objective of a trained f64 model's RFF
    samples, on the card and on the CPU from the same samples and grid."""
    from mobocmf_tpu_torch.moop.moop import MOOP, SampledFunction
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.util.tree import tree_map

    samples = [rff.sample_prior(torch.Generator().manual_seed(i), 2, 2, n_features=50,
                                device="cpu") for i in range(3)]
    grid = np.random.default_rng(5).uniform(size=(80, 2))
    out = []
    for dev in ("cpu", cuda_device):
        fns = [SampledFunction(rff.eval_sample_fn, tree_map(lambda t: t.to(dev), s))
               for s in samples]
        m = MOOP(fns[:2], fns[2:], input_dim=2, feasible_values=np.array([-0.5]),
                 polish="device")
        like = torch.zeros((), dtype=torch.float64, device=dev)
        with torch.no_grad():
            cons = torch.stack([f(torch.as_tensor(grid, device=dev)) for f in fns[2:]])
            evals = fns[0](torch.as_tensor(grid, device=dev)).cpu().numpy()
        feas = m._feasible_mask(cons.cpu().numpy(), True)
        out.append(m.optimize_obj_globally_device(0, evals, feas, grid, like))
    assert (out[0] is None) == (out[1] is None)
    if out[0] is not None:
        np.testing.assert_allclose(out[1], out[0], rtol=1e-7, atol=1e-9)


def _search_state():
    """A small trained and conditioned f64 state (14 points, 3 blackboxes,
    5 + 5 epochs, on the CPU) and 40 fixed raw points."""
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

    names = [("o1", False), ("o2", False), ("c1", True)]
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(14, 2))
    fid = np.arange(14) % 2
    ys = [np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0],
          0.3 - np.sum((x - 0.5) ** 2, 1)]
    f = BlackBoxMFDGPFitter(2, 14, num_epochs_1=5, num_epochs_2=5, opt_grid_size=20,
                            pareto_set_size=4, seed=1, device="cpu", dtype=torch.float64)
    for (name, is_con), y in zip(names, ys):
        f.initialize_mfdgp(x, y, fid, name, is_constraint=is_con)
    f.train_mfdgps()
    cond = f.copy_uncond()
    cond.sample_and_store_pareto_solution()
    cond.train_conditioned_mfdgps()
    su = trainer.stack_models([f.get_model(n, c) for n, c in names])
    sc = trainer.stack_models([cond.get_model(n, c) for n, c in names])
    raw = torch.rand((40, 2), generator=torch.Generator().manual_seed(11), dtype=torch.float64)
    return su, sc, raw


def _search_on(dev, su, sc, raw):
    """The all-fidelity search of `_search_state` on `dev`: (xs, values,
    lbfgs.last_stats)."""
    from mobocmf_tpu_torch.acquisition import jesmoc, lbfgs
    from mobocmf_tpu_torch.util.tree import tree_map

    pair = [tree_map(lambda t: t.to(dev), t) for t in (su.params, su.consts, sc.params,
                                                        sc.consts)]
    xs, vals = jesmoc.optimize_coupled_jes_all_fidelities(
        *pair, su.config, None, 2, raw_samples=40, maxiter=200, raw=raw.to(dev))
    return xs.cpu(), vals.cpu(), dict(lbfgs.last_stats)


def test_f64_search_on_card_matches_cpu(cuda_device):
    """The all-fidelity search of a small trained and conditioned f64 state
    from 40 fixed raw points, on the card and on the CPU: both run optax's
    L-BFGS (acquisition/lbfgs.py), so the points agree to 1e-8 and the
    values to 1e-10, and every lane takes the same number of iterations."""
    su, sc, raw = _search_state()
    out = [_search_on(dev, su, sc, raw) for dev in ("cpu", cuda_device)]
    (x_c, v_c, st_c), (x_g, v_g, st_g) = out
    np.testing.assert_allclose(x_g.numpy(), x_c.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(v_g.numpy(), v_c.numpy(), rtol=1e-10)
    assert st_g["lane_iterations"] == st_c["lane_iterations"]


def _eager(monkeypatch):
    """The L-BFGS pieces run eagerly on the card (capture_rule says so)."""
    from mobocmf_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "capture_rule", lambda collectives: (False, "eager"))


def test_captured_search_matches_eager_f64(cuda_device, monkeypatch):
    """The same search with its L-BFGS pieces replayed from CUDA graphs and
    with capture off: points within 1e-12, the same iterations per lane and
    evaluations, the captured run replayed its graphs."""
    su, sc, raw = _search_state()
    x_g, v_g, st_g = _search_on(cuda_device, su, sc, raw)
    _eager(monkeypatch)
    x_e, v_e, st_e = _search_on(cuda_device, su, sc, raw)
    assert st_g["captured"] and st_g["replays"] > 0 and not st_e["captured"]
    np.testing.assert_allclose(x_g.numpy(), x_e.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v_g.numpy(), v_e.numpy(), rtol=1e-12)
    assert st_g["lane_iterations"] == st_e["lane_iterations"]
    assert st_g["evaluations"] == st_e["evaluations"]


def test_search_replays_without_a_host_sync(cuda_device, monkeypatch):
    """Every graph replay of a captured search runs under
    set_sync_debug_mode("error"): none synchronizes with the host."""
    su, sc, raw = _search_state()
    inner, replays = torch.cuda.CUDAGraph.replay, []

    def replay(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(graph)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        replays.append(1)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    _, vals, st = _search_on(cuda_device, su, sc, raw)
    assert st["captured"] and len(replays) == st["replays"] > 0
    assert bool(torch.isfinite(vals).all())


def test_captured_device_polish_matches_eager_f64(cuda_device, monkeypatch):
    """The MOOP's device polish (optax's L-BFGS, 100 iterations) captured on
    the card against the same polish with capture off: the same point to
    1e-12 and the same evaluations."""
    from mobocmf_tpu_torch.acquisition import lbfgs
    from mobocmf_tpu_torch.moop.moop import MOOP, SampledFunction
    from mobocmf_tpu_torch.sampling import rff
    from mobocmf_tpu_torch.util.tree import tree_map

    samples = [rff.sample_prior(torch.Generator().manual_seed(i), 2, 2, n_features=50,
                                device="cpu") for i in range(3)]
    fns = [SampledFunction(rff.eval_sample_fn, tree_map(lambda t: t.to(cuda_device), s))
           for s in samples]
    m = MOOP(fns[:2], fns[2:], input_dim=2, feasible_values=np.array([-0.5]), polish="device")
    grid = np.random.default_rng(5).uniform(size=(80, 2))
    like = torch.zeros((), dtype=torch.float64, device=cuda_device)
    with torch.no_grad():
        g = torch.as_tensor(grid, device=cuda_device)
        cons = torch.stack([f(g) for f in fns[2:]]).cpu().numpy()
        evals = fns[0](g).cpu().numpy()
    feas = m._feasible_mask(cons, True)
    got = m.optimize_obj_globally_device(0, evals, feas, grid, like)
    st = dict(lbfgs.last_stats)
    _eager(monkeypatch)
    want = m.optimize_obj_globally_device(0, evals, feas, grid, like)
    assert st["captured"] and st["replays"] > 0 and not lbfgs.last_stats["captured"]
    assert got is not None and want is not None
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert st["evaluations"] == lbfgs.last_stats["evaluations"]
    assert st["lane_iterations"] == lbfgs.last_stats["lane_iterations"] == [100] * 5


# -- the exact-GP family's path: K1 at n = 32 without the ladder -------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("batch,n", [(1, 32), (3, 32), (1, 24), (3, 40)])
def test_kernel_small_n_matches_plain(cuda_device, dtype, ladder, batch, n):
    a = _spd(batch, n, 100 + n, dtype, cuda_device)
    jit = torch.full((batch,), 1e-6, dtype=dtype, device=cuda_device)
    counters.reset()
    got, level = chol.cholesky(a, jitter=jit, ladder=ladder)
    assert counters.get("k1.launches") == 1
    want, want_level = chol.cholesky_plain(a, jit, ladder)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < (1e-5 if dtype == torch.float32 else 1e-12), rel
    assert torch.equal(level, want_level)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


def test_no_ladder_cholesky_gradient_f64(cuda_device):
    """ops.cholesky (K1 forward, chol_pullback backward) passes gradcheck on
    the card at f64, and its gradient equals torch.linalg.cholesky's."""
    k = _spd(1, 32, 7, torch.float64, cuda_device)[0]

    def sym_chol(m):
        return ops.cholesky(0.5 * (m + m.mT))

    kk = k.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(sym_chol, (kk,), eps=1e-6, atol=1e-7)
    w = torch.linspace(0.0, 1.0, 32, dtype=torch.float64, device=cuda_device)
    (g,) = torch.autograd.grad(torch.sum(torch.sin(sym_chol(kk)) * w), kk)
    k2 = k.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        torch.sum(torch.sin(torch.linalg.cholesky(0.5 * (k2 + k2.mT))) * w), k2)
    torch.testing.assert_close(g, want, rtol=1e-10, atol=1e-12)


def test_mfgp_fit_on_card_matches_cpu(cuda_device):
    from mobocmf_tpu_torch.models import mfgp as G

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(28, 2))
    fid = (np.arange(28) % 2).astype(float)
    xf = np.concatenate([x, fid[:, None]], axis=1)
    xf = np.concatenate([xf, np.full((4, 3), 0.5)])
    xf[28:, 2] = 0.0
    y = np.concatenate([np.sin(3 * x[:, 0]) + 0.5 * x[:, 1], np.zeros(4)])
    valid = np.arange(32) < 28
    xs = torch.as_tensor(rng.uniform(size=(9, 2)))
    out = []
    for dev in ("cpu", cuda_device):
        counters.reset()
        m = G.fit_mfgp(G.init_mfgp(xf, y, 2, row_valid=valid, device=dev, dtype=torch.float64),
                       num_iters=20)
        if dev != "cpu":
            assert counters.get("k1.launches") == 20
        mean, var = G.predict(m, xs.to(dev), 1)
        out.append([t.cpu() for t in (m.params.raw_noise, mean, var)])
    for a, b in zip(out[1], out[0]):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12)


def _chunk_problem(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    return x, fid, ys


def _assert_rel(got, want, bound=1e-8):
    """Each tensor within `bound` of the CPU's, relative to its largest
    entry (chip_smoke.py's measure)."""
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        scale = max(float(b.abs().max()), 1e-300)
        assert float((a - b).abs().max()) / scale < bound, (a, b)


def _predictive(params, model, dev, d=2):
    """The trained models' acquisition predictive (plain route) at 9 points,
    on the CPU. Raw parameters are not compared: Adam moves some entries
    from ~0, where it scales the devices' ~1e-13 gradient differences by
    lr / eps (3e5)."""
    xq = torch.as_tensor(np.random.default_rng(9).uniform(size=(9, d)), device=dev)
    return [t.cpu() for t in M.predict_for_acquisition_all(params, model.consts, model.config, xq)]


@pytest.mark.parametrize("batch_size", [40, 16])
def test_captured_chunks_match_eager_cpu_f64(cuda_device, monkeypatch, batch_size):
    """A phase cut into chunks of 2 epochs (2 + 2 + 1), replayed from a CUDA
    graph on the card, against the same phase run eagerly on the CPU from
    the same draws; K1 launches = one eager step's (2) x the steps."""
    monkeypatch.setattr(trainer, "chunk_size_for", lambda m: 2)
    x, fid, ys = _chunk_problem()
    epochs, nb = 5, 3 if batch_size == 16 else 1
    g = torch.Generator().manual_seed(1)
    eps = torch.randn((epochs, 2, 1, 16 * nb if nb > 1 else 40), generator=g,
                      dtype=torch.float64)
    perms = torch.argsort(torch.rand((epochs, 2, 40), generator=g), dim=-1) if nb > 1 else None
    runs = []
    for dev in ("cpu", cuda_device):
        models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        model = trainer.stack_models(models)
        counters.reset()
        stats = {}
        params, logs = trainer.train_phase_stacked_chunked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), epochs, 0.003, "all_free", batch_size,
            eps=eps.to(dev), perms=None if perms is None else perms.to(dev), stats=stats,
        )
        if dev != "cpu":
            assert counters.get("k1.launches") == 2 * nb * epochs
            assert stats["replays"] == epochs - 2 and stats["chunks"] == 3
            assert stats["capture_seconds"] > 0
        runs.append([logs.loss, logs.kl] + _predictive(params, model, dev))
    _assert_rel(runs[1], runs[0])


def test_captured_three_fidelity_chunks_match_eager_cpu_f64(cuda_device, monkeypatch):
    """Three fidelities (F = 3, d = 6, m = 48, DTLZ2-like targets): a full-batch
    phase in chunks of 2 epochs, replayed from a CUDA graph on the card,
    against the same phase run eagerly on the CPU from the same draws. Both
    build F layer states a step through the explicit inverse, and the
    inverse route's GEMM operations per step (counted at the capture on the
    card, from the eager steps on the CPU) agree exactly."""
    from mobocmf_tpu_torch.fit import graphs

    monkeypatch.setattr(trainer, "chunk_size_for", lambda m: 2)
    n, d, nf, epochs = 48, 6, 3, 5
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(n, d))
    fid = np.repeat(np.arange(nf), [24, 12, 12])
    ys = np.stack([np.cos(0.5 * np.pi * x[:, 0]) + np.sum((x[:, 2:] - 0.5) ** 2, axis=1)
                   + 0.1 * (nf - 1 - fid) * np.mean(np.sin(6 * np.pi * x), axis=1),
                   np.sin(0.5 * np.pi * x[:, 0]) * (1 + np.sum((x[:, 2:] - 0.5) ** 2, axis=1))])
    eps = torch.randn((epochs, 2, nf - 1, n), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    runs, per_step = [], []
    for dev in ("cpu", cuda_device):
        models = [M.init_mfdgp(x, y, fid, nf, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        model = trainer.stack_models(models)
        counters.reset()
        stats = {}
        params, logs = trainer.train_phase_stacked_chunked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), epochs, 0.003, "all_free", n,
            eps=eps.to(dev), stats=stats,
        )
        assert stats["inv_states"] == counters.get("inv.states") == nf * epochs
        if dev != "cpu":
            assert stats["replays"] == epochs - 2 and stats["chunks"] == 3
            assert graphs.inv_gemm_flops_per_step == stats["inv_gemm_flops_per_step"]
        per_step.append(stats["inv_gemm_flops_per_step"])
        runs.append([logs.loss, logs.kl] + _predictive(params, model, dev, d))
    assert per_step[0] > 0 and per_step[1] == per_step[0]
    _assert_rel(runs[1], runs[0])


def test_captured_conditioned_chunks_match_eager_cpu_f64(cuda_device, monkeypatch):
    """A conditioned phase in chunks of 2 steps (2 + 2 + 1) on the card
    against the CPU, from the same draws; K1: 2 launches a step."""
    from mobocmf_tpu_torch.fit import conditioned as C

    monkeypatch.setattr(trainer, "chunk_size_for", lambda m: 2)
    x, fid, ys = _chunk_problem(24, seed=2)
    rng = np.random.default_rng(3)
    pset, pfront = rng.uniform(size=(4, 2)), rng.normal(size=(4, 1))
    steps = 5
    runs = []
    for dev in ("cpu", cuda_device):
        models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        t = lambda a, **kw: torch.as_tensor(a, device=dev, **kw)
        data = C.ConditionedData(
            x=t(x), ys_obj=t(ys[:1]), ys_con=t(ys[1:]), fidelities=t(fid), pareto_set=t(pset),
            pareto_front=t(pfront), front_mask=t([True, True, True, False]),
            thresholds=t([0.1], dtype=torch.float64))
        if dev == "cpu":
            chunk = C.draw_chunk(torch.Generator().manual_seed(4), data, models[0].config, 24,
                                 steps)
        draws = [C.StepDraws(None, chunk.x_tilde[i].to(dev), chunk.eps[i].to(dev))
                 for i in range(steps)]
        counters.reset()
        stats = {}
        op, cp, losses = C.train_conditioned_chunked(
            models[0].params, models[1].params, models[0].consts, models[1].consts,
            models[0].config, data, None, steps, 0.01, 1e-8, 24, draws=draws, stats=stats)
        if dev != "cpu":
            assert counters.get("k1.launches") == 2 * steps and stats["replays"] == steps - 2
        runs.append([losses] + _predictive(op, models[0], dev) + _predictive(cp, models[1], dev))
    _assert_rel(runs[1], runs[0])


@pytest.mark.parametrize("batch_size", [40, 16])
def test_captured_flat_adam_chunks_match_eager_cpu_f64(cuda_device, monkeypatch, batch_size):
    """MOBOCMF_FLAT_ADAM=1 on both devices: the captured phase of
    test_captured_chunks_match_eager_cpu_f64 with Adam on one flat tensor."""
    monkeypatch.setenv("MOBOCMF_FLAT_ADAM", "1")
    test_captured_chunks_match_eager_cpu_f64(cuda_device, monkeypatch, batch_size)


@pytest.mark.parametrize("fused,flat", [(False, False), (True, True), (False, True)],
                         ids=["three-forward", "flat-adam", "three-forward-flat-adam"])
def test_captured_conditioned_variants_match_eager_cpu_f64(cuda_device, monkeypatch, fused,
                                                            flat):
    """The captured conditioned phase of
    test_captured_conditioned_chunks_match_eager_cpu_f64 under
    MOBOCMF_FUSED_COND=0 (the module's FUSED_COND_DEFAULT, which the chunked
    phase reads at the call) and MOBOCMF_FLAT_ADAM=1: still 2 K1 launches a
    step (the three forwards share one set of layer states)."""
    from mobocmf_tpu_torch.fit import conditioned as C

    monkeypatch.setattr(C, "FUSED_COND_DEFAULT", fused)
    monkeypatch.setenv("MOBOCMF_FLAT_ADAM", "1" if flat else "0")
    test_captured_conditioned_chunks_match_eager_cpu_f64(cuda_device, monkeypatch)


def test_acquisition_without_inverse_on_card_f64(cuda_device, monkeypatch):
    """MOBOCMF_ACQ_INV=0 on the card at f64: states without L^{-1}; the
    gains against the inverse route (rtol 1e-6, atol 1e-8) and against the
    CPU's solve route (1e-8 of the largest gain); the search's K2 launches
    unchanged (K2 factors its own Gram) and its values against the inverse
    route's (rtol 1e-6, atol 1e-8)."""
    from mobocmf_tpu_torch.acquisition import jesmoc as J

    x, fid, ys = _chunk_problem(30, seed=5)
    xq = np.random.default_rng(6).uniform(size=(9, 2))
    raw = torch.as_tensor(np.random.default_rng(7).uniform(size=(40, 2)))
    gains, searches = {}, {}
    for dev, inv in (("cpu", False), (cuda_device, True), (cuda_device, False)):
        monkeypatch.setattr(J, "ACQ_INV_SOLVES", inv)
        stacks = []
        for epochs in (3, 8):
            model = trainer.stack_models([
                M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i), device=dev,
                             dtype=torch.float64) for i, y in enumerate(ys)])
            eps = torch.randn((epochs, 2, 1, 30), generator=torch.Generator().manual_seed(8),
                              dtype=torch.float64).to(dev)
            params, _ = trainer.train_phase_stacked(
                model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
                torch.as_tensor(fid, device=dev), epochs, 0.01, "all_free", 30, eps=eps)
            stacks.append((params, model.consts))
        pair = (*stacks[0], *stacks[1], model.config)
        states = J.pair_states(J._pair(*pair))
        assert all((st.lk_inv is None) != inv for st in states)
        gains[(str(dev), inv)] = torch.stack([
            J.coupled_acq_stacked(*pair, f, torch.as_tensor(xq, device=dev)).detach().cpu()
            for f in (0, 1)])
        if dev != "cpu":
            counters.reset()
            _, vals = J.optimize_coupled_jes_all_fidelities(*pair, None, 2, raw_samples=40,
                                                            maxiter=20, raw=raw.to(dev))
            torch.cuda.synchronize()
            searches[inv] = (vals.cpu(), counters.get("k2.launches"))
    card = str(cuda_device)
    torch.testing.assert_close(gains[(card, False)], gains[(card, True)], rtol=1e-6, atol=1e-8)
    _assert_rel([gains[(card, False)]], [gains[("cpu", False)]])
    assert searches[False][1] == searches[True][1] >= 1
    torch.testing.assert_close(searches[False][0], searches[True][0], rtol=1e-6, atol=1e-8)


def test_counters_under_replay(cuda_device):
    """K1's launches count the launches that ran (the capture records one,
    each replay runs one), and so do the Steps' own counts; its escalations
    accumulate under replay."""
    from mobocmf_tpu_torch.fit import graphs

    a = _spd(3, 64, 5, torch.float32, cuda_device)
    a[1, 10, 10] = -1.0e4
    jit = torch.full((3,), 1e-6, dtype=torch.float32, device=cuda_device)
    out = torch.zeros((3, 64, 64), dtype=torch.float32, device=cuda_device)

    def step():
        out.copy_(chol.cholesky(a, jit, ladder=True)[0])

    counters.reset()
    esc0 = chol.escalations()
    steps = graphs.Steps(step, cuda_device)
    steps.run(7)
    steps.run(4)
    torch.cuda.synchronize()
    assert steps.replays == 11 - graphs.WARMUP and steps.steps == 11
    assert counters.get("k1.launches") == 11 and counters.recorded["k1.launches"] == 1
    assert steps.counts == {"k1.launches": 11}
    assert chol.escalations() - esc0 == 11
    want, _ = chol.cholesky_plain(a, jit, True)
    torch.testing.assert_close(out[[0, 2]], want[[0, 2]], rtol=1e-4, atol=1e-4)
    steps.close()
    # the eager path adds into the tensor the graph added into
    step()
    assert chol.escalations() - esc0 == 12


def _trsm_per_call(fn, calls=2) -> float:
    """cuBLAS trsm kernels per call of fn, counted from profiler sessions
    that recorded whole calls (mobocmf_tpu_torch/profiling.py's rule)."""
    from collections import Counter

    from mobocmf_tpu_torch import profiling

    for _ in range(profiling.TRIES):
        counts = Counter(name for name, _, _ in profiling._session(fn, calls))
        if not profiling.missing_events(counts, calls):
            return sum(c for name, c in counts.items() if "trsm" in name.lower()) / calls
    raise RuntimeError("profiler sessions kept losing events")


def test_captured_f64_training_step_solves_once_a_layer(cuda_device):
    """A captured float64 training step at B = 3, m = 512, F = 2 builds its
    layer states through the explicit inverse: a replay runs the trsm
    kernels of F solves (one solve_triangular(L, I) a layer, counted from a
    profiler slice), and its loss and gradients match the solve route's,
    run eagerly on the card, to 1e-9 relative (the gradient relative to
    its largest entry)."""
    from mobocmf_tpu_torch.mlls.elbo import elbo_terms
    from mobocmf_tpu_torch.profiling import patched
    from mobocmf_tpu_torch.util.tree import tree_map

    dev, n, nf = cuda_device, 512, 2
    x, fid, ys = _chunk_problem(n, seed=5)
    ys = np.concatenate([ys, (0.25 - np.sum((x - 0.5) ** 2, axis=1))[None]])
    models = [M.init_mfdgp(x, y, fid, nf, generator=torch.Generator().manual_seed(i),
                           device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
    model = trainer.stack_models(models)
    xt, yt, ft = (torch.as_tensor(a, device=dev) for a in (x, ys, fid))
    eps = torch.randn((3, 3, nf - 1, n), generator=torch.Generator().manual_seed(2),
                      dtype=torch.float64).to(dev)
    # lr 0: every step differentiates the initial model
    phase = trainer.TrainPhase(model, xt, yt, ft, 0.0, "all_free", n, chunk=3)
    try:
        counters.reset()
        phase.run_chunk(eps, None)  # two eager steps, the capture, one replay
        assert phase.steps.replays == 1 and counters.get("inv.states") == 3 * nf
        one = eps[:1]
        replay = _trsm_per_call(lambda: phase.run_chunk(one, None))
        l = torch.linalg.cholesky(_spd(3, n, 1, torch.float64, dev))
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        solve = _trsm_per_call(lambda: torch.linalg.solve_triangular(l, eye, upper=False))
        assert solve >= 1 and replay == nf * solve, (replay, solve)
        phase.run_chunk(one, None)
        torch.cuda.synchronize()
        loss, grads = phase.loss_buf[:, 0].clone(), [g.clone() for g in phase.trainable.grads()]
        masks = phase.trainable.masks
    finally:
        phase.close()
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), model.params)
    with patched(M, "inverse_route", lambda kzz: False):
        elbo, _ = elbo_terms(params, model.consts, model.config, xt, yt, ft, eps[0],
                             torch.tensor(float(n), dtype=torch.float64, device=dev),
                             weights=torch.ones(n, dtype=torch.float64, device=dev))
    torch.sum(-elbo).backward()
    want = [p.grad if m is None else p.grad * m for p, m in zip(tree_leaves(params), masks)]
    _assert_rel([loss], [-elbo.detach()], 1e-9)
    # the gradient relative to its largest entry: a leaf whose entries
    # cancel moves by ~1e-9 of itself under a 1e-15 change of the
    # parameters on either route
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g.cpu() - w.cpu()).abs().max()) for g, w in zip(grads, want)) < 1e-9 * scale


def test_fitter_with_captured_phases_pickles_on_card(cuda_device, tmp_path):
    """A fitter whose phases ran from CUDA graphs (training, Pareto sample,
    conditioned training) pickles and unpickles on the card: the same
    predictions, the same generator state, and it trains on."""
    import pickle

    from mobocmf_tpu_torch.util.util import read_pickle, save_pickle

    f = _card_fitter(cuda_device)
    assert all(st["replays"] >= 1 for st in f.phase_stats)
    f.sample_and_store_pareto_solution()
    f.train_conditioned_mfdgps()
    save_pickle(str(tmp_path), "fitter.pkl", f)
    r = read_pickle(str(tmp_path), "fitter.pkl")
    xq = torch.rand((9, 2), device=cuda_device)
    for name in f.obj_names:
        a, b = f.get_model(name), r.get_model(name)
        with torch.no_grad():
            pa = M.predict_for_acquisition_all(a.params, a.consts, a.config, xq)
            pb = M.predict_for_acquisition_all(b.params, b.consts, b.config, xq)
        for u, v in zip(pa, pb):
            assert torch.equal(u, v)
    assert r.generator.device.type == "cuda"
    assert torch.equal(f.generator.get_state(), r.generator.get_state())
    r.train_conditioned_mfdgps()
    f.train_conditioned_mfdgps()
    for name in f.obj_names:
        for u, v in zip(tree_leaves(f.get_model(name).params), tree_leaves(r.get_model(name).params)):
            assert torch.equal(u, v)
    pickle.loads(pickle.dumps(r))


def test_cuda_generator_round_trips(cuda_device):
    """A CUDA torch.Generator through pickle and through get_state /
    set_state continues the same stream."""
    import pickle

    g = torch.Generator(device=cuda_device).manual_seed(11)
    torch.randn(5, generator=g, device=cuda_device)
    h = pickle.loads(pickle.dumps(g))
    k = torch.Generator(device=cuda_device)
    k.set_state(g.get_state())
    want = torch.randn(7, generator=g, device=cuda_device)
    assert h.device.type == "cuda"
    assert torch.equal(torch.randn(7, generator=h, device=cuda_device), want)
    assert torch.equal(torch.randn(7, generator=k, device=cuda_device), want)


def test_gloo_collectives_take_cuda_tensors(cuda_device):
    """Two ranks on one card over gloo: every collective of
    parallel/sharding.py on CUDA tensors, with the autograd rules."""
    from mobocmf_tpu_torch.parallel import launch
    import torch_mesh_ranks as R

    res = launch.run(R.collectives_on_card, 2, device="cuda", timeout_s=300)
    for r, out in enumerate(res):
        assert out["backend"] == "gloo" and out["transport"] == "host"
        assert torch.equal(out["all_reduce"], torch.full((3,), 3.0))
        assert torch.equal(out["all_gather"], torch.tensor([[0.0, 0.0, 1.0, 1.0]] * 2))
        assert torch.equal(out["broadcast"], torch.zeros(2))
        assert out["object"] == {"rank": 0}
        assert torch.equal(out["gather_grad"], torch.full((2,), 2.0 * (r + 1)))
        assert out["enter_reduce"] == (6.0, 3.0)


@pytest.mark.parametrize("world_size", [1, 2])
def test_capture_mode_chosen_from_backend(cuda_device, world_size):
    """A phase whose step runs the mesh's collectives is captured under
    nccl (one rank: the all-reduce inside the graph) and eager under gloo
    (two ranks on one card), stated in its record; both equal the
    unsharded captured phase at f64 (rtol 1e-8), and count one all-reduce
    a step (under nccl: 2 eager, 1 captured, 3 replayed)."""
    from mobocmf_tpu_torch.models.convert import model_to_numpy
    from mobocmf_tpu_torch.parallel import launch
    import torch_mesh_ranks as R

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(24, 2))
    fid = (np.arange(24) % 2).astype(np.int32)
    ys = np.stack([np.sin(4 * x[:, 0]) + x[:, 1] * fid, np.cos(3 * x[:, 1])])
    models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                           device=cuda_device, dtype=torch.float64) for i, y in enumerate(ys)]
    stacked = trainer.stack_models(models)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    eps, _ = trainer.draw_chunk(g, stacked.config, 6, 2, 24, 24, torch.float64, cuda_device)
    stats0: dict = {}
    dev = lambda a: torch.as_tensor(a, device=cuda_device)  # noqa: E731
    _, logs0 = trainer.train_phase_stacked_chunked(
        stacked, dev(x), dev(ys), dev(fid), 6, 0.003, "all_free", 24, eps=eps, stats=stats0)
    assert stats0["captured"] and stats0["replays"] == 4
    res = launch.run(R.training_on_card, world_size, model_to_numpy(stacked), x, ys, fid, 6,
                     eps.cpu().numpy(), device="cuda", timeout_s=300)
    for stats, loss, collectives in res:
        assert collectives == 6
        if world_size == 1:
            assert stats["captured"] and stats["replays"] == 4, stats
        else:
            assert not stats["captured"] and stats["replays"] == 0, stats
            assert "gloo" in stats["capture_reason"]
        # two ranks sum the rows in another order, and Adam divides by the
        # root of second moments near zero: 1.8e-10 seen after 6 steps
        np.testing.assert_allclose(loss, logs0.loss.cpu().numpy(), rtol=1e-8)


def test_a_search_that_fails_to_capture_raises(cuda_device):
    """A step that reads a value on the host cannot be captured: its third
    run (after the two eager warm-up runs) raises, with no eager fallback."""
    from mobocmf_tpu_torch.acquisition import lbfgs

    def fun(z):
        return ((z - float(z.sum().item())) ** 2).sum(-1)

    z0 = torch.zeros((3, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(RuntimeError):
        lbfgs.lbfgs_lanes(fun, z0, 20)
    torch.cuda.synchronize()
    assert torch.ones(2, device=cuda_device).sum().item() == 2.0


def test_split_inverse_route_matches_dense_at_m2048(cuda_device, monkeypatch):
    """B = 4, m = 2048, float64: the inverse route's structured products,
    split at the default leaf, against the same route unsplit (one dense
    GEMM a product): `_SolveByInverse` on a dense and on a lower right-hand
    side, its backward and chol_pullback through L^{-1} (the gradient to
    the Gram), to 1e-12 relative. Then a step of the same work captured
    and replayed counts the GEMM operations issued and skipped a step that
    the step run eagerly counts."""
    from mobocmf_tpu_torch.fit import graphs

    bsz, m = 4, 2048
    g = torch.Generator(device="cpu").manual_seed(5)
    k = _spd(bsz, m, 6, torch.float64, cuda_device).requires_grad_(True)
    rhs = torch.randn((bsz, m, 64), generator=g, dtype=torch.float64).to(cuda_device)
    ls = torch.tril(torch.randn((bsz, m, m), generator=g, dtype=torch.float64)).to(cuda_device)
    ls.requires_grad_(True)

    def route():
        l, _, l_inv = ops.safe_cholesky_inv(k, 2e-6)
        w = ops.tri_solve_lower(l, rhs, l_inv)
        w_ls = ops.tri_solve_lower(l, ls, l_inv, b_lower=True)
        loss = torch.sum(w ** 2) + torch.sum(w_ls ** 2) + torch.sum(ops.logdet_from_chol(l))
        return [w.detach(), w_ls.detach()] + list(torch.autograd.grad(loss, (k, ls)))

    runs = []
    for leaf in (m, ops.GEMM_LEAF):
        monkeypatch.setattr(ops, "GEMM_LEAF", leaf)
        counters.reset()
        runs.append(route())
        assert (counters.get("inv.gemm_skipped") > 0) == (leaf < m)
    for got, want in zip(runs[1], runs[0]):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < 1e-12, rel

    def step():
        l, _, l_inv = ops.safe_cholesky_inv(k, 2e-6)
        torch.sum(ops.tri_solve_lower(l, ls, l_inv, b_lower=True) ** 2).backward()

    per_step = []
    for capture in (False, True):
        steps = graphs.Steps(step, cuda_device, leaves=[k, ls], capture=capture)
        counters.reset()
        steps.run(3)
        torch.cuda.synchronize()
        stats = trainer.steps_stats(steps)
        steps.close()
        assert stats["replays"] == (1 if capture else 0)
        assert stats["inv_gemm_skipped_per_step"] > 0
        if capture:
            assert graphs.inv_gemm_flops_per_step == stats["inv_gemm_flops_per_step"]
        per_step.append((stats["inv_gemm_flops_per_step"], stats["inv_gemm_skipped_per_step"]))
    assert per_step[0] == per_step[1]
