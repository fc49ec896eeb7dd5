"""The port's MOOP (Pareto cull, summary, feasibility, SLSQP polish) against
the JAX package at f64, on the same sampled functions and grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.moop import moop as jmoop
from mobocmf_tpu.sampling import rff as jrff
from mobocmf_tpu_torch.fit import fitter as pfitter
from mobocmf_tpu_torch.moop import moop
from mobocmf_tpu_torch.sampling import rff
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _to_port_sample(js):
    layers = []
    for lay in js.layers:
        cls = rff.Layer0Sample if isinstance(lay, jrff.Layer0Sample) else rff.DeepLayerSample
        layers.append(cls(*[torch.tensor(np.asarray(a)) for a in lay]))
    return rff.MFDGPFunctionSample(layers=tuple(layers))


def _points(seed, n=300, k=2):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, k))
    pts[10] = pts[3]  # an exact duplicate: only the first is kept
    pts[11] = pts[3]
    valid = rng.uniform(size=n) > 0.2
    return pts, valid


@pytest.mark.parametrize("k,chunk", [(2, 128), (3, 64)])
def test_pareto_front_mask_matches_jax(k, chunk):
    pts, valid = _points(k, k=k)
    want = np.asarray(jmoop.pareto_front_mask(jnp.asarray(pts), jnp.asarray(valid), chunk=chunk))
    got = moop.pareto_front_mask(torch.as_tensor(pts), torch.as_tensor(valid), chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() >= 3
    np.testing.assert_array_equal(moop.MOOP.compute_pareto_front(pts),
                                  jmoop.MOOP.compute_pareto_front(pts))


@pytest.mark.parametrize("size", [5, 40])
def test_summarize_pareto_matches_jax(size):
    pts, valid = _points(7, n=200)
    mask = np.asarray(jmoop.pareto_front_mask(jnp.asarray(pts), jnp.asarray(valid)))
    pset = np.random.default_rng(1).uniform(size=(200, 2))
    want = jmoop.summarize_pareto(jnp.asarray(pset), jnp.asarray(pts), jnp.asarray(mask), size)
    got = moop.summarize_pareto(torch.as_tensor(pset), torch.as_tensor(pts),
                                torch.as_tensor(mask), size)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _functions(seed):
    """Two objectives and one constraint drawn from the MFDGP prior."""
    keys = jax.random.split(jax.random.key(seed), 3)
    js = [jrff.sample_prior(k, 2, 2, n_features=50, dtype=jnp.float64) for k in keys]
    jf = [jmoop.SampledFunction(jrff.eval_sample_fn, s) for s in js]
    pf = [moop.SampledFunction(rff.eval_sample_fn, _to_port_sample(s)) for s in js]
    return jf, pf


def test_sampled_function_value_and_grad_matches_jax():
    jf, pf = _functions(1)
    x = np.array([0.3, 0.6])
    v_j, g_j = jf[0].value_and_grad(jnp.asarray(x))
    v_p, g_p = pf[0].value_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-9)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pf[0](torch.as_tensor(x)[None]).item(), float(v_j), rtol=1e-9)


@pytest.mark.parametrize("polish", ["slsqp", "none"])
def test_moop_solution_matches_jax(polish):
    jf, pf = _functions(3)
    inputs = np.random.default_rng(2).uniform(size=(10, 2))
    inputs_valid = np.arange(10) < 8
    kw = dict(input_dim=2, grid_size=60, pareto_set_size=12, feasible_values=np.array([-0.3]),
              polish=polish)
    key = jax.random.key(4)
    jm = jmoop.MOOP(jf[:2], jf[2:], **kw)
    want = jm.compute_pareto_solution_from_samples(inputs, key, inputs_valid=inputs_valid)
    grid = np.asarray(jax.random.uniform(jax.random.split(key)[0], (2 * 60, 2)), dtype=float)
    pm = moop.MOOP(pf[:2], pf[2:], **kw)
    got = pm.compute_pareto_solution_from_samples(
        inputs, inputs_valid=inputs_valid, grid=grid, like=torch.zeros((), dtype=F64))
    assert want is not None and got is not None
    ws, gs = want[0], got[0]
    assert gs.num_valid == ws.num_valid >= 1
    np.testing.assert_array_equal(gs.mask.numpy(), np.asarray(ws.mask))
    np.testing.assert_allclose(gs.pareto_set.numpy(), np.asarray(ws.pareto_set), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gs.pareto_front.numpy(), np.asarray(ws.pareto_front), rtol=1e-6,
                               atol=1e-6)


def test_slsqp_polish_finds_the_same_optimum():
    jf, pf = _functions(5)
    grid = np.random.default_rng(6).uniform(size=(80, 2))
    kw = dict(input_dim=2, feasible_values=np.array([-0.5]))
    jm, pm = jmoop.MOOP(jf[:2], jf[2:], **kw), moop.MOOP(pf[:2], pf[2:], **kw)
    cons = np.stack([np.asarray(f(jnp.asarray(grid))) for f in jf[2:]])
    feas = jm._feasible_mask(cons, True)
    for i in range(2):
        evals = np.asarray(jf[i](jnp.asarray(grid)))
        want = jm.optimize_obj_globally(i, evals, feas, grid)
        got = pm.optimize_obj_globally(i, evals, feas, grid, torch.zeros((), dtype=F64))
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_least_infeasible_fallback_matches_jax():
    rng = np.random.default_rng(8)
    cons = -np.abs(rng.normal(size=(2, 50))) - 0.1  # nowhere feasible
    cons[:, 7] = -0.05  # the least infeasible point
    valid = np.ones(50, dtype=bool)
    valid[3] = False
    fv = np.zeros(2)
    jm = jmoop.MOOP([], [lambda x: x[:, 0]] * 2, input_dim=2, feasible_values=fv)
    pm = moop.MOOP([], [lambda x: x[:, 0]] * 2, input_dim=2, feasible_values=fv)
    assert pm._feasible_mask(cons, False, valid) is None
    got = pm._feasible_mask(cons, True, valid)
    np.testing.assert_array_equal(got, jm._feasible_mask(cons, True, valid))
    assert got.sum() == 1 and got[7]
    edge = np.zeros((2, 50))  # all exactly on the boundary: all feasible
    np.testing.assert_array_equal(pm._feasible_mask(edge, True, valid), valid)


def test_infeasible_samples_give_no_solution():
    _, pf = _functions(9)
    nowhere = moop.SampledFunction(lambda _t, x: -1.0 - x[:, 0], None)
    pm = moop.MOOP(pf[:2], [nowhere], input_dim=2, grid_size=20, pareto_set_size=4)
    inputs = np.random.default_rng(0).uniform(size=(5, 2))
    g = torch.Generator().manual_seed(0)
    assert pm.compute_pareto_solution_from_samples(inputs, g) is None
    sol = pm.compute_pareto_solution_from_samples(inputs, g, allow_negative_constraints=True)
    assert sol is not None and sol[0].num_valid >= 1


def test_fitter_raises_not_feasible_points(monkeypatch):
    """When every attempt and the least-infeasible fallback fail, the inner
    Pareto sampling raises NotFeasiblePoints (the retry-forever wrapper
    catches it)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(8, 2))
    fid = np.arange(8) % 2
    f = pfitter.BlackBoxMFDGPFitter(2, 8, num_epochs_1=0, num_epochs_2=0, opt_grid_size=5,
                                    pareto_set_size=3, device="cpu", dtype=F64)
    f.initialize_mfdgp(x, x[:, 0], fid, "o")
    f.initialize_mfdgp(x, x[:, 1], fid, "c", is_constraint=True)
    monkeypatch.setattr(pfitter, "MAX_TRIES_FOR_FEASIBLE_GRID", 2)
    monkeypatch.setattr(moop.MOOP, "compute_pareto_solution_from_samples", lambda *a, **k: None)
    with pytest.raises(moop.NotFeasiblePoints):
        f._sample_and_store_pareto_solution()
    assert f.pareto_tries == 3
    assert issubclass(moop.NotFeasiblePoints, ValueError)
