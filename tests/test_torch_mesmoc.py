"""MESMOC of the port (acquisition/mesmoc.py) against the JAX package at
f64 on the same MFGP models: the objective entropy, the constraint
probability and the coupled acquisition at fixed points (1e-9); the
search and the next point from the JAX package's raw samples, held by
value (the two L-BFGS implementations differ: the port's maximizer scores
at least the JAX package's on the JAX model, less `_assert_by_value`'s
allowance); and one whole MESMOC iteration of the example in both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.acquisition import mesmoc as JM
from mobocmf_tpu.models import mfgp as JG
from mobocmf_tpu_torch.acquisition import mesmoc as PM
from mobocmf_tpu_torch.acquisition import optimize as PO
from mobocmf_tpu_torch.examples import example_mesmoc_mfgp as E
from mobocmf_tpu_torch.models import convert
from mobocmf_tpu_torch.util.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _port(m):
    pen = None if m.row_penalty is None else np.asarray(m.row_penalty)
    return convert.mfgp_from_numpy(
        (jax.tree.map(np.asarray, m.params.kernel), np.asarray(m.params.raw_noise)),
        np.asarray(m.x_train), np.asarray(m.y_train), m.num_fidelities, m.jitter, pen,
        "cpu", F64)


@pytest.fixture(scope="module")
def models():
    """Two objectives and a constraint, padded rows included, fitted by the
    JAX package (20 Adam steps), and their ports."""
    out = {}
    for name, fn in E.FNS.items():
        xs, fids = _design()
        y = np.array([fn(xs[i:i + 1], fids[i])[0] for i in range(len(xs))])
        xf, valid, yp = E.padded(xs, fids, 24, y)
        mj = JG.fit_mfgp(JG.init_mfgp(jnp.asarray(xf), jnp.asarray(yp), 2, row_valid=valid),
                         num_iters=20)
        out[name] = (mj, _port(mj), float(y.min()))
    return out


def _design(n0=12, n1=6, seed=0):
    rng = np.random.default_rng(seed)
    x = np.vstack([rng.uniform(size=(n0, 2)), rng.uniform(size=(n1, 2))])
    return x, np.concatenate([np.zeros(n0), np.ones(n1)]).astype(int)


def _assert_by_value(acq, x_j, x_p, gtol: float = 1e-5, wall: float = 1e-3):
    """The port's maximizer scores at least the JAX package's on the JAX
    surface, less 1e-6 relative (as the JESMOC search is held) and, along
    each coordinate where the JAX optimum lies on the box's wall (within
    `wall` of it, the gradient pointing out of the box), the value between
    the two points there, |dv/dx_i| |x_p_i - x_j_i| at the JAX optimum.
    Both searches run in z = logit(x) and stop once |dv/dz| <= gtol, so
    near a wall each stops at its own distance from it: the port's
    coordinate must lie on the same wall and meet that rule."""
    x_j, x_p = np.asarray(x_j, np.float64), np.asarray(x_p, np.float64)
    want, got = float(acq(x_j)[0]), float(acq(x_p)[0])
    grad = jax.grad(lambda x: acq(x)[0])
    g_j, g_p = np.asarray(grad(jnp.asarray(x_j))), np.asarray(grad(jnp.asarray(x_p)))
    low = x_j < 0.5
    on_wall = (np.minimum(x_j, 1 - x_j) < wall) & np.where(low, g_j < 0, g_j > 0)
    assert np.all((x_p[on_wall] < 0.5) == low[on_wall])
    assert np.all(np.abs(g_p * x_p * (1 - x_p))[on_wall] <= gtol)
    slack = 1e-6 * abs(want) + float(np.sum((np.abs(g_j) * np.abs(x_p - x_j))[on_wall]))
    assert got >= want - slack, (got - want, slack, x_j, x_p)


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fidelity", [0, 1])
def test_entropy_constraint_probability_and_coupled(models, fidelity):
    xs = np.random.default_rng(2).uniform(size=(13, 2))
    xj, xp = jnp.asarray(xs), torch.as_tensor(xs)
    mj, mp, best = models["obj1"]
    _close(PM.mes_forward(mp, best, fidelity, False, xp),
           JM.mes_forward(mj, jnp.asarray(best), fidelity, False, xj))
    cj, cp, _ = models["con1"]
    for thr in (0.1, -0.3):
        _close(PM.mes_forward(cp, thr, fidelity, True, xp),
               JM.mes_forward(cj, jnp.asarray(thr), fidelity, True, xj))
    objs = [models[n] for n in ("obj1", "obj2")]
    want = JM.coupled_mes(tuple(m[0] for m in objs), tuple(jnp.asarray(m[2]) for m in objs),
                          (cj,), (jnp.asarray(0.0),), fidelity, 1, xj)
    got = PM.coupled_mes(tuple(m[1] for m in objs), tuple(m[2] for m in objs), (cp,), (0.0,),
                         fidelity, 1, xp)
    _close(got, want)
    assert bool((got >= 0).all())
    # the hoisted posterior states change nothing
    states = tuple(PM.G.posterior_state(m[1]) for m in objs)
    got_s = PM.coupled_mes(tuple(m[1] for m in objs), tuple(m[2] for m in objs), (cp,), (0.0,),
                           fidelity, 1, xp, states, (PM.G.posterior_state(cp),))
    assert torch.equal(got_s, got)


def _jax_acq(models, fidelity):
    objs = [models[n] for n in ("obj1", "obj2")]
    cj = models["con1"][0]

    def acq(x):
        return JM.coupled_mes(tuple(m[0] for m in objs), tuple(jnp.asarray(m[2]) for m in objs),
                              (cj,), (jnp.asarray(0.0),), fidelity, 1,
                              jnp.asarray(x, dtype=jnp.float64).reshape(-1, 2))
    return acq


@pytest.mark.parametrize("fidelity", [0, 1])
def test_optimize_coupled_mes_by_value(models, fidelity):
    objs = [models[n] for n in ("obj1", "obj2")]
    cj, cp, _ = models["con1"]
    key, raw_samples = jax.random.key(4 + fidelity), 40
    x_j, v_j = JM.optimize_coupled_mes(
        tuple(m[0] for m in objs), tuple(jnp.asarray(m[2]) for m in objs), (cj,),
        (jnp.asarray(0.0),), fidelity, 1, key, 2, raw_samples=raw_samples, maxiter=60)
    raw = torch.as_tensor(np.array(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    x_p, v_p = PM.optimize_coupled_mes(
        tuple(m[1] for m in objs), tuple(m[2] for m in objs), (cp,), (0.0,), fidelity, 1, None,
        2, raw_samples=raw_samples, maxiter=60, raw=raw)
    assert x_p.shape == (2,) and bool(((x_p >= 0) & (x_p <= 1)).all())
    acq = _jax_acq(models, fidelity)
    np.testing.assert_allclose(float(v_p), float(acq(x_p.numpy())[0]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(v_j), float(acq(x_j)[0]), rtol=1e-9, atol=1e-12)
    _assert_by_value(acq, x_j, x_p.numpy())


@pytest.mark.parametrize("fidelity", [0, 1])
@pytest.mark.parametrize("seed", [4, 9])
def test_optimize_coupled_mes_matches_jax(models, fidelity, seed):
    """Both packages search by optax's L-BFGS, so from the same raw samples
    the port's point is the JAX package's (1e-6) and so is its value
    (1e-9)."""
    objs = [models[n] for n in ("obj1", "obj2")]
    cj, cp, _ = models["con1"]
    key, raw_samples = jax.random.key(seed + fidelity), 40
    x_j, v_j = JM.optimize_coupled_mes(
        tuple(m[0] for m in objs), tuple(jnp.asarray(m[2]) for m in objs), (cj,),
        (jnp.asarray(0.0),), fidelity, 1, key, 2, raw_samples=raw_samples, maxiter=200)
    raw = torch.as_tensor(np.array(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    x_p, v_p = PM.optimize_coupled_mes(
        tuple(m[1] for m in objs), tuple(m[2] for m in objs), (cp,), (0.0,), fidelity, 1, None,
        2, raw_samples=raw_samples, maxiter=200, raw=raw)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(v_p), float(v_j), rtol=1e-9)


def _inject_raws(monkeypatch, seed, num_fidelities, raw_samples=200):
    """The JAX MESMOC_MFGP(seed=...)'s raw samples, fidelity by fidelity,
    fed to the port's search."""
    key, raws = jax.random.key(seed), []
    for _ in range(num_fidelities):
        key, k = jax.random.split(key)
        raws.append(torch.as_tensor(np.array(jax.random.uniform(k, (raw_samples, 2),
                                                                dtype=jnp.float64))))
    inner = PO.optimize_acqf_box
    monkeypatch.setattr(PM, "optimize_acqf_box",
                        lambda *a, **k: inner(*a, **{**k, "raw": raws.pop(0)}))


def _build(models, which, seed):
    objs = {n: models[n][which] for n in ("obj1", "obj2")}
    best = {n: models[n][2] for n in ("obj1", "obj2")}
    kwargs = dict(objectives=objs, constraints={"con1": models["con1"][which]}, input_dim=2,
                  num_fidelities=2, best_objective_values=best,
                  constraint_thresholds={"con1": 0.0}, seed=seed)
    mes = JM.MESMOC_MFGP(**kwargs) if which == 0 else PM.MESMOC_MFGP(**kwargs, device="cpu")
    for f in range(2):
        for n in ("obj1", "obj2"):
            mes.add_blackbox(f, n, cost_evaluation=1.0 if f == 0 else 5.0)
        mes.add_blackbox(f, "con1", is_constraint=True)
    return mes


def test_get_nextpoint_coupled_same_fidelity(models, monkeypatch):
    mes_j, mes_p = _build(models, 0, 3), _build(models, 1, 3)
    grid = np.random.default_rng(5).uniform(size=(9, 2))
    for f in range(2):
        _close(mes_p.coupled_acq(torch.as_tensor(grid)[:, None, :], f),
               mes_j.coupled_acq(jnp.asarray(grid), f))
    _inject_raws(monkeypatch, 3, 2)
    x_j, f_j = mes_j.get_nextpoint_coupled()
    x_p, f_p = mes_p.get_nextpoint_coupled()
    assert f_p == f_j
    costs = (2.0, 10.0)
    assert f_p == int(np.argmax([mes_p.last_values[f] / costs[f] for f in range(2)]))
    _assert_by_value(_jax_acq(models, f_j), x_j, x_p.numpy())


def test_one_mesmoc_iteration_of_the_example(monkeypatch):
    """The slice as a whole: the example's iteration (three fits on the
    padded data, the MESMOC object, the next point) in both packages at
    f64, 20 Adam steps a fit: the same fitted models, the same chosen
    fidelity, and the port's point at least as good on the JAX surface."""
    x, fid = _design(16, 8, seed=0)
    target, it = 32, 0
    models_p, best_p = E.fit_models(x, fid, target, "cpu", F64, num_iters=20)
    models, best_j = {}, {}
    for name, fn in E.FNS.items():
        y = np.array([fn(x[i:i + 1], fid[i])[0] for i in range(len(x))])
        xf, valid, yp = E.padded(x, fid, target, y)
        mj = JG.fit_mfgp(JG.init_mfgp(jnp.asarray(xf), jnp.asarray(yp), 2, row_valid=valid),
                         num_iters=20)
        for a, b in zip(jax.tree.leaves(mj.params), tree_leaves(models_p[name].params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-8, atol=1e-10)
        models[name] = (mj, models_p[name], best_p.get(name, 0.0))
        if name != "con1":
            top = fid == 1
            best_j[name] = float(y[top].min())
    assert best_j == best_p
    mes_j = _build(models, 0, it)
    mes_p = E.make_acquisition(models_p, best_p, it, "cpu")
    _inject_raws(monkeypatch, it, 2)
    x_j, f_j = mes_j.get_nextpoint_coupled()
    x_p, f_p = mes_p.get_nextpoint_coupled()
    assert f_p == f_j
    _assert_by_value(_jax_acq(models, f_j), x_j, x_p.numpy())
    assert all(np.isfinite(v) and v >= 0 for v in mes_p.last_values.values())
