"""JESMOC acquisition, the candidate search and the recommendation pass in
the port against the JAX package at f64.

Gains are compared at fixed x (1e-9), through the plain route (gradients
on) and the K2 route (no gradients). Both packages search by optax's
L-BFGS (the port's copy: acquisition/lbfgs.py), so from the same raw
samples the all-fidelity search returns the JAX package's candidates (x
to 1e-6, values to 1e-9, for twelve keys). The other searches are
compared by value as well: the port's best must be at least the JAX
package's, less 1e-6 (at f32: both candidates scored on the f64 surface,
less the f32 surface's error).
The gains and the search are also held with MOBOCMF_ACQ_INV=0 (states
without L^{-1}) in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.acquisition import jesmoc as JJ
from mobocmf_tpu.bo.loop import _recommendation_model_pass
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.fit.fitter import BlackBoxMFDGPFitter as JFitter
from mobocmf_tpu_torch.acquisition import jesmoc as PJ
from mobocmf_tpu_torch.acquisition import lbfgs as LB
from mobocmf_tpu_torch.acquisition import optimize as PO
from mobocmf_tpu_torch.bo.recommend import recommendation_model_pass
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter as PFitter
from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.models.convert import model_from_numpy
from test_torch_lbfgs import optax_lanes
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
NAMES = [("o1", False), ("o2", False), ("c1", True)]


def _port(params, consts, config):
    return model_from_numpy(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, consts),
                            config._asdict(), "cpu", F64)


def _problem(seed=0, n=14):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    fid = (np.arange(n) % 2).astype(int)
    ys = [np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0],
          0.3 - np.sum((x - 0.5) ** 2, 1)]
    return x, fid, ys


@pytest.fixture(scope="module")
def fitters():
    """A trained JAX fitter and its conditioned copy (tiny settings)."""
    x, fid, ys = _problem()
    f = JFitter(2, x.shape[0], num_epochs_1=5, num_epochs_2=5, opt_grid_size=20,
                pareto_set_size=4, seed=1)
    for (name, is_con), y in zip(NAMES, ys):
        f.initialize_mfdgp(jnp.asarray(x), jnp.asarray(y)[:, None], jnp.asarray(fid), name,
                           is_constraint=is_con)
    f.train_mfdgps()
    cond = f.copy_uncond()
    cond.sample_and_store_pareto_solution()
    cond.train_conditioned_mfdgps()
    return f, cond


def _stacks(fitters):
    f, cond = fitters
    su_p, su_c, config = jtrainer.stack_models([f.get_model(n, c) for n, c in NAMES])
    sc_p, sc_c, _ = jtrainer.stack_models([cond.get_model(n, c) for n, c in NAMES])
    pu, pc = _port(su_p, su_c, config), _port(sc_p, sc_c, config)
    return (su_p, su_c, sc_p, sc_c, config), (pu.params, pu.consts, pc.params, pc.consts, pu.config)


XQ = np.random.default_rng(3).uniform(size=(7, 2))


@pytest.mark.parametrize("fidelity", [0, 1])
def test_info_gain_matches_jax(fitters, fidelity):
    f, cond = fitters
    for name, is_con in NAMES:
        ju, jc = f.get_model(name, is_con), cond.get_model(name, is_con)
        want = np.asarray(JJ.info_gain(ju.params, ju.consts, jc.params, jc.consts, ju.config,
                                       fidelity, jnp.asarray(XQ)))
        pu = _port(ju.params, ju.consts, ju.config)
        pc = _port(jc.params, jc.consts, jc.config)
        got = PJ.info_gain(pu.params, pu.consts, pc.params, pc.consts, pu.config, fidelity,
                           torch.as_tensor(XQ))[0]
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("no_grad", [False, True], ids=["plain-route", "k2-route"])
def test_coupled_and_all_fidelity_gains_match_jax(fitters, no_grad):
    (ju, jp) = _stacks(fitters)
    xq = torch.as_tensor(XQ)
    states_u = jtrainer.states_stacked(ju[0], ju[1], ju[4], with_inv=True)
    states_c = jtrainer.states_stacked(ju[2], ju[3], ju[4], with_inv=True)
    want_all = np.asarray(JJ._coupled_gain_all_stacked(*ju[:4], ju[4], jnp.asarray(XQ),
                                                       states_u, states_c))
    with torch.set_grad_enabled(not no_grad):
        pair = PJ._pair(*jp)
        got_all = PJ._coupled_gain_all_stacked(pair, xq, PJ.pair_states(pair))
        for fidelity in (0, 1):
            want = np.asarray(JJ.coupled_acq_stacked(*ju, fidelity, jnp.asarray(XQ)))
            got = PJ.coupled_acq_stacked(*jp, fidelity, xq)
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(want_all[fidelity], want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_all.detach().numpy(), want_all, rtol=1e-9, atol=1e-12)


def test_optimize_all_fidelities_by_value(fitters):
    (ju, jp) = _stacks(fitters)
    key, raw_samples = jax.random.key(5), 40
    xs_j, vals_j = JJ.optimize_coupled_jes_all_fidelities(*ju, key, 2, raw_samples=raw_samples,
                                                          maxiter=60)
    raw = torch.as_tensor(np.asarray(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    xs_p, vals_p = PJ.optimize_coupled_jes_all_fidelities(*jp, None, 2, raw_samples=raw_samples,
                                                          maxiter=60, raw=raw)
    vals_j = np.asarray(vals_j)
    assert xs_p.shape == (2, 2) and bool(((xs_p >= 0) & (xs_p <= 1)).all())
    assert np.all(vals_p.numpy() >= vals_j - 1e-6), (vals_p, vals_j)
    # the reported values are the acquisition at the returned points
    for fidelity in (0, 1):
        at = PJ.coupled_acq_stacked(*jp, fidelity, xs_p[fidelity][None])
        np.testing.assert_allclose(at.detach().numpy(), vals_p[fidelity:fidelity + 1].numpy(),
                                   rtol=1e-9)


@pytest.mark.parametrize("fidelity", [0, 1])
def test_optimize_one_fidelity_by_value(fitters, fidelity):
    """The per-fidelity search (blackbox sets that differ between
    fidelities, and the highest-fidelity variant) from the same raw samples."""
    (ju, jp) = _stacks(fitters)
    key, raw_samples = jax.random.key(8), 30
    _, val_j = JJ.optimize_coupled_jes(*ju, fidelity, key, 2, raw_samples=raw_samples, maxiter=60)
    raw = torch.as_tensor(np.asarray(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    x_p, val_p = PJ.optimize_coupled_jes(*jp, fidelity, None, 2, raw_samples=raw_samples,
                                         maxiter=60, raw=raw)
    assert x_p.shape == (2,) and bool(((x_p >= 0) & (x_p <= 1)).all())
    assert val_p.item() >= float(val_j) - 1e-6


def test_optimize_all_fidelities_by_value_f32(fitters):
    """The same search in float32, where the gradient seldom falls to gtol.
    The f32 surface is itself off the f64 one by up to ~1e-1 (cancelling
    variances in the log ratio; 7e-2 at a candidate here), so each package's f32 candidate is scored
    on the f64 surface: the port's scores at least the JAX package's, less
    the f32 surface's own error at the two candidates (no f32 search
    resolves the surface more finely)."""
    (ju, jp) = _stacks(fitters)
    ju32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, ju[:4])
    key, raw_samples = jax.random.key(5), 40
    xs_j, _ = JJ.optimize_coupled_jes_all_fidelities(*ju32, ju[4], key, 2,
                                                     raw_samples=raw_samples, maxiter=200)
    raw = torch.as_tensor(np.array(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float32)))
    jp32 = [jax.tree.map(np.asarray, t) for t in ju32]
    pu = model_from_numpy(jp32[0], jp32[1], ju[4]._asdict(), "cpu", torch.float32)
    pc = model_from_numpy(jp32[2], jp32[3], ju[4]._asdict(), "cpu", torch.float32)
    xs_p, vals_p = PJ.optimize_coupled_jes_all_fidelities(
        pu.params, pu.consts, pc.params, pc.consts, pu.config, None, 2,
        raw_samples=raw_samples, maxiter=200, raw=raw)
    st = LB.last_stats
    assert vals_p.dtype == torch.float32 and bool(((xs_p >= 0) & (xs_p <= 1)).all())
    assert st["at_gtol"] + st["at_maxiter"] == st["lanes"] == 10
    xs_j = torch.as_tensor(np.array(xs_j), dtype=F64)
    for fidelity in (0, 1):
        cand = torch.stack([xs_p[fidelity].double(), xs_j[fidelity]])
        at64 = PJ.coupled_acq_stacked(*jp, fidelity, cand)
        at32 = PJ.coupled_acq_stacked(pu.params, pu.consts, pc.params, pc.consts, pu.config,
                                      fidelity, cand.float())
        surface_err = (at32.double() - at64).abs().max().item()
        assert at64[0].item() >= at64[1].item() - surface_err, (fidelity, at64, surface_err)


def test_f32_line_searches_take_the_jax_packages_steps(fitters):
    """At f32 nearly every zoom line search runs to its 20-step cap in both
    packages: the search's cost per iteration is optax's algorithm on an
    f32 surface, not the port's. Fidelity 0's 5 lanes from the f32
    screening of jax.random.key(5)'s 40 raw points, 30 iterations: the
    port's mean line-search steps per lane and iteration lie within 2 of
    optax's (vmapped, optax_lanes, run in f32 with x64 off), and both take
    at least 10."""
    (ju, _) = _stacks(fitters)
    p32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, ju[:4])
    config, fidelity, iters = ju[4], 0, 30
    raw = torch.as_tensor(np.array(jax.random.uniform(jax.random.key(5), (40, 2),
                                                      dtype=jnp.float32)))
    pt = [jax.tree.map(np.asarray, t) for t in p32]
    pu = model_from_numpy(pt[0], pt[1], config._asdict(), "cpu", torch.float32)
    pc = model_from_numpy(pt[2], pt[3], config._asdict(), "cpu", torch.float32)
    pair = PJ._pair(pu.params, pu.consts, pc.params, pc.consts, pu.config)
    states = PJ.pair_states(pair)
    with torch.no_grad():
        top = torch.topk(PJ._coupled_gain_all_stacked(pair, raw, states)[fidelity], 5).indices
    z0 = PO._logit(raw[top])

    def neg_acq(z):  # (5, d) -> (5,)
        return -PJ._coupled_gain_all_stacked(pair, torch.sigmoid(z), states)[fidelity]

    LB.lbfgs_lanes(neg_acq, z0, iters, 1e-5)
    port_mean = LB.last_stats["ls_steps_mean"]
    # with x64 on (this process's setting) parts of the JAX package's f32
    # surface are computed in f64, and its line searches take 3-12 steps
    with jax.enable_x64(False):
        pj = jax.tree.map(jnp.asarray, p32)
        jstates = [jtrainer.states_stacked(p, c, config, with_inv=True)
                   for p, c in ((pj[0], pj[1]), (pj[2], pj[3]))]

        def neg_acq_j(z):  # one lane (d,) -> ()
            return -JJ._coupled_gain_all_stacked(*pj, config, jax.nn.sigmoid(z)[None],
                                                 *jstates)[fidelity, 0]

        _, its, _, ls, _ = optax_lanes(neg_acq_j, z0.numpy(), iters, 1e-5)
    jax_mean = float(np.mean(np.concatenate([ls[i, :n] for i, n in enumerate(its)])))
    print(f"mean line-search steps per lane and iteration: port {port_mean:.3f}, JAX "
          f"{jax_mean:.3f}; iterations per lane: port {LB.last_stats['lane_iterations']}, JAX "
          f"{its.tolist()}")
    assert port_mean >= 10 and jax_mean >= 10, (port_mean, jax_mean)
    assert abs(port_mean - jax_mean) <= 2, (port_mean, jax_mean)


@pytest.mark.parametrize("no_grad", [False, True], ids=["plain-route", "k2-route"])
def test_gains_without_inverse_match_jax_and_inverse_route(fitters, monkeypatch, no_grad):
    """ACQ_INV_SOLVES off: the states carry no L^{-1}; the all-fidelity and
    per-fidelity gains equal the JAX package's with_inv=False gains (1e-9)
    and the port's inverse route (rtol 1e-6, atol 1e-8, as
    tests/test_fused_acq.py holds the JAX package's two routes)."""
    (ju, jp) = _stacks(fitters)
    xq = torch.as_tensor(XQ)
    states_u = jtrainer.states_stacked(ju[0], ju[1], ju[4])
    states_c = jtrainer.states_stacked(ju[2], ju[3], ju[4])
    want = np.asarray(JJ._coupled_gain_all_stacked(*ju[:4], ju[4], jnp.asarray(XQ), states_u,
                                                   states_c))
    monkeypatch.setattr(JJ, "ACQ_INV_SOLVES", False)
    with torch.set_grad_enabled(not no_grad):
        stack = PJ._pair(*jp)
        monkeypatch.setattr(PJ, "ACQ_INV_SOLVES", True)
        inv = PJ._coupled_gain_all_stacked(stack, xq, PJ.pair_states(stack))
        monkeypatch.setattr(PJ, "ACQ_INV_SOLVES", False)
        states = PJ.pair_states(stack)
        assert all(st.lk_inv is None for st in states)
        got = PJ._coupled_gain_all_stacked(stack, xq, states)
        for fidelity in (0, 1):
            one = PJ.coupled_acq_stacked(*jp, fidelity, xq)
            want_one = np.asarray(JJ.coupled_acq_stacked(*ju, fidelity, jnp.asarray(XQ)))
            np.testing.assert_allclose(one.detach().numpy(), want_one, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.detach().numpy(), inv.detach().numpy(), rtol=1e-6, atol=1e-8)


def test_search_without_inverse_by_value(fitters, monkeypatch):
    """The all-fidelity search with ACQ_INV_SOLVES off in both packages, from
    the same raw samples: the port's values at least the JAX package's less
    1e-6 (different L-BFGS implementations, as
    test_optimize_all_fidelities_by_value),
    each the JAX with_inv=False gain at the returned point (1e-9), and the
    port's inverse-route search's values (rtol 1e-6, atol 1e-8)."""
    (ju, jp) = _stacks(fitters)
    key, raw_samples = jax.random.key(5), 40
    raw = torch.as_tensor(np.asarray(jax.random.uniform(key, (raw_samples, 2),
                                                        dtype=jnp.float64)))

    def search():
        return PJ.optimize_coupled_jes_all_fidelities(*jp, None, 2, raw_samples=raw_samples,
                                                      maxiter=60, raw=raw)

    _, vals_inv = search()
    monkeypatch.setattr(JJ, "ACQ_INV_SOLVES", False)
    monkeypatch.setattr(PJ, "ACQ_INV_SOLVES", False)
    _, vals_j = JJ.optimize_coupled_jes_all_fidelities(*ju, key, 2, raw_samples=raw_samples,
                                                       maxiter=60)
    xs_p, vals_p = search()
    assert bool(((xs_p >= 0) & (xs_p <= 1)).all())
    assert np.all(vals_p.numpy() >= np.asarray(vals_j) - 1e-6), (vals_p, vals_j)
    for fidelity in (0, 1):
        at = JJ.coupled_acq_stacked(*ju, fidelity, jnp.asarray(xs_p[fidelity][None].numpy()))
        np.testing.assert_allclose(vals_p[fidelity:fidelity + 1].numpy(), np.asarray(at),
                                   rtol=1e-9)
    np.testing.assert_allclose(vals_p.numpy(), vals_inv.numpy(), rtol=1e-6, atol=1e-8)


def test_optimize_acqf_box_on_a_quadratic():
    """One surface, known optimum: L-BFGS in the sigmoid box converges to it."""
    center = torch.tensor([0.3, 0.7], dtype=F64)

    def acq(x):
        return -torch.sum((x - center) ** 2, dim=-1)

    x, v = PO.optimize_acqf_box(acq, 2, torch.Generator().manual_seed(0), raw_samples=30)
    np.testing.assert_allclose(x.numpy(), center.numpy(), atol=1e-4)
    assert v.item() > -1e-8


def _port_fitter(jf, is_cond):
    pf = PFitter(2, jf.batch_size, num_epochs_1=0, num_epochs_2=0, device="cpu", dtype=F64)
    x = np.asarray(jf.x_train)
    for (name, is_con), y in zip(NAMES, jf.ys_objs + jf.ys_cons):
        pf.initialize_mfdgp(x, np.asarray(y), np.asarray(jf.fidelities), name, is_constraint=is_con)
        jm = jf.get_model(name, is_con)
        reg = pf.models_cons if is_con else pf.models_objs
        reg[name] = _port(jm.params, jm.consts, jm.config)
    if is_cond:
        from mobocmf_tpu_torch.moop.moop import ParetoSolution

        s = jf.pareto_solution
        pf.pareto_solution = ParetoSolution(torch.as_tensor(np.asarray(s.pareto_set)),
                                            torch.as_tensor(np.asarray(s.pareto_front)),
                                            torch.as_tensor(np.asarray(s.mask)), s.num_valid)
    return pf


def test_jesmoc_get_nextpoint_coupled_matches_jax(fitters, monkeypatch):
    """The same uncond / cond models and the same raw samples: the port's
    candidate scores at least the JAX package's at its fidelity, less
    1e-6, and the fidelity follows the cost-weighted values."""
    f, cond = fitters
    seed, raw_samples = 3, 40
    jes_j = JJ.JESMOC_MFDGP(f, num_fidelities=2, model_cond=cond, seed=seed,
                            acq_raw_samples=raw_samples, acq_maxiter=60)
    jes_p = PJ.JESMOC_MFDGP(_port_fitter(f, False), num_fidelities=2,
                            model_cond=_port_fitter(cond, True), seed=seed,
                            acq_raw_samples=raw_samples, acq_maxiter=60)
    for jes in (jes_j, jes_p):
        for fidelity, cost in ((0, 1.0), (1, 10.0)):
            for name, is_con in NAMES:
                jes.add_blackbox(fidelity, name, cost_evaluation=cost, is_constraint=is_con)
    key = jax.random.split(jax.random.key(seed))[1]  # jes_j's first _next_key()
    raw = torch.as_tensor(np.asarray(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    inner = PO.optimize_acqf_box_multi
    monkeypatch.setattr(PJ, "optimize_acqf_box_multi",
                        lambda *a, **k: inner(*a, **{**k, "raw": raw}))
    x_j, fid_j = jes_j.get_nextpoint_coupled()
    x_p, fid_p = jes_p.get_nextpoint_coupled()
    vals_p = jes_p.last_values.numpy()
    costs = np.array([3.0, 30.0])
    assert fid_p == int(np.argmax(vals_p / costs)) and fid_p in (0, 1)
    assert jes_p.last_points.shape == (2, 2) and torch.equal(jes_p.last_points[fid_p], x_p)
    assert x_p.shape == (2,) and bool(((x_p >= 0) & (x_p <= 1)).all())
    (ju, jp) = _stacks(fitters)
    want = np.asarray(JJ.coupled_acq_stacked(*ju, fid_j, jnp.asarray(np.asarray(x_j))[None]))[0]
    got = PJ.coupled_acq_stacked(*jp, fid_p, x_p[None]).item()
    assert got / costs[fid_p] >= want / costs[fid_j] - 1e-6


@pytest.mark.parametrize("with_con", [True, False])
def test_recommendation_pass_matches_jax(fitters, with_con):
    f, _ = fitters
    op, oc, config = jtrainer.stack_models([f.get_model("o1"), f.get_model("o2")])
    if with_con:
        cp, cc, _ = jtrainer.stack_models([f.get_model("c1", True)])
        thr = jnp.asarray([-0.1])
    else:
        cp = jax.tree.map(lambda a: a[:0], op)
        cc = oc._replace(acq_eps=oc.acq_eps[:0], noise_lower=oc.noise_lower[:0],
                         noise_upper=oc.noise_upper[:0])
        thr = jnp.zeros((0,))
    scale = jnp.asarray([[0.5, 2.0], [-1.0, 0.5]])
    grid = np.random.default_rng(9).uniform(size=(60, 2))
    means_j, feas_j, mask_j = _recommendation_model_pass(op, oc, cp, cc, config, 1,
                                                         jnp.asarray(grid), thr, scale, 0.6)
    po, pc = _port(op, oc, config), _port(cp, cc, config)
    means, feas, mask = recommendation_model_pass(
        po.params, po.consts, pc.params, pc.consts, po.config, 1, torch.as_tensor(grid),
        torch.as_tensor(np.asarray(thr)), torch.as_tensor(np.asarray(scale)), 0.6)
    # 1e-9 of the means' scale: points where the mixture mean cancels carry
    # the packages' ~1e-13 factor differences at a larger relative size
    want = np.asarray(means_j)
    np.testing.assert_allclose(means.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    np.testing.assert_array_equal(feas.numpy(), np.asarray(feas_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert mask.sum() >= 1 and (not with_con or 0 < feas.sum() < 60)


@pytest.mark.parametrize("highest", [False, True])
def test_jesmoc_runs_pareto_and_conditioning_itself(highest):
    """Without model_cond the constructor samples the Pareto solution and
    trains the conditioned models on the passed fitter (reference :70-86);
    blackboxes registered only at the top fidelity take the per-fidelity
    search, and eval_highest_fidelity always evaluates the top fidelity."""
    x, fid, ys = _problem(seed=4, n=12)
    f = PFitter(2, 12, num_epochs_1=3, num_epochs_2=3, opt_grid_size=15, pareto_set_size=4,
                device="cpu", dtype=F64)
    for (name, is_con), y in zip(NAMES, ys):
        f.initialize_mfdgp(x, y, fid, name, is_constraint=is_con)
    f.train_mfdgps()
    # float64 training and conditioning build F = 2 layer states a step
    # through the explicit inverse (linalg/ops.py); the Pareto stage and
    # the search build theirs by the solves
    inv0 = counters.get("inv.states")
    jes = PJ.JESMOC_MFDGP(f, num_fidelities=2, eval_highest_fidelity=highest, seed=1,
                          acq_raw_samples=20, acq_maxiter=15)
    assert jes.blackbox_mfdgp_fitter_cond is f and f.phase_stats[-1]["label"] == "COND"
    assert [st["inv_states"] for st in f.phase_stats] == [2 * 3] * len(f.phase_stats)
    assert counters.get("inv.states") - inv0 == f.phase_stats[-1]["inv_states"]
    inv0 = counters.get("inv.states")
    assert jes.pareto_set.shape == (4, 2)
    for name, is_con in NAMES:
        jes.add_blackbox(1, name, cost_evaluation=10.0, is_constraint=is_con)
    jes.add_blackbox(0, "o1", cost_evaluation=1.0)
    assert jes._fused_eligible() is None
    x_next, fidelity = jes.get_nextpoint_coupled()
    assert x_next.shape == (2,) and bool(((x_next >= 0) & (x_next <= 1)).all())
    assert fidelity == 1 if highest else fidelity in (0, 1)
    assert bool(torch.isfinite(jes.last_values).all()) and bool((jes.last_values >= 0).all())
    assert counters.get("inv.states") == inv0



# (k, fidelity) -> the lane (5 x fidelity + start) of the search whose
# candidate leaves the JAX package's: the
# two packages' acquisition differs by some 5e-11 of its value (their
# factorizations round differently; the gains above agree to 1e-9), and
# the lane that ends on fidelity 1's candidate (start 4) grows that
# difference about tenfold an iteration from its 4th iteration: 1.9e-11,
# 8.1e-10, 1.0e-8, 2.5e-7 in z, ending 2.1e-6 from the JAX package's point
# and 4.2e-8 from its value. The JAX package's own candidate there moves
# 2.2e-7 in x and 6.9e-10 in value when that lane's start moves by 1e-13 of
# itself. This lane is held to the JAX package's iterates over its first 3
# iterations, and its candidate by value.
DIVERGES = {(11, 1): 9}


@pytest.mark.parametrize("k", range(12))
def test_optimize_all_fidelities_matches_jax(fitters, k, monkeypatch):
    """Both packages run optax's L-BFGS from jax.random.key(k)'s 40 raw
    points at maxiter=200, so every candidate is the JAX package's: x to
    1e-6, values to 1e-9 (but DIVERGES)."""
    (ju, jp) = _stacks(fitters)
    key, raw_samples = jax.random.key(k), 40
    xs_j, vals_j = JJ.optimize_coupled_jes_all_fidelities(*ju, key, 2, raw_samples=raw_samples,
                                                          maxiter=200)
    xs_j, vals_j = np.asarray(xs_j), np.asarray(vals_j)
    raw = torch.as_tensor(np.asarray(jax.random.uniform(key, (raw_samples, 2), dtype=jnp.float64)))
    seen, inner = [], LB.precondition
    monkeypatch.setattr(LB, "precondition", lambda g, z, mem: (seen.append(z), inner(g, z, mem))[1])
    xs_p, vals_p = PJ.optimize_coupled_jes_all_fidelities(*jp, None, 2, raw_samples=raw_samples,
                                                          maxiter=200, raw=raw)
    for fidelity in (0, 1):
        lane = DIVERGES.get((k, fidelity))
        if lane is None:
            np.testing.assert_allclose(xs_p[fidelity].numpy(), xs_j[fidelity], rtol=0, atol=1e-6)
            np.testing.assert_allclose(vals_p[fidelity].item(), vals_j[fidelity], rtol=1e-9)
            continue
        assert vals_p[fidelity].item() >= vals_j[fidelity] - 1e-6
        states = [jtrainer.states_stacked(p, c, ju[4], with_inv=True)
                  for p, c in ((ju[0], ju[1]), (ju[2], ju[3]))]

        def neg_acq(z):
            x = jax.nn.sigmoid(z)[None]
            return -JJ._coupled_gain_all_stacked(*ju[:4], ju[4], x, *states)[fidelity, 0]

        z0 = seen[0][lane : lane + 1].numpy()
        _, _, hist, _, _ = optax_lanes(neg_acq, z0, 200, 1e-5)
        after = torch.stack([z[lane] for z in seen[1:4]]).numpy()
        np.testing.assert_allclose(after, hist[0, :3], rtol=0, atol=1e-10 * np.abs(hist).max())
