"""q > 1 batches and the random baseline in the port against the JAX
package at f64.

The penalized acquisition is compared at fixed x (1e-12). The greedy
batch picks run different L-BFGS implementations, so they are judged by
value from the same raw samples (those of the JAX package's keys): each
pick's penalized value is at least the JAX package's, less 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.acquisition import batch as JB
from mobocmf_tpu.acquisition import jesmoc as JJ
from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.fit.fitter import BlackBoxMFDGPFitter as JFitter
from mobocmf_tpu_torch.acquisition import batch as PB
from mobocmf_tpu_torch.acquisition import jesmoc as PJ
from mobocmf_tpu_torch.acquisition.random_choice import Random_choice
from mobocmf_tpu_torch.models.convert import model_from_numpy
from test_torch_loop import port_fitter
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
NAMES = [("o1", False), ("o2", False), ("c1", True)]


def _base_np(x):
    """A smooth positive surface with two bumps, (N, 2) -> (N,)."""
    return (np.exp(-8.0 * np.sum((x - 0.3) ** 2, -1))
            + 0.6 * np.exp(-6.0 * np.sum((x - np.array([0.75, 0.6])) ** 2, -1)))


def _base_jax(x):
    return (jnp.exp(-8.0 * jnp.sum((x - 0.3) ** 2, -1))
            + 0.6 * jnp.exp(-6.0 * jnp.sum((x - jnp.array([0.75, 0.6])) ** 2, -1)))


def _base_torch(x):
    c2 = torch.tensor([0.75, 0.6], dtype=x.dtype)
    return (torch.exp(-8.0 * torch.sum((x - 0.3) ** 2, -1))
            + 0.6 * torch.exp(-6.0 * torch.sum((x - c2) ** 2, -1)))


def test_penalized_acq_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(50, 2))
    chosen = np.full((4, 2), JB.PAD_VALUE)
    chosen[:2] = [[0.3, 0.3], [0.5, 0.52]]
    assert PB.PAD_VALUE == JB.PAD_VALUE
    for rho in (0.05 * 2**0.5, 0.2):
        want = np.asarray(JB.penalized_acq(_base_jax, jnp.asarray(chosen), rho)(jnp.asarray(x)))
        got = PB.penalized_acq(_base_torch, torch.as_tensor(chosen), rho)(torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-300)
    # PAD slots leave the surface as it is; a chosen point zeroes it there
    got = PB.penalized_acq(_base_torch, torch.full((3, 2), PB.PAD_VALUE, dtype=F64), 0.1)(
        torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _base_np(x), rtol=1e-12)
    at = PB.penalized_acq(_base_torch, torch.as_tensor(chosen), 0.1)(torch.as_tensor(chosen[:2]))
    assert at.abs().max().item() == 0.0


def test_optimize_acqf_batch_by_value(monkeypatch):
    """The generic greedy batch from the JAX package's raw samples: each
    pick scores at least the JAX package's on its own penalized surface."""
    key, q, raw_samples, rho = jax.random.key(2), 3, 40, 0.15
    _, vals_j = JB.optimize_acqf_batch(_base_jax, 2, q, key, raw_samples=raw_samples,
                                       maxiter=60, rho=rho)
    calls = iter(_jax_raws(key, q, raw_samples))
    box = PB.optimize_acqf_box
    monkeypatch.setattr(PB, "optimize_acqf_box",
                        lambda *a, **k: box(*a, **{**k, "raw": next(calls)}))
    xs_p, vals_p = PB.optimize_acqf_batch(_base_torch, 2, q, None, raw_samples=raw_samples,
                                          maxiter=60, rho=rho)
    assert xs_p.shape == (q, 2) and bool(((xs_p >= 0) & (xs_p <= 1)).all())
    assert np.all(vals_p.numpy() >= np.asarray(vals_j) - 1e-6), (vals_p, vals_j)
    # the batch spreads: no two picks closer than the repulsion scale
    d = torch.cdist(xs_p, xs_p) + 10 * torch.eye(q, dtype=F64)
    assert d.min().item() > 0.5 * rho


@pytest.mark.parametrize("seed", [2, 5])
def test_optimize_acqf_batch_matches_jax(monkeypatch, seed):
    """Both packages search by optax's L-BFGS, so from the JAX package's raw
    samples every pick is the JAX package's point (1e-6). The first pick's
    value is the JAX package's to 1e-9; a later pick's surface is penalized
    around the picks before it, which agree only as points do (2.4e-9 at
    seed 5, where the third pick's value is 8.9e-9 off), so later values
    are held to 1e-7."""
    key, q, raw_samples, rho = jax.random.key(seed), 3, 40, 0.15
    xs_j, vals_j = JB.optimize_acqf_batch(_base_jax, 2, q, key, raw_samples=raw_samples,
                                          maxiter=200, rho=rho)
    calls = iter(_jax_raws(key, q, raw_samples))
    box = PB.optimize_acqf_box
    monkeypatch.setattr(PB, "optimize_acqf_box",
                        lambda *a, **k: box(*a, **{**k, "raw": next(calls)}))
    xs_p, vals_p = PB.optimize_acqf_batch(_base_torch, 2, q, None, raw_samples=raw_samples,
                                          maxiter=200, rho=rho)
    np.testing.assert_allclose(xs_p.numpy(), np.asarray(xs_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vals_p[0].item(), float(vals_j[0]), rtol=1e-9)
    np.testing.assert_allclose(vals_p.numpy(), np.asarray(vals_j), rtol=1e-7)


def _jax_raws(key, q, raw_samples):
    """The raw samples of q successive picks drawn from `key` as the JAX
    package does (split, then uniform from the second half)."""
    raws = []
    for _ in range(q):
        key, kk = jax.random.split(key)
        raws.append(torch.as_tensor(np.array(
            jax.random.uniform(kk, (raw_samples, 2), dtype=jnp.float64))))
    return raws


def _port(params, consts, config):
    return model_from_numpy(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, consts),
                            config._asdict(), "cpu", F64)


@pytest.fixture(scope="module")
def fitters():
    """A trained JAX fitter and its conditioned copy (tiny settings)."""
    rng = np.random.default_rng(0)
    n = 14
    x = rng.uniform(size=(n, 2))
    fid = (np.arange(n) % 2).astype(int)
    ys = [np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0],
          0.3 - np.sum((x - 0.5) ** 2, 1)]
    f = JFitter(2, n, num_epochs_1=5, num_epochs_2=5, opt_grid_size=20, pareto_set_size=4,
                seed=1)
    for (name, is_con), y in zip(NAMES, ys):
        f.initialize_mfdgp(jnp.asarray(x), jnp.asarray(y)[:, None], jnp.asarray(fid), name,
                           is_constraint=is_con)
    f.train_mfdgps()
    cond = f.copy_uncond()
    cond.sample_and_store_pareto_solution()
    cond.train_conditioned_mfdgps()
    return f, cond


@pytest.mark.parametrize("fidelity", [0, 1])
def test_get_batch_coupled_by_value(fitters, fidelity, monkeypatch):
    """Two penalized picks after a seed point, from the JAX package's raw
    samples. Pick k is searched by the port on the JAX package's surface
    for that pick (the seed and the JAX package's picks before k): its
    penalized coupled gain is at least the JAX package's pick's, less 1e-6
    (both scored on the port's f64 surface, which the acquisition tests
    hold to the JAX package's at 1e-9). The port's own batch from the same
    raw samples lies in the box, its first pick passes the same bar, and
    its screening runs without gradients, so through K2's route. (Later
    picks of the two batches are not paired: when the first picks differ,
    so do the surfaces after them.)"""
    f, cond = fitters
    seed, raw_samples, q = 4, 40, 2
    rho = 0.05 * 2**0.5
    x0 = np.array([[0.42, 0.58]])
    jes_j = JJ.JESMOC_MFDGP(f, num_fidelities=2, model_cond=cond, seed=seed,
                            acq_raw_samples=raw_samples, acq_maxiter=60)
    jes_p = PJ.JESMOC_MFDGP(port_fitter(f), num_fidelities=2, model_cond=port_fitter(cond),
                            seed=seed, acq_raw_samples=raw_samples, acq_maxiter=60)
    for jes in (jes_j, jes_p):
        for name, is_con in NAMES:
            jes.add_blackbox(fidelity, name, is_constraint=is_con)
    xs_j = np.array(jes_j.get_batch_coupled(fidelity, q, x0=x0))
    raws = _jax_raws(jax.random.key(seed), q, raw_samples)

    su_p, su_c, config = jtrainer.stack_models([f.get_model(n, c) for n, c in NAMES])
    sc_p, sc_c, _ = jtrainer.stack_models([cond.get_model(n, c) for n, c in NAMES])
    pu, pc = _port(su_p, su_c, config), _port(sc_p, sc_c, config)
    jp = (pu.params, pu.consts, pc.params, pc.consts, pu.config)

    def value(chosen, x):
        acq = PB.penalized_acq(lambda xx: PJ.coupled_acq_stacked(*jp, fidelity, xx),
                               torch.as_tensor(chosen), rho)
        return acq(torch.as_tensor(x).reshape(1, 2)).item()

    for k in range(q):
        chosen = np.full((1 + q, 2), PB.PAD_VALUE)
        chosen[0], chosen[1:1 + k] = x0[0], xs_j[:k]
        x_k, v_k = PJ.optimize_coupled_jes_penalized(
            *jp, fidelity, torch.as_tensor(chosen), None, 2, rho, raw_samples=raw_samples,
            maxiter=60, raw=raws[k])
        assert bool(((x_k >= 0) & (x_k <= 1)).all())
        np.testing.assert_allclose(v_k.item(), value(chosen, x_k.detach()), rtol=1e-9)
        assert v_k.item() >= value(chosen, xs_j[k]) - 1e-6, (k, x_k, xs_j[k])

    calls = iter(raws)
    box = PJ.optimize_acqf_box
    screened = []

    def with_raw(acq_fn, *a, **k):
        def spy(x):
            screened.append(torch.is_grad_enabled())
            return acq_fn(x)
        return box(spy, *a, **{**k, "raw": next(calls)})

    monkeypatch.setattr(PJ, "optimize_acqf_box", with_raw)
    xs_p = jes_p.get_batch_coupled(fidelity, q, x0=x0)
    assert screened[0] is False
    assert xs_p.shape == (q, 2) and bool(((xs_p >= 0) & (xs_p <= 1)).all())
    assert value(x0, xs_p[0]) >= value(x0, xs_j[0]) - 1e-6


def test_random_choice_fidelity_frequencies_and_box():
    costs = (1.0, 10.0)
    rc = Random_choice(input_size=3, num_fidelities=2, seed=5, device="cpu")
    for name in ("o1", "o2", "c1"):
        for level in range(2):
            rc.add_blackbox(level, name, cost_evaluation=costs[level])
    total = 3 * sum(costs)
    p = np.array([1.0 - 3 * c / total for c in costs])
    p = p / p.sum()
    np.testing.assert_allclose(rc.fidelity_probabilities().numpy(), p, rtol=1e-12)
    draws = 4000
    counts = np.zeros(2)
    for _ in range(draws):
        x, fid = rc.get_nextpoint_coupled()
        assert x.shape == (3,) and bool(((x >= 0) & (x < 1)).all())
        counts[fid] += 1
    se = np.sqrt(p * (1 - p) / draws)
    assert np.all(np.abs(counts / draws - p) < 4 * se), (counts / draws, p)
    for q in (1, 4):
        xs, fid = rc.get_batch_coupled(q)
        assert xs.shape == (q, 3) and fid in (0, 1) and bool(((xs >= 0) & (xs < 1)).all())
    assert rc.coupled_acq(torch.zeros((7, 3)), 0).shape == (7,)
    # the same seed gives the same stream
    a = Random_choice(input_size=2, num_fidelities=2, seed=9, device="cpu")
    b = Random_choice(input_size=2, num_fidelities=2, seed=9, device="cpu")
    for rcx in (a, b):
        rcx.add_blackbox(0, "o", 1.0)
        rcx.add_blackbox(1, "o", 10.0)
    xa, fa = a.get_batch_coupled(3)
    xb, fb = b.get_batch_coupled(3)
    assert torch.equal(xa, xb) and fa == fb
