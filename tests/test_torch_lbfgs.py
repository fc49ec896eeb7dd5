"""The port's L-BFGS (mobocmf_tpu_torch/acquisition/lbfgs.py) against
optax.lbfgs() at f64 on the CPU, run as mobocmf_tpu/acquisition/optimize.py
runs it: one vmapped lax.while_loop over lanes, its stop rule reading the
gradient of the previous body, the value and gradient taken from the line
search's state (optax.value_and_grad_from_state).

Every case holds each lane's iteration count (equal), its final point
(1e-9) and its iterates over the first 30 iterations: to 1e-10 of the
iterate's size, plus ten times the distance optax's own iterate moves when
the lane's start moves by one ulp. That second term is rounding: XLA
contracts optax's multiply-adds into FMAs on the CPU (one x + s * y in four
rounds differently from torch's two operations), and a curved valley grows
such one-ulp differences (Rosenbrock at d = 2: 3.9e-10 against optax by
iteration 27, where optax's one-ulp spread is 8.6e-11). The objectives
compute their values and gradients alike in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobocmf_tpu_torch.acquisition import lbfgs as LB
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
HISTORY = 30


def optax_lanes(fn, z0, maxiter, gtol=None):
    """optax.lbfgs() on each lane of z0 (L, d), as the JAX package's search
    loop runs it. Returns (final z, iterations per lane, the iterate after
    each of the first HISTORY iterations (L, HISTORY, d), line-search steps
    per iteration (L, HISTORY), and how far those iterates move when z0
    moves by one ulp)."""
    solver = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(fn)
    stop = -1.0 if gtol is None else gtol

    def cond(carry):
        _, _, grad, it = carry
        return (it < maxiter) & (jnp.max(jnp.abs(grad)) > stop)

    def body(carry):
        z, state, _, it = carry
        value, grad = value_and_grad(z, state=state)
        updates, state = solver.update(grad, state, z, value=value, grad=grad, value_fn=fn)
        return (optax.apply_updates(z, updates), state, grad, it + 1)

    def init(z):
        return (z, solver.init(z), jnp.full_like(z, jnp.inf), 0)

    def run_one(z):
        z, _, _, it = jax.lax.while_loop(cond, body, init(z))
        return z, it

    def history_one(z):
        def step(carry, _):  # the while_loop under vmap: a stopped lane is kept
            carry = jax.lax.cond(cond(carry), body, lambda c: c, carry)
            return carry, (carry[0], carry[1][2].info.num_linesearch_steps)

        return jax.lax.scan(step, init(z), None, length=HISTORY)[1]

    history = jax.jit(jax.vmap(history_one))
    z, its = jax.jit(jax.vmap(run_one))(jnp.asarray(z0))
    hist, ls = history(jnp.asarray(z0))
    moved, _ = history(jnp.asarray(np.nextafter(z0, np.inf)))
    return (np.asarray(z), np.asarray(its), np.asarray(hist), np.asarray(ls),
            np.abs(np.asarray(moved) - np.asarray(hist)))


def port_lanes(fun, z0, maxiter, gtol=None, monkeypatch=None):
    """lbfgs_lanes from z0, with the iterate each iteration starts from."""
    seen = []
    inner = LB.precondition

    def spy(grad, z, mem):
        seen.append(z.clone())
        return inner(grad, z, mem)

    monkeypatch.setattr(LB, "precondition", spy)
    z = LB.lbfgs_lanes(fun, torch.as_tensor(z0, dtype=F64), maxiter, gtol)
    monkeypatch.setattr(LB, "precondition", inner)
    # the iterate after iteration j is the start of iteration j + 1, or z
    after = torch.stack(seen[1:] + [z]).transpose(0, 1).numpy()
    return z.numpy(), dict(LB.last_stats), after


def _compare(jfn, tfn, z0, maxiter, gtol, monkeypatch):
    zj, itj, hist, ls, spread = optax_lanes(jfn, z0, maxiter, gtol)
    zp, stats, after = port_lanes(tfn, z0, maxiter, gtol, monkeypatch)
    assert stats["lane_iterations"] == itj.tolist()
    n = min(HISTORY, after.shape[1])
    size = np.abs(hist[:, :n]).max(-1, keepdims=True)
    bound = 1e-10 * size + 10.0 * spread[:, :n]
    off = np.abs(after[:, :n] - hist[:, :n])
    assert np.all(off <= bound), np.argwhere(off > bound)[:5]
    np.testing.assert_allclose(zp, zj, rtol=1e-9, atol=1e-12)
    assert stats["at_gtol"] + stats["at_maxiter"] == stats["lanes"] == z0.shape[0]
    return stats, itj, ls


def rosenbrock(z):
    return (100.0 * (z[..., 1:] - z[..., :-1] ** 2) ** 2 + (1.0 - z[..., :-1]) ** 2).sum(-1)


@pytest.mark.parametrize("d", [2, 6])
def test_rosenbrock_follows_optax(d, monkeypatch):
    z0 = 1.5 * np.random.default_rng(d).normal(size=(5, d))
    stats, its, _ = _compare(rosenbrock, rosenbrock, z0, 200, 1e-5, monkeypatch)
    assert stats["at_gtol"] == 5 and its.min() > HISTORY // 2
    assert stats["evaluations"] > stats["iterations"] + 1  # some searches took more than one step


SCALES = 4.0 ** np.arange(6)  # curvatures 1 to 1024


def _quadratic(xp):
    scales = xp.asarray(SCALES) if xp is jnp else torch.as_tensor(SCALES)

    def fn(z):
        c = z - 0.25
        return 0.5 * (scales * c**2).sum(-1) + 0.125 * (c[..., 0] * c[..., 1]) ** 2
    return fn


def test_ill_conditioned_quadratic_follows_optax(monkeypatch):
    z0 = np.random.default_rng(1).normal(size=(4, 6))
    stats, its, _ = _compare(_quadratic(jnp), _quadratic(torch), z0, 200, 1e-8, monkeypatch)
    assert stats["at_gtol"] == 4 and its.max() > 10


def plateau(z):
    """A quartic bowl on a large constant: once the steps' decrease falls
    under the value's rounding, Armijo's test fails and the approximate
    decrease criterion decides."""
    return 1024.0 + (((z - 0.5) ** 2) ** 2).sum(-1)


def test_plateau_takes_the_approximate_decrease(monkeypatch):
    z0 = 0.5 + 0.05 * np.random.default_rng(4).normal(size=(3, 2))
    approx_only = []
    inner = LB._decrease_error

    def spy(stepsize, value, slope, value_init, slope_init):
        err = inner(stepsize, value, slope, value_init, slope_init)
        armijo = value - value_init - LB.SLOPE_RTOL * stepsize * slope_init
        approx_only.append(bool(((armijo > 0) & (err == 0)).any()))
        return err

    monkeypatch.setattr(LB, "_decrease_error", spy)
    stats, its, _ = _compare(plateau, plateau, z0, 40, None, monkeypatch)
    assert any(approx_only)
    assert its.tolist() == [40, 40, 40] and stats["at_maxiter"] == 3


def walled(z):
    """A bowl whose minimum (at 2) lies outside the unit ball, +inf outside:
    the line searches step out of the domain, zoom back, and end failed on
    their safe step."""
    inside = (z**2).sum(-1) < 1.0
    value = ((z - 2.0) ** 2).sum(-1)
    if isinstance(z, torch.Tensor):
        return torch.where(inside, value, torch.full_like(value, float("inf")))
    return jnp.where(inside, value, jnp.inf)


def test_failed_searches_take_the_safe_step(monkeypatch):
    z0 = 0.25 * np.random.default_rng(5).normal(size=(4, 2))
    stats, _, ls = _compare(walled, walled, z0, 60, 1e-5, monkeypatch)
    assert stats["failed_searches"] == 4
    assert ls.max() >= 10 and stats["ls_steps_max"] == ls.max()
    # every lane ends at the wall, facing the minimum
    zp = LB.lbfgs_lanes(walled, torch.as_tensor(z0, dtype=F64), 60, 1e-5)
    radius = torch.linalg.norm(zp, dim=-1)
    assert bool(((radius > 0.999) & (radius < 1.0)).all())


def test_one_lane_stops_at_gtol_while_the_others_go_on(monkeypatch):
    """Lane 0 starts at its minimum: its first body sees a zero gradient,
    so it stops after one iteration (the stop rule lags one body) and is
    kept, bit for bit, while the others run on."""
    z0 = np.random.default_rng(6).normal(size=(4, 6))
    z0[0] = 0.25
    fn = _quadratic(torch)
    stats, its, _ = _compare(_quadratic(jnp), fn, z0, 200, 1e-8, monkeypatch)
    assert its[0] == 1 and its[1:].min() > 10 and stats["at_gtol"] == 4
    zp = LB.lbfgs_lanes(fn, torch.as_tensor(z0, dtype=F64), 200, 1e-8)
    assert torch.equal(zp[0], torch.as_tensor(z0[0]))


def test_precondition_matches_scale_by_lbfgs():
    """One memory through 14 updates (the ring of 10 wraps), per lane
    against optax.scale_by_lbfgs on the same params and gradients,
    including a pair with s.y == 0 (weight 0) and a repeated gradient
    (y.y == 0, gamma 1)."""
    rng = np.random.default_rng(7)
    lanes, d, steps = 3, 5, 14
    params = np.cumsum(rng.normal(size=(steps, lanes, d)), axis=0)
    grads = rng.normal(size=(steps, lanes, d))
    params[5, 1] = params[4, 1]  # s = 0 in lane 1
    grads[8, 2] = grads[7, 2]  # y = 0 in lane 2
    tx = optax.scale_by_lbfgs()
    state = jax.vmap(tx.init)(jnp.asarray(params[0]))
    update = jax.jit(jax.vmap(tx.update))
    mem = LB.init_memory(torch.as_tensor(params[0]))
    for k in range(steps):
        want, state = update(jnp.asarray(grads[k]), state, jnp.asarray(params[k]))
        got, mem = LB.precondition(torch.as_tensor(grads[k]), torch.as_tensor(params[k]), mem)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(mem.weights.numpy().T, np.asarray(state.weights_memory), rtol=1e-14)
    assert mem.count == steps


@pytest.mark.parametrize("maxiter", [10, 11, 20, 21])
def test_ring_wraps_at_its_edges(maxiter, monkeypatch):
    """The ring's position is a device count: runs that end on either side
    of count % 10 == 0 (one and two wraps) keep optax's iterates, every
    lane running maxiter iterations."""
    z0 = 1.5 * np.random.default_rng(8).normal(size=(3, 6))
    stats, its, _ = _compare(rosenbrock, rosenbrock, z0, maxiter, None, monkeypatch)
    assert its.tolist() == [maxiter] * 3 and stats["at_maxiter"] == 3


def below(z):
    """A bowl whose disk of radius 0.1 around its minimum is -inf: a line
    search that lands there is done (-inf passes the decrease test), so the
    next iteration starts from a value that is not finite and recomputes it
    (value_and_grad_from_state)."""
    c = ((z - 0.3) ** 2).sum(-1)
    if isinstance(z, torch.Tensor):
        return torch.where(c < 0.01, torch.full_like(c, -float("inf")), c)
    return jnp.where(c < 0.01, -jnp.inf, c)


def test_a_value_turned_non_finite_is_recomputed(monkeypatch):
    z0 = np.random.default_rng(9).normal(size=(4, 2))
    stats, its, _ = _compare(below, below, z0, 50, 1e-5, monkeypatch)
    assert stats["fresh"] >= 2  # iteration 0's, and at least one mid-search
    assert stats["at_gtol"] == 4 and its.max() < 50


def test_line_search_stops_with_its_last_searching_lane(monkeypatch):
    """Lanes that stop at gtol at different iterations, and lanes whose line
    searches end at different steps: every line search runs as many
    evaluations as its slowest active lane's steps (optax's), so the run
    takes one evaluation for iteration 0's value plus, per iteration, the
    most steps any active lane took (the history covers every iteration)."""
    monkeypatch.setitem(globals(), "HISTORY", 40)
    z0 = 0.25 + 0.5 * np.random.default_rng(10).normal(size=(5, 6))
    z0[0] = 0.25 + 1e-3  # near the minimum: stops first
    stats, its, ls = _compare(_quadratic(jnp), _quadratic(torch), z0, 200, 1e-5, monkeypatch)
    assert its.max() <= HISTORY and len(set(its.tolist())) == 5
    want = 1 + sum(int(ls[its > j, j].max()) for j in range(its.max()))
    assert stats["evaluations"] == want and stats["fresh"] == 1
    assert stats["ls_steps_max"] == ls.max() > 1
