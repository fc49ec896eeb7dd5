"""The MOOP's device polish in the port against the JAX package's at f64,
on the same sampled functions, grid and feasibility.

Both minimize the same penalty objective by optax's L-BFGS (the port's
copy: acquisition/lbfgs.py) for 100 iterations from the same deterministic
starts. Where the JAX package accepts an optimum, the port accepts one
too, at least as good (rtol 1e-7); where both end at the same point, the
values agree to rtol 1e-7; whatever the port accepts passes the accept
rule (feasible, and better than the best feasible grid point); and each
optimum of the draws below but one is the JAX package's own outcome (the
same point, or no point in either)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.moop import moop as jmoop
from mobocmf_tpu.sampling import rff as jrff
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


def _functions(seed, n_con=1):
    """Two objectives and n_con constraints drawn from the MFDGP prior."""
    keys = jax.random.split(jax.random.key(seed), 2 + n_con)
    js = [jrff.sample_prior(k, 2, 2, n_features=50, dtype=jnp.float64) for k in keys]
    jf = [jmoop.SampledFunction(jrff.eval_sample_fn, s) for s in js]
    pf = [moop.SampledFunction(rff.eval_sample_fn, _to_port_sample(s)) for s in js]
    return jf, pf


CASES = [(5, 1, -0.5), (7, 1, 0.2), (11, 2, 0.0), (13, 0, 0.0)]


@pytest.mark.parametrize("seed,n_con,level", CASES)
def test_device_polish_matches_jax(seed, n_con, level):
    _compare(seed, n_con, level)


@functools.lru_cache(maxsize=None)
def _compare(seed, n_con, level) -> tuple:
    """Checks one draw; returns, per objective, whether the port ends where
    the JAX package does (the same point, or no point in either)."""
    jf, pf = _functions(seed, n_con)
    grid = np.random.default_rng(seed).uniform(size=(80, 2))
    kw = dict(input_dim=2, feasible_values=np.full(max(n_con, 1), level), polish="device")
    jm, pm = jmoop.MOOP(jf[:2], jf[2:], **kw), moop.MOOP(pf[:2], pf[2:], **kw)
    cons = (np.stack([np.asarray(f(jnp.asarray(grid))) for f in jf[2:]]) if n_con
            else np.zeros((0, 80)))
    feas = jm._feasible_mask(cons, True)
    same = []
    for i in range(2):
        evals = np.asarray(jf[i](jnp.asarray(grid)))
        want = jm.optimize_obj_globally_device(i, evals, feas, grid, jax.random.key(0))
        got = pm.optimize_obj_globally_device(i, evals, feas, grid, torch.zeros((), dtype=F64))
        if got is not None:
            v_p = pf[i](torch.as_tensor(got)).item()
            assert v_p < np.min(np.where(feas, evals, np.inf))
            for c in pf[2:]:
                assert c(torch.as_tensor(got)).item() >= level - 1e-6
        same.append(got is None and want is None)
        if want is not None:
            v_j = float(jf[i](jnp.asarray(want))[0])
            assert got is not None, (i, want)
            assert v_p <= v_j + 1e-7 * abs(v_j), (i, v_p, v_j)
            if np.abs(got - want).max() < 1e-5:
                same[-1] = True
                np.testing.assert_allclose(v_p, v_j, rtol=1e-7)
    return tuple(same)


# (draw, objective) whose optimum is not the JAX package's: of its five
# lanes, the one that ends best (start 3) hugs a constraint's penalty wall,
# every line search of it failing at 20 steps; it leaves the JAX package's
# iterates by 1e-8 from iteration 50, and the JAX package's own lane moves
# 5.6e-2 by iteration 100 when its start moves by one ulp. Its end point
# decides the outcome: the port's lane ends feasible (the port accepts it,
# value -0.7225), the JAX package's ends elsewhere and it accepts another
# lane's point (value -0.4064). The port's optimum is held by value above.
DIVERGES = {((11, 2, 0.0), 0)}


def test_device_polish_often_ends_where_jax_does():
    """Every optimum of the draws above but DIVERGES' is the JAX package's
    own outcome: the same point with the same value (1e-7), or no point in
    either package."""
    ends = {(c, i): same for c in CASES for i, same in enumerate(_compare(*c))}
    assert {k for k, same in ends.items() if not same} == DIVERGES
