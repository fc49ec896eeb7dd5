"""The port's kernels, constraints, distances, bucketing and test functions
against the JAX package, at f64 (Grams and diags at rtol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.core import constraints as jcons
from mobocmf_tpu.core import distances as jdist
from mobocmf_tpu.fit import bucketing as jbuck
from mobocmf_tpu.kernels import deep_mf as jdeep
from mobocmf_tpu.kernels import rbf as jrbf
from mobocmf_tpu.test_functions import synthetic as jsyn
from mobocmf_tpu_torch.core import config as pcfg
from mobocmf_tpu_torch.core import constraints as pcons
from mobocmf_tpu_torch.core import distances as pdist
from mobocmf_tpu_torch.fit import bucketing as pbuck
from mobocmf_tpu_torch.kernels import deep_mf as pdeep
from mobocmf_tpu_torch.kernels import rbf as prbf
from mobocmf_tpu_torch.test_functions import synthetic as psyn
from torch_threads import one_intra_op_thread  # noqa: F401


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float64))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _raw(rng, d):
    return {"raw_lengthscale": rng.normal(size=d), "raw_outputscale": rng.normal()}


def _deep_raw(rng, d):
    return {"kx1": _raw(rng, d), "kf": _raw(rng, 1), "kx2": _raw(rng, d),
            "klin": {"raw_variance": rng.normal()}}


def _close(a, b, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_rbf_and_linear_match_jax(seed):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.uniform(size=(9, 3)), rng.uniform(size=(7, 3))
    p = _raw(rng, 3)
    _close(prbf.rbf_gram(_t(p), _t(x1), _t(x2)), jrbf.rbf_gram(_j(p), _j(x1), _j(x2)))
    _close(prbf.rbf_diag(_t(p), _t(x1)), jrbf.rbf_diag(_j(p), _j(x1)))
    lin = {"raw_variance": rng.normal()}
    _close(prbf.linear_gram(_t(lin), _t(x1), _t(x2)), jrbf.linear_gram(_j(lin), _j(x1), _j(x2)))
    _close(prbf.linear_diag(_t(lin), _t(x1)), jrbf.linear_diag(_j(lin), _j(x1)))


def test_rbf_gram_batched_params_and_inputs():
    """Leading blackbox dim on params and inputs equals per-model Grams."""
    rng = np.random.default_rng(2)
    ps = [_raw(rng, 2) for _ in range(3)]
    xs = rng.uniform(size=(3, 6, 2))
    z = rng.uniform(size=(5, 2))
    stacked = {k: torch.stack([_t(p)[k] for p in ps]) for k in ps[0]}
    got = prbf.rbf_gram(stacked, _t(xs), _t(z))
    assert got.shape == (3, 6, 5)
    for i, p in enumerate(ps):
        _close(got[i], jrbf.rbf_gram(_j(p), _j(xs[i]), _j(z)))
    shared = prbf.rbf_gram(stacked, _t(z), _t(z))
    assert shared.shape == (3, 5, 5)
    _close(shared[1], jrbf.rbf_gram(_j(ps[1]), _j(z), _j(z)))


@pytest.mark.parametrize("only_hf", [False, True])
def test_deep_mf_gram_and_diag_match_jax(only_hf):
    rng = np.random.default_rng(3)
    xf1, xf2 = rng.uniform(size=(8, 3)), rng.uniform(size=(5, 3))
    p = _deep_raw(rng, 2)
    gram_p, diag_p = (pdeep.only_hf_gram, pdeep.only_hf_diag) if only_hf else (
        pdeep.deep_mf_gram, pdeep.deep_mf_diag)
    gram_j, diag_j = (jdeep.only_hf_gram, jdeep.only_hf_diag) if only_hf else (
        jdeep.deep_mf_gram, jdeep.deep_mf_diag)
    _close(gram_p(_t(p), _t(xf1), _t(xf2)), gram_j(_j(p), _j(xf1), _j(xf2)))
    _close(diag_p(_t(p), _t(xf1)), diag_j(_j(p), _j(xf1)))
    # the diag is the diagonal of the Gram
    _close(diag_p(_t(p), _t(xf1)), np.diag(np.asarray(gram_j(_j(p), _j(xf1), _j(xf1)))))


@pytest.mark.parametrize("only_hf", [False, True])
def test_kernel_init_matches_jax(only_hf):
    ls0 = np.array([0.3, 0.7])
    if only_hf:
        got, want = pdeep.init_only_hf_params(ls0, 2), jdeep.init_only_hf_params(ls0, 2)
    else:
        got, want = pdeep.init_deep_mf_params(ls0, 2), jdeep.init_deep_mf_params(ls0, 2)
    for k in want:
        for kk in want[k]:
            _close(got[k][kk], want[k][kk])
    _close(prbf.init_scale_rbf_params(0.4, 2.0, 3)["raw_lengthscale"],
           jrbf.init_scale_rbf_params(0.4, 2.0, 3)["raw_lengthscale"])


def test_constraints_match_jax():
    v = np.array([1e-6, 0.3, 5.0, 25.0, 40.0])
    raw = np.array([-30.0, -2.0, 0.0, 3.0, 30.0])
    _close(pcons.softplus(torch.as_tensor(raw)), jcons.softplus(jnp.asarray(raw)))
    _close(pcons.inv_softplus(torch.as_tensor(v)), jcons.inv_softplus(jnp.asarray(v)))
    iv_p, iv_j = pcons.Interval(1e-8, 0.5), jcons.Interval(1e-8, 0.5)
    _close(iv_p.forward(torch.as_tensor(raw)), iv_j.forward(jnp.asarray(raw)))
    _close(iv_p.inverse(torch.as_tensor(v / 100)), iv_j.inverse(jnp.asarray(v / 100)))
    gt_p, gt_j = pcons.GreaterThan(0.1), jcons.GreaterThan(0.1)
    _close(gt_p.forward(torch.as_tensor(raw)), gt_j.forward(jnp.asarray(raw)))
    _close(gt_p.inverse(torch.as_tensor(v + 0.2)), gt_j.inverse(jnp.asarray(v + 0.2)))
    assert pcfg.default_jitter(torch.float64) == 2e-6
    assert pcfg.default_jitter(torch.float32) == 1e-5


@pytest.mark.parametrize("n", [1, 2, 9, 12])
def test_median_lengthscale_matches_jax(n):
    x = np.random.default_rng(n).uniform(size=(n, 2))
    want = float(jdist.median_lengthscale_np(x))
    assert float(pdist.median_lengthscale_np(x)) == want
    np.testing.assert_allclose(pdist.median_lengthscale(torch.as_tensor(x)).item(), want, rtol=1e-12)


def test_bucketing_matches_jax():
    for n in (1, 8, 9, 64, 65, 120, 128, 129, 490, 512, 513):
        assert pbuck.next_bucket(n) == jbuck.next_bucket(n)
    x = np.random.default_rng(0).uniform(size=(11, 2))
    fid = np.arange(11) % 2
    for a, b in zip(pbuck.pad_inputs_np(x, fid, 16), jbuck.pad_inputs_np(x, fid, 16)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pbuck.pad_rows_np(x[:, 0], 16), jbuck.pad_rows_np(x[:, 0], 16))


def test_synthetic_functions_match_jax_package():
    x = np.random.default_rng(1).uniform(size=(17, 2))
    for name in ("branin_scaled", "branin_scaled_low", "currin", "currin_low", "disk_constraint"):
        np.testing.assert_array_equal(getattr(psyn, name)(x), getattr(jsyn, name)(x))
    x6 = np.random.default_rng(2).uniform(size=(5, 6))
    np.testing.assert_array_equal(psyn.hartmann6(x6), jsyn.hartmann6(x6))
    np.testing.assert_array_equal(psyn.dtlz2(x6), jsyn.dtlz2(x6))
