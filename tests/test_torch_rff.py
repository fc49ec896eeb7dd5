"""RFF pathwise sampling in the port against the JAX package at f64.

The two packages draw W, b and the theta seeds from different generators,
so the tests hand the JAX package's draws to the port (rff.LayerDraws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.fit import trainer as jtrainer
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu.sampling import rff as jrff
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.models.convert import model_from_numpy
from mobocmf_tpu_torch.sampling import rff
from mobocmf_tpu_torch.test_functions.prior_problem import sample_problem
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _to_port_sample(js):
    layers = []
    for lay in js.layers:
        cls = rff.Layer0Sample if isinstance(lay, jrff.Layer0Sample) else rff.DeepLayerSample
        layers.append(cls(*[torch.as_tensor(np.asarray(a)) for a in lay]))
    return rff.MFDGPFunctionSample(layers=tuple(layers))


def _stacked_problem(seed=0, n=12, num_models=2, whitened=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    ys = [np.sin(4 * x[:, 0]) + x[:, 1] ** 2, np.cos(3 * x[:, 1]) * x[:, 0], x[:, 0] - x[:, 1]]
    models = [JM.init_mfdgp(jax.random.key(i), jnp.asarray(x), jnp.asarray(y)[:, None],
                            jnp.asarray(fid), 2, whitened=whitened)
              for i, y in enumerate(ys[:num_models])]
    sp, sc, config = jtrainer.stack_models(models)
    pm = model_from_numpy(jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, sc),
                          config._asdict(), "cpu", F64)
    return sp, sc, config, pm, x


def test_host_dual_theta_identical_for_the_same_seed():
    rng = np.random.default_rng(1)
    phi = rng.normal(size=(60, 9))
    y = rng.normal(size=9)
    a = rng.normal(size=(9, 9))
    s_cov = a @ a.T * 1e-3
    got = rff.host_dual_theta(123, phi, y, s_cov)
    want = jrff.host_dual_theta(123, phi, y, s_cov)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, rff.host_dual_theta(124, phi, y, s_cov))


@pytest.mark.parametrize("kind", ["prior", "posterior"])
def test_eval_sample_with_injected_weights(kind):
    """The same W, b and theta evaluate to the same function, every layer."""
    sp, sc, config, _, x = _stacked_problem(2)
    if kind == "prior":
        js = jrff.sample_prior(jax.random.key(5), 2, 2, n_features=64, dtype=jnp.float64)
    else:
        js = jrff.sample_posterior_stacked(jax.random.key(5), sp, sc, config, 2, n_features=64)[1]
    ps = _to_port_sample(js)
    xq = np.random.default_rng(3).uniform(size=(9, 2))
    for layer in (0, None):
        want = np.asarray(jrff.eval_sample(js, jnp.asarray(xq), layer=layer))
        got = rff.eval_sample(ps, torch.as_tensor(xq), layer=layer).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        rff.eval_sample_scalar(ps, torch.as_tensor(xq[0])).item(),
        float(jrff.eval_sample_scalar(js, jnp.asarray(xq[0]))), rtol=1e-9)


@pytest.mark.parametrize("whitened", [False, True])
def test_sample_posterior_stacked_matches_jax_with_injected_draws(whitened):
    """Features at the dynamic inducing points and the host dual solve: the
    port's weights from the JAX package's W, b and seeds. theta goes
    through a QR of the feature matrix and G = R R^T + 1e-6 I (condition up
    to ~1e9 here), so 1e-12 differences in the features move it by ~1e-7."""
    sp, sc, config, pm, x = _stacked_problem(3, whitened=whitened)
    key, n_features = jax.random.key(11), 64
    jss = jrff.sample_posterior_stacked(key, sp, sc, config, 2, n_features=n_features)
    key_theta = jax.random.split(key, 3)[2]
    draws = []
    softplus = lambda r: np.log1p(np.exp(r))  # noqa: E731
    for i, js in enumerate(jss):
        # W = normals / lengthscale and b = 2 pi u: recover the normals and u
        seeds = [jrff._key_to_seed(jax.random.fold_in(key_theta, i * 131 + ell)) for ell in range(2)]
        l0, l1 = js.layers
        ls = softplus(np.asarray(sp.layers[0].kernel["raw_lengthscale"])[i])
        c = jax.tree.map(lambda a: softplus(np.asarray(a)[i]), sp.layers[1].kernel)
        normals1 = np.concatenate([
            np.asarray(l1.w_x1) * c["kx1"]["raw_lengthscale"],
            np.asarray(l1.w_x1f)[:, -1:] * c["kf"]["raw_lengthscale"],
            np.asarray(l1.w_x2) * c["kx2"]["raw_lengthscale"],
        ], axis=1)
        two_pi = 2 * np.pi
        draws.append([
            rff.LayerDraws(torch.as_tensor(np.asarray(l0.w) * ls),
                           torch.as_tensor(np.asarray(l0.b) / two_pi), seeds[0]),
            rff.LayerDraws(torch.as_tensor(normals1),
                           torch.as_tensor(np.concatenate([np.asarray(l1.b_x1), np.asarray(l1.b_x2)], 1) / two_pi),
                           seeds[1]),
        ])
    pss = rff.sample_posterior_stacked(None, pm.params, pm.consts, pm.config, n_features, draws)
    xq = torch.as_tensor(np.random.default_rng(4).uniform(size=(11, 2)))
    for js, ps in zip(jss, pss):
        for jl, pl in zip(js.layers, ps.layers):
            for name in jl._fields:
                tol = 1e-6 if name == "theta" else 1e-12
                np.testing.assert_allclose(getattr(pl, name).numpy(), np.asarray(getattr(jl, name)),
                                           rtol=tol, atol=tol)
        want = np.asarray(jrff.eval_sample(js, jnp.asarray(xq.numpy())))
        np.testing.assert_allclose(rff.eval_sample(ps, xq).numpy(), want, rtol=1e-6, atol=1e-6)


def test_sample_posterior_stacked_matches_per_model_sampling():
    """One stacked call draws model by model, so per-model calls with the
    same generator stream give the same samples."""
    _, _, _, pm, _ = _stacked_problem(5, num_models=3)
    stacked = rff.sample_posterior_stacked(torch.Generator().manual_seed(9), pm.params, pm.consts,
                                           pm.config, n_features=32)
    g = torch.Generator().manual_seed(9)
    for i, s in enumerate(stacked):
        mi = trainer.select_model(pm, i)
        single = rff.sample_posterior(g, mi.params, mi.consts, mi.config, n_features=32)
        for a, b in zip(s.layers, single.layers):
            for u, v in zip(a, b):
                np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-12, atol=1e-14)


def test_sample_problem_calibrates_feasibility():
    objs, cons = sample_problem(torch.Generator().manual_seed(0), d=2, num_constraints=2,
                                device="cpu")
    assert len(objs) == 2 and len(cons) == 2
    probe = torch.rand((400, 2), generator=torch.Generator().manual_seed(1), dtype=F64)
    joint = torch.ones(400, dtype=torch.bool)
    for c in cons:
        v = rff.eval_sample(c, probe)
        assert 0.02 < float((v >= 0).double().mean()) < 0.98
        joint &= v >= 0
    assert bool(joint.any())
    for fid in (0, 1):
        assert rff.eval_sample(objs[0], probe, layer=fid).shape == (400,)
