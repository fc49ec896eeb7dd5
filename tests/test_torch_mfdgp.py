"""Parity of the port's MFDGP (mobocmf_tpu_torch) with the JAX package at f64.

Both packages get the same numpy inputs; the JAX model's weights (and its
eps draws) are handed to the port as numpy arrays, so the two compute the
same function on the same values. Tolerances are those of
tests/test_parity_torch.py:196-200.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.mlls.elbo import elbo_terms as jax_elbo_terms
from mobocmf_tpu.models import mfdgp as JM
from mobocmf_tpu_torch.mlls.elbo import elbo_terms
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models.convert import model_from_numpy, model_to_numpy
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _data(seed, n=16, d=2, num_fidelities=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(4 * x[:, 0]) + x[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    fid = (np.arange(n) % num_fidelities).astype(np.int64)
    return x, y, fid


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(seed, x, y, fid, num_fidelities, **kw):
    return JM.init_mfdgp(
        jax.random.key(seed), jnp.asarray(x), jnp.asarray(y)[:, None], jnp.asarray(fid),
        num_fidelities, **kw,
    )


def _to_port(jm):
    return model_from_numpy(
        _np(jm.params), _np(jm.consts), jm.config._asdict(), "cpu", F64
    )


def _perturb_whitened(jm, seed):
    """Move whitened coordinates off their init point (generic parameter value)."""
    prng = np.random.default_rng(seed + 7)
    layers = []
    for lp in jm.params.layers:
        mw = np.asarray(lp.variational.mean) + 0.1 * prng.normal(size=lp.variational.mean.shape)
        lw = np.asarray(lp.variational.chol_raw)
        lw = lw + 0.05 * np.tril(prng.normal(size=lw.shape))
        lw[np.diag_indices_from(lw)] = np.abs(lw[np.diag_indices_from(lw)]) + 0.05
        layers.append(lp._replace(variational=lp.variational._replace(
            mean=jnp.asarray(mw), chol_raw=jnp.asarray(lw))))
    return jm._replace(params=jm.params._replace(layers=tuple(layers)))


INIT_CASES = [
    dict(),
    dict(whitened=True),
    dict(whitened=True, whitened_init="prior"),
    dict(use_only_highest_fidelity=True),
    dict(init_params_to_prior_and_fix_them=True),
]


@pytest.mark.parametrize("kw", INIT_CASES, ids=lambda kw: "-".join(kw) or "default")
def test_init_mfdgp_parity(kw):
    x, y, fid = _data(3)
    jm = _jax_model(3, x, y, fid, 2, **kw)
    pm = M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(0),
                      device="cpu", dtype=F64, **kw)
    p_params, p_consts, p_config = model_to_numpy(pm)
    assert p_config == jm.config._asdict()
    jl, pl = jax.tree.leaves(_np(jm.params)), tree_leaves(p_params)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12)
    jc = _np(jm.consts)
    for a, b in zip(jc.z_x, p_consts.z_x):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(p_consts.noise_lower, jc.noise_lower, rtol=1e-14)
    np.testing.assert_allclose(p_consts.noise_upper, jc.noise_upper, rtol=1e-14)
    assert p_consts.acq_eps.shape == jc.acq_eps.shape


def test_convert_round_trip():
    x, y, fid = _data(4)
    jm = _jax_model(4, x, y, fid, 2)
    params, consts, config = model_to_numpy(_to_port(jm))
    for a, b in zip(jax.tree.leaves(_np(jm.params)), tree_leaves(params)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jax.tree.leaves(_np(jm.consts)), tree_leaves(consts)):
        np.testing.assert_array_equal(b, a)
    assert config == jm.config._asdict()


@pytest.mark.parametrize(
    "whitened,num_fidelities,seed",
    [(False, 2, 0), (False, 2, 1), (True, 2, 0), (True, 2, 1), (False, 3, 2), (True, 3, 2)],
)
def test_forward_elbo_kl_acquisition_parity(whitened, num_fidelities, seed):
    """Two blackboxes stacked in the port, each against its own JAX model.

    Both packages factor (K + K^T) / 2, as jnp.linalg.cholesky symmetrizes
    its input (the expansion-trick Gram is symmetric only to rounding); the
    port's linalg/ops.py does the same. Factoring the raw lower triangle
    instead put the [True-2-1] case's top-layer mean at 1.02x the bound.
    What is left is the two CPU LAPACKs' own rounding, ~1e-13 in the
    layer-0 factors. Two fidelities hold the 1e-9 bound. With three, that
    difference passes through two chain layers whose Kzz (jitter 2e-6) has
    condition ~1e7, which leaves differences up to ~6e-9 relative in the top
    layer: those cases allow 100x the bound."""
    tol = 1.0 if num_fidelities == 2 else 100.0
    x, y, fid = _data(seed, num_fidelities=num_fidelities)
    ys = [y, np.cos(3 * y)]
    jms = [_jax_model(seed + 10 * i, x, yi, fid, num_fidelities, whitened=whitened)
           for i, yi in enumerate(ys)]
    if whitened:
        jms = [_perturb_whitened(jm, seed + i) for i, jm in enumerate(jms)]
    n = x.shape[0]
    eps_j = [JM.sample_eps(jax.random.key(seed + 100 + i), jms[0].config, n, jnp.float64)
             for i in range(2)]

    from mobocmf_tpu_torch.fit.trainer import stack_models

    pm = stack_models([_to_port(jm) for jm in jms])
    xt = torch.as_tensor(x)
    yt = torch.as_tensor(np.stack(ys))
    ft = torch.as_tensor(fid)
    eps_t = torch.as_tensor(np.stack([np.asarray(e) for e in eps_j]))
    outs_p = M.forward(pm.params, pm.consts, pm.config, xt, eps_t)
    elbo_p, skl_p = elbo_terms(pm.params, pm.consts, pm.config, xt, yt, ft, eps_t, n)
    kl_p = M.kl_all_layers(pm.params, pm.consts, pm.config)
    x_acq = x[:5] + 0.01
    mus_p, vars_p = M.predict_for_acquisition_all(
        pm.params, pm.consts, pm.config, torch.as_tensor(x_acq))
    mu1_p, var1_p = M.predict_for_acquisition(
        pm.params, pm.consts, pm.config, torch.as_tensor(x_acq), 1)

    for i, jm in enumerate(jms):
        p, c, cfg = jm.params, jm.consts, jm.config
        outs_j = JM.forward(p, c, cfg, jnp.asarray(x), eps_j[i])
        for (mj, vj), (mp, vp) in zip(outs_j, outs_p):
            np.testing.assert_allclose(
                mp[i].numpy(), np.asarray(mj), rtol=1e-9 * tol, atol=1e-11 * tol)
            np.testing.assert_allclose(
                vp[i].numpy(), np.asarray(vj), rtol=1e-9 * tol, atol=1e-12 * tol)
        elbo_j, skl_j = jax_elbo_terms(p, c, cfg, jnp.asarray(x), jnp.asarray(ys[i]),
                                       jnp.asarray(fid), eps_j[i], n)
        np.testing.assert_allclose(float(elbo_p[i]), float(elbo_j), rtol=1e-9 * tol)
        np.testing.assert_allclose(float(skl_p[i]), float(skl_j), rtol=1e-9 * tol)
        kl_j = float(JM.kl_all_layers(p, c, cfg))
        np.testing.assert_allclose(float(kl_p[i]), kl_j, rtol=1e-9 * tol)
        mus_j, vars_j = JM.predict_for_acquisition_all(p, c, cfg, jnp.asarray(x_acq))
        np.testing.assert_allclose(
            mus_p[i].numpy(), np.asarray(mus_j), rtol=1e-9 * tol, atol=1e-11 * tol)
        np.testing.assert_allclose(
            vars_p[i].numpy(), np.asarray(vars_j), rtol=1e-9 * tol, atol=1e-12 * tol)
        mu1_j, var1_j = JM.predict_for_acquisition(p, c, cfg, jnp.asarray(x_acq), 1)
        np.testing.assert_allclose(
            mu1_p[i].numpy(), np.asarray(mu1_j), rtol=1e-9 * tol, atol=1e-11 * tol)
        np.testing.assert_allclose(
            var1_p[i].numpy(), np.asarray(var1_j), rtol=1e-9 * tol, atol=1e-12 * tol)


def test_only_hf_forward_parity():
    x, y, fid = _data(5)
    jm = _jax_model(5, x, y, fid, 2, use_only_highest_fidelity=True)
    pm = _to_port(jm)
    eps = JM.sample_eps(jax.random.key(9), jm.config, x.shape[0], jnp.float64)
    outs_j = JM.forward(jm.params, jm.consts, jm.config, jnp.asarray(x), eps)
    outs_p = M.forward(pm.params, pm.consts, pm.config, torch.as_tensor(x),
                       torch.as_tensor(np.asarray(eps)))
    for (mj, vj), (mp, vp) in zip(outs_j, outs_p):
        np.testing.assert_allclose(mp[0].numpy(), np.asarray(mj), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(vp[0].numpy(), np.asarray(vj), rtol=1e-9, atol=1e-12)


def test_layer_states_with_inverse_match_solves():
    """lk_inv (explicit L^{-1}) gives the same predictive as the solves."""
    x, y, fid = _data(6)
    pm = _to_port(_jax_model(6, x, y, fid, 2))
    xt = torch.as_tensor(x[:7])
    s0 = M.compute_layer_states(pm.params, pm.consts, pm.config)
    s1 = M.compute_layer_states(pm.params, pm.consts, pm.config, with_inv=True)
    a = M.predict_for_acquisition_all(pm.params, pm.consts, pm.config, xt, states=s0)
    b = M.predict_for_acquisition_all(pm.params, pm.consts, pm.config, xt, states=s1)
    for u, v in zip(a, b):
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=1e-9, atol=1e-12)


def test_sample_eps_shape_and_noise():
    x, y, fid = _data(7)
    jm = _jax_model(7, x, y, fid, 2)
    pm = _to_port(jm)
    e = M.sample_eps(torch.Generator().manual_seed(1), pm.config, 11, F64, "cpu", (3,))
    assert e.shape == (3, 1, 11)
    for f in range(2):
        np.testing.assert_allclose(
            M.likelihood_noise(pm.params, pm.consts, f)[0].item(),
            float(JM.likelihood_noise(jm.params, jm.consts, f)), rtol=1e-12)


@pytest.mark.parametrize("whitened", [False, True])
def test_layer_predictive_kl_and_data_term_match_jax(whitened):
    """svgp.predict_diag / kl_divergence (both parameterizations) and
    elbo_data_term against the JAX package."""
    from mobocmf_tpu.linalg.ops import safe_cholesky as jax_safe_cholesky
    from mobocmf_tpu.mlls.elbo import elbo_data_term as jax_elbo_data_term
    from mobocmf_tpu.models import svgp as JS
    from mobocmf_tpu_torch.linalg.ops import safe_cholesky
    from mobocmf_tpu_torch.mlls.elbo import elbo_data_term
    from mobocmf_tpu_torch.models import svgp as S

    x, y, fid = _data(8)
    jm = _perturb_whitened(_jax_model(8, x, y, fid, 2, whitened=whitened), 8)
    pm = _to_port(jm)
    lp, jlp = pm.params.layers[0], jm.params.layers[0]
    z, jz = pm.consts.z_x[0], jm.consts.z_x[0]
    xq = x[:6] + 0.02
    gram, diag = M._layer_fns(0, False)
    jgram, jdiag = JM._layer_fns(0, False)
    lk = safe_cholesky(gram(lp.kernel, z, z), pm.config.jitter)
    jlk = jax_safe_cholesky(jgram(jlp.kernel, jz, jz), jm.config.jitter)
    mu, var = S.predict_diag(gram, diag, lp.kernel, lp.variational, z, torch.as_tensor(xq), lk,
                             whitened)
    jpred = JS.predict_diag_whitened if whitened else JS.predict_diag
    jmu, jvar, _ = jpred(jgram, jdiag, jlp.kernel, jlp.variational, jz, jnp.asarray(xq),
                         jm.config.jitter, lk=jlk)
    np.testing.assert_allclose(mu[0].numpy(), np.asarray(jmu), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var[0].numpy(), np.asarray(jvar), rtol=1e-9, atol=1e-12)
    kl = S.kl_divergence(lp.variational, lk, whitened)
    jkl = (JS.kl_divergence_whitened(jlp.variational) if whitened else
           JS.kl_divergence(jgram, jlp.kernel, jlp.variational, jz, jm.config.jitter, lk=jlk))
    np.testing.assert_allclose(float(kl[0]), float(jkl), rtol=1e-9)

    eps = JM.sample_eps(jax.random.key(3), jm.config, x.shape[0], jnp.float64)
    got = elbo_data_term(pm.params, pm.consts, pm.config, torch.as_tensor(x),
                         torch.as_tensor(y)[None], torch.as_tensor(fid),
                         torch.as_tensor(np.array(eps)))
    want = jax_elbo_data_term(jm.params, jm.consts, jm.config, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(fid), eps)
    np.testing.assert_allclose(float(got[0]), float(want), rtol=1e-9)


def test_init_variational_matches_jax():
    from mobocmf_tpu.models import svgp as JS
    from mobocmf_tpu_torch.models import svgp as S

    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 6))
    for cov in (a @ a.T, 1e-8 * np.eye(6)):
        m = rng.normal(size=6)
        mean, chol = S.init_variational(m, cov)
        want = JS.init_variational(jnp.asarray(m), jnp.asarray(cov))
        np.testing.assert_allclose(chol, np.asarray(want.chol_raw), rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(mean, np.asarray(want.mean))


@pytest.mark.parametrize("given_factor", [False, True])
def test_svgp_predict_mean_matches_jax(given_factor):
    """svgp.predict_mean on layer 0 of a perturbed model, with and without
    the factor given: the mean at rtol 1e-9, the factor it used at 1e-12."""
    from mobocmf_tpu.kernels import rbf as jrbf
    from mobocmf_tpu.linalg.ops import safe_cholesky as jsafe_cholesky
    from mobocmf_tpu.models import svgp as jsvgp
    from mobocmf_tpu_torch.kernels import rbf
    from mobocmf_tpu_torch.models import svgp

    x, y, fid = _data(5)
    jm = _perturb_whitened(_jax_model(5, x, y, fid, 2), 5)
    lp, z = jm.params.layers[0], jm.consts.z_x[0]
    xt = np.random.default_rng(6).uniform(size=(7, 2))
    jitter = jm.config.jitter
    lk_j = jsafe_cholesky(jrbf.rbf_gram(lp.kernel, z, z), jitter) if given_factor else None
    mu_j, lk_j = jsvgp.predict_mean(jrbf.rbf_gram, lp.kernel, lp.variational, z,
                                    jnp.asarray(xt), jitter, lk_j)
    pm = _to_port(jm)
    plp, pz = pm.params.layers[0], pm.consts.z_x[0]
    lk_p = torch.as_tensor(np.asarray(lk_j))[None] if given_factor else None
    mu_p, lk_p = svgp.predict_mean(rbf.rbf_gram, plp.kernel, plp.variational, pz,
                                   torch.as_tensor(xt), jitter, lk_p)
    np.testing.assert_allclose(mu_p[0].numpy(), np.asarray(mu_j), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lk_p[0].numpy(), np.asarray(lk_j), rtol=1e-12, atol=1e-12)


def _states_by_solves(params, consts, config):
    """compute_layer_states with every product by L^{-1} a triangular solve
    (the route of the states nothing differentiates): (lk, level, w_mean,
    w_ls) per layer."""
    from mobocmf_tpu_torch.linalg.ops import safe_cholesky_level
    from mobocmf_tpu_torch.models import svgp

    out, chain_mean = [], None
    for ell in range(config.num_fidelities):
        gram, _ = M._layer_fns(ell, config.only_hf)
        lp, z_x = params.layers[ell], consts.z_x[ell]
        if ell == 0:
            z = z_x
        else:
            z = torch.cat([z_x.expand(chain_mean.shape[:-1] + z_x.shape),
                           chain_mean.unsqueeze(-1)], dim=-1)
        lk, level = safe_cholesky_level(gram(lp.kernel, z, z), config.jitter)
        w_mean, w_ls = svgp.solve_variational(lp.variational, lk, config.whitened)
        out.append((lk, level, w_mean, w_ls))
        m = lp.variational.mean
        if config.whitened:
            back = torch.linalg.solve_triangular(lk.mT, m.unsqueeze(-1), upper=True)
            chain_mean = (lk @ m.unsqueeze(-1))[..., 0] - config.jitter * back[..., 0]
        else:
            back = torch.linalg.solve_triangular(lk.mT, w_mean.unsqueeze(-1), upper=True)
            chain_mean = m - config.jitter * back[..., 0]
    return out


@pytest.mark.parametrize("dtype,grad,whitened", [
    (torch.float64, True, False), (torch.float64, True, True),
    (torch.float64, False, False), (torch.float64, False, True),
    (torch.float32, True, False),
], ids=["f64-grad", "f64-grad-whitened", "f64-no-grad", "f64-no-grad-whitened", "f32-grad"])
def test_layer_states_take_the_inverse_route_when_differentiated_at_f64(dtype, grad, whitened):
    """compute_layer_states factors through L^{-1} (ops.safe_cholesky_inv,
    one count a layer) exactly when the Gram requires grad at float64;
    otherwise it is bitwise the solves. On the route, layer 0's factor is
    the solves' and every state's products match the solves on its own
    factor to 1e-11; a deeper factor, whose Gram takes the inducing chain's
    mean, matches the solves' to 1e-11 (the chain's rounding moves its
    products by up to cond(Kzz) times that, 4e-11 here)."""
    from mobocmf_tpu_torch.models import svgp
    from mobocmf_tpu_torch.util import counters

    x, y, fid = _data(8)
    pm = M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(0), device="cpu",
                      dtype=dtype, whitened=whitened)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), pm.params)
    counters.reset()
    with torch.set_grad_enabled(grad):
        states = M.compute_layer_states(params, pm.consts, pm.config)
        want = _states_by_solves(params, pm.consts, pm.config)
    route = grad and dtype == torch.float64
    assert counters.get("inv.states") == (2 if route else 0)

    def rel(a, b):
        return float((a - b).detach().abs().max() / b.detach().abs().max())

    for ell, (st, (lk, level, w_mean, w_ls)) in enumerate(zip(states, want)):
        assert torch.equal(st.level, level)
        assert (st.lk_inv is not None) == route
        if not route:
            for got, ref in ((st.lk, lk), (st.w_mean, w_mean), (st.w_ls, w_ls)):
                assert torch.equal(got, ref)
            continue
        assert rel(st.lk, lk) <= (0.0 if ell == 0 else 1e-11)
        with torch.no_grad():
            own = svgp.solve_variational(params.layers[ell].variational, st.lk, whitened)
        for got, ref in zip((st.w_mean, st.w_ls), own):
            assert rel(got, ref) < 1e-11
