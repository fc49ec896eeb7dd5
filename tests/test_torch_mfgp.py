"""The exact-GP family of the port (kernels/mf_exact.py, models/mfgp.py,
models/mfgp_lin.py, models/exact_gp.py and linalg/ops.py::cholesky)
against the JAX package at f64 on the same numbers (models cross through
models/convert.py; the JAX package's RFF draws are injected).
Tolerance 1e-9 relative unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.kernels import mf_exact as JK
from mobocmf_tpu.linalg import ops as JO
from mobocmf_tpu.models import exact_gp as JEG
from mobocmf_tpu.models import mfgp as JG
from mobocmf_tpu.models import mfgp_lin as JGL
from mobocmf_tpu.sampling.rff import _key_to_seed
from mobocmf_tpu_torch.kernels import mf_exact as PK
from mobocmf_tpu_torch.linalg import ops as PO
from mobocmf_tpu_torch.models import convert
from mobocmf_tpu_torch.models import exact_gp as PEG
from mobocmf_tpu_torch.models import mfgp as PG
from mobocmf_tpu_torch.models import mfgp_lin as PGL
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _mf_data(seed=0, n=24, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    fid = (np.arange(n) % 2).astype(float)
    y = np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] + 0.3 * (fid == 0) * np.sin(9 * x[:, 1])
    y = y + 0.05 * rng.normal(size=n)
    return np.concatenate([x, fid[:, None]], axis=1), y


def _padded(n=20, pad=8, seed=7):
    xf, y = _mf_data(seed=seed, n=n)
    xp = np.concatenate([xf, np.full((pad, xf.shape[1]), 0.5)])
    xp[n:, -1] = 0.0
    return xp, np.concatenate([y, np.zeros(pad)]), np.arange(n + pad) < n


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_mfgp(m):
    pen = None if m.row_penalty is None else np.asarray(m.row_penalty)
    return convert.mfgp_from_numpy((_np(m.params.kernel), np.asarray(m.params.raw_noise)),
                                   np.asarray(m.x_train), np.asarray(m.y_train),
                                   m.num_fidelities, m.jitter, pen, "cpu", F64)


def port_mfgp_lin(m):
    return convert.mfgp_lin_from_numpy((_np(m.params.kernel), np.asarray(m.params.raw_noise)),
                                       np.asarray(m.x_train), np.asarray(m.y_train),
                                       m.num_fidelities, m.jitter, "cpu", F64)


def _leaves_close(port_params, jax_params, rtol=RTOL, atol=1e-12):
    got, want = tree_leaves(port_params), jax.tree.leaves(jax_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol, atol)


def _raw_params(rng, d, lin_fidelities=None):
    def vec():
        return rng.normal(size=(d,))

    kernel = {"signal": {"raw_lengthscale": vec(), "raw_outputscale": rng.normal(size=())},
              "noise": {"raw_lengthscale": vec(), "raw_outputscale": rng.normal(size=())}}
    if lin_fidelities is not None:
        kernel["rho"] = rng.uniform(0.2, 0.9, size=(lin_fidelities - 1,))
    return kernel


def test_mf_kernel_gram_and_diag():
    rng = np.random.default_rng(0)
    kernel = _raw_params(rng, 3)
    x1 = np.concatenate([rng.uniform(size=(9, 3)), rng.integers(0, 3, (9, 1))], axis=1)
    x2 = np.concatenate([rng.uniform(size=(7, 3)), rng.integers(0, 3, (7, 1))], axis=1)
    kj = jax.tree.map(jnp.asarray, kernel)
    kp = jax.tree.map(torch.as_tensor, kernel)
    _close(PK.mf_kernel_gram(kp, torch.as_tensor(x1), torch.as_tensor(x2)),
           JK.mf_kernel_gram(kj, jnp.asarray(x1), jnp.asarray(x2)))
    _close(PK.mf_kernel_diag(kp, torch.as_tensor(x1)), JK.mf_kernel_diag(kj, jnp.asarray(x1)))
    # the analytic diagonal is the Gram's
    _close(PK.mf_kernel_diag(kp, torch.as_tensor(x1)),
           torch.diagonal(PK.mf_kernel_gram(kp, torch.as_tensor(x1), torch.as_tensor(x1))))
    for key, value in PK.mf_kernel_constrained(kp).items():
        _close(value, JK.mf_kernel_constrained(kj)[key])
    for a, b in zip(tree_leaves(PK.init_mf_kernel_params(0.3, 3)),
                    jax.tree.leaves(JK.init_mf_kernel_params(0.3, 3))):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("num_fidelities", [2, 3, 5])
def test_mf_lin_kernel_gram(num_fidelities):
    """Including the range(3, F - 1) noise-factor loop, which only F = 5
    of these enters."""
    rng = np.random.default_rng(num_fidelities)
    kernel = _raw_params(rng, 2, num_fidelities)
    fids = rng.integers(0, num_fidelities, (11, 1))
    x = np.concatenate([rng.uniform(size=(11, 2)), fids], axis=1)
    x2 = np.concatenate([rng.uniform(size=(6, 2)), rng.integers(0, num_fidelities, (6, 1))], 1)
    want = JK.mf_lin_kernel_gram(jax.tree.map(jnp.asarray, kernel), jnp.asarray(x),
                                 jnp.asarray(x2), num_fidelities)
    got = PK.mf_lin_kernel_gram(jax.tree.map(torch.as_tensor, kernel), torch.as_tensor(x),
                                torch.as_tensor(x2), num_fidelities)
    _close(got, want)
    init_p = PK.init_mf_lin_kernel_params(0.4, 2, num_fidelities)
    init_j = JK.init_mf_lin_kernel_params(0.4, 2, num_fidelities)
    _leaves_close(init_p, init_j, 1e-12)


def test_cholesky_no_ladder_value_gradient_and_nan():
    """linalg/ops.py::cholesky against the JAX package's: the factor, the
    gradient of a scalar of it, and NaN (no exception) on an indefinite
    matrix."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 12))
    k = a @ a.T / 12 + np.eye(12)
    w = rng.normal(size=(12, 12))
    _close(PO.cholesky(torch.as_tensor(k)), JO.cholesky(jnp.asarray(k)))

    kt = torch.as_tensor(k).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(PO.cholesky(kt) * torch.as_tensor(w)), kt)
    want = jax.grad(lambda m: jnp.sum(JO.cholesky(m) * w))(jnp.asarray(k))
    _close(g, want)

    bad = k.copy()
    bad[5, 5] = -10.0
    got = PO.cholesky(torch.as_tensor(bad))
    assert bool(torch.isnan(torch.diagonal(got)).any())
    assert bool(np.isnan(np.asarray(JO.cholesky(jnp.asarray(bad)))).any())


def test_init_mfgp_matches_jax():
    xp, yp, valid = _padded()
    mj = JG.init_mfgp(jnp.asarray(xp), jnp.asarray(yp), 2, row_valid=valid)
    mp = PG.init_mfgp(xp, yp, 2, row_valid=valid, device="cpu", dtype=F64)
    _leaves_close(mp.params, mj.params, 1e-12)
    _close(mp.row_penalty, mj.row_penalty, 0.0, 0.0)
    assert (mp.input_dim, mp.num_fidelities, mp.jitter) == (mj.input_dim, 2, mj.jitter)


@pytest.mark.parametrize("padded", [False, True])
def test_nlml_and_gradient(padded):
    if padded:
        xp, yp, valid = _padded()
        mj = JG.init_mfgp(jnp.asarray(xp), jnp.asarray(yp), 2, row_valid=valid)
    else:
        xf, y = _mf_data()
        mj = JG.init_mfgp(jnp.asarray(xf), jnp.asarray(y), 2)
    # move off the init so every leaf has a gradient of its own
    mj = JG.fit_mfgp(mj, num_iters=5)
    mp = port_mfgp(mj)
    args_j = (mj.x_train, mj.y_train, mj.jitter, mj.row_penalty)
    want, grad_j = jax.value_and_grad(JG.nlml)(mj.params, *args_j)
    params = tree_map(lambda t: t.clone().requires_grad_(True), mp.params)
    got = PG.nlml(params, mp.x_train, mp.y_train, mp.jitter, mp.row_penalty)
    grads = torch.autograd.grad(got, tree_leaves(params))
    _close(got, want)
    for g, w in zip(grads, jax.tree.leaves(grad_j)):
        _close(g, w, RTOL, 1e-10)


def test_fit_20_adam_steps():
    xp, yp, valid = _padded()
    mj = JG.init_mfgp(jnp.asarray(xp), jnp.asarray(yp), 2, row_valid=valid)
    mp = port_mfgp(mj)
    _leaves_close(PG.fit_mfgp(mp, num_iters=20).params, JG.fit_mfgp(mj, num_iters=20).params,
                  1e-8, 1e-10)


@pytest.fixture(scope="module")
def fitted():
    """A JAX MFGP after 40 Adam steps and its port."""
    xf, y = _mf_data(seed=1, n=18)
    mj = JG.fit_mfgp(JG.init_mfgp(jnp.asarray(xf), jnp.asarray(y), 2), num_iters=40)
    return mj, port_mfgp(mj)


@pytest.mark.parametrize("fidelity", [0, 1])
def test_predict_and_posterior_state(fitted, fidelity):
    mj, mp = fitted
    xs = np.random.default_rng(1).uniform(size=(11, 2))
    mean_j, var_j = JG.predict(mj, jnp.asarray(xs), fidelity)
    mean_p, var_p = PG.predict(mp, torch.as_tensor(xs), fidelity)
    _close(mean_p, mean_j)
    _close(var_p, var_j)
    st = PG.posterior_state(mp)
    mean_s, var_s = PG.predict(mp, torch.as_tensor(xs), fidelity, state=st)
    assert torch.equal(mean_s, mean_p) and torch.equal(var_s, var_p)
    st_j = JG.posterior_state(mj)
    _close(st.l, st_j.l)
    _close(st.alpha, st_j.alpha)


def test_batched_inputs_match_per_row(fitted):
    mj, mp = fitted
    xf, y = _mf_data(seed=8)
    lin = port_mfgp_lin(JGL.init_mfgp_lin(jnp.asarray(xf), jnp.asarray(y), 2))
    xb = torch.as_tensor(np.random.default_rng(9).uniform(size=(4, 3, 2)))
    for model, mod in ((mp, PG), (lin, PGL)):
        mean_b, var_b = mod.predict(model, xb, 1)
        assert mean_b.shape == (4, 3) and var_b.shape == (4, 3)
        mean_f, var_f = mod.predict(model, xb.reshape(12, 2), 1)
        _close(mean_b.reshape(-1), mean_f, 1e-10)
        _close(var_b.reshape(-1), var_f, 1e-10)
    mean_j, _ = JG.predict(mj, jnp.asarray(xb.numpy()), 1)
    _close(PG.predict(mp, xb, 1)[0], mean_j)


def test_padded_rows_change_nothing():
    """Padded rows (PAD_PENALTY extra noise) leave the fit and the
    posterior as they are (the JAX package's test, at 20 steps), and the
    padded port matches the padded JAX model."""
    xf, y = _mf_data(seed=7, n=20)
    xp, yp, valid = _padded()
    m = PG.fit_mfgp(PG.init_mfgp(xf, y, 2, device="cpu", dtype=F64), num_iters=20)
    mp = PG.fit_mfgp(PG.init_mfgp(xp, yp, 2, row_valid=valid, device="cpu", dtype=F64),
                     num_iters=20)
    grid = torch.as_tensor(np.random.default_rng(11).uniform(size=(12, 2)))
    for a, b in zip(PG.predict(mp, grid, 1), PG.predict(m, grid, 1)):
        _close(a, b, 0.0, 2e-4)
    mj = JG.fit_mfgp(JG.init_mfgp(jnp.asarray(xp), jnp.asarray(yp), 2, row_valid=valid),
                     num_iters=20)
    _close(PG.predict(mp, grid, 1)[0], JG.predict(mj, jnp.asarray(grid.numpy()), 1)[0], 1e-8)


def _jax_draws(key, n_features, d):
    """The JAX package's draws of sample_from_posterior, as the port's
    MFGPDraws: the same normals and U[0, 1) phases, the same theta seed."""
    kws, kbs, kwn, kbn, kth = jax.random.split(key, 5)

    def t(a):
        return torch.as_tensor(np.array(a))

    return PG.MFGPDraws(
        w_s=t(jax.random.normal(kws, (n_features, d), dtype=jnp.float64)),
        b_s=t(jax.random.uniform(kbs, (n_features, 1), dtype=jnp.float64)),
        w_n=t(jax.random.normal(kwn, (n_features, d), dtype=jnp.float64)),
        b_n=t(jax.random.uniform(kbn, (n_features, 1), dtype=jnp.float64)),
        seed=_key_to_seed(kth),
    )


@pytest.mark.parametrize("padded,fidelity", [(False, 1), (False, 0), (True, 1)])
def test_rff_sample_with_injected_draws(fitted, padded, fidelity):
    if padded:
        xp, yp, valid = _padded()
        mj = JG.fit_mfgp(JG.init_mfgp(jnp.asarray(xp), jnp.asarray(yp), 2, row_valid=valid),
                         num_iters=20)
        mp = port_mfgp(mj)
    else:
        mj, mp = fitted
    key = jax.random.key(2)
    sj = JG.sample_from_posterior(key, mj, fidelity, n_features=100)
    sp = PG.sample_from_posterior(None, mp, fidelity, n_features=100,
                                  draws=_jax_draws(key, 100, 2))
    _close(sp.theta, sj.theta, 1e-8, 1e-10)
    grid = np.random.default_rng(3).uniform(size=(10, 2))
    _close(PG.eval_mfgp_sample(sp, torch.as_tensor(grid)),
           JG.eval_mfgp_sample(sj, jnp.asarray(grid)), 1e-8, 1e-10)
    # drawn from a generator: finite, one value per point
    s = PG.sample_from_posterior(torch.Generator().manual_seed(0), mp, fidelity)
    v = PG.eval_mfgp_sample(s, torch.as_tensor(grid))
    assert v.shape == (10,) and bool(torch.isfinite(v).all())


def test_exact_gp_fit_and_predict():
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(15, 2))
    y = np.sin(4 * x[:, 0])
    mj = JEG.init_exact_gp(jnp.asarray(x), jnp.asarray(y), initial_length_scale=0.3)
    mp = PEG.init_exact_gp(x, y, initial_length_scale=0.3, device="cpu", dtype=F64)
    _leaves_close(mp.params, mj.params, 1e-12)
    fj, fp = JEG.fit_exact_gp(mj, num_iters=20), PEG.fit_exact_gp(mp, num_iters=20)
    _leaves_close(fp.params, fj.params, 1e-8, 1e-10)
    fp2 = convert.exact_gp_from_numpy((_np(fj.params.kernel), np.asarray(fj.params.raw_noise)),
                                      x, y, fj.jitter, "cpu", F64)
    xs = rng.uniform(size=(6, 2))
    for noiseless in (True, False):
        for a, b in zip(PEG.predict(fp2, torch.as_tensor(xs), noiseless),
                        JEG.predict(fj, jnp.asarray(xs), noiseless)):
            _close(a, b)
    _close(PEG.nlml(fp2.params, fp2.x_train, fp2.y_train, fp2.jitter),
           JEG.nlml(fj.params, fj.x_train, fj.y_train, fj.jitter))


def test_mfgp_lin_fit_mean_function_and_gradient():
    xf, y = _mf_data(seed=2)
    mj = JGL.init_mfgp_lin(jnp.asarray(xf), jnp.asarray(y), 2)
    mp = PGL.init_mfgp_lin(xf, y, 2, device="cpu", dtype=F64)
    _leaves_close(mp.params, mj.params, 1e-12)
    _close(PGL.nlml_model(mp.params, mp), JGL.nlml_model(mj.params, mj))
    fj, fp = JGL.fit_mfgp_lin(mj, num_iters=20), PGL.fit_mfgp_lin(mp, num_iters=20)
    _leaves_close(fp.params, fj.params, 1e-8, 1e-10)
    fp = port_mfgp_lin(fj)
    x_test = np.random.default_rng(4).uniform(size=(4, 2))
    fn_j, fn_p = JGL.get_mean_function_high_fidelity(fj), PGL.get_mean_function_high_fidelity(fp)
    _close(fn_p(x_test), fn_j(x_test))
    grads = fn_p(x_test, gradient=True)
    assert grads.shape == (4, 2)
    _close(grads, fn_j(x_test, gradient=True), RTOL, 1e-10)
    for fidelity in (0, 1):
        for a, b in zip(PGL.predict(fp, torch.as_tensor(x_test), fidelity),
                        JGL.predict(fj, jnp.asarray(x_test), fidelity)):
            _close(a, b)
