"""K2 (the fused RBF-SVGP predictive) in the port against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which these tests
hold against the Pallas kernel in interpret mode (f32) and against
`reference_forward` (f64); the CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.linalg.fused_svgp import fused_rbf_svgp_forward as jax_fused
from mobocmf_tpu.linalg.fused_svgp import reference_forward
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.linalg import chol
from mobocmf_tpu_torch.linalg.fused_svgp import fused_rbf_svgp_forward
from mobocmf_tpu_torch.linalg.ops import ladder_jitter
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.models import svgp
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64


def _problem(m, n, d, seed, dtype=np.float32):
    """The JAX kernel test's problem (tests/test_fused_svgp_kernel.py:19-35):
    short lengthscale and a large jitter keep it well posed in f32."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(size=(m, d))
    x = rng.uniform(size=(n, d))
    mean = rng.normal(size=(m,))
    ls_chol = np.tril(rng.normal(size=(m, m)) * 0.05) + 0.3 * np.eye(m)
    return [np.asarray(a, dtype=dtype) for a in (z, x, mean, ls_chol, [0.15] * d, 1.3, 1e-2)]


@pytest.mark.parametrize("m,n", [(128, 128), (100, 150)])
def test_plain_matches_pallas_kernel_interpret_f32(m, n):
    args = _problem(m, n, 3, 0)
    mu_j, var_j = jax_fused(*[jnp.asarray(a) for a in args], interpret=True)
    mu, var = fused_rbf_svgp_forward(*[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=2e-3, atol=2e-3)
    assert bool((var > 0).all())


@pytest.mark.parametrize("m,n", [(64, 40), (37, 53)])
def test_plain_matches_reference_forward_f64(m, n):
    args = _problem(m, n, 2, 1, np.float64)
    mu_r, var_r = reference_forward(*[jnp.asarray(a) for a in args])
    mu, var = fused_rbf_svgp_forward(*[torch.as_tensor(a) for a in args])
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_r), rtol=1e-9, atol=1e-12)


def test_batched_matches_per_state_calls():
    rng = np.random.default_rng(2)
    b, m, n, d = 3, 24, 17, 2
    z = torch.as_tensor(rng.uniform(size=(m, d)))
    x = torch.as_tensor(rng.uniform(size=(n, d)))
    mean = torch.as_tensor(rng.normal(size=(b, m)))
    ls_chol = torch.as_tensor(np.tril(rng.normal(size=(b, m, m)) * 0.1) + 0.2 * np.eye(m))
    ls = torch.as_tensor(rng.uniform(0.2, 0.6, size=(b, d)))
    os_ = torch.as_tensor(rng.uniform(0.5, 2.0, size=(b,)))
    jit = torch.as_tensor([1e-3, 2e-3, 5e-3])
    mu, var = fused_rbf_svgp_forward(z, x, mean, ls_chol, ls, os_, jit)
    assert mu.shape == var.shape == (b, n)
    for i in range(b):
        mu_i, var_i = fused_rbf_svgp_forward(z, x, mean[i], ls_chol[i], ls[i], os_[i], jit[i])
        np.testing.assert_allclose(mu[i].numpy(), mu_i.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(var[i].numpy(), var_i.numpy(), rtol=1e-12, atol=1e-14)


def _trained_model(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                           device="cpu", dtype=F64) for i, y in enumerate(ys)]
    model = trainer.stack_models(models)
    params, _ = trainer.train_phase_stacked(
        model, torch.as_tensor(x), torch.as_tensor(ys), torch.as_tensor(fid), 10, 0.01,
        "all_free", n, generator=torch.Generator().manual_seed(3),
    )
    return model._replace(params=params), x


def test_k2_layer0_route_matches_predict_diag_state_f64():
    """On a trained state: K2's layer-0 predictive (its own Gram and factor
    at the state's jitter) against predict_diag_state on the state's K1
    factor, and the whole acquisition predictive without gradients (K2
    route) against the same with gradients on (plain route), at 1e-9."""
    model, x = _trained_model()
    p, c, cfg = model
    xq = torch.as_tensor(x[:7] + 0.013)
    with torch.no_grad():
        states = M.compute_layer_states(p, c, cfg)
        lp, st = p.layers[0], states[0]
        assert M.uses_k2(cfg, xq)
        mu_k2, var_k2 = M._layer0_k2(lp, st, cfg, xq)
        gram, diag = M._layer_fns(0, False)
        mu_pl, var_pl = svgp.predict_diag_state(gram, diag, lp.kernel, st.z, xq, st.lk,
                                                st.w_mean, st.w_ls)
        via_k2 = M.predict_for_acquisition_all(p, c, cfg, xq)
    np.testing.assert_allclose(mu_k2.numpy(), mu_pl.numpy(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var_k2.numpy(), var_pl.numpy(), rtol=1e-9, atol=1e-12)
    assert not M.uses_k2(cfg, xq)  # gradients on: the plain route
    plain = M.predict_for_acquisition_all(p, c, cfg, xq)
    for a, b in zip(via_k2, plain):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-9, atol=1e-12)


def test_k2_route_off_when_whitened():
    model, _ = _trained_model(1)
    cfg = model.config._replace(whitened=True)
    with torch.no_grad():
        assert not M.uses_k2(cfg, torch.zeros(3, 2, dtype=F64))
        assert not M.uses_k2(model.config, torch.zeros(2, 3, 2, dtype=F64))  # per-model x


@pytest.mark.parametrize("scale,rung", [(1.0, 0), (4000.0, 1)])
def test_ladder_jitter_rebuilds_the_factorized_jitter(scale, rung):
    """ladder_jitter(level) is the jitter K1's ladder ended on: factorizing
    at it without the ladder gives the ladder's factor."""
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(48, 2))
    k = scale * np.exp(-0.5 * np.sum((x[:, None] - x[None]) ** 2, -1) / 0.3**2)
    w, v = np.linalg.eigh(k)
    if rung:
        w[0] = -1e-5 * scale
    a = torch.as_tensor((v * w) @ v.T, dtype=torch.float32)[None]
    jit = torch.full((1,), 2e-6)
    l_ladder, level = chol.cholesky(a, jit, ladder=True)
    assert int(level[0]) == rung
    scale_t = torch.mean(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)
    j = ladder_jitter(2e-6, level, scale_t)
    l_plain, _ = chol.cholesky(a, j, ladder=False)
    np.testing.assert_array_equal(l_plain.numpy(), l_ladder.numpy())
    assert ladder_jitter(2e-6, level, scale_t.double()).item() == 2e-6  # f64: no ladder


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args = [torch.as_tensor(a) for a in _problem(8, 5, 2, 0)]
    with pytest.raises(ValueError):
        fused_rbf_svgp_forward(args[0][:, :1], *args[1:])
    with pytest.raises(TypeError):
        fused_rbf_svgp_forward(*[a.half() for a in args])
    with pytest.raises(ValueError, match="forward only"):
        fused_rbf_svgp_forward(args[0], args[1], args[2].requires_grad_(True), *args[3:])
