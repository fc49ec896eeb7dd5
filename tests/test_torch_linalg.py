"""K1 and the port's linalg helpers against the JAX package.

On the CPU the port's `cholesky` runs its plain version; it is held against
the JAX XLA Cholesky at f64, against the Pallas kernel itself (interpret
mode) at f32 for n <= 128, and the ladder against JAX's safe_cholesky. The
CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.linalg import chol as jchol
from mobocmf_tpu.linalg import ops as jops
from mobocmf_tpu_torch.linalg import chol, ops
from mobocmf_tpu_torch.util import counters
from torch_threads import one_intra_op_thread  # noqa: F401


def _spd(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    a = rng.normal(size=shape)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _rbf_gram_shifted(n=64, seed=8, scale=1.0, min_eig_rel=-1e-5):
    """An RBF Gram of `scale` whose smallest eigenvalue is set to
    min_eig_rel*scale, in f32: -1e-5 fails the first rung (4*eps*scale)
    and passes the second, -1e-3 needs the third."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    w, v = np.linalg.eigh(scale * np.exp(-0.5 * d2 / 0.25))
    w[0] = min_eig_rel * scale
    return ((v * w) @ v.T).astype(np.float32)


def test_plain_cholesky_matches_jax_xla_f64():
    a = _spd(40, seed=1, batch=3)
    l, level = chol.cholesky(torch.as_tensor(a))
    want = np.stack([np.asarray(jchol.cholesky(jnp.asarray(ai))) for ai in a])
    np.testing.assert_allclose(l.numpy(), want, rtol=1e-12, atol=1e-12)
    assert level.tolist() == [0, 0, 0]
    assert np.all(np.triu(l.numpy(), 1) == 0)


@pytest.mark.parametrize("n", [100, 128])
def test_plain_cholesky_matches_pallas_kernel_f32(n):
    """The Pallas kernel itself, interpret mode (single 128-block)."""
    a = _spd(n, seed=n).astype(np.float32)
    want = np.asarray(jchol.cholesky(jnp.asarray(a), force_pallas=True))
    got, _ = chol.cholesky(torch.as_tensor(a))
    assert got.dtype == torch.float32
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 2e-6, rel


def test_plain_cholesky_matches_jax_xla_f32_multiblock():
    # multi-block Pallas interpret mode hits a JAX-internal recursion
    # (tests/test_linalg.py:30-35), so n > 128 compares with the XLA path
    a = _spd(200, seed=2).astype(np.float32)
    want = np.asarray(jchol.cholesky(jnp.asarray(a)))
    got, _ = chol.cholesky(torch.as_tensor(a))
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 2e-6, rel


@pytest.mark.parametrize("ladder", [False, True])
def test_indefinite_gives_nan_and_never_raises(ladder):
    a = _spd(16, seed=3, batch=3)
    w, v = np.linalg.eigh(a[1])
    w[0] = -10.0 * w[-1]  # far below anything the ladder adds
    a[1] = (v * w) @ v.T
    l, level = chol.cholesky(torch.as_tensor(a), jitter=1e-6, ladder=ladder)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    assert bool(torch.isnan(diag[1]).any())
    assert bool(torch.isfinite(l[[0, 2]]).all())
    assert level.tolist() == ([0, 2, 0] if ladder else [0, 0, 0])


@pytest.mark.parametrize(
    "scale,min_eig_rel,rung", [(1.0, -1e-5, 1), (1.0, -1e-3, 2), (4000.0, -1e-5, 1), (4000.0, -1e-3, 2)]
)
def test_f32_ladder_matches_jax_safe_cholesky(scale, min_eig_rel, rung):
    k = _rbf_gram_shifted(scale=scale, min_eig_rel=min_eig_rel)
    want = np.asarray(jops.safe_cholesky(jnp.asarray(k), 2e-6))
    esc0 = chol.escalations()
    got = ops.safe_cholesky(torch.as_tensor(k), 2e-6)
    _, level = chol.cholesky(torch.as_tensor(k), 2e-6, ladder=True)
    assert level.item() == rung
    assert chol.escalations() - esc0 == 2
    assert np.all(np.isfinite(want))
    assert bool(torch.isfinite(got).all())
    # f32 factors of a matrix of condition ~1e5 after the rung's jitter
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 5e-4, rel


def test_f32_ladder_is_per_matrix():
    """A matrix that factorizes keeps its jitter while another escalates."""
    good = _spd(64, seed=4).astype(np.float32)
    k = torch.as_tensor(np.stack([good, _rbf_gram_shifted(), good]))
    l, level = chol.cholesky(k, jitter=2e-6, ladder=True)
    assert level.tolist() == [0, 1, 0]
    ref, _ = chol.cholesky(k[0], jitter=2e-6, ladder=True)
    np.testing.assert_array_equal(l[0].numpy(), ref.numpy())


def test_safe_cholesky_f64_is_one_plain_factorization():
    k = _spd(24, seed=3) * 3000.0
    got = ops.safe_cholesky(torch.as_tensor(k), 2e-6)
    want = np.asarray(jops.safe_cholesky(jnp.asarray(k), 2e-6))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    plain = np.linalg.cholesky(k + 2e-6 * np.eye(24))
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_safe_cholesky_gradient_matches_jax_grad_f64(batched):
    k = _spd(24, seed=7, batch=2 if batched else None)
    wts = np.arange(24.0)[None, :]

    def loss_jax(kk):
        l = jops.safe_cholesky(kk, 2e-6)
        return jnp.sum(jnp.sin(l) * wts)

    if batched:
        g_jax = np.asarray(jax.grad(lambda kk: jnp.sum(jax.vmap(loss_jax)(kk)))(jnp.asarray(k)))
    else:
        g_jax = np.asarray(jax.grad(loss_jax)(jnp.asarray(k)))
    kt = torch.as_tensor(k).requires_grad_(True)
    l = ops.safe_cholesky(kt, 2e-6)
    torch.sum(torch.sin(l) * torch.as_tensor(wts)).backward()
    np.testing.assert_allclose(kt.grad.numpy(), g_jax, rtol=1e-8, atol=1e-10)


def test_safe_cholesky_f32_gradient_finite_under_escalation():
    k = torch.as_tensor(_rbf_gram_shifted(scale=4000.0, min_eig_rel=-1e-3))
    k.requires_grad_(True)
    l = ops.safe_cholesky(k, 2e-6)
    (torch.sum(l * l) / 4000.0).backward()
    assert bool(torch.isfinite(k.grad).all())


def test_safe_cholesky_rel_and_solves_match_jax():
    k = _spd(20, seed=9, batch=2) * 50.0
    got = ops.safe_cholesky_rel(torch.as_tensor(k), 1e-6)
    want = np.stack([np.asarray(jops.safe_cholesky_rel(jnp.asarray(ki), 1e-6)) for ki in k])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    b = np.random.default_rng(5).normal(size=(2, 20, 3))
    x = ops.cho_solve(got, torch.as_tensor(b))
    x_j = np.stack([np.asarray(jops.cho_solve(jnp.asarray(want[i]), jnp.asarray(b[i])))
                    for i in range(2)])
    np.testing.assert_allclose(x.numpy(), x_j, rtol=1e-10, atol=1e-12)
    y = ops.tri_solve_lower(got, torch.as_tensor(b))
    np.testing.assert_allclose((got @ y).numpy(), b, atol=1e-10)
    np.testing.assert_allclose(
        ops.logdet_from_chol(got).numpy(),
        [float(jops.logdet_from_chol(jnp.asarray(w))) for w in want], rtol=1e-12)
    np.testing.assert_allclose(
        ops.add_jitter(torch.zeros(5, 5, dtype=torch.float64), 2e-6).numpy(), 2e-6 * np.eye(5))


def test_cholesky_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        chol.cholesky(torch.zeros(3, 4))
    with pytest.raises(TypeError):
        chol.cholesky(torch.zeros(3, 3, dtype=torch.float16))



def _rbf_gram(batch, n, seed):
    """RBF Grams of outputscale 1.5 at lengthscale 0.3 on the unit square:
    cond(L) ~3e2 at n = 16, ~4e3 at 64 with the jitter 2e-6."""
    x = np.random.default_rng(seed).uniform(size=(batch, n, 2))
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    return torch.as_tensor(1.5 * np.exp(-0.5 * d2 / 0.3**2))


def test_safe_cholesky_inv_gradcheck():
    """gradcheck through L, L^{-1} and logdet_from_chol(L) together, and
    through the products with L^{-1} and L^{-T} that stand for solves (a
    lower right-hand side among them), unsplit and with the structured
    products split at a leaf of 2."""
    k = torch.as_tensor(_spd(6, seed=11, batch=2)).requires_grad_(True)
    rng = np.random.default_rng(12)
    b = torch.as_tensor(rng.normal(size=(2, 6, 3))).requires_grad_(True)
    b_low = torch.as_tensor(rng.normal(size=(2, 6, 6))).requires_grad_(True)

    def outputs(kk, bb, bl):
        l, _, l_inv = ops.safe_cholesky_inv(kk, 2e-6)
        return (l, l_inv, ops.logdet_from_chol(l), ops.tri_solve_lower(l, bb, l_inv),
                ops.tri_solve_lower(l, bb, l_inv, trans=True),
                ops.tri_solve_lower(l, torch.tril(bl), l_inv, b_lower=True))

    for leaf in (ops.GEMM_LEAF, 2):
        counters.reset()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "GEMM_LEAF", leaf)
            assert torch.autograd.gradcheck(outputs, (k, b, b_low))
        assert (counters.get("inv.gemm_skipped") > 0) == (leaf == 2)


# the route's structures: (a, b, lower-only output), each product of
# _SolveByInverse, _SafeCholeskyInv.backward and chol_pullback given L^{-1}
ROUTE_PRODUCTS = [
    ("lower", "dense", False), ("lower", "lower", False), ("upper", "dense", False),
    ("dense", "upper", True), ("dense", "dense", True), ("upper", "dense", True),
    ("upper", "lower", False), ("dense", "lower", False),
]


@pytest.mark.parametrize("m,p", [(37, 130), (130, 37)])
@pytest.mark.parametrize("kind_a,kind_b,lower_out", ROUTE_PRODUCTS)
def test_structured_product_matches_the_dense_product(kind_a, kind_b, lower_out, m, p):
    """ops._product against the dense product of the same triangles (its
    tril for a lower-only output), batch (2, 3), to 1e-13 relative: at a
    leaf of 4 (three levels of 2 x 2 blocks at m = 37, odd halves); the
    operations issued plus those skipped make the dense product's; at
    the default leaf it is the one dense GEMM, bitwise, with none skipped."""
    g = torch.Generator().manual_seed(m + 7 * ROUTE_PRODUCTS.index((kind_a, kind_b, lower_out)))

    def operand(kind, rows, cols):
        t = torch.randn((2, 3, rows, cols), generator=g, dtype=torch.float64)
        return {"lower": torch.tril, "upper": torch.triu}.get(kind, lambda x: x)(t)

    inner = m if kind_a != "dense" or kind_b != "dense" else p
    a = operand(kind_a, m, inner)
    b = operand(kind_b, inner, m if kind_b != "dense" or lower_out else p)
    want = a @ b
    for leaf in (4, None):
        counters.reset()
        got = ops._product(a, b, kind_a, kind_b, lower_out, leaf=leaf)
        issued, skipped = counters.get("inv.gemm_flops"), counters.get("inv.gemm_skipped")
        assert issued + skipped == 2 * 6 * m * inner * b.shape[-1]
        if leaf is None:
            assert torch.equal(got, want) and skipped == 0
            continue
        assert skipped > 0
        keep = torch.tril if lower_out else (lambda x: x)
        assert float((keep(got) - keep(want)).abs().max() / keep(want).abs().max()) < 1e-13


@pytest.mark.parametrize("n,leaf", [(16, None), (64, None), (16, 4), (64, 8)],
                         ids=["16", "64", "16-split", "64-split"])
def test_safe_cholesky_inv_matches_the_solve_route(n, leaf, monkeypatch):
    """Forward and backward of safe_cholesky_inv against _SafeCholesky plus
    solve_triangular(L, I), and the products with L^{-1} and L^{-T} that
    the layer states take (a lower right-hand side among them) against the
    solves they replace, to 1e-11 relative; unsplit, and with the
    structured products split two levels deep."""
    if leaf is not None:
        monkeypatch.setattr(ops, "GEMM_LEAF", leaf)
    k = _rbf_gram(2, n, n).requires_grad_(True)
    counters.reset()
    l, level, l_inv = ops.safe_cholesky_inv(k, 2e-6)
    assert counters.get("inv.states") == 1 and level.tolist() == [0, 0]
    l_ref, _ = ops.safe_cholesky_level(k, 2e-6)
    eye = torch.eye(n, dtype=torch.float64)
    l_inv_ref = torch.linalg.solve_triangular(l_ref, eye, upper=False)
    g = torch.Generator().manual_seed(n)
    w_l, w_inv = torch.randn((2, 2, n, n), generator=g, dtype=torch.float64)
    w_det = torch.randn((2,), generator=g, dtype=torch.float64)
    rhs = torch.randn((2, n, n + 1), generator=g, dtype=torch.float64)
    rhs_low = torch.tril(torch.randn((2, n, n), generator=g, dtype=torch.float64))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    products = [(ops.tri_solve_lower(l, rhs, l_inv, trans),
                 ops.tri_solve_lower(l_ref, rhs, None, trans)) for trans in (False, True)]
    products.append((ops.tri_solve_lower(l, rhs_low, l_inv, b_lower=True),
                     ops.tri_solve_lower(l_ref, rhs_low)))
    for out, ref in [(l, l_ref), (l_inv, l_inv_ref)] + products:
        assert rel(out.detach(), ref.detach()) < 1e-11
    losses = [
        (torch.sum(l * w_l) + torch.sum(l_inv * w_inv) + torch.sum(ops.logdet_from_chol(l) * w_det),
         torch.sum(l_ref * w_l) + torch.sum(l_inv_ref * w_inv)
         + torch.sum(ops.logdet_from_chol(l_ref) * w_det)),
    ] + [(torch.sum(w ** 2) + torch.sum(ops.logdet_from_chol(l)),
          torch.sum(w_ref ** 2) + torch.sum(ops.logdet_from_chol(l_ref))) for w, w_ref in products]
    for loss, loss_ref in losses:
        got, = torch.autograd.grad(loss, k, retain_graph=True)
        want, = torch.autograd.grad(loss_ref, k, retain_graph=True)
        assert rel(got, want) < 1e-11
    assert (counters.get("inv.gemm_skipped") > 0) == (leaf is not None)


@pytest.mark.parametrize("route", ["inverse", "inverse-adjoint", "solve-f64", "solve-f32",
                                   "inverse-split", "inverse-adjoint-split"])
def test_inv_gemm_flops_closed_form(route, monkeypatch):
    """"inv.gemm_flops" after one factor and one product with L^{-1} (B =
    2, m = 16, 5 columns) and their backward: per matrix 3 x 2 m^2 n for
    the refined product, 2 x 2 m^2 n for its backward, 3 x 2 m^3 for the
    pullback through the inverse, and 2 x 2 m^3 more for an adjoint of
    L^{-1} itself, none skipped. The solve route, at either precision, adds
    nothing. At a leaf of 8 (one level of 2 x 2 blocks) the products issue
    3/4 of the lower or upper times dense ones and of the lower-only
    outputs of dense operands, 1/2 of L^T L_bar's and L^-T G L^-T's
    lower-only outputs and 5/8 of L^-T phi: 7.5 m^2 n + 3.75 m^3 (+ 2.5
    m^3), and skip the rest of the dense count."""
    bsz, m, n = 2, 16, 5
    split = route.endswith("split")
    if split:
        monkeypatch.setattr(ops, "GEMM_LEAF", 8)
    dtype = torch.float32 if route == "solve-f32" else torch.float64
    k = torch.as_tensor(_spd(m, seed=3, batch=bsz), dtype=dtype).requires_grad_(True)
    b = torch.as_tensor(np.random.default_rng(4).normal(size=(bsz, m, n)), dtype=dtype)
    counters.reset()
    if route.startswith("inverse"):
        adjoint = route.startswith("inverse-adjoint")
        l, _, l_inv = ops.safe_cholesky_inv(k, 2e-6)
        w = ops.tri_solve_lower(l, b, l_inv)
        assert counters.get("inv.gemm_flops") == bsz * (9 if split else 12) * m * m * n // 2
        loss = torch.sum(w ** 2) + (torch.sum(l_inv) if adjoint else 0.0)
        dense = bsz * (10 * m * m * n + 6 * m ** 3 + (4 * m ** 3 if adjoint else 0))
        want = (bsz * (30 * m * m * n + 15 * m ** 3 + (10 * m ** 3 if adjoint else 0)) // 4
                if split else dense)
    else:
        l = ops.safe_cholesky(k, 2e-6)
        loss = torch.sum(ops.tri_solve_lower(l, b) ** 2)
        dense = want = 0
    loss.backward()
    assert counters.get("inv.gemm_flops") == want and counters.recorded["inv.gemm_flops"] == 0
    assert (counters.get("inv.gemm_skipped") == dense - want
            and counters.recorded["inv.gemm_skipped"] == 0)
