"""K2's launch plan and the schedule of its two solves, on the CPU.

`plan(m, n, batch, dtype)` is checked for every bucket `next_bucket` gives
between 8 and 2048 and for ragged M, at f32 and f64, against the card's
shared memory per block; the constants it mirrors are read from
csrc/fused_svgp.cu.

`_schedule` is a plain PyTorch mirror of the kernels' schedule: stripes of
W columns solved right-looking by 32-row panels (the panel's triangle by
forward substitution, column k scaled by the reciprocal pivot, then the
rank-32 update of every row below it), the stripes of L_S starting at
their own panel and the m column in the last stripe, walking every panel,
and colsum((W_ls^T W)^2) by 32-row blocks in the warps' order (i0 paired
with J - 1 - i0). The rows of W_ls above a stripe's first panel are NaN
here: the kernel never writes them, so the mirror shows they are never
read. It is held against
fused_rbf_svgp_forward_plain and the JAX package's reference_forward at
f64, and against the Pallas kernel in interpret mode at f32, so that a
fault of the schedule shows here before the card runs the kernel.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.linalg.fused_svgp import fused_rbf_svgp_forward as jax_fused
from mobocmf_tpu.linalg.fused_svgp import reference_forward
from mobocmf_tpu_torch.fit.bucketing import next_bucket
from mobocmf_tpu_torch.linalg import chol
from mobocmf_tpu_torch.linalg import fused_svgp as K2
from torch_threads import one_intra_op_thread  # noqa: F401

SOURCE = Path(K2.__file__).resolve().parent.parent / "csrc" / "fused_svgp.cu"
NB = 32


def _buckets(lo=8, hi=2048):
    out, n = [], lo
    while n <= hi:
        b = next_bucket(n)
        out.append(b)
        n = b + 1
    return out


M_VALUES = _buckets() + [1, 31, 100, 490]


def test_plan_constants_mirror_the_source():
    text = SOURCE.read_text()
    limit = int(re.search(r"constexpr int SMEM_LIMIT = (\d+);", text).group(1))
    assert limit == chol.MAX_SMEM_PER_BLOCK
    assert "return (long)sizeof(T) * ((long)m * width + NB * LDS);" in text
    for w in K2.WIDTHS:
        assert f"case {w}: return launch_solve<T, {w}, PREDICT>" in text


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", M_VALUES)
def test_plan_every_bucket(m, dtype):
    size = torch.finfo(dtype).bits // 8
    for n in (1, 150, 200, 1000):
        for batch in (1, 3, 6, 8):
            pl = K2.plan(m, n, batch, dtype)
            assert pl.width in (32, 16, 8, 4)
            assert pl.smem_bytes == size * (m * pl.width + 32 * 33)
            assert pl.smem_bytes + chol.STATIC_SMEM_BYTES <= 232_448
            # the widest stripe that fits and still gives every SM a block
            # of the predictive; the narrowest that fits when none does
            fits = [w for w in (32, 16, 8, 4)
                    if size * (m * w + 32 * 33) + chol.STATIC_SMEM_BYTES <= 232_448]
            full = [w for w in fits if -(-n // w) * batch >= 132]
            assert pl.width == (full[0] if full else fits[-1])


def test_plan_at_the_path_shapes():
    f32, f64 = torch.float32, torch.float64
    assert K2.plan(512, 200, 6, f32) == K2.Plan(8, 20608)
    assert K2.plan(512, 1000, 3, f32) == K2.Plan(16, 36992)
    assert K2.plan(128, 200, 8, f32) == K2.Plan(8, 8320)
    assert K2.plan(512, 1000, 6, f32).width == 32
    assert K2.plan(2048, 1000, 6, f32).width == 16  # W = 32 would need 266 KB
    assert K2.plan(1024, 200, 3, f64).width == 4
    assert K2.plan(4096, 200, 3, f64).width == 4


def _substitute(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d^{-1} x for a lower-triangular block d, as the warps do it: the
    rows below row k take row k times d[:, k] * (1 / d_kk), and each row is
    scaled by its reciprocal pivot at the end."""
    x = x.clone()
    r = 1.0 / torch.diagonal(d)
    for k in range(d.shape[0]):
        x[k + 1:] -= torch.outer(d[k + 1:, k] * r[k], x[k])
    return x * r[:, None]


def _solve_stripe(l, x, p_first):
    """x (M x W) <- L^{-1} x from panel p_first on, right-looking."""
    m = l.shape[0]
    for p in range(p_first, -(-m // NB)):
        p0 = p * NB
        pb = min(NB, m - p0)
        x[p0:p0 + pb] = _substitute(l[p0:p0 + pb, p0:p0 + pb], x[p0:p0 + pb])
        x[p0 + NB:] -= l[p0 + NB:, p0:p0 + NB] @ x[p0:p0 + NB]
    return x


def _schedule(z, x, mean, ls_chol, ls, os_, jit, width):
    """One state through the kernels' schedule at stripe width `width`
    (both solves)."""
    m, n = z.shape[0], x.shape[0]
    dt = z.dtype
    a, b = z / ls, x / ls
    kzz = os_ * torch.exp(-0.5 * ((a[:, None] - a[None]) ** 2).sum(-1))
    kzx = os_ * torch.exp(-0.5 * ((a[:, None] - b[None]) ** 2).sum(-1))
    l = chol.cholesky_plain(kzz[None], jit.reshape(1), False)[0][0]
    rhs_ls = torch.cat([torch.tril(ls_chol), mean[:, None]], dim=1)
    wls = torch.full((m, m + 1), float("nan"), dtype=dt)
    stripes = -(-(m + 1) // width)
    for s in [stripes - 1] + list(range(stripes - 1)):  # the kernel's order
        c0 = s * width
        c1 = min(c0 + width, m + 1)
        p_first = 0 if c0 + width > m else c0 // NB
        xs = torch.zeros((m, width), dtype=dt)
        xs[p_first * NB:, :c1 - c0] = rhs_ls[p_first * NB:, c0:c1]
        xs = _solve_stripe(l, xs, p_first)
        wls[p_first * NB:, c0:c1] = xs[p_first * NB:, :c1 - c0]
    nt = -(-m // NB)
    order = []
    for pair in range((nt + 1) // 2):
        order += [pair] if nt - 1 - pair == pair else [pair, nt - 1 - pair]
    mu, var = torch.empty(n, dtype=dt), torch.empty(n, dtype=dt)
    for c0 in range(0, n, width):
        c1 = min(c0 + width, n)
        xs = torch.zeros((m, width), dtype=dt)
        xs[:, :c1 - c0] = kzx[:, c0:c1]
        xs = _solve_stripe(l, xs, 0)
        pm = xs.T @ wls[:, m]
        p1 = (xs * xs).sum(0)
        p2 = torch.zeros(width, dtype=dt)
        for i0 in order:
            cols = slice(i0 * NB, min(i0 * NB + NB, m))
            blk = wls[i0 * NB:, cols].T @ xs[i0 * NB:]
            p2 += (blk * blk).sum(0)
        mu[c0:c1] = pm[:c1 - c0]
        var[c0:c1] = torch.clamp(os_ - p1 + p2, min=1e-12)[:c1 - c0]
    return mu, var


def _problem(m, n, d, seed, dtype=np.float64):
    """The JAX kernel test's problem (tests/test_fused_svgp_kernel.py:19-35)."""
    rng = np.random.default_rng(seed)
    vals = (rng.uniform(size=(m, d)), rng.uniform(size=(n, d)), rng.normal(size=(m,)),
            np.tril(rng.normal(size=(m, m)) * 0.05) + 0.3 * np.eye(m), [0.15] * d, 1.3, 1e-2)
    return [np.asarray(v, dtype=dtype) for v in vals]


@pytest.mark.parametrize("m,n", [(1, 1), (31, 150), (100, 150), (128, 200), (490, 200)])
def test_schedule_matches_plain_and_reference_f64(m, n):
    args = _problem(m, n, 2, m + n)
    t = [torch.as_tensor(v) for v in args]
    mu, var = _schedule(*t, K2.plan(m, n, 1, torch.float64).width)
    mu_p, var_p = K2.fused_rbf_svgp_forward_plain(
        t[0], t[1], t[2][None], t[3][None], t[4][None], t[5].reshape(1), t[6].reshape(1))
    np.testing.assert_allclose(mu.numpy(), mu_p[0].numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), var_p[0].numpy(), rtol=1e-10, atol=1e-10)
    mu_r, var_r = reference_forward(*[jnp.asarray(v) for v in args])
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_r), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("width", [32, 16, 8, 4])
def test_schedule_every_width_f64(width):
    """Every stripe width, ragged M and N, against the plain version."""
    t = [torch.as_tensor(v) for v in _problem(100, 37, 3, 5)]
    mu, var = _schedule(*t, width)
    mu_p, var_p = K2.fused_rbf_svgp_forward_plain(
        t[0], t[1], t[2][None], t[3][None], t[4][None], t[5].reshape(1), t[6].reshape(1))
    np.testing.assert_allclose(mu.numpy(), mu_p[0].numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), var_p[0].numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("m,n", [(128, 128), (100, 150)])
def test_schedule_matches_pallas_kernel_interpret_f32(m, n):
    """The Pallas kernel itself, interpret mode (as
    tests/test_torch_fused_svgp.py), within chip_smoke.py's f32 tolerance."""
    args = _problem(m, n, 3, 0, np.float32)
    mu_j, var_j = jax_fused(*[jnp.asarray(a) for a in args], interpret=True)
    t = [torch.as_tensor(a) for a in args]
    mu, var = _schedule(*t, K2.plan(m, n, 1, torch.float32).width)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=2e-3, atol=2e-3)


def test_schedule_failed_factor_gives_nan():
    """A Gram that does not factorize gives NaN in mu and var, and the
    variance floor does not hide it."""
    t = [torch.as_tensor(v) for v in _problem(64, 10, 2, 3)]
    t[6] = torch.tensor(-10.0, dtype=torch.float64)
    mu, var = _schedule(*t, 8)
    assert bool(torch.isnan(mu).any()) and bool(torch.isnan(var).any())

