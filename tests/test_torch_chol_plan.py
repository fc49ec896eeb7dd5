"""K1's launch plan and its schedule, on the CPU.

`plan(n, dtype)` is checked for every bucket `next_bucket` gives between 8
and 4096: the cluster size, the storage (the cluster's shared memory exactly
where the lower triangle in 32x32 tiles fits it) and the shared memory per
block within the card's limit; the constants it mirrors are read from
csrc/chol_factor.cuh.

`_schedule` is a plain PyTorch mirror of the kernel's schedule (32-wide
inner panels inside 128-wide outer panels, the diagonal block factored
with reciprocal pivots, the panel rows solved against it by forward
substitution, the inner update inside the outer panel and one depth-128
trailing update per outer panel, identity padding of the last tile). It
is held against cholesky_plain and JAX's XLA Cholesky at f64, against the
Pallas kernel in interpret mode, and at f32 against the f64 factor within
chip_smoke.py's tolerance, so that a fault of the schedule shows here
before the card runs the kernel.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobocmf_tpu.linalg import chol as jchol
from mobocmf_tpu_torch.fit.bucketing import next_bucket
from mobocmf_tpu_torch.linalg import chol
from torch_threads import one_intra_op_thread  # noqa: F401

HEADER = Path(chol.__file__).resolve().parent.parent / "csrc" / "chol_factor.cuh"


def _buckets(lo=8, hi=4096):
    out, n = [], lo
    while n <= hi:
        b = next_bucket(n)
        out.append(b)
        n = b + 1
    return out


BUCKETS = _buckets()


def test_buckets_cover_the_range():
    assert BUCKETS[0] == 8 and BUCKETS[-1] == 4096
    assert {128, 512, 1024, 1536, 2048} <= set(BUCKETS)


def test_plan_constants_mirror_the_header():
    text = HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("NB"), const("OUTER"), const("UNIT")) == (chol.NB, chol.OUTER, chol.UNIT)
    assert "constexpr int LDS = NB + 1;" in text
    assert "constexpr int WORK_WORDS = 2 * UNIT * LDS + NB * LDS + NB;" in text
    assert f"constexpr int NOT_SCHEDULABLE = {chol.NOT_SCHEDULABLE};" in text


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", BUCKETS)
def test_plan_every_bucket(n, dtype):
    pl = chol.plan(n, dtype)
    size = torch.finfo(dtype).bits // 8
    assert pl.cluster == (8 if n <= 256 else 16)
    assert pl.outer == 4
    assert pl.smem_bytes + chol.STATIC_SMEM_BYTES <= 232_448
    # the lower triangle in 32x32 tiles, spread over the cluster, and the
    # staging workspace (two 64x33 slices, the 32x33 diagonal block and its
    # 32 reciprocal pivots)
    tiles = -(-n // 32) * (-(-n // 32) + 1) // 2
    work = size * (2 * 64 * 33 + 32 * 33 + 32)
    resident_bytes = work + size * 1024 * -(-tiles // pl.cluster)
    fits = resident_bytes + chol.STATIC_SMEM_BYTES <= 232_448
    assert pl.resident == fits
    assert pl.smem_bytes == (resident_bytes if fits else work)


@pytest.mark.parametrize("n,dtype,resident", [
    (512, torch.float32, True), (512, torch.float64, True), (1024, torch.float32, True),
    (1024, torch.float64, False), (1536, torch.float32, False), (768, torch.float64, True),
])
def test_plan_resident_boundary(n, dtype, resident):
    assert chol.plan(n, dtype).resident == resident


def _factor_block(d: torch.Tensor) -> torch.Tensor:
    """The diagonal block as the warp factorizes it: right-looking rank-1
    steps, a non-positive or non-finite pivot turned into NaN."""
    r = torch.tril(d.clone())
    for k in range(r.shape[0]):
        piv = r[k, k]
        if not (piv > 0 and torch.isfinite(piv)):
            piv = torch.tensor(float("nan"), dtype=r.dtype)
        piv = torch.sqrt(piv)
        r[k, k] = piv
        r[k + 1:, k] = r[k + 1:, k] * (1.0 / piv)
        r[k + 1:, k + 1:] -= torch.tril(torch.outer(r[k + 1:, k], r[k + 1:, k]))
    return r


def _substitute(a: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """x L^T = a for every row of a, as one thread solves its row: x_j *=
    1 / L_jj, then x_q -= x_j L_qj for q > j."""
    x = a.clone()
    for j in range(l.shape[0]):
        x[:, j] = x[:, j] * (1.0 / l[j, j])
        x[:, j + 1:] -= torch.outer(x[:, j], l[j + 1:, j])
    return x


def _schedule(a: torch.Tensor, nb: int = 32, outer: int = 4) -> torch.Tensor:
    n = a.shape[0]
    nt = -(-n // nb)
    w = torch.eye(nt * nb, dtype=a.dtype)
    w[:n, :n] = torch.tril(a)
    for p in range(0, nt, outer):
        pe = min(p + outer, nt)
        for k in range(p, pe):
            s = slice(k * nb, (k + 1) * nb)
            lkk = _factor_block(w[s, s])
            below = slice((k + 1) * nb, nt * nb)
            w[below, s] = _substitute(w[below, s], lkk)
            w[s, s] = lkk
            inner = slice((k + 1) * nb, pe * nb)
            w[below, inner] -= w[below, s] @ w[inner, s].T
        if pe < nt:
            t, dep = slice(pe * nb, nt * nb), slice(p * nb, pe * nb)
            w[t, t] -= w[t, dep] @ w[t, dep].T
    return torch.tril(w)[:n, :n]


def _spd(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return (a @ a.T / n + np.eye(n)).astype(dtype)


@pytest.mark.parametrize("n", [1, 31, 128, 200, 384, 512])
def test_schedule_matches_plain_and_xla_f64(n):
    a = _spd(n, n)
    got = _schedule(torch.as_tensor(a)).numpy()
    plain, _ = chol.cholesky_plain(torch.as_tensor(a)[None], torch.zeros(1, dtype=torch.float64),
                                   False)
    np.testing.assert_allclose(got, plain[0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jchol.cholesky(jnp.asarray(a))), rtol=1e-12,
                               atol=1e-12)


def test_schedule_matches_pallas_kernel_f32():
    """The Pallas kernel itself, interpret mode, one 128-block (as
    tests/test_torch_linalg.py): both are f32 factors of the same matrix,
    with a rounding order of their own."""
    a = _spd(128, 128, np.float32)
    want = np.asarray(jchol.cholesky(jnp.asarray(a), force_pallas=True))
    got = _schedule(torch.as_tensor(a)).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-6, rel


@pytest.mark.parametrize("n", [128, 200, 384, 512])
def test_schedule_f32_within_chip_smoke_tolerance(n):
    """chip_smoke.py holds the f32 kernel to rel 1e-4 and reconstruction
    1e-5; the f32 schedule meets both against the f64 factor."""
    a = _spd(n, n + 7)
    want = np.linalg.cholesky(a)
    got = _schedule(torch.as_tensor(a, dtype=torch.float32)).double().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    recon = np.abs(got @ got.T - a).max() / np.abs(a).max()
    assert rel < 1e-4 and recon < 1e-5, (rel, recon)


def test_schedule_failed_pivot_gives_nan_from_there_on():
    a = _spd(200, 3)
    a[100, 100] = -1e4
    d = torch.diagonal(_schedule(torch.as_tensor(a)))
    assert bool(torch.isfinite(d[:100]).all())
    assert bool(torch.isnan(d[100:]).all())
