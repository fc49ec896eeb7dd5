"""The port's CUDA path on the card: K1 against its plain version, and a
short f64 training run on the card against the same run on the CPU.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.linalg import chol, ops
from mobocmf_tpu_torch.models import mfdgp as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel runs on the card only")
    return torch.device("cuda")


def _spd(batch, n, seed, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((batch, n, n), generator=g, dtype=torch.float64)
    a = a @ a.mT / n + torch.eye(n, dtype=torch.float64)
    return a.to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch,n", [(1, 128), (3, 200), (4, 384), (3, 512)])
def test_kernel_matches_plain(cuda_device, dtype, batch, n):
    a = _spd(batch, n, n, dtype, cuda_device)
    jit = torch.full((batch,), 1e-6, dtype=dtype, device=cuda_device)
    chol.reset_counts()
    got, level = chol.cholesky(a, jitter=jit, ladder=True)
    assert chol.launches == 1
    want, want_level = chol.cholesky_plain(a, jit, True)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < (1e-5 if dtype == torch.float32 else 1e-12), rel
    assert torch.equal(level, want_level)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


def test_kernel_nan_on_indefinite_and_ladder(cuda_device):
    a = _spd(3, 256, 1, torch.float32, cuda_device)
    a[1, 100, 100] = -1.0e4
    l, level = chol.cholesky(a, jitter=1e-6, ladder=False)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    assert bool(torch.isnan(diag[1, 100:]).all())
    assert bool(torch.isfinite(l[[0, 2]]).all())
    l, level = chol.cholesky(a, jitter=1e-6, ladder=True)
    assert level.tolist() == [0, 2, 0]
    # a matrix with a small negative eigenvalue climbs one rung and ends finite
    w, v = torch.linalg.eigh(_spd(1, 256, 2, torch.float64, "cpu")[0])
    w[0] = -1e-5 * w.mean()
    k = ((v * w) @ v.T).to(device=cuda_device, dtype=torch.float32)
    l, level = chol.cholesky(k, jitter=2e-6, ladder=True)
    want, want_level = chol.cholesky_plain(k[None], torch.full((1,), 2e-6, device=cuda_device), True)
    assert level.item() == 1 == want_level.item()
    assert bool(torch.isfinite(l).all())


def test_safe_cholesky_gradient_on_card_matches_cpu(cuda_device):
    k = _spd(2, 96, 3, torch.float64, "cpu")
    w = torch.linspace(0.0, 1.0, 96, dtype=torch.float64)
    grads = []
    for dev in ("cpu", cuda_device):
        kk = k.to(dev).clone().requires_grad_(True)
        torch.sum(torch.sin(ops.safe_cholesky(kk, 2e-6)) * w.to(dev)).backward()
        grads.append(kk.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-10, atol=1e-12)


def test_f64_training_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    fid = np.arange(40) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    eps = torch.randn((6, 2, 1, 40), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    runs = []
    for dev in ("cpu", cuda_device):
        models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        model = trainer.stack_models(models)
        chol.reset_counts()
        params, logs = trainer.train_phase_stacked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), 6, 0.003, "all_free", 40, eps=eps.to(dev),
        )
        if dev != "cpu":
            assert chol.launches == 2 * 6
        runs.append(logs.loss.cpu())
    torch.testing.assert_close(runs[1], runs[0], rtol=1e-8, atol=0.0)
