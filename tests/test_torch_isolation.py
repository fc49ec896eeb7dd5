"""The port imports neither jax nor mobocmf_tpu, and its entry points raise
rather than fall back to the CPU when no GPU is present.

Runs in a subprocess: this test process has imported jax already
(tests/conftest.py).
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import mobocmf_tpu_torch
for mod in pkgutil.walk_packages(mobocmf_tpu_torch.__path__, "mobocmf_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from mobocmf_tpu_torch import BlackBoxMFDGPFitter, init_mfdgp
from mobocmf_tpu_torch.models.convert import model_from_numpy

leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "mobocmf_tpu"
                or m.startswith("mobocmf_tpu."))
assert not leaked, leaked

import torch
assert not torch.cuda.is_available()
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
x = np.random.default_rng(0).uniform(size=(6, 2))
fid = np.arange(6) % 2
calls = [
    lambda: BlackBoxMFDGPFitter(2, 10),
    lambda: init_mfdgp(x, x[:, 0], fid, 2),
    lambda: model_from_numpy(None, None, {}, None, torch.float32),
]
for call in calls:
    try:
        call()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise AssertionError("an entry point ran without a GPU and no device named")
fitter = BlackBoxMFDGPFitter(2, 10, device="cpu")
print("ISOLATED")
"""


def test_port_imports_no_jax_and_needs_a_named_device_without_gpu():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ISOLATED" in out.stdout
