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
from mobocmf_tpu_torch.acquisition.random_choice import Random_choice
from mobocmf_tpu_torch.bench import bench_bo_iteration
from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop
from mobocmf_tpu_torch.examples.toy_synthetic_2D_JESMOCMF import main as toy_main
from mobocmf_tpu_torch.models.convert import model_from_numpy
from mobocmf_tpu_torch.sampling.rff import sample_prior
from mobocmf_tpu_torch.test_functions.prior_problem import sample_problem
from mobocmf_tpu_torch.util.checkpoint import restore_fitter
from mobocmf_tpu_torch.acquisition.mesmoc import MESMOC_MFGP
from mobocmf_tpu_torch.examples.example_batch_bo_10d import main as batch10d_main
from mobocmf_tpu_torch.examples.example_branin_currin_512 import main as bc512_main
from mobocmf_tpu_torch.examples.example_dtlz2_2048 import main as dtlz2_main
from mobocmf_tpu_torch.examples.example_mesmoc_mfgp import main as mesmoc_main
from mobocmf_tpu_torch.examples.example_synthetic_2D import main as synthetic2d_main
from mobocmf_tpu_torch.examples.example_acquisition_mfdgp_forrester import main as forrester_main
from mobocmf_tpu_torch.models.exact_gp import init_exact_gp
from mobocmf_tpu_torch.models.mfgp import init_mfgp
from mobocmf_tpu_torch.models.mfgp_lin import init_mfgp_lin
from mobocmf_tpu_torch.util.util import preprocess_outputs
from mobocmf_tpu_torch.parallel.dryrun import dryrun_multichip
from mobocmf_tpu_torch.parallel.launch import Group
from mobocmf_tpu_torch.parallel.sharding import make_mesh

walked = {m.name for m in pkgutil.walk_packages(mobocmf_tpu_torch.__path__, "mobocmf_tpu_torch.")}
for name in ("bench", "bo.loop", "acquisition.batch", "acquisition.random_choice",
             "util.hypervolume", "util.heartbeat", "util.checkpoint", "util.describe",
             "examples.toy_synthetic_2D_JESMOCMF", "kernels.mf_exact", "models.exact_gp",
             "models.mfgp", "models.mfgp_lin", "acquisition.mesmoc", "util.util",
             "util.profiling", "examples.example_mesmoc_mfgp", "examples.example_branin_currin_512",
             "examples.example_batch_bo_10d", "examples.example_dtlz2_2048", "fit.graphs",
             "examples.example_synthetic_2D", "examples.example_acquisition_mfdgp_forrester",
             "parallel.sharding", "parallel.launch", "parallel.dryrun"):
    assert "mobocmf_tpu_torch." + name in walked, name

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
    lambda: sample_problem(torch.Generator()),
    lambda: sample_prior(torch.Generator(), 2, 2),
    lambda: run_bo_loop([], x, fid, BOConfig(num_bo_iterations=0)),
    lambda: Random_choice(2, 2),
    lambda: restore_fitter("missing"),
    lambda: bench_bo_iteration(fast=True),
    lambda: toy_main(["--fast", "--iters", "0", "--log-dir", "unused"]),
    lambda: mesmoc_main(["--iters", "0"]),
    lambda: bc512_main(["--fast", "--iters", "0", "--log-dir", "unused"]),
    lambda: batch10d_main(["--fast", "--iters", "0", "--log-dir", "unused"]),
    lambda: dtlz2_main(["--fast", "--iters", "0", "--log-dir", "unused"]),
    lambda: synthetic2d_main([]),
    lambda: forrester_main(["--fast"]),
    lambda: MESMOC_MFGP({}, {}, 2, 2, {}, {}),
    lambda: init_mfgp(np.c_[x, fid], x[:, 0], 2),
    lambda: init_mfgp_lin(np.c_[x, fid], x[:, 0], 2),
    lambda: init_exact_gp(x, x[:, 0]),
    lambda: preprocess_outputs(x[:, 0]),
    lambda: make_mesh(),
    lambda: Group(2),
    lambda: dryrun_multichip(2),
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
