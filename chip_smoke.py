#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mobocmf_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from mobocmf_tpu_torch/csrc/ into
   build/kernels/ (one nvcc per source, all started together);
2. holds K1 (the batched Cholesky) against its plain PyTorch version on the
   card at the main path's shapes and more, f32 and f64, and times the
   kernel, the plain version and torch.linalg.cholesky (the yardstick);
3. checks the f64 CUDA path against the port's CPU path (which the CPU
   tests hold against the JAX package) on a small problem;
4. drives the main path through the entry points a user calls: the
   Branin-Currin-512 configuration (3 blackboxes, 490 points padded to the
   512 bucket, so m = 512 inducing points per layer) through
   BlackBoxMFDGPFitter -> initialize_mfdgp -> train_mfdgps ->
   predict_for_acquisition_all, then the 128-bucket shape (4 blackboxes,
   120 points), both f32 on the card, with the kernel counters set to 0
   just before each run and read just after;
5. prints the kernel line and, last, {"ok": true, "device": {...}}.

Exits non-zero, with no result line, without a CUDA device, outside a
checkout of the repo, or when any check fails.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense, no tensor cores for fp32 / fp64)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES_PER_S = 3.35e12
SEED = 7


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd(batch: int, n: int, seed: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((batch, n, n), generator=g, dtype=torch.float64, device=device)
    return (a @ a.mT / n + torch.eye(n, dtype=torch.float64, device=device)).to(dtype)


def chol_bound_ms(batch: int, n: int, dtype) -> tuple:
    """Least time for B factorizations: n^3/3 flops and 2 n^2 words each."""
    flops = batch * n**3 / 3.0
    nbytes = batch * 2.0 * n * n * torch.finfo(dtype).bits / 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k1(P) -> dict:
    """K1 against its plain version; returns the record of each shape."""
    chol = P.chol
    dev = torch.device("cuda")
    shapes = [(torch.float32, b, n) for b in (1, 3, 4) for n in (128, 200, 384, 512, 1536)]
    shapes.append((torch.float64, 3, 512))
    records = {}
    for dtype, b, n in shapes:
        a = spd(b, n, 1000 * b + n, dtype, dev)
        jit = torch.full((b,), 1e-5 if dtype == torch.float32 else 2e-6, dtype=dtype, device=dev)
        got, level = chol.cholesky(a, jit, ladder=True)
        want, want_level = chol.cholesky_plain(a, jit, True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        a_j = a.double() + jit.double()[:, None, None] * torch.eye(n, device=dev, dtype=torch.float64)
        g64 = got.double()
        recon = ((g64 @ g64.mT - a_j).abs().max() / a_j.abs().max()).item()
        reps = 5 if n >= 1536 else 20
        ms = cuda_ms(lambda: chol.cholesky(a, jit, ladder=True), reps)
        plain_ms = cuda_ms(lambda: chol.cholesky_plain(a, jit, True), reps)
        library_ms = cuda_ms(lambda: torch.linalg.cholesky(a), reps)
        bound_ms, bound_by = chol_bound_ms(b, n, dtype)
        tag = "f32" if dtype == torch.float32 else "f64"
        print(
            f"[k1] {tag} B={b} n={n}: max_rel_diff={rel:.3e} max_abs_err={err:.3e} "
            f"recon={recon:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})",
            flush=True,
        )
        check(torch.equal(level, want_level), f"K1 {tag} B={b} n={n}: ladder rungs differ")
        check(bool(torch.isfinite(got).all()), f"K1 {tag} B={b} n={n}: non-finite factor")
        tol_rel, tol_recon = (1e-4, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
        check(rel < tol_rel, f"K1 {tag} B={b} n={n}: differs from plain by {rel:.3e}")
        check(recon < tol_recon, f"K1 {tag} B={b} n={n}: reconstruction error {recon:.3e}")
        records[(tag, b, n)] = dict(
            max_abs_err=err, max_rel_diff=rel, recon=recon, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )

    # an indefinite matrix gives a NaN diagonal from the failed pivot on
    a = spd(3, 256, 5, torch.float32, dev)
    a[1, 100, 100] = -1.0e4
    for ladder in (False, True):
        l, level = chol.cholesky(a, 1e-5, ladder=ladder)
        diag = torch.diagonal(l, dim1=-2, dim2=-1)
        check(bool(torch.isnan(diag[1, 100:]).all()), "K1: indefinite input did not give NaN")
        check(bool(torch.isfinite(l[[0, 2]]).all()), "K1: NaN leaked into other matrices")
        check(level.tolist() == ([0, 2, 0] if ladder else [0, 0, 0]), f"K1: rungs {level.tolist()}")
    print("[k1] indefinite input -> NaN diagonal from the failed pivot on: ok", flush=True)

    # a near-singular large-scale RBF Gram goes up the ladder and ends finite
    g = torch.Generator().manual_seed(8)
    x = torch.rand((512, 2), generator=g, dtype=torch.float64)
    w, v = torch.linalg.eigh(4000.0 * torch.exp(-0.5 * torch.cdist(x, x) ** 2 / 0.25))
    w[0] = -1e-5 * 4000.0
    k = ((v * w) @ v.T).to(device=dev, dtype=torch.float32)
    l, level = chol.cholesky(k, 2e-6, ladder=True)
    _, want_level = chol.cholesky_plain(k[None], torch.full((1,), 2e-6, device=dev), True)
    print(f"[k1] near-singular Gram (scale 4000): rung {level.item()}, plain rung "
          f"{want_level.item()}", flush=True)
    check(level.item() >= 1, "K1: the near-singular Gram did not climb the ladder")
    check(level.item() == want_level.item(), "K1: ladder rung differs from the plain version")
    check(bool(torch.isfinite(l).all()), "K1: the ladder did not end finite")
    return records


def phase_reference(P) -> None:
    """f64 on the card (K1 f64 + the CUDA path) against the CPU path."""
    trainer, chol, M = P.trainer, P.chol, P.M
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(48, 2))
    fid = np.arange(48) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    eps = torch.randn((5, 2, 1, 48), generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    out = []
    for dev in ("cpu", "cuda"):
        models = [M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i),
                               device=dev, dtype=torch.float64) for i, y in enumerate(ys)]
        model = trainer.stack_models(models)
        chol.reset_counts()
        params, logs = trainer.train_phase_stacked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), 5, 0.003, "all_free", 48, eps=eps.to(dev),
        )
        mus, var = M.predict_for_acquisition_all(
            params, model.consts, model.config, torch.as_tensor(x[:9] + 0.01, device=dev))
        out.append((logs.loss.cpu(), mus.cpu(), var.cpu(), chol.launches))
    (l_c, m_c, v_c, _), (l_g, m_g, v_g, launched) = out
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in ((l_g, l_c), (m_g, m_c), (v_g, v_c)))
    print(f"[reference] f64 card vs CPU: max rel diff {rel:.3e}, K1 launches {launched}",
          flush=True)
    check(rel < 1e-8, f"f64 card path differs from the CPU path by {rel:.3e}")
    check(launched >= 2 * 5, "f64 card path did not launch K1")


def run_slice(P, label, blackboxes, n_init, epochs) -> dict:
    """One fitter run at full width; counters zeroed just before, read just after."""
    trainer, chol, M = P.trainer, P.chol, P.M
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(n_init, 2))
    n_high = n_init // 4
    fid = np.concatenate([np.zeros(n_init - n_high), np.ones(n_high)]).astype(int)
    ys = [np.where(fid == 0, lo(x), hi(x)) for _, (lo, hi), _ in blackboxes]
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16)), -1).reshape(-1, 2)

    chol.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter = P.BlackBoxMFDGPFitter(
        num_fidelities=2, batch_size=n_init, lr_1=0.003, lr_2=0.001,
        num_epochs_1=epochs, num_epochs_2=epochs, seed=SEED, pad_data=True,
    )
    for (name, _, is_con), y in zip(blackboxes, ys):
        fitter.initialize_mfdgp(x, y, fid, name, threshold_constraint=0.0, is_constraint=is_con)
    t_init = time.perf_counter() - t0
    fitter.train_mfdgps()
    model = trainer.stack_models([fitter.get_model(n, c) for n, _, c in blackboxes])
    t1 = time.perf_counter()
    mus, var = M.predict_for_acquisition_all(
        model.params, model.consts, model.config,
        torch.as_tensor(grid, device="cuda", dtype=torch.float32),
    )
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t1
    launches, escalations = chol.launches, chol.escalations()

    m = fitter.x_train.shape[0]
    steps = 0
    for st in fitter.phase_stats:
        steps += st["epochs"]
        print(
            f"[{label}] phase {st['phase']}: {st['epochs']} steps in {st['seconds']:.3f} s = "
            f"{st['epochs'] / st['seconds']:.2f} steps/s; neg-ELBO first {st['first']:.6g} "
            f"last {st['last']:.6g}; K1 launches {st['chol_launches']}; "
            f"ladder escalations {st['escalations']}",
            flush=True,
        )
        check(np.isfinite(st["last"]), f"{label}: non-finite loss")
    print(
        f"[{label}] m={m} blackboxes={len(blackboxes)} init {t_init:.3f} s; "
        f"predict_for_acquisition_all on {grid.shape[0]} points {t_pred * 1e3:.2f} ms; "
        f"K1 launches {launches} for {steps} steps; ladder escalations {escalations}",
        flush=True,
    )
    leaves = P.tree_leaves(model.params)
    check(all(bool(torch.isfinite(t).all()) for t in leaves), f"{label}: non-finite params")
    check(launches >= 2 * steps, f"{label}: K1 launched {launches} times for {steps} steps")
    check(tuple(mus.shape) == (len(blackboxes), 2, grid.shape[0]), f"{label}: shape {mus.shape}")
    check(bool(torch.isfinite(mus).all()) and bool(torch.isfinite(var).all()),
          f"{label}: non-finite acquisition predictive")
    check(bool((var > 0).all()), f"{label}: non-positive predictive variance")
    print(f"[{label}] predict_for_acquisition_all: finite, var > 0 "
          f"(min {var.min().item():.3e})", flush=True)
    return dict(launches=launches, steps=steps, m=m,
                steps_per_s=[st["epochs"] / st["seconds"] for st in fitter.phase_stats])


def card_name_and_power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        raise CheckFailed(f"nvidia-smi: {exc}") from exc
    check(smi.returncode == 0 and bool(smi.stdout.strip()), "nvidia-smi gave no card")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mobocmf_tpu_torch import BlackBoxMFDGPFitter, _build
        from mobocmf_tpu_torch.fit import trainer
        from mobocmf_tpu_torch.linalg import chol
        from mobocmf_tpu_torch.models import mfdgp as M
        from mobocmf_tpu_torch.test_functions import synthetic as S
        from mobocmf_tpu_torch.util.tree import tree_leaves
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repo ({exc})", file=sys.stderr)
        return 2

    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    try:
        card = card_name_and_power_limit()
        print(f"[card] {card}", flush=True)
        t0 = time.perf_counter()
        logs = _build.build()
        print(f"[build] {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for name, out in logs.items():
            for line in out.splitlines():
                if "registers" in line or "bytes stack" in line:
                    print(f"[build] {name}: {line.strip()}", flush=True)

        P = SimpleNamespace(BlackBoxMFDGPFitter=BlackBoxMFDGPFitter, trainer=trainer,
                            chol=chol, M=M, tree_leaves=tree_leaves)
        k1 = phase_k1(P)
        phase_reference(P)

        bc512 = [
            ("branin", (S.branin_scaled_low, S.branin_scaled), False),
            ("currin", (S.currin_low, S.currin), False),
            ("disk", (S.disk_constraint, S.disk_constraint), True),
        ]
        run_a = run_slice(P, "bc512", bc512, 490, 100)
        small_disk = functools.partial(S.disk_constraint, radius=0.4)
        bench128 = bc512 + [("disk04", (small_disk, small_disk), True)]
        run_b = run_slice(P, "b128", bench128, 120, 50)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    main_rec = k1[("f32", 3, 512)]
    print(f"[summary] bc512 K1 launches {run_a['launches']} for {run_a['steps']} steps; "
          f"b128 K1 launches {run_b['launches']} for {run_b['steps']} steps", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "chol",
        "route": "cuda",
        "source": "mobocmf_tpu_torch/csrc/chol.cu",
        "replaces": "mobocmf_tpu/linalg/chol.py:61",
        "launches": run_a["launches"],
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
