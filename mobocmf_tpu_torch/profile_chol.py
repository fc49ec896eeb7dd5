"""K1's design steps, each timed on the card against the one before, and
where one factorization's time goes.

    python -m mobocmf_tpu_torch.profile_chol [--reps 20] [--sweep] [--phases] [--json PATH]

Times the batched Cholesky kernel (linalg/chol.py) at f32 on the same
matrices under forced launch plans, from the single-level schedule to the
plan's choice:
  1. 32: 32-wide panels, one depth-32 trailing update per panel, the
     factor in L2, 8 blocks per matrix (outer = 1);
  2. +128: 32-wide inner panels inside 128-wide outer panels (outer = 4);
  3. +resident: the factor in the cluster's shared memory, where it fits
     8 blocks;
  4. +16: 16 blocks per matrix, the factor resident where it fits them;
and torch.linalg.cholesky beside them, each as device time per call
(torch.profiler). With --sweep it times every cluster size and storage
at B=3 for n from 128 to 1024. With --phases it also builds the
kernel with -DMOBOCMF_CHOL_PHASES and prints, for one matrix under the
plan, the time block 0 spent in each phase of the factorization (cluster
barriers, diagonal block, panel, inner and trailing updates), summed over
the panel steps. Prints the card's name and power limit, and with --json
writes the rows as JSON to PATH. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mobocmf_tpu_torch.profiling import device_ms

SHAPES = [(4, 128), (1, 512), (3, 512), (3, 1024), (3, 1536), (3, 2048)]
SWEEP_N = (128, 200, 256, 384, 512, 768, 1024)


PHASES = ("sync_top", "diag", "panel", "sync_mid", "inner", "sync_outer", "outer")


def phase_breakdown(chol, n: int) -> dict:
    """Nanoseconds block 0 spends in each phase of one f32 factorization of
    an n x n matrix under the plan (the profiling build), and the kernel's
    time with CUDA events."""
    from mobocmf_tpu_torch import _build

    lib = _build.load("chol", ("MOBOCMF_CHOL_PHASES",))
    fn = lib.mobocmf_chol_f32
    fn.argtypes = chol._C_ARGTYPES
    fn.restype = ctypes.c_int
    lib.mobocmf_chol_phases.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(n)
    a = torch.randn((1, n, n), generator=g, dtype=torch.float64, device="cuda")
    a = (a @ a.mT / n + torch.eye(n, dtype=torch.float64, device="cuda")).float()
    jit = torch.full((1,), 1e-5, device="cuda")
    out, level = torch.empty_like(a), torch.empty(1, dtype=torch.int32, device="cuda")
    pl = chol.plan(n, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    ns = (ctypes.c_ulonglong * len(PHASES))()

    def launch():
        err = fn(a.data_ptr(), out.data_ptr(), jit.data_ptr(), level.data_ptr(), 1, n, 1,
                 pl.cluster, int(pl.resident), pl.smem_bytes, pl.outer, stream)
        if err != 0:
            raise SystemExit(f"profile_chol: the profiling build failed to launch ({err})")

    launch()
    torch.cuda.synchronize()
    lib.mobocmf_chol_phases(ctypes.addressof(ns))  # zero after the warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    lib.mobocmf_chol_phases(ctypes.addressof(ns))
    row = {"n": n, "kernel_us": 1e3 * start.elapsed_time(end)}
    row.update({name: ns[i] / 1e3 for i, name in enumerate(PHASES)})
    return row


def main() -> None:
    from mobocmf_tpu_torch.linalg import chol

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_chol: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}", flush=True)
    dtype, size = torch.float32, 4

    def fits(n, cluster):
        need = chol.smem_bytes(n, size, cluster, True) + chol.STATIC_SMEM_BYTES
        return need <= chol.MAX_SMEM_PER_BLOCK

    def forced(n, cluster, resident, outer):
        return chol.Plan(cluster, resident, chol.smem_bytes(n, size, cluster, resident), outer)

    rows = []
    for batch, n in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n)
        a = torch.randn((batch, n, n), generator=g, dtype=torch.float64, device="cuda")
        a = (a @ a.mT / n + torch.eye(n, dtype=torch.float64, device="cuda")).to(dtype)
        jit = torch.full((batch,), 1e-5, dtype=dtype, device="cuda")
        plans = {
            "32": forced(n, 8, False, 1),
            "+128": forced(n, 8, False, chol.OUTER),
            "+resident": forced(n, 8, fits(n, 8), chol.OUTER),
            "+16": forced(n, 16, fits(n, 16), chol.OUTER),
            "plan": chol.plan(n, dtype),
        }
        row = {"batch": batch, "n": n, "card": card}
        want, _ = chol.cholesky_plain(a, jit, True)
        for name, pl in plans.items():
            got, _ = chol._launch(a, jit, True, pl)
            torch.cuda.synchronize()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel < 1e-4:
                raise SystemExit(f"profile_chol: {name} at B={batch} n={n} is off by {rel:.3e}")
            row[name] = device_ms(lambda: chol._launch(a, jit, True, pl), args.reps,
                                 "chol_kernel", 1)
            row[name + "_storage"] = "resident" if pl.resident else "L2"
        row["library"] = device_ms(lambda: torch.linalg.cholesky(a), args.reps)
        rows.append(row)
        print("[profile_chol] f32 B={batch} n={n}: ".format(**row) + ", ".join(
            f"{k} {row[k]:.4f} ms ({row[k + '_storage']})" for k in plans
        ) + f", torch.linalg.cholesky {row['library']:.4f} ms", flush=True)
    sweep = []
    if args.sweep:
        for n in SWEEP_N:
            g = torch.Generator(device="cuda").manual_seed(n)
            a = torch.randn((3, n, n), generator=g, dtype=torch.float64, device="cuda")
            a = (a @ a.mT / n + torch.eye(n, dtype=torch.float64, device="cuda")).to(dtype)
            jit = torch.full((3,), 1e-5, dtype=dtype, device="cuda")
            row = {"batch": 3, "n": n, "plan": list(chol.plan(n, dtype)[:2])}
            for cluster in (8, 16):
                for resident in (True, False):
                    if resident and not fits(n, cluster):
                        continue
                    pl = forced(n, cluster, resident, chol.OUTER)
                    row[f"{cluster}-{'resident' if resident else 'L2'}"] = device_ms(
                        lambda: chol._launch(a, jit, True, pl), args.reps, "chol_kernel", 1)
            sweep.append(row)
            print(f"[profile_chol] sweep f32 B=3 n={n} (plan {row['plan']}): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items() if k[0].isdigit() and "-" in k),
                flush=True)
    phases = []
    if args.phases:
        for n in (128, 512, 1536):
            row = phase_breakdown(chol, n)
            phases.append(row)
            print(f"[profile_chol] phases f32 B=1 n={n} (us, block 0; kernel "
                  f"{row['kernel_us']:.1f} us): "
                  + ", ".join(f"{name} {row[name]:.1f}" for name in PHASES), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"plans": rows, "sweep": sweep, "phases": phases}, indent=1))


if __name__ == "__main__":
    main()
