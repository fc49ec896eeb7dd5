"""K2's launches and design steps, timed on the card.

    python -m mobocmf_tpu_torch.profile_k2 [--reps 20] [--steps] [--tree PATH] [--json PATH]

At the main path's three K2 shapes (bc512 screening: B=6 M=512 N=200;
bc512 recommendation: B=3 M=512 N=1000; b128 screening: B=8 M=128 N=200;
f32, d=2, the JAX kernel test's problem, `profiling.k2_problem`) it checks
the kernel against its plain version and prints a loop of wrapper calls
(CUDA events) and the device time of each launch (torch.profiler).

With --steps it also times the stripe width of linalg/fused_svgp.py::plan
against every width forced (W = 32, 16, 8, 4) on the same inputs (device
time of the two solve launches and of the whole call), and, as the solves'
yardstick, one torch.linalg.solve_triangular(L, [K_zx | L_S | m]) on the
same factor and right-hand side.

With --tree PATH it times the K2 of the checkout at PATH instead (the
per-shape timing only), so that two commits compare in one call: run this
file by its path, `python mobocmf_tpu_torch/profile_k2.py --tree PATH`, on
the parent's checkout and on this one, in turns. Prints the card's name and
power limit; with --json writes the rows to PATH. Needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)  # run by its path: the package's own directory is no top level

import argparse
import importlib.util
import json
import subprocess

import torch


def _own_profiling():
    """profiling.py of this file's checkout, loaded by its path: with --tree
    the package is imported from the other checkout, which may lack it."""
    spec = importlib.util.spec_from_file_location(
        "_k2_profiling", Path(__file__).resolve().with_name("profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_profiling = _own_profiling()
k2_problem, loop_ms, per_kernel_us = (_profiling.k2_problem, _profiling.loop_ms,
                                      _profiling.per_kernel_us)

SHAPES = [("bc512-screen", 6, 512, 200), ("bc512-recommend", 3, 512, 1000),
          ("b128-screen", 8, 128, 200)]
WIDTHS = [("plan", None), ("W=32", 32), ("W=16", 16), ("W=8", 8), ("W=4", 4)]
# kernels of one call of fused_rbf_svgp_forward, by a part of their names
K2_LAUNCHES = {"gram_factor_kernel": 1, "solve_kernel": 2}


def launch_split(us: dict) -> dict:
    """The device time of one call by launch: factor (Gram + factor),
    ls (the [L_S | m] solve), predict, and total."""
    row = {"factor_us": 0.0, "ls_us": 0.0, "predict_us": 0.0, "span_us": us["span"]}
    for name, t in us.items():
        if name == "span":
            continue
        if "gram_factor_kernel" in name:
            row["factor_us"] += t
        elif "solve_kernel" in name:
            row["predict_us" if "Lb1E" in name or ", true>" in name else "ls_us"] += t
    row["total_us"] = row["factor_us"] + row["ls_us"] + row["predict_us"]
    return row


def k2_split(fn, calls: int) -> dict:
    """launch_split of `calls` calls of fn, a call of K2's kernels."""
    return launch_split(per_kernel_us(fn, calls, K2_LAUNCHES))


def describe(split: dict) -> str:
    return (f"factor {split['factor_us']:.1f} us, [L_S | m] solve {split['ls_us']:.1f} us, "
            f"predictive {split['predict_us']:.1f} us (sum {split['total_us']:.1f} us, span "
            f"{split['span_us']:.1f} us)")


def yardstick_us(args, reps: int) -> float:
    """One torch.linalg.solve_triangular(L, [K_zx | L_S | m]) on the factor
    and right-hand side of K2's solves (device time)."""
    z, x, mean, ls_chol, ls, os_, jit = args
    a, b = z / ls[:, None], x / ls[:, None]
    os3 = os_[:, None, None]
    kzz = os3 * torch.exp(-0.5 * ((a[:, :, None] - a[:, None]) ** 2).sum(-1))
    kzx = os3 * torch.exp(-0.5 * ((a[:, :, None] - b[:, None]) ** 2).sum(-1))
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    lk = torch.linalg.cholesky(kzz + jit[:, None, None] * eye)
    rhs = torch.cat([kzx, torch.tril(ls_chol), mean[..., None]], dim=-1)
    us = per_kernel_us(lambda: torch.linalg.solve_triangular(lk, rhs, upper=False), reps)
    return sum(t for name, t in us.items() if name != "span")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("--tree", type=Path, default=None)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k2: needs a CUDA device")
    tree = (args.tree or Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(tree))
    from mobocmf_tpu_torch import _build
    from mobocmf_tpu_torch.linalg import fused_svgp as K2

    if tree not in Path(K2.__file__).resolve().parents:
        raise SystemExit(f"profile_k2: imported {K2.__file__}, not the checkout at {tree}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}; K2 of {Path(K2.__file__).resolve()}", flush=True)
    _build.build()
    dev = torch.device("cuda")
    rows = []
    with torch.no_grad():
        for label, b, m, n in SHAPES:
            p = k2_problem(b, m, n, 2, m + n, torch.float32, dev)
            mu_p, var_p = K2.fused_rbf_svgp_forward_plain(*p)
            row = {"shape": label, "B": b, "M": m, "N": n, "tree": tree.name, "card": card}

            def check(mu, var, what):
                torch.cuda.synchronize()
                err = max((mu - mu_p).abs().max().item(), (var - var_p).abs().max().item())
                if not err < 2e-3:
                    raise SystemExit(f"profile_k2: {what} at {label} is off by {err:.3e}")
                return err

            row["max_abs_err"] = check(*K2.fused_rbf_svgp_forward(*p), "the kernel")
            row["loop_ms"] = loop_ms(lambda: K2.fused_rbf_svgp_forward(*p), args.reps)
            row.update(k2_split(lambda: K2.fused_rbf_svgp_forward(*p), args.reps))
            print(f"[profile_k2] {label} f32 B={b} M={m} N={n} ({tree.name}): loop "
                  f"{row['loop_ms']:.4f} ms; device {describe(row)}; "
                  f"max_abs_err {row['max_abs_err']:.3e}",
                  flush=True)
            if args.steps:
                for name, width in WIDTHS:
                    sp = K2.plan(m, n, b, torch.float32)
                    if width is not None:
                        sp = K2.Plan(width, K2.solve_smem_bytes(m, width, 4))
                    check(*K2._launch(*p, sp=sp), name)
                    split = k2_split(lambda: K2._launch(*p, sp=sp), args.reps)
                    row[name] = dict(split, width=sp.width)
                    print(f"[profile_k2] width {name} {label} (W {sp.width}): {describe(split)}",
                          flush=True)
                row["trsm_us"] = yardstick_us(p, args.reps)
                print(f"[profile_k2] yardstick {label}: solve_triangular(L, [K_zx | L_S | m]) "
                      f"{row['trsm_us']:.1f} us", flush=True)
            rows.append(row)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
