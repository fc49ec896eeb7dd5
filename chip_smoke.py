#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mobocmf_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from mobocmf_tpu_torch/csrc/ into
   build/kernels/ (one nvcc per source, all started together);
2. holds K1 (the batched Cholesky) against its plain PyTorch version on the
   card at the main path's shapes and more (B 1, 3, 4 x n 128 to 2048 at
   f32, on both sides of the plan's resident / L2 boundary and both
   cluster sizes; B 3 x n 512, 1024 at f64), and at the exact-GP models'
   shapes with and without the ladder (B 1, 3 x n 24, 32, 40, 96 at f32, B
   1 x n 32 at f64), prints each shape's plan and how many of its clusters
   the card holds at once; after every path it times the kernel, the
   plain version and torch.linalg.cholesky (the yardstick) there as device
   time per call (torch.profiler; the wrapper's call time beside it), the
   MESMOC path's factor (B 1, n 32, f32, no ladder) too, and reads the
   cost of one panel step from the slope of time against n/32;
3. holds K2 (the fused RBF-SVGP predictive) against its plain PyTorch
   version at the JAX kernel test's problem, at the slice's shapes and at
   shapes that take every stripe width of its plan (printed per shape),
   f32 and f64, and times both (no single PyTorch call computes K2's
   function); at the three shapes of the main path it prints the device
   time of each of K2's launches and of one torch.linalg.solve_triangular
   on the same factor and right-hand sides (the solves' yardstick);
4. checks the f64 CUDA path against the port's CPU path (which the CPU
   tests hold against the JAX package) on a small problem, and the K2
   route of the acquisition predictive against the plain route at f64;
   the f64 all-fidelity search of a small trained state and one f64
   device polish on the card against the CPU's (both optax's L-BFGS,
   acquisition/lbfgs.py: points 1e-8, values 1e-10), and each, replayed
   from CUDA graphs, against the same run with its pieces eager on the
   card (points 1e-12, equal iterations per lane and evaluations); then
   the phases replayed from CUDA graphs (mobocmf_tpu_torch/fit/graphs.py)
   against the CPU's eager steps from the same draws at f64: a full-batch,
   a minibatch and a conditioned phase cut into chunks of 2 steps (two
   chunk boundaries and a remainder) and an exact-GP adam_fit,
   with K1's launches equal to one eager step's times the steps;
5. drives the main path through the entry points a user calls: the
   Branin-Currin-512 configuration (3 blackboxes, 490 points padded to the
   512 bucket, so m = 512 inducing points per layer) through
   BlackBoxMFDGPFitter -> initialize_mfdgp -> train_mfdgps ->
   JESMOC_MFDGP (Pareto sampling, conditioned training) -> add_blackbox ->
   get_nextpoint_coupled -> the recommendation pass on a 1000-point grid,
   then the 128-bucket shape (4 blackboxes, 120 points), both f32 on the
   card, with the kernel counters set to 0 just before each stage and read
   just after; before training it holds K1's ladder rung for each layer's
   Kzz at the initial parameters to the plain version's and prints ladder
   escalations per K1 launch; it scores the candidates on the f64 copy of
   the models, and holds K2 on the path's own trained states to the plain
   route's accuracy (layer 0 against the f64 answer of the same system,
   and the recommendation means against the f64 models); at b128 the f32
   search from 200 fixed raw points captured and eager (200 iterations
   each): values within the f32 surface's error, evaluations per iteration
   within 2 %, every replay under set_sync_debug_mode("error");
5b. the JAX package's three switches, each flipped in this
   process and restored (phase_variants): at f64, flat Adam
   (MOBOCMF_FLAT_ADAM=1) against per-leaf Adam and the three-forward
   conditioned loss (MOBOCMF_FUSED_COND=0) against the fused one through
   captured phases, and the solve-route gains (MOBOCMF_ACQ_INV=0) against
   the inverse route; at f32 and the b128 width, the fitter's training,
   conditioned training and search under each setting with steps/s,
   capture seconds and K1 / K2 launches, K1 per step equal under every
   setting;
6. drives the BO loop (mobocmf_tpu_torch/bo/loop.py::run_bo_loop) on the
   card at the bench's width (mobocmf_tpu_torch/bench.py: 4 blackboxes,
   120 points padded to m = 128, f32), at a cut depth (100 + 100 epochs,
   100 conditioned steps), with the recommendation on and a temporary log
   directory: (a) two q=1 JESMOC iterations, with the log files, phase
   times, points, fidelities, observed HV and K1 / K2 launches of every
   stage checked and printed; (b) a resume of the same directory to three
   iterations; (c) one q=2 iteration, whose penalized pick launches K2;
   (d) one random-baseline iteration with nothing that consumes models,
   which must train nothing; (e) the checkpoints that (a) stored, restored
   on the same iteration instead of retraining, bitwise equal to the saved
   fitters; (f) one Pareto sample of the restored models with the device
   polish, timed against the SLSQP polish;
7. runs the port's example_mesmoc_mfgp at its defaults (5 iterations, f32,
   a temporary log directory): the four logs, finite non-negative
   acquisition values, fidelities in {0, 1}, and K1 launches per iteration
   equal to the count PERF.md predicted (MESMOC_K1_PER_ITER); K1 on one of
   the path's own NLML Grams against the plain version; one f64 MFGP fit
   and predict on the card against the CPU;
8. runs one iteration of example_dtlz2_2048 --fast at the example's width
   (2040 points padded to m = 2048, 3 fidelities, 4 objectives: K1 at
   n = 2048, K2 at M = 2048) and one of example_batch_bo_10d --fast
   (q = 16, d = 10), with K1 / K2 launches per stage (2 K2 per penalized
   pick checked), holds K2 on each search's own screening states to the
   plain route's accuracy (as for bc512), and times K2 at the shape the
   path gave it against its plain version, with its plan;
9. runs the two examples that checkpoint or pickle the fitter between its
   phases (example_synthetic_2D, example_acquisition_mfdgp_forrester
   --fast): the round trips on the card keep every prediction, K2 runs on
   their acquisition surfaces, and K1 / K2 launches per stage equal the
   counts predicted (PIPELINE_STAGES);
10. runs the device mesh (mobocmf_tpu_torch/parallel/): (a) the dry run
   (parallel/dryrun.py) at the bench's width in f64 on a 2 x 2 mesh of four ranks
   that share the card over gloo, its phases uncaptured, (b) the same on a
   1 x 1 NCCL mesh, its phases captured with the all-reduce inside the
   graph, each held to the same body run unsharded in this process, and (c)
   one run_bo_loop iteration at the loop phase's width with
   BOConfig(mesh=make_mesh(2, bb=1)) on two ranks: the logs written once,
   by rank 0, with the unsharded loop's file set, the same BOState on
   every rank, and the sharded MOOP's front equal to rank 0's unsharded
   MOOP on the same samples and grid; K1 and K2 launch on every rank,
   counted per rank and per stage;
11. prints, for every path, its captured phases' steps per second with the
   capture seconds and replays, each phase's seconds, and for every path
   that searches or polishes its L-BFGS runs (`[search]` lines: seconds,
   ms per evaluation, how many runs were replayed from CUDA graphs with
   the capture seconds and replays, iterations, evaluations per iteration,
   line-search steps per lane and iteration, lanes ended at gtol or at
   maxiter, with a failed line search or on a non-finite point; each mesh
   rank's), the kernel line, the script's total seconds and, last,
   {"ok": true, "device": {...}}.

Every L-BFGS run on the card is replayed from CUDA graphs (fit/graphs.py),
but for the dry run's search over the gloo mesh, which runs eagerly (the
reason is printed), and the eager arms of the checks; the [search] lines
fail otherwise. Every search and polish runs at its full depth (200 and
100 iterations at f32, as in a BO iteration). `python -m
mobocmf_tpu_torch.profile_search` times the searches eager and captured.

Exits non-zero, with no result line, without a CUDA device, outside a
checkout of the repo, or when any check fails.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense; fp64 on the tensor cores, as port_bench/_flops.py)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES_PER_S = 3.35e12
SEED = 7
COND_ITERS = 100  # conditioned iterations (15000 in a full BO iteration)
# chunk size of the captured reference phases (5 steps: 2 + 2 + 1)
REFERENCE_CHUNK = 2
# K2 on the main path's f32 states against the plain route, from the H100
# readings in PERF.md: at layer 0 K2 was 0.12x (bc512) and 0.24x (b128) as
# far off the f64 answer as the plain route, so it may be no further off;
# end to end (layer 1 on the plain route in both) 0.92x and 0.88x, bound 1.5x.
# The floors are f32 rounding of the answer, relative to its largest value.
LAYER0_RATIO, LAYER0_FLOOR = 1.0, 1e-6
END_TO_END_RATIO, END_TO_END_FLOOR = 1.5, 1e-6


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


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


K1_SHAPES = [(torch.float32, b, n) for b in (1, 3, 4)
             for n in (128, 200, 384, 512, 768, 1024, 1536, 2048)]
K1_SHAPES += [(torch.float64, 3, 512), (torch.float64, 3, 1024)]
# the exact-GP family's shapes (the MESMOC example factors n = 32, B = 1,
# without the ladder), each checked with and without the ladder
K1_SMALL_N = 128
K1_SHAPES += [(torch.float32, b, n) for b in (1, 3) for n in (24, 32, 40, 96)]
K1_SHAPES += [(torch.float64, 1, 32)]


def k1_input(b: int, n: int, dtype, dev):
    a = spd(b, n, 1000 * b + n, dtype, dev)
    jit = torch.full((b,), 1e-5 if dtype == torch.float32 else 2e-6, dtype=dtype, device=dev)
    return a, jit


def phase_k1(P) -> dict:
    """K1 against its plain version; returns the record of each shape."""
    chol = P.chol
    dev = torch.device("cuda")
    records = {}
    for dtype, b, n in K1_SHAPES:
        tag = "f32" if dtype == torch.float32 else "f64"
        pl = chol.plan(n, dtype)
        active = chol.max_active_clusters(pl, dtype)
        print(f"[k1] plan {tag} n={n}: cluster {pl.cluster}, "
              f"{'resident' if pl.resident else 'L2'} storage, {pl.smem_bytes} B dynamic shared "
              f"memory per block, max active clusters {active}", flush=True)
        check(active >= 1, f"K1 {tag} n={n}: the card cannot hold one cluster of the plan")
        a, jit = k1_input(b, n, dtype, dev)
        for ladder in ((False, True) if n < K1_SMALL_N else (True,)):
            got, level = chol.cholesky(a, jit, ladder=ladder)
            want, want_level = chol.cholesky_plain(a, jit, ladder)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            a_j = a.double() + jit.double()[:, None, None] * torch.eye(n, device=dev,
                                                                       dtype=torch.float64)
            g64 = got.double()
            recon = ((g64 @ g64.mT - a_j).abs().max() / a_j.abs().max()).item()
            what = f"{tag} B={b} n={n}" + ("" if ladder else " no ladder")
            print(f"[k1] {what}: max_rel_diff={rel:.3e} max_abs_err={err:.3e} "
                  f"recon={recon:.3e}", flush=True)
            check(torch.equal(level, want_level), f"K1 {what}: ladder rungs differ")
            check(bool(torch.isfinite(got).all()), f"K1 {what}: non-finite factor")
            tol_rel, tol_recon = (1e-4, 1e-5) if dtype == torch.float32 else (1e-10, 1e-12)
            check(rel < tol_rel, f"K1 {what}: differs from plain by {rel:.3e}")
            check(recon < tol_recon, f"K1 {what}: reconstruction error {recon:.3e}")
            records[(tag, b, n) if ladder else (tag + "-noladder", b, n)] = dict(
                max_abs_err=err, max_rel_diff=rel, recon=recon)

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


def time_k1(P, records: dict) -> None:
    """K1, its plain version and torch.linalg.cholesky (the yardstick) at
    every shape of phase_k1, as device time per call (the card's kernels,
    torch.profiler: the kernel alone for K1, every kernel of the call for
    the others), with the wrapper's call time beside it, and the cost of one
    panel step. It runs after the main path, and the call times before the
    first profiler session: a session may leave the host slower for the
    rest of the process."""
    chol = P.chol
    dev = torch.device("cuda")
    for dtype, b, n in K1_SHAPES:
        tag = "f32" if dtype == torch.float32 else "f64"
        a, jit = k1_input(b, n, dtype, dev)
        reps = 5 if n >= 1536 else 20
        records[(tag, b, n)]["call_ms"] = P.loop_ms(lambda: chol.cholesky(a, jit, ladder=True), reps)
    for dtype, b, n in K1_SHAPES:
        tag = "f32" if dtype == torch.float32 else "f64"
        a, jit = k1_input(b, n, dtype, dev)
        reps = 5 if n >= 1536 else 20
        ms = P.device_ms(lambda: chol.cholesky(a, jit, ladder=True), reps, "chol_kernel", 1)
        plain_ms = P.device_ms(lambda: chol.cholesky_plain(a, jit, True), reps)
        library_ms = P.device_ms(lambda: torch.linalg.cholesky(a), reps)
        bound_ms, bound_by = chol_bound_ms(b, n, dtype)
        rec = records[(tag, b, n)]
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        print(f"[k1] {tag} B={b} n={n}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
              f"call_ms={rec['call_ms']:.4f} (a loop of wrapper calls, CUDA events)", flush=True)
    # the MESMOC path's factor: B=1 n=32 f32 without the ladder
    a, jit = k1_input(1, 32, torch.float32, dev)
    jit = torch.zeros_like(jit)
    rec = records[("f32-noladder", 1, 32)]
    rec.update(
        ms=P.device_ms(lambda: chol.cholesky(a, jit, ladder=False), 20, "chol_kernel", 1),
        plain_ms=P.device_ms(lambda: chol.cholesky_plain(a, jit, False), 20),
        library_ms=P.device_ms(lambda: torch.linalg.cholesky(a), 20),
        call_ms=P.loop_ms(lambda: chol.cholesky(a, jit, ladder=False), 20),
    )
    rec["bound_ms"], rec["bound_by"] = chol_bound_ms(1, 32, torch.float32)
    print(f"[k1] f32 B=1 n=32 no ladder (the MESMOC path's factor): ms={rec['ms']:.4f} "
          f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
          f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) call_ms={rec['call_ms']:.4f}",
          flush=True)
    # the cost of one 32-wide panel step: the slope of the kernel's time
    # against n/32 at one matrix, between two shapes of one cluster size
    for lo, hi in ((128, 200), (384, 512)):
        t_lo, t_hi = records[("f32", 1, lo)]["ms"], records[("f32", 1, hi)]["ms"]
        blocks = chol.plan(hi, torch.float32).cluster
        print(f"[k1] per-panel cost (f32, B=1, n {lo} -> {hi}, {blocks} blocks): "
              f"{1e3 * (t_hi - t_lo) / ((hi - lo) / 32):.2f} us", flush=True)


def k2_flops(m: int, n: int, d: int) -> float:
    """Flops K2's function needs per state: the Gram's lower triangle and
    K_zx ((3 d + 2) each entry: differences, squares, sum, exp, scale), the
    factor M^3/3, the K_zx solve M^2 N, the solve of the lower-triangular
    L_S M^3/3, the m solve M^2, the lower-triangular W_ls^T W M^2 N, and
    the three column reductions 6 M N."""
    gram = (m * (m + 1) / 2.0 + m * n) * (3 * d + 2)
    return gram + 2.0 * m**3 / 3.0 + 2.0 * m * m * n + m * m + 6.0 * m * n


def k2_bound_ms(batch: int, m: int, n: int, d: int, dtype) -> tuple:
    """Least time for K2 on B states: k2_flops at the dtype's peak against
    the bytes of z, x, mean, ls_chol, lengthscale, outputscale, jitter read
    once and mu, var written once."""
    flops = batch * k2_flops(m, n, d)
    words = (m + n) * d + batch * (m + m * m + d + 2 + 2 * n)
    nbytes = words * torch.finfo(dtype).bits / 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k2(P) -> dict:
    """K2 against its plain version; returns the record of each shape."""
    K2 = P.fused_svgp
    dev = torch.device("cuda")
    shapes = [
        ("jax-test", torch.float32, 1, 128, 128, 3),
        ("jax-test", torch.float32, 1, 100, 150, 3),
        ("b128-screen", torch.float32, 8, 128, 200, 2),
        ("bc512-screen", torch.float32, 6, 512, 200, 2),
        ("bc512-recommend", torch.float32, 3, 512, 1000, 2),
        ("bc512-screen", torch.float64, 6, 512, 200, 2),
        # the stripe widths of the plan that the path's shapes do not take
        ("wide", torch.float32, 6, 512, 1000, 2),
        ("m1024", torch.float32, 3, 1024, 200, 2),
        ("m2048", torch.float32, 3, 2048, 200, 2),
        ("m1024", torch.float64, 3, 1024, 200, 2),
    ]
    records = {}
    with torch.no_grad():
        for label, dtype, b, m, n, d in shapes:
            sp = K2.plan(m, n, b, dtype)
            print(f"[k2] plan {label} {'f32' if dtype == torch.float32 else 'f64'} B={b} M={m} "
                  f"N={n}: stripe W={sp.width}, {sp.smem_bytes} B per solve block; grids "
                  f"{(-(-(m + 1) // sp.width), b)} ([L_S | m] solve) and "
                  f"{(-(-n // sp.width), b)} (predictive)", flush=True)
            args = P.k2_problem(b, m, n, d, m + n, dtype, dev)
            mu, var = K2.fused_rbf_svgp_forward(*args)
            mu_p, var_p = K2.fused_rbf_svgp_forward_plain(*args)
            torch.cuda.synchronize()
            err = max((mu - mu_p).abs().max().item(), (var - var_p).abs().max().item())
            tol = 2e-3 if dtype == torch.float32 else 1e-10
            close = all(
                bool(torch.allclose(a, w, rtol=tol, atol=tol)) for a, w in ((mu, mu_p), (var, var_p))
            )
            ms = P.loop_ms(lambda: K2.fused_rbf_svgp_forward(*args), 20)
            plain_ms = P.loop_ms(lambda: K2.fused_rbf_svgp_forward_plain(*args), 20)
            bound_ms, bound_by = k2_bound_ms(b, m, n, d, dtype)
            tag = "f32" if dtype == torch.float32 else "f64"
            print(
                f"[k2] {label} {tag} B={b} M={m} N={n} d={d}: max_abs_err={err:.3e} (tol {tol:g}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
                "library_ms=none (no single PyTorch call computes K2's function)",
                flush=True,
            )
            check(bool(torch.isfinite(mu).all() and torch.isfinite(var).all()),
                  f"K2 {label} {tag}: non-finite output")
            check(bool((var > 0).all()), f"K2 {label} {tag}: non-positive variance")
            check(close, f"K2 {label} {tag} B={b} M={m} N={n}: differs from plain by {err:.3e}")
            records[(label, tag, b, m, n)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            )
        for label, b, m, n in (("bc512-screen", 6, 512, 200), ("bc512-recommend", 3, 512, 1000),
                               ("b128-screen", 8, 128, 200)):
            k2_breakdown(P, label, P.k2_problem(b, m, n, 2, m + n, torch.float32, dev))
    return records


def k2_breakdown(P, label, args, calls: int = 10) -> None:
    """Device time of each of K2's three launches (torch.profiler; the
    span runs from the first launch's start to the last one's end: the
    predictive overlaps the [L_S | m] solve), and of the solves' yardstick,
    one torch.linalg.solve_triangular(L, [K_zx | L_S | m])."""
    K2 = P.fused_svgp
    split = P.k2_split(lambda: K2.fused_rbf_svgp_forward(*args), calls)
    trsm = P.yardstick_us(args, calls)
    print(f"[k2] breakdown {label} f32: Gram + factor {split['factor_us']:.1f} us, [L_S | m] "
          f"solve {split['ls_us']:.1f} us, predictive {split['predict_us']:.1f} us per call; "
          f"span {split['span_us']:.1f} us; yardstick solve_triangular(L, [K_zx | L_S | m]) "
          f"{trsm:.1f} us", flush=True)


def phase_reference(P) -> None:
    """f64 on the card (K1 f64 + the CUDA path) against the CPU path, and
    the K2 route of the acquisition predictive against the plain route."""
    trainer, M = P.trainer, P.M
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
        P.counters.reset()
        params, logs = trainer.train_phase_stacked(
            model, torch.as_tensor(x, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(fid, device=dev), 5, 0.003, "all_free", 48, eps=eps.to(dev),
        )
        mus, var = M.predict_for_acquisition_all(
            params, model.consts, model.config, torch.as_tensor(x[:9] + 0.01, device=dev))
        out.append((logs.loss.cpu(), mus.cpu(), var.cpu(), P.counters.get("k1.launches")))
    (l_c, m_c, v_c, _), (l_g, m_g, v_g, launched) = out
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in ((l_g, l_c), (m_g, m_c), (v_g, v_c)))
    print(f"[reference] f64 card vs CPU: max rel diff {rel:.3e}, K1 launches {launched}",
          flush=True)
    check(rel < 1e-8, f"f64 card path differs from the CPU path by {rel:.3e}")
    check(launched >= 2 * 5, "f64 card path did not launch K1")

    # the same trained f64 model on the card: layer 0 through K2 (no grad)
    # against predict_diag_state (grad enabled, the plain route)
    xq = torch.as_tensor(x[:9] + 0.01, device="cuda")
    P.counters.reset()
    with torch.no_grad():
        via_k2 = M.predict_for_acquisition_all(params, model.consts, model.config, xq)
    k2_calls = P.counters.get("k2.launches")
    plain = M.predict_for_acquisition_all(params, model.consts, model.config, xq)
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(via_k2, plain))
    print(f"[reference] f64 acquisition predictive, K2 route vs plain route: max rel diff "
          f"{rel:.3e}, K2 launches {k2_calls}", flush=True)
    check(k2_calls == 1, f"the no-grad predictive launched K2 {k2_calls} times, not once")
    check(rel < 1e-9, f"the K2 route differs from the plain route by {rel:.3e}")
    search_reference(P)
    captured_reference(P)


SEARCH_NAMES = [("o1", False), ("o2", False), ("c1", True)]


def search_reference(P) -> None:
    """The f64 search and the f64 device polish on the card against the
    CPU port (which the CPU tests hold to the JAX package's optax L-BFGS):
    the all-fidelity search of a small trained and conditioned state (14
    points, 3 blackboxes, 5 + 5 epochs) from 40 fixed raw points, and one
    polish of RFF prior samples; points within 1e-8, values 1e-10. Each
    captured run on the card is also held to the same run with its pieces
    eager on the card (captured_vs_eager)."""
    tree_map = P.tree_map
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(14, 2))
    fid = np.arange(14) % 2
    ys = [np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0],
          0.3 - np.sum((x - 0.5) ** 2, 1)]
    f = P.BlackBoxMFDGPFitter(2, 14, num_epochs_1=5, num_epochs_2=5, opt_grid_size=20,
                              pareto_set_size=4, seed=1, device="cpu", dtype=torch.float64)
    for (name, is_con), y in zip(SEARCH_NAMES, ys):
        f.initialize_mfdgp(x, y, fid, name, is_constraint=is_con)
    f.train_mfdgps()
    cond = f.copy_uncond()
    cond.sample_and_store_pareto_solution()
    cond.train_conditioned_mfdgps()
    su = P.trainer.stack_models([f.get_model(n, c) for n, c in SEARCH_NAMES])
    sc = P.trainer.stack_models([cond.get_model(n, c) for n, c in SEARCH_NAMES])
    raw = torch.rand((40, 2), generator=torch.Generator().manual_seed(11), dtype=torch.float64)
    out = {}
    for arm, dev in (("cpu", "cpu"), ("card", "cuda"), ("eager", "cuda")):
        pair = [tree_map(lambda t: t.to(dev), t) for t in (su.params, su.consts, sc.params,
                                                            sc.consts)]
        with eager_arm(P) if arm == "eager" else contextlib.nullcontext():
            xs, vals = P.jesmoc.optimize_coupled_jes_all_fidelities(
                *pair, su.config, None, 2, raw_samples=40, maxiter=200, raw=raw.to(dev))
        out[arm] = (xs.cpu(), vals.cpu(), dict(P.lbfgs.last_stats))
    (x_c, v_c, st_c), (x_g, v_g, st_g), (x_e, v_e, st_e) = out["cpu"], out["card"], out["eager"]
    dx = (x_g - x_c).abs().max().item()
    dv = ((v_g - v_c).abs() / v_c.abs().clamp_min(1e-300)).max().item()
    print(f"[reference] f64 search card vs CPU: points {x_g.tolist()}, max |dx| {dx:.3e}, "
          f"values max rel diff {dv:.3e}; iterations per lane card {st_g['lane_iterations']}, "
          f"CPU {st_c['lane_iterations']}; evaluations {st_g['evaluations']} / "
          f"{st_c['evaluations']}", flush=True)
    check(dx <= 1e-8 and dv <= 1e-10,
          f"the f64 search on the card is off the CPU's: |dx| {dx:.3e}, values {dv:.3e}")
    captured_vs_eager("f64 search", (x_g, st_g), (x_e, st_e))

    samples = [P.rff.sample_prior(torch.Generator().manual_seed(i), 2, 2, n_features=50,
                                  device="cpu") for i in range(3)]
    grid = np.random.default_rng(5).uniform(size=(80, 2))
    ends = {}
    for arm, dev in (("cpu", "cpu"), ("card", "cuda"), ("eager", "cuda")):
        fns = [P.SampledFunction(P.rff.eval_sample_fn, tree_map(lambda t: t.to(dev), smp))
               for smp in samples]
        m = P.MOOP(fns[:2], fns[2:], input_dim=2, feasible_values=np.array([-0.5]),
                   polish="device")
        with torch.no_grad():
            cons = torch.stack([fn(torch.as_tensor(grid, device=dev)) for fn in fns[2:]])
            evals = fns[0](torch.as_tensor(grid, device=dev)).cpu().numpy()
        feas = m._feasible_mask(cons.cpu().numpy(), True)
        with eager_arm(P) if arm == "eager" else contextlib.nullcontext():
            got = m.optimize_obj_globally_device(
                0, evals, feas, grid, torch.zeros((), dtype=torch.float64, device=dev))
        value = None if got is None else fns[0](torch.as_tensor(got, device=dev)).item()
        ends[arm] = (got, value, dict(P.lbfgs.last_stats))
    (p_c, f_c, st_c), (p_g, f_g, st_g), (p_e, _, st_e) = ends["cpu"], ends["card"], ends["eager"]
    check(p_c is not None and p_g is not None and p_e is not None,
          f"the f64 device polish accepted no point (CPU {p_c}, card {p_g}, eager {p_e})")
    dx, dv = float(np.abs(p_g - p_c).max()), abs(f_g - f_c) / max(abs(f_c), 1e-300)
    print(f"[reference] f64 device polish card vs CPU: point {p_g.tolist()}, max |dx| {dx:.3e}, "
          f"value rel diff {dv:.3e}; evaluations {st_g['evaluations']} / {st_c['evaluations']}, "
          f"failed line searches {st_g['failed_searches']} / {st_c['failed_searches']}",
          flush=True)
    check(dx <= 1e-8 and dv <= 1e-10,
          f"the f64 device polish on the card is off the CPU's: |dx| {dx:.3e}, value {dv:.3e}")
    captured_vs_eager("f64 device polish", (torch.as_tensor(p_g), st_g),
                      (torch.as_tensor(p_e), st_e))


def captured_vs_eager(label, captured, eager) -> None:
    """An f64 L-BFGS run on the card replayed from CUDA graphs against the
    same run with its pieces eager: points within 1e-12, the same
    iterations per lane and evaluations, and the captured run replayed."""
    (x_g, st_g), (x_e, st_e) = captured, eager
    dx = (x_g - x_e).abs().max().item()
    print(f"[reference] {label} on the card, captured vs eager: max |dx| {dx:.3e} (bitwise "
          f"equal: {torch.equal(x_g, x_e)}); iterations per lane {st_g['lane_iterations']} / "
          f"{st_e['lane_iterations']}; evaluations {st_g['evaluations']} / {st_e['evaluations']}; "
          f"captured {st_g['captured']}: capture {st_g['capture_seconds']:.3f} s, "
          f"{st_g['replays']} replays", flush=True)
    check(st_g["captured"] and st_g["replays"] > 0 and not st_e["captured"],
          f"{label}: captured {st_g['captured']} with {st_g['replays']} replays, eager arm "
          f"captured {st_e['captured']}")
    check(dx <= 1e-12, f"{label}: the captured run is {dx:.3e} off the eager one")
    check(st_g["lane_iterations"] == st_e["lane_iterations"]
          and st_g["evaluations"] == st_e["evaluations"],
          f"{label}: captured and eager runs took other steps ({st_g}, {st_e})")


def rel_diff(got, want) -> float:
    """The largest |difference| of each pair, relative to the CPU tensor's
    largest entry, maximized over the pairs."""
    return max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()
               for a, b in zip(got, want))


def reference_case(P, label, run, one_step, steps, replays) -> None:
    """One captured-path case: `run(dev)` -> (tensors, stats) on the CPU
    (eager) and on the card (from a CUDA graph), stats["k1"] the K1
    launches of the phase alone; `one_step()` is one eager step on the
    card. Holds the card to the CPU at rel < 1e-8 and K1's launches to one
    eager step's x the steps (f64: no ladder escalation)."""
    chol = P.chol
    P.counters.reset()
    per_step = one_step()[1]["k1"]
    want, _ = run("cpu")
    P.counters.reset()
    esc0 = chol.escalations()
    got, stats = run("cuda")
    launched, escalated = stats["k1"], chol.escalations() - esc0
    rel = rel_diff(got, want)
    print(f"[reference] captured {label}: {steps} steps in {stats.get('chunks', 1)} chunk(s), "
          f"{stats['replays']} replays, capture {stats['capture_seconds']:.3f} s; card vs CPU "
          f"max rel diff {rel:.3e}; K1 launches {launched} = {per_step} per eager step x "
          f"{steps}; escalations {escalated}", flush=True)
    check(rel < 1e-8, f"captured {label}: the card differs from the CPU by {rel:.3e}")
    check(launched == per_step * steps and per_step > 0,
          f"captured {label}: K1 launched {launched} times, {per_step} per eager step")
    check(escalated == 0, f"captured {label}: {escalated} ladder escalations at f64")
    check(stats["replays"] == replays, f"captured {label}: {stats['replays']} replays")


def captured_reference(P) -> None:
    """The captured path at f64 against the CPU's eager path from the same
    draws: a full-batch phase, a minibatch phase and a conditioned phase,
    each cut into chunks of REFERENCE_CHUNK steps (5 steps: 2 + 2 + 1, so
    two chunk boundaries and a remainder), and an exact-GP adam_fit (one
    chunk, as the JAX package's one scan)."""
    trainer, C, M, f64 = P.trainer, P.conditioned, P.M, torch.float64
    rng = np.random.default_rng(2)
    n, steps = 48, 5
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    g = torch.Generator().manual_seed(3)
    t = lambda a, dev, **kw: torch.as_tensor(a, device=dev, **kw)  # noqa: E731

    xq = x[:9] + 0.01

    def launched():
        torch.cuda.synchronize()
        return P.counters.get("k1.launches")

    def predictive(params, model, dev):
        """The trained models' acquisition predictive (plain route), the
        quantities the f64 check above compares: Adam moves some entries
        from ~0, where it scales the devices' ~1e-13 gradient differences
        by lr / eps, so raw parameters are not compared."""
        return list(M.predict_for_acquisition_all(params, model.consts, model.config,
                                                  t(xq, dev)))

    def model_on(dev):
        return trainer.stack_models([
            M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i), device=dev,
                         dtype=f64) for i, y in enumerate(ys)])

    with P.patched(trainer, "chunk_size_for", lambda m: REFERENCE_CHUNK):
        for label, bsz in (("full-batch phase", n), ("minibatch phase", 16)):
            nb = -(-n // bsz)
            eps = torch.randn((steps, 2, 1, bsz * nb), generator=g, dtype=f64)
            perms = torch.argsort(torch.rand((steps, 2, n), generator=g), -1) if nb > 1 else None

            def run(dev, count=steps):
                stats = {}
                args = (model_on(dev), t(x, dev), t(ys, dev), t(fid, dev), count, 0.003,
                        "all_free", bsz)
                draws = dict(eps=eps[:count].to(dev),
                             perms=None if perms is None else perms[:count].to(dev))
                params, logs = trainer.train_phase_stacked_chunked(*args, **draws, stats=stats)
                stats["k1"] = launched()
                return [logs.loss, logs.kl] + predictive(params, args[0], dev), stats

            reference_case(P, label, run, lambda: run("cuda", 1), steps,
                           steps - P.graphs.WARMUP)

        pset, pfront = rng.uniform(size=(4, 2)), rng.normal(size=(4, 1))

        def run_cond(dev, count=steps):
            m = model_on(dev)
            obj, con = (P.trainer.select_model(m, i) for i in (0, 1))
            data = C.ConditionedData(
                x=t(x, dev), ys_obj=t(ys[:1], dev), ys_con=t(ys[1:], dev), fidelities=t(fid, dev),
                pareto_set=t(pset, dev), pareto_front=t(pfront, dev),
                front_mask=t([True, True, True, False], dev), thresholds=t([0.1], dev, dtype=f64))
            chunk = C.draw_chunk(torch.Generator().manual_seed(4), data._replace(
                x=data.x.cpu(), pareto_set=data.pareto_set.cpu()), obj.config, 24, count)
            draws = [C.StepDraws(*(None if a is None else a[i].to(dev) for a in chunk))
                     for i in range(count)]
            stats = {}
            op, cp, losses = C.train_conditioned_chunked(
                obj.params, con.params, obj.consts, con.consts, obj.config, data, None, count,
                0.01, 1e-8, 24, draws=draws, stats=stats)
            stats["k1"] = launched()
            return [losses] + predictive(op, obj, dev) + predictive(cp, con, dev), stats

        reference_case(P, "conditioned phase (minibatch of 24)", run_cond,
                       lambda: run_cond("cuda", 1), steps, steps - P.graphs.WARMUP)

    E = P.exact_gp
    fit_steps = 20

    def run_fit(dev, count=fit_steps):
        with StepsLog(P) as log:
            model = E.fit_exact_gp(E.init_exact_gp(x, ys[0], device=dev, dtype=f64),
                                   num_iters=count)
        # the log keeps the card's runners only: the CPU run has no record
        stats = dict(log.records[-1] if log.records else {}, k1=launched())
        return P.tree_leaves(model.params) + list(E.predict(model, t(xq, dev))), stats

    reference_case(P, "adam_fit (exact GP NLML, one chunk)", run_fit,
                   lambda: run_fit("cuda", 1), fit_steps, fit_steps - P.graphs.WARMUP)


class StepsLog:
    """Every graphs.Steps runner of a phase on the card closed inside the
    block: its steps, graph replays, capture seconds, and the seconds its
    run() calls took (each call synchronized on both ends). The L-BFGS
    pieces (acquisition/lbfgs.py, also Steps runners) are left to
    SearchLog, untimed here."""

    def __init__(self, P):
        self.P, self.records, self.saved = P, [], []

    def __enter__(self):
        steps_cls = self.P.graphs.Steps
        run, close, records = steps_cls.run, steps_cls.close, self.records

        def piece(steps) -> bool:
            return isinstance(getattr(steps.step, "__self__", None), self.P.lbfgs._Lanes)

        def timed_run(steps, n):
            if piece(steps):
                return run(steps, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(steps, n)
            torch.cuda.synchronize()
            steps.run_seconds = getattr(steps, "run_seconds", 0.0) + time.perf_counter() - t0

        def recorded_close(steps):
            if steps.device.type == "cuda" and not piece(steps):
                records.append(dict(steps=steps.steps, replays=steps.replays,
                                    capture_seconds=steps.capture_seconds,
                                    seconds=getattr(steps, "run_seconds", 0.0)))
            close(steps)

        self.saved = [("run", run), ("close", close)]
        steps_cls.run, steps_cls.close = timed_run, recorded_close
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(self.P.graphs.Steps, name, fn)
        return False


class SearchLog:
    """Every L-BFGS run inside the block (acquisition/lbfgs.py::lbfgs_lanes,
    called by the candidate searches of acquisition/optimize.py and by the
    MOOP's device polish): its kind, seconds (synchronized on both ends)
    and lbfgs.last_stats. Imports the port itself, so that a rank process
    of the mesh phase can keep one too."""

    def __enter__(self):
        from mobocmf_tpu_torch.acquisition import lbfgs, optimize
        from mobocmf_tpu_torch.moop import moop
        from mobocmf_tpu_torch.profiling import patched

        self.runs, inner = [], lbfgs.lbfgs_lanes

        def recorded(kind):
            def run(fun, z0, maxiter, *args, **kwargs):
                sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
                sync()
                t0 = time.perf_counter()
                out = inner(fun, z0, maxiter, *args, **kwargs)
                sync()
                self.runs.append((kind, time.perf_counter() - t0, dict(lbfgs.last_stats)))
                return out
            return run

        self.stack = contextlib.ExitStack()
        self.stack.enter_context(patched(optimize, "lbfgs_lanes", recorded("search")))
        self.stack.enter_context(patched(moop, "lbfgs_lanes", recorded("polish")))
        return self

    def __exit__(self, *exc):
        self.stack.close()
        return False


# the capture reason of the eager arm of a captured-against-eager check
EAGER_ARM = "the eager arm of a captured-against-eager check"


def uncaptured_by_rule(st) -> bool:
    """An L-BFGS run that ran eagerly by rule: over gloo's collectives, on
    the CPU, or as the eager arm of a check."""
    reason = st["capture_reason"]
    return "gloo" in reason or "CPU" in reason or reason == EAGER_ARM


def eager_arm(P):
    """capture_rule answering 'eager' inside the block (the L-BFGS pieces
    run eagerly on the card)."""
    return P.patched(P.sharding, "capture_rule", lambda collectives: (False, EAGER_ARM))


def search_summary(label, runs) -> dict:
    """One `[search]` line per kind of L-BFGS run of a path (SearchLog):
    runs, seconds, ms per evaluation, iterations, evaluations per
    iteration, line-search steps per lane and iteration, how the lanes
    ended, and how many runs were replayed from CUDA graphs (capture
    seconds, replays). Fails unless every lane ended at gtol or at maxiter,
    and unless every run was captured with replays or ran eagerly by rule
    (uncaptured_by_rule)."""
    out = {}
    for kind in sorted({k for k, _, _ in runs}):
        rs = [(sec, st) for k, sec, st in runs if k == kind]
        its = [st["iterations"] for _, st in rs]
        evals = sum(st["evaluations"] for _, st in rs)
        lane_its = sum(sum(st["lane_iterations"]) for _, st in rs)
        ls_mean = sum(st["ls_steps_mean"] * sum(st["lane_iterations"]) for _, st in rs)
        lanes = sum(st["lanes"] for _, st in rs)
        row = dict(runs=len(rs), seconds=sum(sec for sec, _ in rs),
                   iterations=sum(its), evaluations=evals,
                   evals_per_iteration=evals / max(sum(its), 1),
                   ls_steps_max=max(st["ls_steps_max"] for _, st in rs),
                   ls_steps_mean=ls_mean / max(lane_its, 1), lanes=lanes,
                   at_gtol=sum(st["at_gtol"] for _, st in rs),
                   at_maxiter=sum(st["at_maxiter"] for _, st in rs),
                   failed=sum(st["failed_searches"] for _, st in rs),
                   nonfinite=sum(st["nonfinite"] for _, st in rs),
                   captured=sum(bool(st["captured"]) for _, st in rs),
                   capture_seconds=sum(st["capture_seconds"] for _, st in rs),
                   replays=sum(st["replays"] for _, st in rs),
                   reasons=sorted({st["capture_reason"] for _, st in rs}))
        row["ms_per_evaluation"] = 1e3 * row["seconds"] / max(evals, 1)
        print(f"[search] {label} {kind}: {row['runs']} run(s) in {row['seconds']:.3f} s "
              f"({min(sec for sec, _ in rs):.3f}-{max(sec for sec, _ in rs):.3f} s each), "
              f"{row['ms_per_evaluation']:.3f} ms per evaluation; captured {row['captured']} of "
              f"{row['runs']} ({'; '.join(row['reasons'])}), capture {row['capture_seconds']:.3f} "
              f"s, {row['replays']} replays; "
              f"iterations {min(its)}-{max(its)}; {evals} evaluations, "
              f"{row['evals_per_iteration']:.3f} per iteration; line-search steps per lane and "
              f"iteration max {row['ls_steps_max']}, mean {row['ls_steps_mean']:.3f}; of {lanes} "
              f"lanes {row['at_gtol']} ended at gtol, {row['at_maxiter']} at maxiter, "
              f"{row['failed']} had a failed line search, {row['nonfinite']} ended on a "
              f"non-finite point", flush=True)
        check(all(st["at_gtol"] + st["at_maxiter"] == st["lanes"] for _, st in rs),
              f"{label} {kind}: L-BFGS lanes {[st for _, st in rs]}")
        check(all(st["replays"] > 0 if st["captured"] else uncaptured_by_rule(st)
                  for _, st in rs),
              f"{label} {kind}: a run on the card was not replayed from CUDA graphs: "
              f"{[(st['captured'], st['replays'], st['capture_reason']) for _, st in rs]}")
        out[kind] = row
    return out


def steps_summary(label, records) -> dict:
    """Steps per second of a path's captured phases (each phase's steps over
    its run time less its capture), with the capture seconds and replays."""
    for i, r in enumerate(records):
        rate = r["steps"] / max(r["seconds"] - r["capture_seconds"], 1e-9)
        print(f"[steps] {label} phase {i}: {r['steps']} steps in {r['seconds']:.3f} s "
              f"(capture {r['capture_seconds']:.3f} s, {r['replays']} replays): "
              f"{rate:.2f} steps/s without the capture", flush=True)
    total = dict(steps=sum(r["steps"] for r in records),
                 seconds=sum(r["seconds"] for r in records),
                 capture_seconds=sum(r["capture_seconds"] for r in records),
                 replays=sum(r["replays"] for r in records), phases=len(records))
    total["steps_per_s"] = total["steps"] / max(total["seconds"] - total["capture_seconds"], 1e-9)
    print(f"[steps] {label}: {total['phases']} captured phases, {total['steps']} steps, "
          f"{total['replays']} replays, capture {total['capture_seconds']:.3f} s, "
          f"{total['steps_per_s']:.2f} steps/s without the capture", flush=True)
    return total


def staged(P, fn):
    """Run one stage with every kernel counter set to 0 just before it and
    read just after: (result, seconds, K1 launches, K1 escalations, K2 calls)."""
    P.counters.reset()
    esc0 = P.chol.escalations()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, seconds, P.counters.get("k1.launches"), P.chol.escalations() - esc0,
            P.counters.get("k2.launches"))


def layer0_f64(P, lp, st, config, x) -> tuple:
    """The f64 answer of one layer-0 system: the f32 parameters in f64,
    factored at the jitter the f32 factor ended on (plain version)."""
    ls, os_ = P.rbf.scale_rbf_constrained(lp.kernel)
    jitter = P.ladder_jitter(config.jitter, st.level, os_)
    args = (st.z, x, lp.variational.mean, torch.tril(lp.variational.chol_raw), ls, os_, jitter)
    return P.fused_svgp.fused_rbf_svgp_forward_plain(*(t.detach().double() for t in args))


def rel_err(pairs) -> float:
    """max over (got, want) pairs of max|got - want| / max|want|."""
    return max(((got.detach().double() - want.detach().double()).abs().max()
                / want.detach().double().abs().max()).item() for got, want in pairs)


def layer0_routes(P, model, x) -> tuple:
    """Layer 0 of trained f32 states at x through K2 (no gradient), through
    the plain route (gradients on: K1's factor, cuBLAS solves) and in f64
    (layer0_f64): three (mu, var) pairs."""
    M = P.M
    with torch.no_grad():
        k2 = M.forward(model.params, model.consts, model.config, x, None, max_fidelity=0)[0]
    plain = M.forward(model.params, model.consts, model.config, x, None, max_fidelity=0)[0]
    st = M.compute_layer_states(model.params, model.consts, model.config)[0]
    return k2, plain, layer0_f64(P, model.params.layers[0], st, model.config, x)


def layer0_errors(P, model, x) -> tuple:
    """K2's and the plain route's layer 0 against f64 (layer0_routes), each
    as the max over mu and var of max|err| / max|f64 answer|."""
    k2, plain, exact = layer0_routes(P, model, x)
    return rel_err(zip(k2, exact)), rel_err(zip(plain, exact))


def first_step_rungs(P, label, fitter, blackboxes) -> None:
    """K1's ladder rung for each layer's Kzz at the first training step (the
    initial parameters) against cholesky_plain's on the same matrices."""
    model = P.trainer.stack_models([fitter.get_model(n, c) for n, _, c in blackboxes])
    seen = []
    kernel = P.ops.k1_cholesky

    def spy(k, jitter=None, ladder=False):
        l, level = kernel(k, jitter, ladder)
        seen.append((k, jitter, ladder, level))
        return l, level

    P.ops.k1_cholesky = spy
    try:
        with torch.no_grad():
            P.M.compute_layer_states(model.params, model.consts, model.config)
    finally:
        P.ops.k1_cholesky = kernel
    check(len(seen) == model.config.num_fidelities, f"{label}: {len(seen)} Kzz factorizations")
    for ell, (k, jitter, ladder, level) in enumerate(seen):
        jit = torch.as_tensor(jitter, dtype=k.dtype, device=k.device).expand(k.shape[0]).contiguous()
        _, want = P.chol.cholesky_plain(k, jit, ladder)
        print(f"[{label}] first training step, layer {ell} Kzz ({tuple(k.shape)}): K1 rungs "
              f"{level.tolist()}, plain rungs {want.tolist()}", flush=True)
        check(torch.equal(level, want), f"{label}: layer {ell} K1 rungs {level.tolist()} differ "
              f"from the plain version's {want.tolist()}")


def slice_problem(blackboxes, n_init):
    """A slice's data: n_init points in [0, 1]^2, the last quarter at the top
    fidelity, and each blackbox's outputs standardized, with its threshold,
    as run_bo_loop does (bo/loop.py:158-162, 275-277, 326-327): (x, fid,
    ys, (mean, std) per blackbox, thresholds)."""
    rng = np.random.default_rng(SEED)
    x = rng.uniform(size=(n_init, 2))
    n_high = n_init // 4
    fid = np.concatenate([np.zeros(n_init - n_high), np.ones(n_high)]).astype(int)
    raw = [np.where(fid == 0, lo(x), hi(x)) for _, (lo, hi), _ in blackboxes]
    stats = [(float(y.mean()), float(y.std())) for y in raw]
    ys = [(y - mu) / sd for y, (mu, sd) in zip(raw, stats)]
    thresholds = [(0.0 - mu) / sd for mu, sd in stats]
    return x, fid, ys, stats, thresholds


def slice_fitter(P, blackboxes, problem, epochs):
    """The slice's fitter (f32 on the card), every blackbox initialized."""
    x, fid, ys, _, thresholds = problem
    fitter = P.BlackBoxMFDGPFitter(
        num_fidelities=2, batch_size=x.shape[0], lr_1=0.003, lr_2=0.001,
        num_epochs_1=epochs, num_epochs_2=epochs, seed=SEED, pad_data=True,
    )
    for (name, _, is_con), y, thr in zip(blackboxes, ys, thresholds):
        fitter.initialize_mfdgp(x, y, fid, name, threshold_constraint=thr if is_con else 0.0,
                                is_constraint=is_con)
    return fitter


def run_slice(P, label, blackboxes, n_init, epochs, cond_iters, eager_check=False) -> dict:
    """One BO iteration's model side at full width: training, then JESMOC
    (Pareto sampling + conditioned training), the all-fidelity candidate
    search and the recommendation pass, each stage counted on its own;
    with eager_check, the search captured against eager on the path's
    state (search_f32_captured_vs_eager)."""
    trainer, M = P.trainer, P.M
    problem = slice_problem(blackboxes, n_init)
    _, _, _, stats, thresholds = problem
    fitter, t_init, _, _, _ = staged(P, lambda: slice_fitter(P, blackboxes, problem, epochs))
    first_step_rungs(P, label, fitter, blackboxes)
    _, t_train, k1_train, esc_train, k2_train = staged(P, fitter.train_mfdgps)
    m = fitter.x_train.shape[0]
    steps = 0
    for st in fitter.phase_stats:
        steps += st["epochs"]
        print(
            f"[{label}] phase {st['phase']}: {st['epochs']} steps in {st['seconds']:.3f} s = "
            f"{st['epochs'] / st['seconds']:.2f} steps/s (capture {st['capture_seconds']:.3f} s, "
            f"{st['replays']} replays); neg-ELBO first {st['first']:.6g} "
            f"last {st['last']:.6g}; K1 launches {st['chol_launches']}; "
            f"ladder escalations {st['escalations']} "
            f"({st['escalations'] / max(st['chol_launches'], 1):.3f} per launch)",
            flush=True,
        )
        check(np.isfinite(st["last"]), f"{label}: non-finite loss")
    print(f"[{label}] m={m} blackboxes={len(blackboxes)} init {t_init:.3f} s; training "
          f"{t_train:.3f} s, K1 launches {k1_train} for {steps} steps, ladder escalations "
          f"{esc_train} ({esc_train / max(k1_train, 1):.3f} per launch), K2 launches {k2_train}",
          flush=True)
    leaves = P.tree_leaves(trainer.stack_models([fitter.get_model(n, c) for n, _, c in blackboxes]).params)
    check(all(bool(torch.isfinite(t).all()) for t in leaves), f"{label}: non-finite params")
    check(k1_train >= 2 * steps, f"{label}: K1 launched {k1_train} times for {steps} steps")

    # Pareto sampling + conditioned training, inside the JESMOC constructor
    fitter.num_epochs_2 = cond_iters  # the conditioned phase runs num_epochs_2 iterations
    jes, t_jes, k1_jes, _, k2_jes = staged(P, lambda: P.JESMOC_MFDGP(
        fitter, num_fidelities=2, seed=SEED, acq_maxiter=200, acq_raw_samples=200))
    cond = fitter.phase_stats[-1]
    check(cond["label"] == "COND" and cond["epochs"] == cond_iters, f"{label}: no conditioned phase")
    t_pareto = t_jes - cond["seconds"]
    sol = fitter.pareto_solution
    print(f"[{label}] Pareto sampling: {t_pareto:.3f} s ({fitter.pareto_tries} MOOP attempt(s), "
          f"{sol.num_valid} valid Pareto points of {sol.pareto_set.shape[0]})", flush=True)
    print(f"[{label}] conditioned training: {cond_iters} steps in {cond['seconds']:.3f} s = "
          f"{cond_iters / cond['seconds']:.2f} steps/s (capture {cond['capture_seconds']:.3f} s, "
          f"{cond['replays']} replays); loss first {cond['first']:.6g} last "
          f"{cond['last']:.6g}; K1 launches {cond['chol_launches']}; ladder escalations "
          f"{cond['escalations']} ({cond['escalations'] / max(cond['chol_launches'], 1):.3f} per "
          "launch)", flush=True)
    check(sol.num_valid >= 1, f"{label}: empty Pareto set")
    check(np.isfinite(cond["last"]), f"{label}: non-finite conditioned loss")
    check(cond["chol_launches"] >= 2 * cond_iters,
          f"{label}: K1 launched {cond['chol_launches']} times on {cond_iters} conditioned steps")
    check(k2_jes == 0, f"{label}: K2 launched during training stages")

    for f in range(2):
        for name, _, is_con in blackboxes:
            jes.add_blackbox(f, name, cost_evaluation=(1.0, 10.0)[f], is_constraint=is_con)
    (x_next, fid_next), t_acq, k1_acq, _, k2_acq = staged(P, jes.get_nextpoint_coupled)
    vals, lb = jes.last_values, P.lbfgs.last_stats
    print(f"[{label}] acquisition search (all fidelities, 200 raw samples, 5 restarts each): "
          f"{t_acq:.3f} s; x={x_next.tolist()} fidelity={fid_next}; values {vals.tolist()}; "
          f"K1 launches {k1_acq}; K2 launches {k2_acq}", flush=True)
    print(f"[{label}] L-BFGS: {lb['iterations']} iterations, {lb['evaluations']} evaluations "
          f"({lb['evaluations'] / max(lb['iterations'], 1):.3f} per iteration); line-search "
          f"steps per lane and iteration max {lb['ls_steps_max']}, mean "
          f"{lb['ls_steps_mean']:.3f}; of {lb['lanes']} lanes {lb['at_gtol']} ended at gtol, "
          f"{lb['at_maxiter']} at maxiter, {lb['failed_searches']} had a failed line search, "
          f"{lb['nonfinite']} ended on a non-finite point; captured {lb['captured']}, capture "
          f"{lb['capture_seconds']:.3f} s, {lb['replays']} replays", flush=True)
    check(tuple(x_next.shape) == (2,) and bool(((x_next >= 0) & (x_next <= 1)).all()),
          f"{label}: candidate {x_next.tolist()} outside [0, 1]^2")
    check(fid_next in (0, 1), f"{label}: fidelity {fid_next}")
    check(bool(torch.isfinite(vals).all()) and bool((vals >= 0).all()),
          f"{label}: acquisition values {vals.tolist()}")
    check(k2_acq >= 1, f"{label}: the screening did not launch K2")
    check(lb["at_gtol"] + lb["at_maxiter"] == lb["lanes"] == 10,
          f"{label}: L-BFGS lanes {lb}")
    check(lb["captured"] and lb["replays"] > 0, f"{label}: the search was not captured: {lb}")
    check(lb["iterations"] == 200 or lb["at_gtol"] == lb["lanes"],
          f"{label}: the search ran {lb['iterations']} iterations, not its 200")

    # the f32 surface is not the model's: score each fidelity's candidate on
    # the f64 copy of the uncond and cond models (plain route)
    unc = jes.blackbox_mfdgp_fitter_uncond  # the constructor conditioned `fitter` in place
    su = trainer.stack_models([unc.get_model(n, c) for n, _, c in blackboxes])
    sc = trainer.stack_models([fitter.get_model(n, c) for n, _, c in blackboxes])
    f64 = functools.partial(P.tree_map, lambda t: t.double() if t.is_floating_point() else t)
    pair64 = (f64(su.params), f64(su.consts), f64(sc.params), f64(sc.consts), su.config)
    at64 = torch.stack([P.coupled_acq_stacked(*pair64, f, jes.last_points[f:f + 1].double())[0]
                        for f in range(2)]).detach()
    print(f"[{label}] the candidates on the f64 models: {at64.tolist()} (f32 search values "
          f"{vals.tolist()})", flush=True)
    check(bool(torch.isfinite(at64).all()) and bool((at64 >= 0).all()),
          f"{label}: f64 acquisition at the candidates {at64.tolist()}")
    arms = search_f32_captured_vs_eager(P, label, su, sc, pair64) if eager_check else None

    objs = [n for n, _, c in blackboxes if not c]
    cons = [n for n, _, c in blackboxes if c]
    obj = trainer.stack_models([unc.get_model(n) for n in objs])
    con = trainer.stack_models([unc.get_model(n, True) for n in cons])
    grid = torch.as_tensor(np.random.default_rng(SEED).uniform(size=(1000, 2)),
                           dtype=torch.float32, device="cuda")
    scale = torch.tensor([st for st, (_, _, c) in zip(stats, blackboxes) if not c], device="cuda")
    thr = torch.tensor([t for t, (_, _, c) in zip(thresholds, blackboxes) if c], device="cuda")
    (means, feasible, mask), t_rec, _, _, k2_rec = staged(P, lambda: P.recommendation_model_pass(
        obj.params, obj.consts, con.params, con.consts, obj.config, 1, grid, thr, scale, 0.999))
    print(f"[{label}] recommendation pass on {grid.shape[0]} points: {t_rec:.3f} s; "
          f"{int(feasible.sum())} feasible, {int(mask.sum())} on the front; K2 launches {k2_rec}",
          flush=True)
    check(tuple(means.shape) == (len(objs), 1000) and bool(torch.isfinite(means).all()),
          f"{label}: recommendation means")
    check(not bool((mask & ~feasible).any()), f"{label}: an infeasible point on the front")
    check(k2_rec >= 1, f"{label}: the recommendation pass did not launch K2")

    # K2 on the path's own trained f32 states: layer 0 of the screening's
    # uncond and cond states, through K2 and through the plain route, each
    # against the f64 answer of the same system
    pair = trainer.stack_models([su, sc])
    err_k2_l0, err_plain_l0 = layer0_errors(P, pair, grid)
    print(f"[{label}] layer 0 of the {2 * len(blackboxes)} screening states on the grid, max rel "
          f"err against f64 at the same jitter: K2 route {err_k2_l0:.3e}, plain route "
          f"{err_plain_l0:.3e}", flush=True)
    check(err_k2_l0 <= LAYER0_RATIO * err_plain_l0 + LAYER0_FLOOR,
          f"{label}: layer 0 through K2 is {err_k2_l0:.3e} off, the plain route {err_plain_l0:.3e}")
    # end to end: the recommendation means (top fidelity, layer 1 on the
    # plain route in every case) against the f64 copy of the models, in
    # standard deviations of each objective's outputs
    stacked = trainer.stack_models([obj, con])
    mu64, _ = M.predict_for_acquisition(f64(stacked.params), f64(stacked.consts), stacked.config,
                                        grid.double(), 1)
    mu_plain, _ = M.predict_for_acquisition(stacked.params, stacked.consts, stacked.config, grid, 1)
    sd = scale[:, 1:2].double()
    via_k2 = (means.double() - scale[:, 0:1].double()) / sd
    ref, plain = mu64[: len(objs)].detach(), mu_plain[: len(objs)].detach().double()
    err_k2 = (via_k2 - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    k2_vs_plain = (via_k2 - plain).abs().max().item()
    print(f"[{label}] recommendation means against the f64 models, max err in output standard "
          f"deviations: K2 route {err_k2:.3e}, plain route {err_plain:.3e}; K2 route against "
          f"plain route {k2_vs_plain:.3e}", flush=True)
    check(err_k2 <= END_TO_END_RATIO * err_plain,
          f"{label}: recommendation means through K2 {err_k2:.3e} off, plain route {err_plain:.3e}")
    return dict(
        m=m, steps=steps, k1_train=k1_train, k1_slice=k1_jes + k1_acq, k2_acq=k2_acq,
        k2_rec=k2_rec, t_pareto=t_pareto, t_cond=cond["seconds"], cond_iters=cond_iters,
        t_acq=t_acq, t_rec=t_rec, arms=arms,
        steps_per_s=[st["epochs"] / st["seconds"] for st in fitter.phase_stats],
    )


@contextlib.contextmanager
def replays_without_sync(P, count: list):
    """Every CUDA graph replay inside the block runs under
    torch.cuda.set_sync_debug_mode("error"), so that a synchronizing call
    in it raises; `count` gets one entry per replay."""
    inner = torch.cuda.CUDAGraph.replay

    def replay(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner(graph)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        count.append(1)

    with P.patched(torch.cuda.CUDAGraph, "replay", replay):
        yield


def search_f32_captured_vs_eager(P, label, su, sc, pair64) -> dict:
    """The all-fidelity search (200 iterations) of the path's f32 state from
    200 raw points fixed by a seed, eager and captured on the card, every
    replay of the captured arm under set_sync_debug_mode("error")
    (replays_without_sync). Each arm's candidates are scored on the f64
    models: the arms' values must agree within the f32 surface's error
    there (the larger |f32 value - f64 value| of the two arms), and their
    evaluations per iteration within 2 %. Prints whether the iterates are
    bitwise equal."""
    raw = torch.rand((200, 2), generator=torch.Generator().manual_seed(SEED + 1)).to("cuda")
    arms, replays = {}, []
    for arm in ("eager", "captured"):
        ctx = eager_arm(P) if arm == "eager" else replays_without_sync(P, replays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            xs, vals = P.jesmoc.optimize_coupled_jes_all_fidelities(
                su.params, su.consts, sc.params, sc.consts, su.config, None, 2, raw_samples=200,
                maxiter=200, raw=raw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st = dict(P.lbfgs.last_stats)
        at64 = torch.stack([P.coupled_acq_stacked(*pair64, f, xs[f:f + 1].double())[0]
                            for f in range(2)]).detach()
        arms[arm] = dict(xs=xs.cpu(), vals=vals.double().cpu(), seconds=seconds, stats=st,
                         surface_err=(vals.double() - at64).abs().max().item(),
                         evals_per_iteration=st["evaluations"] / max(st["iterations"], 1))
    e, c = arms["eager"], arms["captured"]
    tol = max(e["surface_err"], c["surface_err"])
    dv = (c["vals"] - e["vals"]).abs().max().item()
    ratio = c["evals_per_iteration"] / e["evals_per_iteration"]
    print(f"[{label}] f32 search captured vs eager (200 raw points, 200 iterations): seconds "
          f"{c['seconds']:.3f} / {e['seconds']:.3f}, ms per evaluation "
          f"{1e3 * c['seconds'] / c['stats']['evaluations']:.3f} / "
          f"{1e3 * e['seconds'] / e['stats']['evaluations']:.3f}; evaluations per iteration "
          f"{c['evals_per_iteration']:.3f} / {e['evals_per_iteration']:.3f}; values "
          f"{c['vals'].tolist()} / {e['vals'].tolist()}, max |diff| {dv:.3e} against the f32 "
          f"surface's error {tol:.3e}; iterates bitwise equal: {torch.equal(c['xs'], e['xs'])}; "
          f"capture {c['stats']['capture_seconds']:.3f} s, {c['stats']['replays']} replays, "
          f"{len(replays)} of them under set_sync_debug_mode('error')", flush=True)
    check(c["stats"]["captured"] and len(replays) == c["stats"]["replays"] > 0,
          f"{label}: the captured arm replayed {c['stats']['replays']} graphs, "
          f"{len(replays)} under the sync check")
    check(dv <= tol, f"{label}: captured and eager values differ by {dv:.3e} (surface {tol:.3e})")
    check(abs(ratio - 1.0) <= 0.02,
          f"{label}: evaluations per iteration captured / eager = {ratio:.4f}")
    return dict(captured_seconds=c["seconds"], eager_seconds=e["seconds"],
                captured_evals=c["stats"]["evaluations"], eager_evals=e["stats"]["evaluations"])


# the variants phase at the b128 width: 200 + 200 training epochs and 200
# conditioned steps per setting (chunks of 5000: one capture each)
VARIANT_STEPS = 200


@contextlib.contextmanager
def flat_adam_env(on: bool):
    """MOBOCMF_FLAT_ADAM set to `on` inside the block (the phases read it
    when they build their optimizer), restored after."""
    before = os.environ.get("MOBOCMF_FLAT_ADAM")
    os.environ["MOBOCMF_FLAT_ADAM"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("MOBOCMF_FLAT_ADAM")
        else:
            os.environ["MOBOCMF_FLAT_ADAM"] = before


def variants_f64(P) -> None:
    """The JAX package's three switches at f64 on the card, each
    non-default path against the default through captured phases (chunks of
    REFERENCE_CHUNK steps, captured_reference's problem): flat Adam against
    per-leaf Adam in a training phase (rel 1e-9), the three-forward
    conditioned phase against the fused one and flat Adam in the
    conditioned phase (rel 1e-9), each on the same draws; the solve-route
    acquisition predictive and gains of the trained pair against the
    inverse route's (rtol 1e-6, atol 1e-8), with no L^-1 in the states.
    K1's launches per step must be equal under every setting of a phase."""
    trainer, C, M, J, f64 = P.trainer, P.conditioned, P.M, P.jesmoc, torch.float64
    rng = np.random.default_rng(2)
    n, steps = 48, 5
    x = rng.uniform(size=(n, 2))
    fid = np.arange(n) % 2
    ys = np.stack([np.sin(5 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 0]])
    pset, pfront = rng.uniform(size=(4, 2)), rng.normal(size=(4, 1))
    t = lambda a, **kw: torch.as_tensor(a, device="cuda", **kw)  # noqa: E731
    xq = t(x[:9] + 0.01)
    eps = torch.randn((steps, 2, 1, n), generator=torch.Generator().manual_seed(5),
                      dtype=f64).to("cuda")
    model = trainer.stack_models([
        M.init_mfdgp(x, y, fid, 2, generator=torch.Generator().manual_seed(i), device="cuda",
                     dtype=f64) for i, y in enumerate(ys)])
    k1_per_step = {}

    def predictive(params, m):
        return list(M.predict_for_acquisition_all(params, m.consts, m.config, xq))

    def counted(key, fn):
        P.counters.reset()
        out = fn()
        torch.cuda.synchronize()
        k1_per_step[key] = P.counters.get("k1.launches") / steps
        return out

    def train(flat):
        with flat_adam_env(flat):
            params, logs = counted(("train", flat), lambda: trainer.train_phase_stacked_chunked(
                model, t(x), t(ys), t(fid), steps, 0.003, "all_free", n, eps=eps))
        return params, [logs.loss, logs.kl] + predictive(params, model)

    with P.patched(trainer, "chunk_size_for", lambda m: REFERENCE_CHUNK):
        trained, want = train(False)
        _, got = train(True)
        rel = rel_diff(got, [w.cpu() for w in want])
        print(f"[variants] f64 training phase, flat Adam vs per-leaf Adam (captured, {steps} "
              f"steps): max rel diff {rel:.3e}", flush=True)
        check(rel < 1e-9, f"flat Adam differs from per-leaf Adam by {rel:.3e}")

        m = model._replace(params=trained)
        obj, con = trainer.select_model(m, 0), trainer.select_model(m, 1)
        data = C.ConditionedData(
            x=t(x), ys_obj=t(ys[:1]), ys_con=t(ys[1:]), fidelities=t(fid), pareto_set=t(pset),
            pareto_front=t(pfront), front_mask=t([True, True, True, False]),
            thresholds=t([0.1], dtype=f64))
        chunk = C.draw_chunk(torch.Generator().manual_seed(4), data._replace(
            x=data.x.cpu(), pareto_set=data.pareto_set.cpu()), obj.config, 24, steps)
        draws = [C.StepDraws(*(None if a is None else a[i].to("cuda") for a in chunk))
                 for i in range(steps)]

        def cond(fused, flat):
            with flat_adam_env(flat), P.patched(C, "FUSED_COND_DEFAULT", fused):
                op, cp, losses = counted(("cond", fused, flat), lambda: C.train_conditioned_chunked(
                    obj.params, con.params, obj.consts, con.consts, obj.config, data, None, steps,
                    0.01, 1e-8, 24, draws=draws))
            return (op, cp), [losses] + predictive(op, obj) + predictive(cp, con)

        (op, cp), want = cond(True, False)
        for fused, flat, what in ((False, False, "three-forward vs fused"),
                                  (True, True, "fused, flat Adam vs per-leaf"),
                                  (False, True, "three-forward with flat Adam vs fused")):
            rel = rel_diff(cond(fused, flat)[1], [w.cpu() for w in want])
            print(f"[variants] f64 conditioned phase (captured, {steps} steps, minibatch of "
                  f"24), {what}: max rel diff {rel:.3e}", flush=True)
            check(rel < 1e-9, f"conditioned phase, {what}: differs by {rel:.3e}")

    sc = trainer.stack_models([obj._replace(params=op), con._replace(params=cp)])
    pair = (m.params, m.consts, sc.params, sc.consts, m.config)
    routes = {}
    for inv in (True, False):
        with P.patched(J, "ACQ_INV_SOLVES", inv):
            stack = J._pair(*pair)
            states = J.pair_states(stack)
            check(all((st.lk_inv is None) != inv for st in states),
                  f"ACQ_INV_SOLVES={inv}: the states' L^-1 is not as set")
            # the L-BFGS loop's route (gradients on): every layer's solve
            # takes the states' L^-1 or the triangular factor
            mus, var = M.predict_for_acquisition_all(stack.params, stack.consts, stack.config, xq,
                                                     states)
            gains = torch.stack([J.coupled_acq_stacked(*pair, f, xq) for f in (0, 1)])
            routes[inv] = [t.detach() for t in (mus, var, gains)]
    worst = 0.0
    for got, want in zip(routes[False], routes[True]):
        excess = (got - want).abs() / (1e-8 + 1e-6 * want.abs())
        worst = max(worst, excess.max().item())
    print(f"[variants] f64 acquisition predictive and gains, solve route vs inverse route: "
          f"max |diff| / (1e-8 + 1e-6 |inverse route|) = {worst:.3e} (largest gain "
          f"{routes[True][2].abs().max().item():.3e})", flush=True)
    check(worst <= 1.0, "the solve route differs from the inverse route beyond rtol 1e-6")
    per_step = ", ".join(f"{k} {v:g}" for k, v in k1_per_step.items())
    print(f"[variants] f64 K1 launches per step: {per_step}", flush=True)
    for kind in ("train", "cond"):
        seen = {v for k, v in k1_per_step.items() if k[0] == kind}
        check(len(seen) == 1 and seen.pop() > 0,
              f"K1 launches per {kind} step differ between settings: {per_step}")


def phase_variants(P, blackboxes) -> dict:
    """The three switches: first variants_f64, then the A/B at f32 and the
    b128 width through the fitter's entry points, each setting flipped in
    this process and restored, with the kernel counters set to 0 just
    before each stage and read just after: train_mfdgps per-leaf and flat
    (VARIANT_STEPS + VARIANT_STEPS epochs), one Pareto sample, then
    train_conditioned_mfdgps (VARIANT_STEPS steps) fused, three-forward and
    flat from the same trained models and Pareto solution, and the
    all-fidelity search (200 raw samples, 200 L-BFGS iterations) with
    ACQ_INV_SOLVES on and off from the same raw samples. Prints steps/s
    without the capture, capture seconds and K1 / K2 launches per setting
    and fails unless K1's launches per step are equal under every setting.
    Returns the path's K1 / K2 launches."""
    variants_f64(P)
    J, C = P.jesmoc, P.conditioned
    problem = slice_problem(blackboxes, 120)
    base = slice_fitter(P, blackboxes, problem, VARIANT_STEPS)
    k1_all = k2_all = 0
    rows = []

    def stage(label, fn, records):
        nonlocal k1_all, k2_all
        out, seconds, k1, _, k2 = staged(P, fn)
        k1_all, k2_all = k1_all + k1, k2_all + k2
        for st in records():
            rate = st["epochs"] / max(st["seconds"] - st["capture_seconds"], 1e-9)
            per_step = st["chol_launches"] / st["epochs"]
            rows.append((label, st["phase"], per_step))
            print(f"[variants] b128 f32 {label} {st['phase']}: {st['epochs']} steps, {rate:.2f} "
                  f"steps/s without the capture (capture {st['capture_seconds']:.3f} s); K1 "
                  f"{st['chol_launches']} ({per_step:g} per step); loss last {st['last']:.6g}",
                  flush=True)
            check(np.isfinite(st["last"]), f"variants {label}: non-finite loss")
        print(f"[variants] b128 f32 {label}: {seconds:.3f} s, K1 {k1}, K2 {k2}", flush=True)
        return out

    trained = None
    for label, flat in (("train per-leaf Adam", False), ("train flat Adam", True)):
        f = base.copy_uncond()
        with flat_adam_env(flat):
            stage(label, f.train_mfdgps, lambda: f.phase_stats)
        trained = trained or f
    stage("pareto", trained.sample_and_store_pareto_solution, list)
    cond = None
    for label, fused, flat in (("cond fused", True, False), ("cond three-forward", False, False),
                               ("cond fused flat Adam", True, True)):
        c = trained.copy_uncond()
        with flat_adam_env(flat), P.patched(C, "FUSED_COND_DEFAULT", fused):
            stage(label, c.train_conditioned_mfdgps, lambda: c.phase_stats[-1:])
        cond = cond or c
    for phase in (1, 2, "cond"):
        seen = {r[2] for r in rows if r[1] == phase}
        check(len(seen) <= 1, f"K1 launches per {phase} step differ between settings: {rows}")
    searches = {}
    for inv in (True, False):
        jes = P.JESMOC_MFDGP(trained, num_fidelities=2, model_cond=cond, seed=SEED,
                             acq_maxiter=200, acq_raw_samples=200)
        for fi in range(2):
            for name, _, is_con in blackboxes:
                jes.add_blackbox(fi, name, cost_evaluation=(1.0, 10.0)[fi], is_constraint=is_con)
        with P.patched(J, "ACQ_INV_SOLVES", inv):
            (x_next, fid_next), seconds, k1, _, k2 = staged(P, jes.get_nextpoint_coupled)
        k1_all, k2_all = k1_all + k1, k2_all + k2
        vals = jes.last_values
        searches[inv] = (seconds, k1, k2)
        print(f"[variants] b128 f32 search ACQ_INV_SOLVES={int(inv)}: {seconds:.3f} s, "
              f"x={x_next.tolist()} fidelity={fid_next}, values {vals.tolist()}; K1 {k1}, "
              f"K2 {k2}", flush=True)
        check(bool(torch.isfinite(vals).all()) and bool((vals >= 0).all()),
              f"search ACQ_INV_SOLVES={inv}: values {vals.tolist()}")
    check(searches[True][1:] == searches[False][1:],
          f"the search's K1 / K2 launches differ with ACQ_INV_SOLVES: {searches}")
    return dict(k1=k1_all, k2=k2_all)


LOOP_EPOCHS = 100  # 100 + 100 epochs and 100 conditioned steps (5000 + 15000, 15000 in full)
# what run_bo_loop writes: file -> columns (the JAX package's names and columns)
LOOP_LOGS = {
    "fidelities_evaluated.txt": 1, "hypervolume_solution.txt": 1, "hypervolumes.txt": 6,
    "iteration_seconds.txt": 3, "observed_hypervolumes.txt": 1, "pareto_resamples.txt": 3,
    "phase_seconds.txt": 8, "points_evaluated.txt": 2, "process_starts.txt": 1,
    "setup_breakdown.txt": 6,
}


class Tee(io.TextIOBase):
    """Forward writes to stdout and keep a copy (the loop's log lines are
    checked)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


class StageCounts:
    """K1 and K2 launches per stage of run_bo_loop, read around the method
    each stage calls (the counters themselves are set to 0 before each run
    and read after it); `iteration` marks where each iteration ends."""

    def __init__(self, P):
        self.P = P
        self.stages = [
            ("train", P.BlackBoxMFDGPFitter, "train_mfdgps"),
            ("pareto", P.BlackBoxMFDGPFitter, "sample_and_store_pareto_solution"),
            ("cond", P.BlackBoxMFDGPFitter, "train_conditioned_mfdgps"),
            ("acq", P.JESMOC_MFDGP, "get_nextpoint_coupled"),
            ("batch", P.JESMOC_MFDGP, "get_batch_coupled"),
            ("recommend", P.loop, "recommend_and_score"),
            ("surfaces", P.JESMOC_MFDGP, "decoupled_acq"),
            ("surfaces", P.JESMOC_MFDGP, "coupled_acq"),
        ]
        self.records, self.current, self.saved = [], {}, []

    def __enter__(self):
        for stage, owner, name in self.stages:
            inner = getattr(owner, name)
            setattr(owner, name, self._counted(stage, inner))
            self.saved.append((owner, name, inner))
        return self

    def __exit__(self, *exc):
        for owner, name, inner in self.saved:
            setattr(owner, name, inner)
        return False

    def _counted(self, stage, inner):
        P = self.P

        @functools.wraps(inner)
        def run(*args, **kwargs):
            k1, k2 = P.counters.get("k1.launches"), P.counters.get("k2.launches")
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            got = self.current.setdefault(stage, [0, 0])
            got[0] += P.counters.get("k1.launches") - k1
            got[1] += P.counters.get("k2.launches") - k2
            return out

        return run

    def iteration(self, it, state):
        self.records.append(self.current)
        self.current = {}


def run_loop(P, log_dir, iterations, **kw):
    """run_bo_loop of the port on the bench's problem at the cut depth, with
    the kernel counters set to 0 just before it and read just after:
    (state, stdout, stage launches per iteration, K1 launches, K2 launches)."""
    config = P.BOConfig(**{**dict(num_bo_iterations=iterations, seed=0, log_dir=str(log_dir),
                                  pad_data=True, num_epochs_1=LOOP_EPOCHS,
                                  num_epochs_2=LOOP_EPOCHS, track_recommendation=True,
                                  device="cuda"), **kw})
    rng = np.random.default_rng(0)
    x_init = rng.uniform(size=(120, 2)).astype(np.float32)
    fid_init = np.concatenate([np.zeros(80), np.ones(40)]).astype(int)
    tee = Tee(sys.stdout)
    with StageCounts(P) as counts, contextlib.redirect_stdout(tee):
        P.counters.reset()
        state = P.loop.run_bo_loop(P.loop_blackboxes, x_init, fid_init, config,
                                   callback=counts.iteration)
        torch.cuda.synchronize()
        k1, k2 = P.counters.get("k1.launches"), P.counters.get("k2.launches")
    return state, tee.text(), counts.records, k1, k2


def log_rows(log_dir) -> dict:
    return {name: np.loadtxt(log_dir / name, ndmin=2) for name in sorted(os.listdir(log_dir))
            if name.endswith(".txt")}


def check_new_points(label, state, n_before, q):
    x, fid = state.x[n_before:], state.fidelities[n_before:]
    check(x.shape == (q, 2) and bool(((x >= 0) & (x <= 1)).all()),
          f"loop {label}: evaluated points {x.tolist()} outside [0, 1]^2")
    check(set(fid.tolist()) <= {0, 1}, f"loop {label}: fidelities {fid.tolist()}")
    check(all(np.isfinite(h) and h >= 0 for h in state.hypervolumes),
          f"loop {label}: observed HV {state.hypervolumes}")


def phase_loop(P, root) -> dict:
    """Steps (a)-(f) of the loop phase; returns the launches of (a)."""
    from mobocmf_tpu_torch.util import checkpoint

    # (a) two q=1 JESMOC iterations, checkpoints stored for (e)
    saved = []
    save = checkpoint.save_fitter

    def keep(path, fitter):
        saved.append((path, fitter))
        return save(path, fitter)

    checkpoint.save_fitter = keep
    try:
        t0 = time.perf_counter()
        state, _, stages, k1_a, k2_a = run_loop(P, root / "a", 2, store_models_in_disk=True)
        t_a = time.perf_counter() - t0
    finally:
        checkpoint.save_fitter = save
    rows = log_rows(root / "a")
    check(set(rows) == set(LOOP_LOGS), f"loop (a): log files {sorted(rows)}")
    for name, cols in LOOP_LOGS.items():
        want = (1 if name == "process_starts.txt" else 2, cols)
        check(rows[name].shape == want, f"loop (a): {name} holds {rows[name].shape}, not {want}")
    phases, iters = rows["phase_seconds.txt"], rows["iteration_seconds.txt"]
    check(bool(np.isfinite(phases).all() and (phases[:, 2:] >= 0).all()),
          f"loop (a): phase seconds {phases.tolist()}")
    check(bool(np.isfinite(iters).all()), f"loop (a): iteration seconds {iters.tolist()}")
    check_new_points("(a)", state, 120, 2)
    for it, st in enumerate(stages):
        print(f"[loop] (a) iteration {it}: K1 / K2 launches per stage "
              + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in st.items())
              + f"; phase_seconds row {phases[it].tolist()} (it, n, setup, train, pareto, "
              f"cond, acq, recommend); wall clock {iters[it, 2]:.3f} s", flush=True)
        for stage in ("train", "cond"):
            check(st.get(stage, [0, 0])[0] > 0, f"loop (a) iteration {it}: no K1 launch in {stage}")
        for stage in ("acq", "recommend"):
            check(st.get(stage, [0, 0])[1] > 0, f"loop (a) iteration {it}: no K2 launch in {stage}")
    print(f"[loop] (a) 2 iterations in {t_a:.3f} s; K1 launches {k1_a}, K2 launches {k2_a}; "
          f"observed HV {state.hypervolumes}; hypervolumes.txt "
          f"{rows['hypervolumes.txt'].tolist()}", flush=True)

    # (b) resume the same directory to three iterations
    state, out, stages_b, _, _ = run_loop(P, root / "a", 3, store_models_in_disk=True)
    check("[resume] replayed 2 evaluated points (2 iterations)" in out,
          "loop (b): no replay of 2 iterations")
    check(len(stages_b) == 1 and "[BO iter 0]" not in out, "loop (b): ran more than iteration 2")
    after = log_rows(root / "a")
    for name, before in rows.items():
        check(after[name].shape == (before.shape[0] + 1, before.shape[1]),
              f"loop (b): {name} went from {before.shape} to {after[name].shape}")
    check_new_points("(b)", state, 122, 1)
    print(f"[loop] (b) resumed: replayed 2 iterations, one row added to each of "
          f"{len(after)} logs; phase_seconds row {after['phase_seconds.txt'][-1].tolist()}",
          flush=True)

    # (c) one q=2 iteration in a fresh directory
    state, _, stages_c, _, _ = run_loop(P, root / "c", 1, q=2)
    check_new_points("(c)", state, 120, 2)
    x = state.x[120:]
    check(state.fidelities[120] == state.fidelities[121] and np.abs(x[0] - x[1]).max() > 1e-6,
          f"loop (c): the batch {x.tolist()} at fidelities {state.fidelities[120:].tolist()}")
    batch = stages_c[0].get("batch", [0, 0])
    check(batch[1] > 0, "loop (c): the penalized pick did not launch K2")
    print(f"[loop] (c) q=2: {x.tolist()} at fidelity {state.fidelities[120]}; the penalized "
          f"pick launched K1 {batch[0]}, K2 {batch[1]}", flush=True)

    # (d) the random baseline with nothing that consumes models
    state, _, _, k1_d, _ = run_loop(P, root / "d", 1, acquisition="random",
                                    track_recommendation=False)
    check_new_points("(d)", state, 120, 1)
    check(k1_d == 0, f"loop (d): the random baseline launched K1 {k1_d} times")
    print(f"[loop] (d) random baseline: K1 launches {k1_d}; x {state.x[120].tolist()} "
          f"fidelity {state.fidelities[120]}", flush=True)

    # (e) restore the checkpoints of (a)'s iteration 0 instead of retraining
    os.makedirs(root / "e" / "models")
    shutil.copytree(root / "a" / "models" / "iter0", root / "e" / "models" / "iter0")
    restored = []
    restore = checkpoint.restore_fitter

    def spy(path, device=None):
        restored.append((path, restore(path, device)))
        return restored[-1][1]

    checkpoint.restore_fitter = spy
    try:
        state, out, stages_e, _, _ = run_loop(P, root / "e", 1, load_models_from_disk=True)
    finally:
        checkpoint.restore_fitter = restore
    check(f"[BO iter 0] restored models from {root / 'e' / 'models' / 'iter0'}" in out,
          "loop (e): the log does not say the models were restored")
    check("train" not in stages_e[0] and "cond" not in stages_e[0],
          f"loop (e): trained after restoring ({stages_e[0]})")
    check_new_points("(e)", state, 120, 1)
    by_kind = {os.path.basename(p): f for p, f in saved if f"{os.sep}iter0{os.sep}" in p}
    check(len(restored) == 2, f"loop (e): {len(restored)} fitters restored")
    equal = 0
    for path, fitter in restored:
        ref = by_kind[os.path.basename(path)]
        names = [(n, False) for n in ref.obj_names] + [(n, True) for n in ref.con_names]
        for n, c in names:
            a = P.tree_leaves(ref.get_model(n, c).params)
            b = P.tree_leaves(fitter.get_model(n, c).params)
            check(len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b)),
                  f"loop (e): restored {n} differs from the saved one")
            equal += len(a)
    print(f"[loop] (e) restored uncond and cond of iteration 0 instead of training: "
          f"{equal} parameter tensors bitwise equal to the saved fitters'; stages run "
          f"{sorted(stages_e[0])}", flush=True)

    # (f) one Pareto sample of the restored models per polish
    base = next(f for p, f in restored if os.path.basename(p) == "uncond")
    for polish in ("slsqp", "device"):
        fitter = base.copy_uncond()
        fitter.polish = polish
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = fitter.sample_and_store_pareto_solution()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        pset = sol.pareto_set[sol.mask]
        check(sol.num_valid >= 1 and bool(torch.isfinite(sol.pareto_front[sol.mask]).all()),
              f"loop (f) {polish}: Pareto set of {sol.num_valid} points")
        # feasible for the constraint samples it was solved on (MOOP keeps
        # c(x) >= -threshold), unless every draw failed and the reference's
        # least-infeasible fallback ran (fit/fitter.py)
        slack = min(float((P.rff.eval_sample_fn(s, pset) + thr).min())
                    for s, thr in zip(fitter.samples_cons, fitter.thresholds_cons))
        fallback = fitter.pareto_tries > P.MAX_TRIES_FOR_FEASIBLE_GRID
        check(fallback or slack >= -1e-5,
              f"loop (f) {polish}: a Pareto point violates a sampled constraint by {-slack:.3e}")
        print(f"[loop] (f) Pareto sample with polish={polish}: {seconds:.3f} s, "
              f"{fitter.pareto_tries} MOOP attempt(s), {sol.num_valid} Pareto points, least "
              f"constraint slack {slack:.3e}"
              + (" (least-infeasible fallback)" if fallback else ""), flush=True)
    return dict(k1=k1_a, k2=k2_a)


def mesh_loop_rank(log_dir: str) -> dict:
    """One rank of the mesh phase's (c): one run_bo_loop iteration at the
    loop phase's width with BOConfig(mesh=make_mesh(2, bb=1)), every MOOP
    call recorded (its grid drawn here as the MOOP draws it); rank 0 then
    solves the last MOOP call's samples and grid unsharded. The counters
    are set to 0 just before the loop and read just after."""
    import torch.distributed as dist

    from mobocmf_tpu_torch.bench import bench_blackboxes
    from mobocmf_tpu_torch.bo import loop
    from mobocmf_tpu_torch.moop.moop import MOOP
    from mobocmf_tpu_torch.parallel import sharding
    from mobocmf_tpu_torch.util import counters

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = sharding.make_mesh(2, bb=1)
    calls = []
    solve = MOOP.compute_pareto_solution_from_samples

    def recorded(self, inputs, generator=None, allow_negative_constraints=False,
                 inputs_valid=None, grid=None, like=None):
        if grid is None:
            grid = torch.rand((self.input_dim * self.grid_size, self.input_dim),
                              generator=generator, dtype=torch.float64,
                              device=like.device).cpu().numpy()
        out = solve(self, inputs, generator, allow_negative_constraints, inputs_valid, grid, like)
        calls.append((self, inputs, allow_negative_constraints, inputs_valid, grid, like, out))
        return out

    MOOP.compute_pareto_solution_from_samples = recorded
    rng = np.random.default_rng(0)
    x_init = rng.uniform(size=(120, 2)).astype(np.float32)
    fid_init = np.concatenate([np.zeros(80), np.ones(40)]).astype(int)
    config = loop.BOConfig(num_bo_iterations=1, seed=0, log_dir=log_dir, pad_data=True,
                           num_epochs_1=LOOP_EPOCHS, num_epochs_2=LOOP_EPOCHS,
                           track_recommendation=True, mesh=mesh, device="cuda")
    blackboxes = bench_blackboxes(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    counters.reset()
    seconds0 = sharding.seconds
    t0 = time.perf_counter()
    with SearchLog() as searches:
        state = loop.run_bo_loop(blackboxes, x_init, fid_init, config)
    torch.cuda.synchronize(dev)
    out = dict(wall=time.perf_counter() - t0, k1=counters.get("k1.launches"),
               k2=counters.get("k2.launches"),
               searches=[(kind, sec, st) for kind, sec, st in searches.runs],
               collective_seconds=sharding.seconds - seconds0,
               collectives=counters.get("collectives"),
               memory=torch.cuda.max_memory_allocated(dev), moop_calls=len(calls),
               x=state.x, fid=state.fidelities, ys=state.ys, hv=state.hypervolumes,
               transport=sharding.transport(mesh))
    if dist.get_rank() == 0:
        moop, inputs, allow, valid, grid, like, res = calls[-1]
        alone = copy.copy(moop)
        alone.mesh = None
        ref = solve(alone, inputs, None, allow, valid, grid, like)
        out["fronts"] = [None if r is None else (r[0].pareto_set.cpu().numpy(),
                                                r[0].pareto_front.cpu().numpy(),
                                                r[0].num_valid) for r in (res, ref)]
    return out


def print_dryrun(label: str, summary: dict, seconds: float) -> dict:
    """The mesh phase's lines for one dry run; its K1 / K2 launches per rank."""
    ranks = summary["ranks"]
    stages = list(summary["reference"])
    mem = [r["max_memory_bytes"] / 2**30 for r in ranks]
    coll = [sum(r[k]["collective_seconds"] for k in stages) for r in ranks]
    print(f"[mesh] {label}: mesh {summary['mesh']}, backend {summary['backend']}, transport "
          f"{ranks[0]['transport']}, wall {seconds:.3f} s (ranks {summary['sharded_seconds']:.3f} "
          f"s), max memory per rank {[round(m, 3) for m in mem]} GiB, collective seconds per "
          f"rank {[round(c, 3) for c in coll]}, inducing-sharded predictive max |diff| per rank "
          f"{[r['predictive_err'] for r in ranks]}", flush=True)
    for ph in summary["phases"]:
        print(f"[steps] mesh {label} {ph['label']}: {ph['steps']} steps, captured "
              f"{ph['captured']} ({ph['capture_reason']}), {ph['replays']} replays, capture "
              f"{ph['capture_seconds']:.3f} s", flush=True)
    for k in stages:
        print(f"[mesh] {label} {k}: seconds per rank "
              f"{[round(r[k]['seconds'], 3) for r in ranks]} (unsharded "
              f"{summary['reference'][k]['seconds']:.3f}); K1 / K2 per rank "
              f"{[(r[k]['k1'], r[k]['k2']) for r in ranks]} (unsharded "
              f"{summary['reference'][k]['k1']} / {summary['reference'][k]['k2']}); "
              f"collectives {ranks[0][k]['collectives']} (graph replays included) in "
              f"{ranks[0][k]['collective_seconds']:.3f} s of host time on rank 0", flush=True)
    st = ranks[0]["search_stats"]
    print(f"[search] mesh {label} search on every rank: {st['iterations']} iterations, "
          f"{st['evaluations']} evaluations, line-search steps per lane and iteration max "
          f"{st['ls_steps_max']}, mean {st['ls_steps_mean']:.3f}; of {st['lanes']} lanes "
          f"{st['at_gtol']} ended at gtol, {st['at_maxiter']} at maxiter, "
          f"{st['failed_searches']} had a failed line search; captured {st['captured']} "
          f"({st['capture_reason']}), capture {st['capture_seconds']:.3f} s, "
          f"{st['replays']} replays", flush=True)
    k1 = [sum(r[k]["k1"] for k in stages) for r in ranks]
    k2 = [sum(r[k]["k2"] for k in stages) for r in ranks]
    check(all(a > 0 for a in k1) and all(b > 0 for b in k2),
          f"mesh {label}: a rank launched no K1 or no K2 ({k1}, {k2})")
    check(all(r["inducing"]["k2"] > 0 for r in ranks),
          f"mesh {label}: the inducing-sharded predictive launched no K2 on some rank")
    return dict(k1=k1, k2=k2)


def phase_mesh(P, root) -> dict:
    """(a) the dry run on a 2 x 2 gloo mesh, (b) on a 1 x 1 NCCL mesh, (c)
    run_bo_loop with BOConfig.mesh on two ranks; returns the K1 / K2
    launches per rank of each."""
    from mobocmf_tpu_torch.parallel import dryrun, launch

    out = {}
    for key, label, n, backend in (("mesh_dryrun", "(a) dry run 2x2", 4, "gloo"),
                                   ("mesh_nccl1", "(b) dry run 1x1", 1, "nccl")):
        t0 = time.perf_counter()
        summary = dryrun.dryrun_multichip(n, device="cuda", size=dryrun.BENCH)
        out[key] = print_dryrun(label, summary, time.perf_counter() - t0)
        check(summary["backend"] == backend, f"mesh {label}: backend {summary['backend']}")
        want = backend == "nccl"
        check(all(ph["captured"] == want for ph in summary["phases"]),
              f"mesh {label}: phases captured {[ph['captured'] for ph in summary['phases']]}")
        searched = [r["search_stats"] for r in summary["ranks"]]
        check(all(st["captured"] == want and (st["replays"] > 0) == want for st in searched),
              f"mesh {label}: searches captured {[st['captured'] for st in searched]}, replays "
              f"{[st['replays'] for st in searched]}")
        # one gradient all-reduce a training step, replayed ones included
        steps = sum(ph["steps"] for ph in summary["phases"] if ph["label"] != "cond")
        got = [r["uncond"]["collectives"] for r in summary["ranks"]]
        check(all(c >= steps for c in got),
              f"mesh {label}: {got} collectives counted for {steps} training steps")

    t0 = time.perf_counter()
    res = launch.run(mesh_loop_rank, 2, str(root / "loop"), device="cuda", timeout_s=900)
    seconds = time.perf_counter() - t0
    rows = log_rows(root / "loop")
    check(set(rows) == set(LOOP_LOGS), f"mesh (c): log files {sorted(rows)}")
    for name, cols in LOOP_LOGS.items():
        check(rows[name].shape == (1, cols),
              f"mesh (c): {name} holds {rows[name].shape}, not one row of {cols}")
    for r, got in enumerate(res):
        same = (np.array_equal(got["x"], res[0]["x"]) and np.array_equal(got["fid"], res[0]["fid"])
                and all(np.array_equal(got["ys"][k], res[0]["ys"][k]) for k in got["ys"])
                and got["hv"] == res[0]["hv"])
        check(same, f"mesh (c): rank {r} ended with another BOState than rank 0")
        check(got["k1"] > 0 and got["k2"] > 0,
              f"mesh (c): rank {r} launched K1 {got['k1']}, K2 {got['k2']}")
        search_summary(f"mesh (c) rank {r}", got["searches"])
        check([dryrun.steps_taken(st) for _, _, st in got["searches"]]
              == [dryrun.steps_taken(st) for _, _, st in res[0]["searches"]],
              f"mesh (c): rank {r}'s L-BFGS runs took other steps than rank 0's")
    fronts = res[0]["fronts"]
    check((fronts[0] is None) == (fronts[1] is None), f"mesh (c): sharded MOOP {fronts}")
    if fronts[0] is not None:
        (ps, pf, nv), (ps0, pf0, nv0) = fronts
        check(nv == nv0 and np.allclose(ps, ps0, atol=1e-5) and np.allclose(pf, pf0, atol=1e-4),
              f"mesh (c): the sharded MOOP's front differs from rank 0's unsharded one by "
              f"{np.abs(pf - pf0).max()}")
    check_new_points("mesh (c)", SimpleNamespace(x=res[0]["x"], fidelities=res[0]["fid"],
                                                 hypervolumes=res[0]["hv"]), 120, 1)
    print(f"[mesh] (c) run_bo_loop with BOConfig.mesh (1, 2): backend gloo, transport "
          f"{res[0]['transport']}, wall {seconds:.3f} s (loop per rank "
          f"{[round(g['wall'], 3) for g in res]} s), max memory per rank "
          f"{[round(g['memory'] / 2**30, 3) for g in res]} GiB, collectives per rank "
          f"{[g['collectives'] for g in res]} in {[round(g['collective_seconds'], 3) for g in res]}"
          f" s, MOOP calls {res[0]['moop_calls']}; K1 / K2 per rank "
          f"{[(g['k1'], g['k2']) for g in res]}; phase_seconds row "
          f"{rows['phase_seconds.txt'][0].tolist()}; sharded front == unsharded on rank 0 "
          f"({'none' if fronts[0] is None else fronts[0][2]} points)", flush=True)
    out["mesh_loop"] = dict(k1=[g["k1"] for g in res], k2=[g["k2"] for g in res])
    return out


MESMOC_ITERS = 5
# K1 launches per MESMOC iteration, predicted in PERF.md before the
# first run: 3 fits x 150 NLML steps, 2 fidelities x 3 posterior states in
# the search, 3 predicts in the recommendation HV; all at n = 32
MESMOC_K1_PER_ITER = 3 * 150 + 2 * 3 + 3


def phase_mesmoc(P, root) -> dict:
    """The port's example_mesmoc_mfgp at its defaults (5 iterations, f32),
    K1 launches per iteration and stage; K1 on one of the path's own NLML
    Grams against the plain version; an f64 fit and predict on the card
    against the CPU."""
    E, G = P.mesmoc_example, P.mfgp
    per_iter, current, kept = [], {}, {}

    def counted(stage, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            k1 = P.counters.get("k1.launches")
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            current[stage] = current.get(stage, 0) + P.counters.get("k1.launches") - k1
            if stage == "fit":
                kept["models"] = out[0]
            if stage == "recommendation_hv":
                per_iter.append(dict(current))
                current.clear()
            return out
        return run

    with contextlib.ExitStack() as stack:
        for owner, name, stage in ((E, "fit_models", "fit"),
                                   (P.MESMOC_MFGP, "get_nextpoint_coupled", "search"),
                                   (E, "recommendation_hv", "recommendation_hv")):
            stack.enter_context(P.patched(owner, name, counted(stage, getattr(owner, name))))
        P.counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = E.main(["--iters", str(MESMOC_ITERS), "--log-dir", str(root)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = P.counters.get("k1.launches"), P.counters.get("k2.launches")
    for name in E.LOG_FILES:
        rows = np.loadtxt(root / name, ndmin=2)
        check(rows.shape[0] == MESMOC_ITERS and bool(np.isfinite(rows).all()),
              f"mesmoc: {name} holds {rows.shape}")
    values = [v for it in res["values"] for v in it.values()]
    check(len(values) == 2 * MESMOC_ITERS and all(np.isfinite(v) and v >= 0 for v in values),
          f"mesmoc: acquisition values {values}")
    new_fid = res["fidelities"][-MESMOC_ITERS:]
    check(set(new_fid.tolist()) <= {0, 1}, f"mesmoc: fidelities {new_fid.tolist()}")
    for it, (st, counts) in enumerate(zip(res["stage_seconds"], per_iter)):
        print(f"[mesmoc] iteration {it}: fit {st['fit']:.3f} s, search {st['search']:.3f} s, "
              f"recommendation HV {st['recommendation_hv']:.3f} s; K1 launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f" = {sum(counts.values())}", flush=True)
        check(sum(counts.values()) == MESMOC_K1_PER_ITER,
              f"mesmoc iteration {it}: {sum(counts.values())} K1 launches, predicted "
              f"{MESMOC_K1_PER_ITER}")
    print(f"[mesmoc] {MESMOC_ITERS} iterations in {seconds:.3f} s "
          f"({seconds / MESMOC_ITERS:.3f} s an iteration); K1 launches {k1}, K2 launches {k2}; "
          f"fidelities {new_fid.tolist()}; observed HV {res['hypervolumes']}; recommendation "
          f"HV {res['recommendation_hvs']} (optimal {res['optimal_hv']:.4f})", flush=True)
    check(k1 == MESMOC_K1_PER_ITER * MESMOC_ITERS, f"mesmoc: K1 launches {k1}")

    # K1 on the path's own NLML Gram (the constraint's, last iteration)
    m = kept["models"]["con1"]
    gram = G._train_gram(m.params, m.x_train, m.jitter, m.row_penalty).detach()[None]
    got, _ = P.chol.cholesky(gram.contiguous(), None, ladder=False)
    want, _ = P.chol.cholesky_plain(gram, torch.zeros(1, device=gram.device), False)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    g64 = got.double()
    recon = ((g64 @ g64.mT - gram.double()).abs().max() / gram.double().abs().max()).item()
    print(f"[mesmoc] K1 on the path's NLML Gram {tuple(gram.shape)} f32: max_rel_diff "
          f"{rel:.3e} against the plain version, recon {recon:.3e}", flush=True)
    check(rel < 1e-4 and recon < 1e-5, f"mesmoc: K1 on the path's Gram: {rel:.3e}, {recon:.3e}")

    # an f64 MFGP fit and predict on the card against the CPU
    rng = np.random.default_rng(0)
    x = np.vstack([rng.uniform(size=(16, 2)), rng.uniform(size=(8, 2))])
    fid = np.concatenate([np.zeros(16), np.ones(8)]).astype(int)
    y = np.array([E.obj1(x[i:i + 1], fid[i])[0] for i in range(len(x))])
    xf, valid, yp = E.padded(x, fid, 32, y)
    xs = torch.as_tensor(np.random.default_rng(1).uniform(size=(64, 2)))
    out = []
    for dev in ("cpu", "cuda"):
        model = G.fit_mfgp(G.init_mfgp(xf, yp, 2, row_valid=valid, device=dev,
                                       dtype=torch.float64), num_iters=50)
        with torch.no_grad():
            out.append([t.cpu() for t in G.predict(model, xs.to(dev), 1)])
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(out[1], out[0]))
    print(f"[mesmoc] f64 fit (50 steps) and predict, card vs CPU: max rel diff {rel:.3e}",
          flush=True)
    check(rel < 1e-8, f"mesmoc: the f64 card path differs from the CPU path by {rel:.3e}")
    return dict(k1=k1, k2=k2, seconds=seconds, k1_per_iter=[sum(c.values()) for c in per_iter])


def k2_shapes_spy(P, calls: list):
    """A stand-in for mfdgp's K2 entry that records each call's (B, M, N, d)."""
    inner = P.M.fused_rbf_svgp_forward

    def spy(z, x, mean, *rest):
        calls.append((mean.shape[0], mean.shape[-1], x.shape[0], x.shape[1]))
        return inner(z, x, mean, *rest)

    return spy


def keep_jesmoc(P, kept: list):
    """get_nextpoint_coupled that keeps its JESMOC_MFDGP object."""
    inner = P.JESMOC_MFDGP.get_nextpoint_coupled

    @functools.wraps(inner)
    def run(self, *args, **kwargs):
        kept.append(self)
        return inner(self, *args, **kwargs)

    return run


def k2_on_path(P, label, jes, d: int, points: int = 200) -> dict:
    """K2 on a search's own trained f32 screening states (uncond and cond
    of every blackbox). At layer 0: no further off the f64 answer than the
    plain route. End to end (the top-fidelity acquisition means and
    variances): each route's layer 0 fed through the same deeper layers in
    f64, within END_TO_END_RATIO of the plain route's distance from the f64
    layer 0 fed through them. The deeper layers run in f64 because in f32
    their own rounding swamps layer 0's error (at m = 2048 both routes sit
    ~0.9 output std from the f64 models, and the f32 ratio swings 0.5-2.2x
    with the points), so an f32 end-to-end comparison cannot hold K2."""
    trainer, M = P.trainer, P.M
    unc, cond = jes.blackbox_mfdgp_fitter_uncond, jes.blackbox_mfdgp_fitter_cond
    names = [(n, False) for n in unc.obj_names] + [(n, True) for n in unc.con_names]
    su = trainer.stack_models([unc.get_model(n, c) for n, c in names])
    sc = trainer.stack_models([cond.get_model(n, c) for n, c in names])
    pair = trainer.stack_models([su, sc])
    z = pair.consts.z_x[0]
    x = torch.rand((points, d), generator=torch.Generator(device=z.device).manual_seed(SEED),
                   dtype=z.dtype, device=z.device)
    k2_l0, plain_l0, exact_l0 = layer0_routes(P, pair, x)
    err_k2_l0, err_plain_l0 = rel_err(zip(k2_l0, exact_l0)), rel_err(zip(plain_l0, exact_l0))
    f64 = functools.partial(P.tree_map, lambda t: t.double() if t.is_floating_point() else t)
    params64, consts64 = f64(pair.params), f64(pair.consts)

    def through_f64(layer0):
        fixed = tuple(t.detach().double() for t in layer0)
        with P.patched(M, "_layer0_k2", lambda *args: fixed), torch.no_grad():
            return M.predict_for_acquisition(params64, consts64, pair.config, x.double(),
                                             pair.config.num_fidelities - 1)

    ref = through_f64(exact_l0)
    err_k2, err_plain = (rel_err(zip(through_f64(l0), ref)) for l0 in (k2_l0, plain_l0))
    print(f"[{label}] K2 on the search's {2 * len(names)} screening states (M = "
          f"{z.shape[0]}, d = {d}, {points} points): layer 0 max rel err against f64 at "
          f"the same jitter, K2 route {err_k2_l0:.3e}, plain route {err_plain_l0:.3e}; "
          f"top-fidelity means and variances, each route's layer 0 through the f64 deeper "
          f"layers against the f64 layer 0 through them, K2 route {err_k2:.3e}, plain route "
          f"{err_plain:.3e}", flush=True)
    check(err_k2_l0 <= LAYER0_RATIO * err_plain_l0 + LAYER0_FLOOR,
          f"{label}: layer 0 through K2 is {err_k2_l0:.3e} off, the plain route {err_plain_l0:.3e}")
    check(err_k2 <= END_TO_END_RATIO * err_plain + END_TO_END_FLOOR,
          f"{label}: top fidelity through K2 {err_k2:.3e} off, plain route {err_plain:.3e}")
    return dict(layer0=(err_k2_l0, err_plain_l0), end_to_end=(err_k2, err_plain))


def time_k2_shape(P, label, b, m, n, d) -> dict:
    """K2 against its plain version on k2_problem at a path's shape: the
    plan, max |err|, device time per call, the plain version's, the bound."""
    K2 = P.fused_svgp
    sp = K2.plan(m, n, b, torch.float32)
    args = P.k2_problem(b, m, n, d, m + n, torch.float32, torch.device("cuda"))
    with torch.no_grad():
        mu, var = K2.fused_rbf_svgp_forward(*args)
        mu_p, var_p = K2.fused_rbf_svgp_forward_plain(*args)
        torch.cuda.synchronize()
        err = max((mu - mu_p).abs().max().item(), (var - var_p).abs().max().item())
        close = all(bool(torch.allclose(a, w, rtol=2e-3, atol=2e-3))
                    for a, w in ((mu, mu_p), (var, var_p)))
        ms = P.device_ms(lambda: K2.fused_rbf_svgp_forward(*args), 10)
        plain_ms = P.device_ms(lambda: K2.fused_rbf_svgp_forward_plain(*args), 10)
    bound_ms, bound_by = k2_bound_ms(b, m, n, d, torch.float32)
    print(f"[{label}] K2 at the path's shape B={b} M={m} N={n} d={d} f32: plan stripe "
          f"W={sp.width}, {sp.smem_bytes} B per solve block, grids {(-(-(m + 1) // sp.width), b)}"
          f" and {(-(-n // sp.width), b)}; max_abs_err={err:.3e} (tol 2e-3) device ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    check(close, f"{label}: K2 at B={b} M={m} N={n} d={d} differs from plain by {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                width=sp.width)


def run_example(P, label, main, argv):
    """One example entry point with the kernel counters set to 0 just
    before it and read just after: (state, K1 / K2 launches per stage,
    K1, K2, the kept JESMOC object, the K2 call shapes, seconds)."""
    calls, kept = [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(P.patched(P.M, "fused_rbf_svgp_forward", k2_shapes_spy(P, calls)))
        stack.enter_context(P.patched(P.JESMOC_MFDGP, "get_nextpoint_coupled",
                                    keep_jesmoc(P, kept)))
        counts = stack.enter_context(StageCounts(P))
        P.counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = P.counters.get("k1.launches"), P.counters.get("k2.launches")
    stages = counts.current
    print(f"[{label}] one iteration in {seconds:.3f} s; K1 / K2 launches per stage "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in stages.items())
          + f"; K1 {k1}, K2 {k2} in all; K2 call shapes (B, M, N, d) {sorted(set(calls))}",
          flush=True)
    return state, stages, k1, k2, kept[-1] if kept else None, calls, seconds


# K1 / K2 launches per stage of the two pipeline examples, counted from
# the code's structure (2 fidelities: one K1 launch per layer for every
# stacked model; layer 0 of a no-grad predictive through one K2 call):
# train 2 per epoch; cond 2 per step; surfaces 2 K1 + 1 K2 per predictive
# (a decoupled gain takes two, the coupled gain of a fidelity one); the
# round trips' predictions 2 K1 + 1 K2 per model, outside the stages.
PIPELINE_STAGES = {
    # 10 + 20 epochs, 10 conditioned steps, 8 decoupled + 2 coupled surfaces
    "synthetic2d": {"train": [60, 0], "cond": [20, 0], "surfaces": [36, 18]},
    # --fast: 10 + 20 epochs, 10 conditioned steps, 2 decoupled surfaces
    "forrester": {"train": [60, 0], "cond": [20, 0], "surfaces": [8, 4]},
}


def phase_pipeline(P, label, main, argv, gaps) -> dict:
    """One of the two examples that checkpoint or pickle the fitter between
    its phases: the round trips on the card keep every prediction (the
    example raises otherwise, and returns each gap), K2 runs on the
    acquisition surfaces, and the deterministic stages launch what
    PIPELINE_STAGES predicts."""
    state, stages, k1, k2, _, calls, seconds = run_example(P, label, main, argv)
    for gap in gaps:
        check(state[gap] == 0.0, f"{label}: {gap} = {state[gap]}")
    print(f"[{label}] round trips {', '.join(f'{g} {state[g]}' for g in gaps)}; pareto points "
          f"{state['pareto_points']} (MOOP attempts {state['pareto_tries']}); conditioned loss "
          f"{state['cond_loss']:.6g}; acquisition maxima {state['acq_max']}", flush=True)
    check(np.isfinite(state["cond_loss"]), f"{label}: conditioned loss {state['cond_loss']}")
    check(all(np.isfinite(v) and v >= 0 for v in state["acq_max"].values()),
          f"{label}: acquisition maxima {state['acq_max']}")
    for stage, want in PIPELINE_STAGES[label].items():
        check(stages.get(stage) == want, f"{label}: {stage} launched K1 / K2 "
              f"{stages.get(stage)}, predicted {want}")
    return dict(k1=k1, k2=k2, stages=stages, seconds=seconds)


def phase_dtlz2(P, root) -> dict:
    """One iteration of example_dtlz2_2048 --fast at the example's width
    (2040 points padded to m = 2048, 3 fidelities, 4 objectives)."""
    state, stages, k1, k2, jes, calls, seconds = run_example(
        P, "dtlz2_2048", P.dtlz2_main,
        ["--fast", "--iters", "1", "--n-init", "2040", "--log-dir", str(root)])
    check(state.x.shape == (2041, 6) and state.fidelities[-1] in (0, 1, 2),
          f"dtlz2_2048: state {state.x.shape}, fidelity {state.fidelities[-1]}")
    check(all(np.isfinite(h) for h in state.hypervolumes), f"dtlz2_2048: HV {state.hypervolumes}")
    check(stages["train"][0] >= 3 * 30, f"dtlz2_2048: K1 launches in train {stages['train']}")
    check(stages["acq"][1] >= 1 and calls and all(c[1] == 2048 for c in calls),
          f"dtlz2_2048: K2 calls {calls}")
    phases = np.loadtxt(root / "phase_seconds.txt", ndmin=2)[0]
    print(f"[dtlz2_2048] phase_seconds row {phases.tolist()} (it, n, setup, train, pareto, "
          f"cond, acq, recommend)", flush=True)
    rule = k2_on_path(P, "dtlz2_2048", jes, 6)
    b, m, n, d = calls[0]
    timing = time_k2_shape(P, "dtlz2_2048", b, m, n, d)
    return dict(k1=k1, k2=k2, stages=stages, seconds=seconds, rule=rule, k2_shape=calls[0],
                k2_timing=timing)


def phase_batch10d(P, root) -> dict:
    """One iteration of example_batch_bo_10d --fast (q = 16, d = 10)."""
    q = 16
    state, stages, k1, k2, jes, calls, seconds = run_example(
        P, "batch10d", P.batch10d_main, ["--fast", "--iters", "1", "--log-dir", str(root)])
    x = state.x[40:]
    check(x.shape == (q, 10) and bool(((x >= 0) & (x <= 1)).all()),
          f"batch10d: the batch {x.shape}")
    check(len(set(state.fidelities[40:].tolist())) == 1, "batch10d: the batch spans fidelities")
    batch = stages.get("batch", [0, 0])
    print(f"[batch10d] the penalized picks launched K1 {batch[0]}, K2 {batch[1]} "
          f"({2 * (q - 1)} K2 predicted: 2 per pick)", flush=True)
    check(batch[1] == 2 * (q - 1), f"batch10d: {batch[1]} K2 launches in {q - 1} picks")
    rule = k2_on_path(P, "batch10d", jes, 10)
    b, m, n, d = calls[0]
    timing = time_k2_shape(P, "batch10d", b, m, n, d)
    return dict(k1=k1, k2=k2, stages=stages, seconds=seconds, rule=rule, k2_shape=calls[0],
                k2_timing=timing)


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
        from mobocmf_tpu_torch.acquisition import lbfgs, optimize
        from mobocmf_tpu_torch.acquisition.jesmoc import JESMOC_MFDGP, coupled_acq_stacked
        from mobocmf_tpu_torch.bench import bench_blackboxes
        from mobocmf_tpu_torch.bo import loop
        from mobocmf_tpu_torch.fit.fitter import MAX_TRIES_FOR_FEASIBLE_GRID
        from mobocmf_tpu_torch.bo.recommend import recommendation_model_pass
        from mobocmf_tpu_torch.fit import trainer
        from mobocmf_tpu_torch.kernels import rbf
        from mobocmf_tpu_torch.linalg import chol, fused_svgp, ops
        from mobocmf_tpu_torch.linalg.ops import ladder_jitter
        from mobocmf_tpu_torch.models import mfdgp as M
        from mobocmf_tpu_torch.profile_k2 import k2_split, yardstick_us
        from mobocmf_tpu_torch.profiling import device_ms, k2_problem, loop_ms, patched
        from mobocmf_tpu_torch.moop.moop import MOOP, SampledFunction
        from mobocmf_tpu_torch.sampling import rff
        from mobocmf_tpu_torch.test_functions import synthetic as S
        from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map
        from mobocmf_tpu_torch.acquisition.mesmoc import MESMOC_MFGP
        from mobocmf_tpu_torch.examples import example_mesmoc_mfgp
        from mobocmf_tpu_torch.examples.example_batch_bo_10d import main as batch10d_main
        from mobocmf_tpu_torch.examples.example_dtlz2_2048 import main as dtlz2_main
        from mobocmf_tpu_torch.models import mfgp
        from mobocmf_tpu_torch.fit import conditioned, graphs
        from mobocmf_tpu_torch.acquisition import jesmoc
        from mobocmf_tpu_torch.models import exact_gp
        from mobocmf_tpu_torch.parallel import sharding
        from mobocmf_tpu_torch.util import counters
        from mobocmf_tpu_torch.examples.example_synthetic_2D import main as synthetic2d_main
        from mobocmf_tpu_torch.examples.example_acquisition_mfdgp_forrester import (
            main as forrester_main)
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repo ({exc})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
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
                            chol=chol, ops=ops, fused_svgp=fused_svgp, counters=counters, M=M,
                            tree_leaves=tree_leaves, tree_map=tree_map, device_ms=device_ms,
                            loop_ms=loop_ms,
                            JESMOC_MFDGP=JESMOC_MFDGP, coupled_acq_stacked=coupled_acq_stacked,
                            optimize=optimize, lbfgs=lbfgs, rbf=rbf,
                            ladder_jitter=ladder_jitter,
                            recommendation_model_pass=recommendation_model_pass,
                            k2_problem=k2_problem, k2_split=k2_split,
                            yardstick_us=yardstick_us, loop=loop, BOConfig=loop.BOConfig,
                            rff=rff, MAX_TRIES_FOR_FEASIBLE_GRID=MAX_TRIES_FOR_FEASIBLE_GRID,
                            MESMOC_MFGP=MESMOC_MFGP, mesmoc_example=example_mesmoc_mfgp,
                            mfgp=mfgp, dtlz2_main=dtlz2_main, batch10d_main=batch10d_main,
                            patched=patched, conditioned=conditioned, graphs=graphs,
                            exact_gp=exact_gp, jesmoc=jesmoc, MOOP=MOOP,
                            SampledFunction=SampledFunction, sharding=sharding)
        phase_seconds, searches = {}, {}

        def timed(name, fn, *args):
            t = time.perf_counter()
            with SearchLog() as log:
                out = fn(*args)
            phase_seconds[name] = time.perf_counter() - t
            if log.runs:
                searches[name] = search_summary(name, log.runs)
            print(f"[phase] {name}: {phase_seconds[name]:.1f} s", flush=True)
            return out

        k1 = timed("k1", phase_k1, P)
        k2 = timed("k2", phase_k2, P)
        timed("reference", phase_reference, P)
        steps = {}

        def stepped(name, fn, *args):
            """A path with its captured phases' steps per second."""
            with StepsLog(P) as log:
                out = timed(name, fn, *args)
            steps[name] = steps_summary(name, log.records)
            return out

        bc512 = [
            ("branin", (S.branin_scaled_low, S.branin_scaled), False),
            ("currin", (S.currin_low, S.currin), False),
            ("disk", (S.disk_constraint, S.disk_constraint), True),
        ]
        run_a = stepped("bc512", run_slice, P, "bc512", bc512, 490, 100, COND_ITERS)
        small_disk = functools.partial(S.disk_constraint, radius=0.4)
        bench128 = bc512 + [("disk04", (small_disk, small_disk), True)]
        run_b = stepped("b128", run_slice, P, "b128", bench128, 120, 50, COND_ITERS, True)
        run_var = timed("variants", phase_variants, P, bench128)
        P.loop_blackboxes = bench_blackboxes(torch.device("cuda"))
        with tempfile.TemporaryDirectory() as tmp:
            run_loop_a = stepped("loop", phase_loop, P, Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            run_mes = stepped("mesmoc", phase_mesmoc, P, Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            run_dtlz2 = stepped("dtlz2_2048", phase_dtlz2, P, Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            run_b10 = stepped("batch10d", phase_batch10d, P, Path(tmp))
        run_s2d = stepped("synthetic2d", phase_pipeline, P, "synthetic2d", synthetic2d_main, [],
                          ["gap_uncond", "gap_cond"])
        run_forr = stepped("forrester", phase_pipeline, P, "forrester", forrester_main,
                           ["--fast"], ["gap_fitter", "gap_jes"])
        with tempfile.TemporaryDirectory() as tmp:
            run_mesh = timed("mesh", phase_mesh, P, Path(tmp))
        timed("k1 timings", time_k1, P, k1)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    k1_rec = k1[("f32", 3, 512)]
    k2_rec = k2[("bc512-screen", "f32", 6, 512, 200)]
    for name, r in (("bc512", run_a), ("b128", run_b)):
        print(f"[summary] {name}: K1 launches {r['k1_train']} for {r['steps']} training steps, "
              f"{r['k1_slice']} in Pareto sampling + conditioned training + acquisition; "
              f"K2 launches {r['k2_acq']} (screening) + {r['k2_rec']} (recommendation); "
              f"stages: Pareto {r['t_pareto']:.3f} s, conditioned "
              f"{r['cond_iters'] / r['t_cond']:.2f} steps/s, acquisition {r['t_acq']:.3f} s, "
              f"recommendation {r['t_rec']:.3f} s", flush=True)
    print("[summary] captured phases, steps/s without the capture: " + ", ".join(
        f"{name} {st['steps_per_s']:.2f} ({st['phases']} phases, {st['replays']} replays, "
        f"capture {st['capture_seconds']:.3f} s)" for name, st in steps.items()), flush=True)
    rounded = {k: round(v, 1) for k, v in phase_seconds.items()}
    print(f"[summary] phase seconds {json.dumps(rounded)}", flush=True)
    print("[summary] L-BFGS runs per path (seconds, evaluations per iteration, mean line-search "
          "steps per lane and iteration, ms per evaluation, captured runs): " + "; ".join(
              f"{name} {kind} {row['runs']} x ({row['seconds']:.3f} s, "
              f"{row['evals_per_iteration']:.3f}, {row['ls_steps_mean']:.3f}, "
              f"{row['ms_per_evaluation']:.3f}, {row['captured']})"
              for name, rows in searches.items() for kind, row in rows.items()), flush=True)
    arms = run_b["arms"]
    print(f"[summary] b128 f32 search at full depth, captured / eager: "
          f"{arms['captured_seconds']:.3f} / {arms['eager_seconds']:.3f} s, "
          f"{arms['captured_evals']} / {arms['eager_evals']} evaluations", flush=True)
    print(f"[summary] total {time.perf_counter() - t_start:.1f} s", flush=True)
    small = k1[("f32-noladder", 1, 32)]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "chol",
            "route": "cuda",
            "source": "mobocmf_tpu_torch/csrc/chol.cu",
            "replaces": "mobocmf_tpu/linalg/chol.py:61",
            "launches": run_a["k1_train"] + run_a["k1_slice"],
            "launches_by_path": {"bc512": run_a["k1_train"] + run_a["k1_slice"],
                                 "b128": run_b["k1_train"] + run_b["k1_slice"],
                                 "loop": run_loop_a["k1"], "mesmoc": run_mes["k1"],
                                 "dtlz2_2048": run_dtlz2["k1"], "batch10d": run_b10["k1"],
                                 "synthetic2d": run_s2d["k1"], "forrester": run_forr["k1"],
                                 "variants": run_var["k1"],
                                 **{k: v["k1"] for k, v in run_mesh.items()}},
            "at_mesmoc_shape": {key: small[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "max_abs_err": k1_rec["max_abs_err"],
            "ms": k1_rec["ms"],
            "plain_ms": k1_rec["plain_ms"],
            "bound_ms": k1_rec["bound_ms"],
            "bound_by": k1_rec["bound_by"],
            "library_ms": k1_rec["library_ms"],
        },
        {
            "name": "fused_svgp",
            "route": "cuda",
            "source": "mobocmf_tpu_torch/csrc/fused_svgp.cu",
            "replaces": "mobocmf_tpu/linalg/fused_svgp.py:100",
            "launches": run_a["k2_acq"] + run_a["k2_rec"],
            "launches_by_path": {"bc512": run_a["k2_acq"] + run_a["k2_rec"],
                                 "b128": run_b["k2_acq"] + run_b["k2_rec"],
                                 "loop": run_loop_a["k2"], "mesmoc": run_mes["k2"],
                                 "dtlz2_2048": run_dtlz2["k2"], "batch10d": run_b10["k2"],
                                 "synthetic2d": run_s2d["k2"], "forrester": run_forr["k2"],
                                 "variants": run_var["k2"],
                                 **{k: v["k2"] for k, v in run_mesh.items()}},
            "at_path_shapes": {name: dict(shape=r["k2_shape"], **r["k2_timing"])
                               for name, r in (("dtlz2_2048", run_dtlz2), ("batch10d", run_b10))},
            "max_abs_err": k2_rec["max_abs_err"],
            "ms": k2_rec["ms"],
            "plain_ms": k2_rec["plain_ms"],
            "bound_ms": k2_rec["bound_ms"],
            "bound_by": k2_rec["bound_by"],
            "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
