"""The multi-device dry run (the port's counterpart of
__graft_entry__.py::dryrun_multichip and its `_dryrun_body`).

    python -m mobocmf_tpu_torch.parallel.dryrun [--devices N] [--size tiny|bench]
                                                 [--device cpu]

`dryrun_multichip(n)` starts n ranks (parallel/launch.py: gloo on the CPU,
gloo on one shared card, NCCL when each rank has a card), factors n into
the mesh (bb, dp) with bb = 2 when n is even, and runs on every rank the
JAX body's stages over the mesh:
1. the unconditioned stacked phases (loss must fall);
2. the conditioned phase on a random Pareto solution (loss must fall);
3. one epoch with the inducing rows sharded over 'dp', and a no-grad
   predictive of that model (layer 0 through K2 on the gathered state);
4. an RFF prior sample with its layer-0 features sharded over 'dp';
5. the MOOP with its grid evaluations sharded over 'dp';
6. the coupled JES gains with the pair stack sharded over 'bb';
7. the all-fidelity JES search over 'bb'.
The same body then runs in this process with mesh=None, and every sharded
result is held to it at the JAX body's tolerances: losses rtol 1e-3 (each
phase's first and last), the gains rtol 1e-4 / atol 1e-6, the Pareto set /
front atol 1e-5 / 1e-4, the search's values re-scored unsharded at its
argmax within 1e-2 (relative, floor 1); the RFF values rtol 1e-5 / atol
1e-5; the inducing-sharded predictive rtol 1e-6 / atol 1e-8 (the same
untrained model either way, its Kzz gathered from row blocks: the
factor's rounding grows with Kzz's condition at m = 2048). Every rank must return the same search
result, its L-BFGS having taken the same line-search steps (lbfgs.last_stats).

The dry run is float64, the only precision at which these checks hold:
at the models' init (likelihood noise 1e-6) an f32 ELBO moves by 0.3 %
with the rows' split (the solves' rounding times 1e6).

Sizes: TINY is the JAX body's problem (2 fidelities, d = 2, 3 dp + dp
rows, 2 bb blackboxes, 20 epochs, 25 conditioned steps); BENCH is the
bench's width (the bench's 2 objectives and 2 constraints, 80 + 40 points
padded to m = 128, 100 + 100 epochs, 100 conditioned steps, a 2000-point
MOOP grid, 50 Pareto points, the search at 5 restarts, 200 raw samples and
200 iterations), with the inducing step at example_dtlz2_2048's width
(m = 2048, d = 6, 3 fidelities, 4 objectives). The port trains the
objectives and constraints together in stage 1 (its fitter's stack),
where the JAX body trains the objectives only.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SEED = 0
DTYPE = torch.float64


class Size(NamedTuple):
    name: str
    points: Optional[Tuple[int, int]]  # (low, high) fidelity rows; None: the JAX body's
    epochs: Tuple[int, int]  # variational hypers fixed, then all free
    cond_iters: int
    pareto_points: int  # the conditioned phase's Pareto solution, and the MOOP's
    features: int  # the sharded RFF sample's
    moop_features: int
    grid_size: Optional[int]  # MOOP grid_size (d * grid_size points); None: 16 dp
    search: Tuple[int, int, int]  # restarts, raw samples, iterations
    inducing: Optional[Tuple[int, int, int, int]]  # (m, d, fidelities, models); None: stage 1's


TINY = Size("tiny", None, (20, 0), 25, 8, 128, 64, None, (2, 32, 15), None)
BENCH = Size("bench", (80, 40), (100, 100), 100, 50, 500, 500, 1000, (5, 200, 200),
             (2048, 6, 3, 4))
SIZES = {s.name: s for s in (TINY, BENCH)}


class DryrunFailed(RuntimeError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise DryrunFailed(what)


def _np(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _to(tree, device):
    from mobocmf_tpu_torch.util.tree import tree_map

    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def _acq_grid(d: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(8).uniform(size=(16, d)), dtype=dtype,
                           device=device)


def _problem(size: Size, bb: int, dp: int, device, dtype):
    """(x, fidelities, row weights, real rows, objective model, constraint
    model, objective ys, constraint ys), the same on every rank."""
    from mobocmf_tpu_torch.bench import bench_blackboxes
    from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
    from mobocmf_tpu_torch.fit import trainer

    rng = np.random.default_rng(SEED)
    if size.points is None:  # __graft_entry__.py::_make_problem
        n_low, n_high = max(3 * dp, 6), max(dp, 2)
        x = np.vstack([rng.uniform(size=(n_high, 2)), rng.uniform(size=(n_low, 2))])
        fid = np.concatenate([np.ones(n_high), np.zeros(n_low)]).astype(np.int32)
        ys = rng.normal(size=(2, n_low + n_high))
        names = [(f"bb{i}", ys[i % 2], i >= bb) for i in range(2 * bb)]
        pad = False
    else:
        n_low, n_high = size.points
        x = rng.uniform(size=(n_low + n_high, 2))
        fid = np.concatenate([np.zeros(n_low), np.ones(n_high)]).astype(np.int32)
        names = []
        for bbox in bench_blackboxes(device):
            y = np.concatenate([bbox.fns[0](x[:n_low]), bbox.fns[1](x[n_low:])]).astype(float)
            names.append((bbox.name, (y - y.mean()) / y.std(), bbox.is_constraint))
        pad = True
    fitter = BlackBoxMFDGPFitter(2, x.shape[0], pad_data=pad, seed=SEED, device=device,
                                 dtype=dtype)
    for name, y, is_con in names:
        fitter.initialize_mfdgp(x, y, fid, name, is_constraint=is_con)
    obj = trainer.stack_models([fitter.models_objs[n] for n in fitter.obj_names])
    con = trainer.stack_models([fitter.models_cons[n] for n in fitter.con_names])
    nd = torch.tensor(float(fitter.num_real), dtype=dtype, device=device)
    return (fitter.x_train, fitter.fidelities, fitter.row_weights, nd, obj, con,
            torch.stack(fitter.ys_objs), torch.stack(fitter.ys_cons))


def _inducing_problem(size: Size, device, dtype):
    """The inducing step's stack and data: stage 1's objectives (TINY), or
    example_dtlz2_2048's width with smooth random targets (BENCH)."""
    from mobocmf_tpu_torch.fit import trainer
    from mobocmf_tpu_torch.models import mfdgp as M

    m, d, nf, nm = size.inducing
    rng = np.random.default_rng(SEED + 1)
    x = rng.uniform(size=(m, d))
    fid = (np.arange(m) % nf).astype(np.int32)
    ys = np.stack([np.sin((k + 2) * x[:, k % d]) + 0.5 * x[:, (k + 1) % d] + 0.1 * fid
                   for k in range(nm)])
    models = [M.init_mfdgp(x, y, fid, nf, generator=torch.Generator().manual_seed(k),
                           device=device, dtype=dtype) for k, y in enumerate(ys)]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return trainer.stack_models(models), t(x).to(dtype), t(ys).to(dtype), t(fid)


class _Stage:
    """A stage's wall clock, K1 / K2 launches and collective time on this
    rank (device synchronized on both ends)."""

    def __init__(self, device, out: dict, name: str):
        self.device, self.out, self.name = device, out, name

    def __enter__(self):
        from mobocmf_tpu_torch.parallel import sharding
        from mobocmf_tpu_torch.util import counters

        self._sync()
        self.k0 = (counters.get("k1.launches"), counters.get("k2.launches"), sharding.seconds,
                   counters.get("collectives"))
        self.t0 = time.perf_counter()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        from mobocmf_tpu_torch.parallel import sharding
        from mobocmf_tpu_torch.util import counters

        self._sync()
        k1, k2, cs, cc = self.k0
        self.out[self.name] = dict(
            seconds=time.perf_counter() - self.t0, k1=counters.get("k1.launches") - k1,
            k2=counters.get("k2.launches") - k2, collective_seconds=sharding.seconds - cs,
            collectives=counters.get("collectives") - cc)
        return False


def body(size: Size, bb: int, dp: int, mesh, device) -> dict:
    """The dry run's stages over `mesh` (None: unsharded) for a (bb, dp)
    layout; plain results (numpy) and this process's per-stage counts."""
    from mobocmf_tpu_torch.acquisition import jesmoc, lbfgs
    from mobocmf_tpu_torch.fit import conditioned as C
    from mobocmf_tpu_torch.fit import trainer
    from mobocmf_tpu_torch.models import mfdgp as M
    from mobocmf_tpu_torch.moop.moop import MOOP, SampledFunction
    from mobocmf_tpu_torch.parallel import sharding
    from mobocmf_tpu_torch.sampling import rff

    device, dtype = torch.device(device), DTYPE
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x, fid, rw, nd, obj, con, ys_obj, ys_con = _problem(size, bb, dp, device, dtype)
    n, d = x.shape
    stages: dict = {}
    res: dict = dict(stages=stages, phases=[])

    # 1. the unconditioned stacked phases over ('bb', 'dp')
    stack = trainer.stack_models([obj, con])
    ys = torch.cat([ys_obj, ys_con])
    first = last = None
    with _Stage(device, stages, "uncond"):
        for epochs, lr, kind in ((size.epochs[0], 0.003, "fix_variational_hypers"),
                                 (size.epochs[1], 0.001, "all_free")):
            if not epochs:
                continue
            stats: dict = {}
            params, logs = trainer.train_phase_stacked_chunked(
                stack, x, ys, fid, epochs, lr, kind, n, rw, nd, generator=gen, stats=stats,
                mesh=mesh)
            stack = stack._replace(params=params)
            loss = _np(logs.loss.sum(dim=0))
            first = loss[0] if first is None else first
            last = loss[-1]
            res["phases"].append(dict(stats, label=kind, loss=loss))
    res["uncond"] = (first, last)
    num_obj = ys_obj.shape[0]
    obj_t = trainer.select_model(stack, 0, num_obj)
    con_t = trainer.select_model(stack, num_obj, stack.params.raw_noises.shape[0])

    # 2. the conditioned phase on a random Pareto solution over ('bb', 'dp')
    p = size.pareto_points
    data = C.ConditionedData(
        x=x, ys_obj=ys_obj, ys_con=ys_con, fidelities=fid,
        pareto_set=torch.as_tensor(np.random.default_rng(3).uniform(size=(p, d)), dtype=dtype,
                                   device=device),
        pareto_front=torch.as_tensor(np.random.default_rng(4).normal(size=(p, num_obj)),
                                     dtype=dtype, device=device),
        front_mask=torch.ones((p,), dtype=torch.bool, device=device),
        thresholds=torch.zeros((ys_con.shape[0],), dtype=dtype, device=device),
        row_weights=rw,
    )
    with _Stage(device, stages, "cond"):
        stats = {}
        op, cp, losses = C.train_conditioned_chunked(
            obj_t.params, con_t.params, obj.consts, con.consts, obj.config, data, gen,
            size.cond_iters, 0.001, 1e-8, n, stats=stats, mesh=mesh)
        res["cond"] = _np(losses)
        res["phases"].append(dict(stats, label="cond", loss=res["cond"]))

    # 3. one epoch with the inducing rows sharded over 'dp'
    if size.inducing is None:
        ind, xi, ysi, fi = obj, x, ys_obj, fid
        wi, ndi = rw, nd
    else:
        ind, xi, ysi, fi = _inducing_problem(size, device, dtype)
        wi = ndi = None
    g_ind = torch.Generator(device=device).manual_seed(SEED + 1)
    eps, _ = trainer.draw_chunk(g_ind, ind.config, 1, ysi.shape[0], xi.shape[0], xi.shape[0],
                                dtype, device)
    if mesh is not None:
        ip, ic = sharding.shard_inducing(mesh, ind.params, ind.consts)
        ind = ind._replace(params=ip, consts=ic)
    xq = xi[:: max(1, xi.shape[0] // 200)]
    with _Stage(device, stages, "inducing"):
        with torch.no_grad():
            out = M.forward(ind.params, ind.consts, ind.config, xq, eps[0, ..., :xq.shape[0]])
        _, logs = trainer.train_phase_stacked(ind, xi, ysi, fi, 1, 0.003,
                                              "fix_variational_hypers", xi.shape[0], wi, ndi,
                                              eps=eps)
    res["inducing"] = _np(logs.loss[:, 0])
    res["inducing_predictive"] = np.stack([_np(torch.stack(o)) for o in out])

    # 4. an RFF prior sample, layer-0 features over 'dp'
    sample = rff.sample_prior(gen, d, 2, n_features=size.features, dtype=dtype, device=device)
    grid = torch.as_tensor(np.random.default_rng(6).uniform(size=(4 * dp if size.grid_size is None
                                                                   else 2 * size.grid_size, d)),
                           dtype=dtype, device=device)
    with _Stage(device, stages, "rff"), torch.no_grad():
        if mesh is None:
            vals = rff.eval_sample(sample, grid)
        else:
            vals = rff.eval_sample(sharding.shard_features(mesh, sample), grid, mesh=mesh)
    res["rff"] = _np(vals)

    # 5. the MOOP, grid evaluations over 'dp'
    samples = [rff.sample_prior(gen, d, 2, n_features=size.moop_features, dtype=dtype,
                                device=device) for _ in range(3)]
    fns = [SampledFunction(rff.eval_sample_fn, s) for s in samples]
    with _Stage(device, stages, "moop"):
        moop = MOOP(fns[:2], fns[2:], input_dim=d,
                    grid_size=16 * dp if size.grid_size is None else size.grid_size,
                    pareto_set_size=p, feasible_values=np.array([-1.0]), polish="none",
                    mesh=mesh)
        out = moop.compute_pareto_solution_from_samples(_np(x), gen, like=x)
    _check(out is not None, "MOOP dry run infeasible")
    sol = out[0]
    res["moop"] = (_np(sol.pareto_set), _np(sol.pareto_front), int(sol.num_valid))

    # 6. the coupled JES gains, pair stack over 'bb'
    pair = (stack.params, stack.consts, trainer.stack_models([
        obj._replace(params=op), con._replace(params=cp)]).params, stack.consts, stack.config)
    acq_grid = _acq_grid(d, dtype, device)
    with _Stage(device, stages, "gains"), torch.no_grad():
        res["gains"] = np.stack([
            _np(jesmoc.coupled_acq_stacked(*pair, f, acq_grid, mesh=mesh))
            for f in range(stack.config.num_fidelities)])

    # 7. the all-fidelity search over 'bb'
    restarts, raw, iters = size.search
    with _Stage(device, stages, "search"):
        xs, vals = jesmoc.optimize_coupled_jes_all_fidelities(
            *pair, gen, d, num_restarts=restarts, raw_samples=raw, maxiter=iters, mesh=mesh)
    res["search"] = (_np(xs), _np(vals))
    res["search_stats"] = dict(lbfgs.last_stats)
    res["pair"] = pair  # the models, for re-scoring the search unsharded
    if device.type == "cuda":
        res["max_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return res


def _rank(size_name: str, bb: int, device: str) -> dict:
    from mobocmf_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(bb=bb, device=device)
    dp = sharding.axis_size(mesh, "dp")
    out = body(SIZES[size_name], bb, dp, mesh, device)
    out["pair"] = _to(out["pair"], "cpu")
    out["transport"] = sharding.transport(mesh)
    return out


def steps_taken(stats: dict) -> dict:
    """lbfgs.last_stats without its one clock reading (capture_seconds)."""
    return {k: v for k, v in stats.items() if k != "capture_seconds"}


def _close(got, want, rtol, atol) -> bool:
    return bool(np.allclose(got, want, rtol=rtol, atol=atol))


def compare(ranks: list, ref: dict, device) -> list:
    """Hold every rank's sharded results to the unsharded run `ref` (the
    module docstring's tolerances); the rows of the per-stage report."""
    from mobocmf_tpu_torch.acquisition import jesmoc
    from mobocmf_tpu_torch.util.tree import tree_leaves

    first, last = ref["uncond"]
    _check(np.isfinite(ref["cond"]).all() and last < first,
           f"unsharded uncond neg-ELBO did not fall: {first} -> {last}")
    # the gains and the search are held to the unsharded function of the
    # same models: the ranks' trained models (all equal after the gathers)
    pair = _to(ranks[0]["pair"], device)
    with torch.no_grad():
        grid = _acq_grid(ref["moop"][0].shape[1], DTYPE, device)
        gains = np.stack([_np(jesmoc.coupled_acq_stacked(*pair, f, grid))
                          for f in range(pair[4].num_fidelities)])
    for r, out in enumerate(ranks):
        u0, u1 = out["uncond"]
        _check(np.isfinite([u0, u1]).all() and u1 < u0,
               f"rank {r}: unconditioned neg-ELBO did not fall: {u0} -> {u1}")
        for a, b in zip(out["phases"], ref["phases"]):
            ends = [0, -1]
            _check(np.isfinite(a["loss"]).all()
                   and _close(a["loss"][ends], b["loss"][ends], 1e-3, 0.0),
                   f"rank {r}: {a['label']} first / last loss {a['loss'][ends]} against the "
                   f"unsharded {b['loss'][ends]}")
        c = out["cond"]
        _check(np.isfinite(c).all() and c[-1] < c[0],
               f"rank {r}: conditioned loss did not fall: {c[0]} -> {c[-1]}")
        _check(_close(out["inducing"], ref["inducing"], 1e-3, 0.0),
               f"rank {r}: inducing-sharded first-epoch loss {out['inducing']} diverged from "
               f"the replicated {ref['inducing']}")
        out["predictive_err"] = float(np.max(np.abs(out["inducing_predictive"]
                                                    - ref["inducing_predictive"])))
        _check(np.isfinite(out["inducing_predictive"]).all()
               and _close(out["inducing_predictive"], ref["inducing_predictive"], 1e-6, 1e-8),
               f"rank {r}: the inducing-sharded predictive is off the replicated one by "
               f"{out['predictive_err']}")
        _check(np.isfinite(out["rff"]).all() and _close(out["rff"], ref["rff"], 1e-5, 1e-5),
               f"rank {r}: feature-sharded RFF values off by "
               f"{np.max(np.abs(out['rff'] - ref['rff']))}")
        (ps, pf, nv), (ps0, pf0, nv0) = out["moop"], ref["moop"]
        _check(nv == nv0 and np.allclose(ps, ps0, atol=1e-5) and np.allclose(pf, pf0, atol=1e-4),
               f"rank {r}: mesh-sharded MOOP diverged from the replicated one")
        _check(all(torch.equal(a, b) for a, b in zip(tree_leaves(out["pair"][:4]),
                                                      tree_leaves(ranks[0]["pair"][:4]))),
               f"rank {r}: its gathered models differ from rank 0's")
        _check(np.isfinite(out["gains"]).all()
               and _close(out["gains"], gains, 1e-4, 1e-6),
               f"rank {r}: bb-sharded gains off the unsharded gains of the same models by "
               f"{np.max(np.abs(out['gains'] - gains))}")
        xs, vals = out["search"]
        _check(np.isfinite(vals).all(), f"rank {r}: non-finite search values")
        _check(np.array_equal(xs, ranks[0]["search"][0]) and
               np.array_equal(vals, ranks[0]["search"][1]),
               f"rank {r}: the search's result differs from rank 0's")
        _check(steps_taken(out["search_stats"]) == steps_taken(ranks[0]["search_stats"]),
               f"rank {r}: the search's L-BFGS took other steps than rank 0's: "
               f"{out['search_stats']} against {ranks[0]['search_stats']}")
        for k, st in out["stages"].items():
            want = ref["stages"][k]
            _check((st["k1"], st["k2"]) == (want["k1"], want["k2"]),
                   f"rank {r}: {k} launched K1 / K2 {st['k1']} / {st['k2']}, the unsharded run "
                   f"{want['k1']} / {want['k2']} (K1 is batched over the local models)")
    xs, vals = ranks[0]["search"]
    for f, v in enumerate(vals):
        with torch.no_grad():
            check = float(jesmoc.coupled_acq_stacked(
                *pair, f, torch.as_tensor(xs[f][None], dtype=DTYPE, device=device))[0])
        _check(abs(check - v) <= 1e-2 * max(1.0, abs(check)),
               f"the sharded search's value at fidelity {f} is not self-consistent: reported "
               f"{v}, re-scored {check}")
    return [dict(rank=r, **{k: out["stages"][k] for k in out["stages"]},
                 max_memory_bytes=out.get("max_memory_bytes"), transport=out["transport"],
                 predictive_err=out["predictive_err"], search_stats=out["search_stats"])
            for r, out in enumerate(ranks)]


def dryrun_multichip(n_devices: int, device=None, size: Size = TINY,
                     timeout_s: float = 1200.0) -> dict:
    """Run the dry run on n_devices ranks and hold it to the unsharded run
    in this process (the module docstring), at float64. device: `cuda`
    unless named. Returns the summary: the mesh, the
    backend, each rank's per-stage seconds, K1 / K2 launches, collective
    seconds and memory, the unsharded run's counts, and the phases' capture
    records. Raises DryrunFailed when a check fails."""
    from mobocmf_tpu_torch.core.device import resolve_device
    from mobocmf_tpu_torch.parallel import launch

    device = resolve_device(device)
    bb = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // bb
    t0 = time.perf_counter()
    with launch.Group(n_devices, device, timeout_s) as group:
        backend = group.backend
        ranks = group.run(_rank, size.name, bb, str(device))
    sharded_s = time.perf_counter() - t0
    ref = body(size, bb, dp, None, device)
    rows = compare(ranks, ref, device)
    first, last = ranks[0]["uncond"]
    c = ranks[0]["cond"]
    summary = dict(mesh=(bb, dp), devices=n_devices, backend=backend, size=size.name,
                   sharded_seconds=sharded_s, ranks=rows, reference=ref["stages"],
                   phases=[{k: v for k, v in ph.items() if k != "loss"}
                           for ph in ranks[0]["phases"]])
    print(f"dryrun_multichip OK: mesh=({bb}x{dp}) devices={n_devices}, "
          f"uncond neg-ELBO {first:.3f} -> {last:.3f}, cond loss {c[0]:.3f} -> {c[-1]:.3f}, "
          f"sharded MOOP == replicated ({ranks[0]['moop'][2]} pareto pts), "
          f"sharded acq gains == replicated; sharded optimizer self-consistent "
          f"(best gain {float(ranks[0]['search'][1].max()):.4f})", flush=True)
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--size", choices=sorted(SIZES), default="tiny")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    summary = dryrun_multichip(args.devices, args.device, SIZES[args.size])
    print(json.dumps(summary, default=float), flush=True)
    return summary


if __name__ == "__main__":
    main()
