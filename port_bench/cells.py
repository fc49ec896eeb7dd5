"""The one general driver of the benchmark's traffic: set-up, window and the
program's outputs for each kind of traffic a traffic file names.

- `train`: one training phase of the stacked models (every blackbox at
  once, full batch) through fit/trainer.py's `TrainPhase`, the object
  `train_phase_stacked_chunked` builds for the fitter, with the fitter's
  chunk sizes, draws per chunk and finiteness check per chunk.
- `cond`: conditioned retraining of the stacked objectives and constraints
  on a Pareto solution, through fit/conditioned.py's `ConditionedPhase`,
  the object `train_conditioned_chunked` builds, chunked alike.

Both start from the initial model. Set-up builds the phase object once,
drives its first three steps from the seed, then warms up on the cell's
own shapes; the window hands the same object more steps. The window's
last `tail_steps` steps are a chunk of their own, run from a snapshot of
the phase's state (parameters and Adam's moments) taken just before it.
The reference follows the first three steps from its own initial model,
and the tail's steps from that snapshot. A traffic file holds the
parameters; a configuration file the problem and the settings.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import problems
from port_bench.reference import mfdgp as R


DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64)}
ADAM_B1 = 0.9  # optax.adam's, as the program's Adam is set


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def flat_params(params) -> Dict[str, torch.Tensor]:
    """The program's MFDGPParams as the reference's flat dict (by name)."""
    out = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                out[prefix + k] = v

    for ell, lp in enumerate(params.layers):
        walk(f"l{ell}.", lp.kernel)
        out[f"l{ell}.mean"] = lp.variational.mean
        out[f"l{ell}.chol_raw"] = lp.variational.chol_raw
    out["raw_noises"] = params.raw_noises
    return out


def detached(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in d.items()}


def phase_params(phase) -> Dict[str, torch.Tensor]:
    """The phase's parameters now (the whole stack), copied."""
    return detached(flat_params(phase.trainable.values()))


def adam_moments(phase) -> Dict[str, Dict[str, torch.Tensor]]:
    """Adam's first and second moments of every parameter, copied, read
    from the program's optimizer carry: the state that
    trainer.train_phase_stacked_carry and conditioned.train_conditioned_carry
    return as `opt_state` and a phase takes back (per Adam tensor: step,
    exp_avg, exp_avg_sq; one flat tensor under MOBOCMF_FLAT_ADAM=1)."""
    from mobocmf_tpu_torch.util.tree import tree_leaves, tree_unflatten

    like = phase.trainable.values()
    leaves = tree_leaves(like)
    carry = phase.trainable.opt.state_dict()
    index = [i for g in carry["param_groups"] for i in g["params"]]
    out = {}
    for key in ("exp_avg", "exp_avg_sq"):
        ts = [carry["state"].get(i, {}).get(key) for i in index]
        if len(ts) == 1 and len(leaves) > 1:  # one flat tensor
            flat = (torch.cat([t.reshape(-1) for t in leaves]).zero_() if ts[0] is None
                    else ts[0].reshape(-1))
            ts = [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in leaves]), leaves)]
        ts = [torch.zeros_like(t) if s is None else s for s, t in zip(ts, leaves)]
        out[key] = detached(flat_params(tree_unflatten(like, ts)))
    return out


class Cell:
    """A cell's program state after set-up. `first` holds the program's
    outputs of the three steps the reference follows from the initial
    model, `last` those of the window's tail."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.marks: List[tuple] = []  # (set-up stage, host clock at its end)
        self.dtype, self.held = DTYPES[config["dtype"]]
        self.data = problems.design(config, seed, device)
        self.mark("data")
        d = self.data
        n_real = d.x.shape[0]
        # batch_size = the real rows: full batch, which covers the padded rows
        self.fitter = BlackBoxMFDGPFitter(
            config["num_fidelities"], n_real, lr_1=config["lr_1"], lr_2=config["lr_2"],
            pareto_set_size=config["pareto_set_size"], seed=seed, pad_data=True,
            device=device, dtype=self.dtype)
        for name, is_con, y, thr in zip(d.names, d.is_con, d.ys, d.thresholds):
            self.fitter.initialize_mfdgp(d.x, y, d.fid, name, threshold_constraint=thr,
                                         is_constraint=is_con)
        self.n = self.fitter.x_train.shape[0]
        self.first: dict = {}
        self.last: dict = {}
        self.done = 0  # steps the phase has run
        self.chunk_ends: List[tuple] = []  # (steps, host clock after the chunk)
        self.mark("model init")

    def mark(self, stage: str):
        sync(self.device)
        self.marks.append((stage, time.perf_counter()))

    # the blackboxes in the stacked order: objectives, then constraints
    def order(self) -> List[int]:
        d = self.data
        return [i for i, c in enumerate(d.is_con) if not c] + [i for i, c in enumerate(d.is_con) if c]

    def padded(self):
        from port_bench.bucket import pad
        return pad(self.data.x, self.data.fid)

    def padded_y(self, y):
        x_p, _, _ = self.padded()
        return np.concatenate([y, np.zeros(x_p.shape[0] - y.shape[0])])

    def ref_init(self, dtype, device):
        """The reference's own initial model and constants, worked out from
        the data."""
        x_p, f_p, _ = self.padded()
        ys = [self.padded_y(self.data.ys[i]) for i in self.order()]
        return R.init_stacked(x_p, ys, f_p, self.config["num_fidelities"], self.config["jitter"],
                              dtype, device, self.held)

    def ref_rows(self, dtype, device):
        """The padded rows as the reference's tensors: x, fidelities, row
        weights, and the targets as the program holds them."""
        x_p, f_p, w_p = self.padded()
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
        ys = t(np.stack([self.padded_y(self.data.ys[i]) for i in self.order()]))
        return t(x_p), torch.as_tensor(f_p, device=device), t(w_p), ys.to(self.dtype).to(dtype)

    # -- the phase: first steps, warm-up, window, tail --------------------

    def run_draws(self, draws):
        """One chunk on the caller's draws; returns the program's log."""
        raise NotImplementedError

    def draw(self, count):
        raise NotImplementedError

    def start(self):
        """The phase's first three steps (one chunk of one, one of two, the
        first's gradient read from Adam's state between them), then the
        warm-up."""
        draws = self.draw(3)
        self.first["draws"] = draws
        log1 = self.run_draws(self.part(draws, 0, 1))
        self.first["grad"] = {k: v / (1 - ADAM_B1)
                              for k, v in adam_moments(self.phase)["exp_avg"].items()}
        log2 = self.run_draws(self.part(draws, 1, 3))
        self.done += 3
        self.first["log"] = {k: torch.cat([log1[k], log2[k]], -1).detach().clone() for k in log1}
        self.first["p3"] = phase_params(self.phase)
        self.mark("first steps")
        self.warm_up()

    def steps(self, total: int):
        """`total` steps as the fitter runs them: the chunks of
        trainer.chunk_sizes, each drawn before it runs and checked after."""
        for size in self.trainer.chunk_sizes(total, self.n):
            with torch.profiler.record_function(self.span):
                self.run_draws(self.draw(size))
                self.check()
            self.done += size
            self.chunk_ends.append((size, time.perf_counter()))

    def check(self):
        pass

    def warm_up(self):
        """Replays on the cell's shapes (the step is captured by now), then
        as many again timed, to size the window."""
        n = self.traffic["warmup_steps"]
        self.steps(n)
        sync(self.device)
        t0 = time.perf_counter()
        self.steps(n)
        sync(self.device)
        self.rate = n / (time.perf_counter() - t0)
        self.mark("warm-up")

    def window(self, seconds: float) -> dict:
        """As many steps as the warm-up's rate fits into `seconds`, the last
        `tail_steps` of them the tail."""
        k = self.traffic["tail_steps"]
        total = max(k + 1, int(round(self.rate * seconds)))
        sync(self.device)
        t0 = time.perf_counter()
        self.chunk_ends = [(0, t0)]
        self.steps(total - k)
        self.tail()
        sync(self.device)
        return dict(steps=total, seconds=time.perf_counter() - t0)

    def tail(self):
        """The state now (parameters, Adam's moments, the steps run), then
        `tail_steps` steps as one chunk on draws kept for the reference."""
        k = self.traffic["tail_steps"]
        self.last = dict(t0=self.done, params=phase_params(self.phase), **adam_moments(self.phase))
        draws = self.draw(k)
        with torch.profiler.record_function(self.span):
            log = self.run_draws(draws)
            self.check()
        self.done += k
        self.last.update(draws=draws, log={n: v.detach().clone() for n, v in log.items()},
                         after=phase_params(self.phase))

    def program(self) -> dict:
        f, t = self.first, self.last
        out = dict(grad=f["grad"], change={k: f["p3"][k] - self.p0[k] for k in self.p0},
                   change_tail={k: t["after"][k] - t["params"][k] for k in t["params"]})
        for name in f["log"]:
            out[name] = f["log"][name]
            out[name + "_tail"] = t["log"][name]
        return out

    def reference(self, dtype, device) -> dict:
        """The reference's three steps from its own initial model, and its
        tail steps from the program's state before the tail."""
        p0, c = self.ref_init(dtype, device)
        cast = lambda d: {k: v.to(device, dtype) for k, v in d.items()}  # noqa: E731
        p3, outs, g1 = R.adam_steps(p0, self.ref_masks(p0), self.lr, self.ref_loss(
            c, self.first["draws"], dtype, device), 3)
        t = self.last
        moments = (cast(t["exp_avg"]), cast(t["exp_avg_sq"]), t["t0"])
        start = cast(t["params"])
        pk, outs_k, gk = R.adam_steps(start, self.ref_masks(start), self.lr, self.ref_loss(
            c, t["draws"], dtype, device), self.traffic["tail_steps"], moments)
        out = dict(grad=g1, change={k: p3[k] - p0[k] for k in p0}, grad_tail=gk,
                   change_tail={k: pk[k] - start[k] for k in start})
        for i, name in enumerate(self.log_names):
            out[name] = torch.stack([o[i] for o in outs], -1)
            out[name + "_tail"] = torch.stack([o[i] for o in outs_k], -1)
        return out

    def close(self):
        self.phase.close()


class TrainCell(Cell):
    """One training phase (mask, lr from the traffic file) of every
    blackbox stacked, from the initial model."""

    span = "bench.train_chunk"
    log_names = ("loss", "kl")

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from mobocmf_tpu_torch.fit import trainer

        self.trainer = trainer
        f = self.fitter
        models = [f.models_objs[n] for n in f.obj_names] + [f.models_cons[n] for n in f.con_names]
        stacked = trainer.stack_models(models)
        num_data = torch.tensor(float(f.num_real), dtype=f.dtype, device=device)
        self.lr = config[traffic["lr"]]
        self.phase = trainer.TrainPhase(
            stacked, f.x_train, torch.stack(f.ys_objs + f.ys_cons), f.fidelities, self.lr,
            traffic["mask"], self.n, f.row_weights, num_data, chunk=trainer.chunk_size_for(self.n))
        self.p0 = detached(flat_params(stacked.params))
        self.start()

    def draw(self, count):
        ph, f = self.phase, self.fitter
        return self.trainer.draw_chunk(f.generator, ph.config, count, ph.total_models, self.n,
                                       ph.bsz, f.dtype, self.device)

    @staticmethod
    def part(draws, a, b):
        eps, perms = draws
        return eps[a:b], None if perms is None else perms[a:b]

    def run_draws(self, draws):
        log = self.phase.run_chunk(*draws)
        return dict(loss=log.loss, kl=log.kl)

    def check(self):
        self.phase.check_finite("[bench] chunk")

    def ref_masks(self, p):
        return R.masks_for(p, self.traffic["mask"])

    def ref_loss(self, c, draws, dtype, device):
        x, fid, w, y = self.ref_rows(dtype, device)
        eps = draws[0].to(device=device, dtype=dtype)
        num_data = float(self.data.x.shape[0])

        def loss(p, step):
            return R.neg_elbo(p, c, x, y, fid, w, eps[step], num_data)

        return loss


def plain_pareto(cell: Cell, params: Dict[str, torch.Tensor], consts: R.Consts, num_obj: int,
                 size: int, grid_points: int, seed: int):
    """The benchmark's own Pareto solution: the models' posterior means at
    the top fidelity over a uniform grid drawn from the seed; the
    non-dominated (minimized) objective means among the grid points where
    every constraint mean meets its threshold, thinned evenly to `size`
    rows and padded by repeating rows (mask False)."""
    d = cell.config["d"]
    grid = np.random.default_rng([seed, 1]).uniform(size=(grid_points, d))
    x = torch.as_tensor(grid.astype(cell.held), dtype=torch.float64, device=consts.z_x[0].device)
    with torch.no_grad():
        sts = R.states(params, consts)
        zero = torch.zeros((next(iter(params.values())).shape[0], consts.num_fidelities - 1,
                            x.shape[0]), dtype=x.dtype, device=x.device)
        outs = R.forward(params, consts, sts, x, zero)
    mu = outs[-1][0].cpu().numpy()
    objs, cons = mu[:num_obj].T, mu[num_obj:].T
    thr = np.asarray([cell.data.thresholds[i] for i in cell.order()[num_obj:]])
    ok = np.all(cons >= thr, axis=1) if cons.size else np.ones(len(grid), bool)
    if not ok.any():
        ok = np.sum(np.maximum(thr - cons, 0), axis=1) <= np.min(np.sum(np.maximum(thr - cons, 0), axis=1))
    idx = np.flatnonzero(ok)
    pts = objs[idx]
    dominated = np.array([np.any(np.all(pts <= p, 1) & np.any(pts < p, 1)) for p in pts])
    front = idx[~dominated]
    front = front[np.argsort(objs[front, 0])]
    if len(front) > size:
        front = front[np.round(np.linspace(0, len(front) - 1, size)).astype(int)]
    k = len(front)
    rows = np.concatenate([front, np.repeat(front[:1], size - k)])
    mask = np.arange(size) < k
    return grid[rows].astype(cell.held), objs[rows], mask


class CondCell(Cell):
    """Conditioned retraining of every model, from the initial model, on
    the benchmark's Pareto solution (plain_pareto on the reference's own
    initial model)."""

    span = "bench.cond_chunk"
    log_names = ("loss",)

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from mobocmf_tpu_torch.fit import conditioned as C
        from mobocmf_tpu_torch.fit import trainer
        from mobocmf_tpu_torch.moop.moop import ParetoSolution

        self.C, self.trainer = C, trainer
        f = self.fitter
        self.num_obj = len(f.obj_names)
        p_ref, c_ref = self.ref_init(torch.float64, device)
        pset, pfront, mask = plain_pareto(self, p_ref, c_ref, self.num_obj,
                                          config["pareto_set_size"], traffic["pareto_grid"], seed)
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)  # noqa: E731
        self.solution = ParetoSolution(t(pset), t(pfront), torch.as_tensor(mask, device=device),
                                       int(mask.sum()))
        self.mark("pareto")
        obj = trainer.stack_models([f.models_objs[n] for n in f.obj_names])
        con = trainer.stack_models([f.models_cons[n] for n in f.con_names])
        sol = self.solution
        self.cdata = C.ConditionedData(
            x=f.x_train, ys_obj=torch.stack(f.ys_objs), ys_con=torch.stack(f.ys_cons),
            fidelities=f.fidelities, pareto_set=sol.pareto_set, pareto_front=sol.pareto_front,
            front_mask=sol.mask,
            thresholds=torch.as_tensor(f.thresholds_cons, dtype=f.dtype, device=device),
            row_weights=f.row_weights)
        self.lr = config["lr_2"]
        self.phase = C.ConditionedPhase(obj.params, con.params, obj.consts, con.consts, obj.config,
                                        self.cdata, self.lr, f.eps, self.n,
                                        trainer.chunk_size_for(self.n), fused=C.FUSED_COND_DEFAULT)
        self.p0 = phase_params(self.phase)
        self.start()

    def draw(self, count):
        return self.C.draw_chunk(self.fitter.generator, self.cdata, self.phase.config, self.n,
                                 count)

    def part(self, draws, a, b):
        return self.C.StepDraws(None if draws.batch_idx is None else draws.batch_idx[a:b],
                                draws.x_tilde[a:b], draws.eps[a:b])

    def run_draws(self, draws):
        return dict(loss=self.phase.run_chunk(draws))

    def ref_masks(self, p):
        return R.masks_for(p, "fix_cond")

    def ref_loss(self, c, draws, dtype, device):
        x, fid, w, ys = self.ref_rows(dtype, device)
        sol = self.solution
        pset, front = sol.pareto_set.to(device, dtype), sol.pareto_front.to(device, dtype)
        mask = sol.mask.to(device)
        thr = torch.as_tensor([self.data.thresholds[i] for i in self.order()[self.num_obj:]],
                              dtype=self.dtype).to(device, dtype)
        x_tilde, eps = draws.x_tilde.to(device, dtype), draws.eps.to(device, dtype)

        def loss(p, step):
            return (R.cond_loss(p, c, self.num_obj, x, ys, fid, w, pset, front, mask, thr,
                                x_tilde[step], eps[step], self.fitter.eps),)

        return loss


KINDS = {"train": TrainCell, "cond": CondCell}


def build(config: dict, traffic: dict, seed: int, device) -> Cell:
    return KINDS[traffic["kind"]](config, traffic, seed, torch.device(device))
