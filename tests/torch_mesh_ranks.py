"""What the ranks of tests/test_torch_sharding.py run (importable by the
spawned ranks, which import no JAX): each function takes plain data,
builds the mesh from the group it runs in, runs one sharded port path at
f64 on the CPU and returns numpy results. The test process runs the
unsharded side (the port's or the JAX package's) and compares."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.models.convert import model_from_numpy
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util import counters
from mobocmf_tpu_torch.util.tree import tree_leaves

F64 = torch.float64


def mesh(bb: int):
    return sharding.make_mesh(bb=bb, device="cpu")


def leaves_np(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def port_model(model_np, device="cpu"):
    params, consts, config = model_np
    return model_from_numpy(params, consts, config, device, F64)


def t64(a, device="cpu"):
    return None if a is None else torch.as_tensor(np.asarray(a), device=device)


def mesh_shape(bb: int):
    m = mesh(bb)
    return (sharding.axis_size(m, "bb"), sharding.axis_size(m, "dp"),
            sharding.axis_rank(m, "bb"), sharding.axis_rank(m, "dp"), dist.get_rank())


def shard_rows(bb: int, x):
    local, padded = sharding.shard_rows(mesh(bb), torch.as_tensor(x))
    return local.numpy(), padded


def grid_fns():
    return [lambda x: torch.sin(3 * x[:, 0]) + x[:, 1], lambda x: torch.prod(x, dim=1)]


def grid_eval(bb: int, grid):
    return sharding.sharded_grid_eval(grid_fns(), torch.as_tensor(grid), mesh(bb))


def train_stacked(bb: int, model_np, x, ys, fid, epochs, lr, mask_kind, batch_size, eps,
                  perms=None, flat_adam=False):
    """flat_adam: MOBOCMF_FLAT_ADAM=1 while the phase builds its optimizer."""
    before = os.environ.get("MOBOCMF_FLAT_ADAM")
    os.environ["MOBOCMF_FLAT_ADAM"] = "1" if flat_adam else "0"
    try:
        params, logs = trainer.train_phase_stacked(
            port_model(model_np), t64(x), t64(ys), t64(fid), epochs, lr, mask_kind, batch_size,
            eps=t64(eps), perms=t64(perms), mesh=mesh(bb))
    finally:
        if before is None:
            os.environ.pop("MOBOCMF_FLAT_ADAM")
        else:
            os.environ["MOBOCMF_FLAT_ADAM"] = before
    return leaves_np(params), logs.loss.numpy(), logs.kl.numpy()


def inducing_step(bb: int, model_np, x, ys, fid, epochs, lr, mask_kind, eps):
    """Training with the inducing rows sharded over 'dp': (whole params, logs)."""
    m = mesh(bb)
    model = port_model(model_np)
    params, consts = sharding.shard_inducing(m, model.params, model.consts)
    params, logs = trainer.train_phase_stacked(
        model._replace(params=params, consts=consts), t64(x), t64(ys), t64(fid), epochs, lr,
        mask_kind, x.shape[0], eps=t64(eps))
    return leaves_np(sharding.unshard_inducing(params, consts)), logs.loss.numpy()


def inducing_predictive(bb: int, model_np, x, eps):
    """A no-grad forward of the inducing-sharded model: (each layer's mu and
    var, the calls of layer 0's K2 route)."""
    from mobocmf_tpu_torch.models import mfdgp as M

    model = port_model(model_np)
    params, consts = sharding.shard_inducing(mesh(bb), model.params, model.consts)
    k2 = M.fused_rbf_svgp_forward
    calls = []
    M.fused_rbf_svgp_forward = lambda *a: calls.append(1) or k2(*a)
    try:
        with torch.no_grad():
            out = M.forward(params, consts, model.config, t64(x), t64(eps))
    finally:
        M.fused_rbf_svgp_forward = k2
    return [(mu.numpy(), var.numpy()) for mu, var in out], len(calls)


def conditioned(bb: int, obj_np, con_np, data_np, batch_size, draws_np, iters, lr, eps_const,
                fused=None):
    """Conditioned training over ('bb', 'dp') with the draws given: (obj
    leaves, con leaves, losses). fused: the loss's form (None: the default)."""
    om, cm = port_model(obj_np), port_model(con_np)
    data = C.ConditionedData(*[t64(a) for a in data_np])
    draws = [C.StepDraws(t64(b), t64(xt), t64(e)) for b, xt, e in draws_np]
    op, cp, losses = C.train_conditioned(
        om.params, cm.params, om.consts, cm.consts, om.config, data, None, iters, lr, eps_const,
        batch_size, draws=draws, mesh=mesh(bb), fused=fused)
    return leaves_np(op), leaves_np(cp), losses.numpy()


# ---------------------------------------------------------------------------
# Card only (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def collectives_on_card():
    """Every collective the port uses, on CUDA tensors of this rank's card."""
    dev = torch.device("cuda", torch.cuda.current_device())
    r = dist.get_rank()
    m = sharding.make_mesh()
    grp = m.get_group("dp")
    out = {"transport": sharding.transport(m), "backend": dist.get_backend()}
    out["all_reduce"] = sharding.all_reduce(torch.full((3,), r + 1.0, device=dev), grp).cpu()
    out["all_gather"] = sharding.all_gather(torch.full((2, 2), float(r), device=dev), grp, 1).cpu()
    out["broadcast"] = sharding.broadcast(torch.full((2,), float(r), device=dev)).cpu()
    out["object"] = sharding.broadcast_object(m, {"rank": r})
    a = torch.full((2,), r + 1.0, device=dev, requires_grad=True)
    (sharding.gather(a, grp) ** 2).sum().backward()
    out["gather_grad"] = a.grad.cpu()
    x = torch.tensor([2.0], device=dev, requires_grad=True)
    v = sharding.reduce(sharding.enter(x, grp) * (r + 1), grp)
    v.backward()
    out["enter_reduce"] = (v.item(), x.grad.item())
    return out


def training_on_card(model_np, x, ys, fid, epochs, eps):
    """One f64 full-batch phase over a (1 x world) mesh on the card: (the
    phase's capture record, losses, the collectives counted)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stats: dict = {}
    m = sharding.make_mesh()
    counters.reset()
    _, logs = trainer.train_phase_stacked_chunked(
        port_model(model_np, dev), t64(x, dev), t64(ys, dev), t64(fid, dev), epochs, 0.003,
        "all_free", x.shape[0], eps=t64(eps, dev), stats=stats, mesh=m)
    return stats, logs.loss.cpu().numpy(), counters.get("collectives")


# ---------------------------------------------------------------------------
# CPU cases (tests/test_torch_sharding.py)
# ---------------------------------------------------------------------------


def mesh_rejects(bb: int) -> str:
    try:
        sharding.make_mesh(bb=bb, device="cpu")
    except ValueError as exc:
        return str(exc)
    return ""


def moop_fns():
    return ([lambda x: (x[:, 0] - 0.3) ** 2 + x[:, 1] ** 2,
             lambda x: (x[:, 0] - 0.7) ** 2 + x[:, 1] ** 2],
            [lambda x: 0.6 - x[:, 1]])


def moop(bb: int, inputs, grid, polish):
    from mobocmf_tpu_torch.moop.moop import MOOP

    objs, cons = moop_fns()
    sol, _, _ = MOOP(objs, cons, input_dim=2, grid_size=100, pareto_set_size=8,
                     feasible_values=np.zeros(1), polish=polish, mesh=mesh(bb)
                     ).compute_pareto_solution_from_samples(inputs, grid=grid,
                                                            like=torch.zeros((), dtype=F64))
    return sol.pareto_set.numpy(), sol.pareto_front.numpy(), sol.num_valid


def dp_gradients(bb: int, model_np, x, ys, fid, eps, num_data):
    """The gradient of the stacked negative ELBO from this rank's rows,
    summed over 'dp' (trainer.sum_over_dp), and the loss."""
    from mobocmf_tpu_torch.mlls.elbo import elbo_terms
    from mobocmf_tpu_torch.util.tree import tree_map

    m = mesh(bb)
    model = port_model(model_np)
    rows = trainer.dp_block(m, x.shape[0])
    params = tree_map(lambda t: t.clone().requires_grad_(True), model.params)
    elbo, _ = elbo_terms(params, model.consts, model.config, t64(x)[rows], t64(ys)[:, rows],
                         t64(fid)[rows], t64(eps)[..., rows], torch.tensor(num_data, dtype=F64),
                         weights=torch.ones(rows.stop - rows.start, dtype=F64))
    loss = -torch.sum(elbo)
    loss.backward()
    grads = [p.grad for p in tree_leaves(params)]
    total = loss.detach().reshape(1)
    trainer.sum_over_dp(m, grads + [total])
    return [g.numpy() for g in grads], float(total)


def jes(bb: int, pair_np, grid, raw, maxiter):
    """The coupled gains (values and the gradient of their sum in x) at
    every fidelity, and the all-fidelity search from the raw points given."""
    from mobocmf_tpu_torch.acquisition import jesmoc

    m = mesh(bb)
    su, sc = port_model(pair_np[0]), port_model(pair_np[1])
    args = (su.params, su.consts, sc.params, sc.consts, su.config)
    gains, grads = [], []
    for f in range(su.config.num_fidelities):
        x = t64(grid).requires_grad_(True)
        g = jesmoc.coupled_acq_stacked(*args, f, x, mesh=m)
        torch.sum(g).backward()
        gains.append(g.detach().numpy())
        grads.append(x.grad.numpy())
    xs, vals = jesmoc.optimize_coupled_jes_all_fidelities(
        *args, None, grid.shape[1], num_restarts=2, raw_samples=raw.shape[0], maxiter=maxiter,
        raw=t64(raw), mesh=m)
    return np.stack(gains), np.stack(grads), xs.numpy(), vals.numpy()


def rff_features(bb: int, seed: int, n_features: int, grid):
    """A prior sample's values and their gradient in x, layer-0 features
    sharded over 'dp', and the whole sample's."""
    from mobocmf_tpu_torch.sampling import rff

    m = mesh(bb)
    sample = rff.sample_prior(torch.Generator().manual_seed(seed), grid.shape[1], 2,
                              n_features=n_features, dtype=F64, device="cpu")
    out = []
    for s, mm in ((sharding.shard_features(m, sample), m), (sample, None)):
        x = t64(grid).requires_grad_(True)
        v = rff.eval_sample(s, x, mesh=mm)
        torch.sum(v).backward()
        out += [v.detach().numpy(), x.grad.numpy()]
    return out


def _bowl(shift, offset):
    return lambda xs: (np.atleast_2d(xs)[:, 0] - shift) ** 2 + np.atleast_2d(xs)[:, 1] ** 2 + offset


def loop_blackboxes():
    """tests/test_torch_loop.py's problem: two bowls and a half-box constraint."""
    from mobocmf_tpu_torch.bo.loop import Blackbox

    con = lambda xs: 0.55 - np.atleast_2d(xs)[:, 0]  # noqa: E731
    return [Blackbox("obj1", [_bowl(0.25, 0.3), _bowl(0.25, 0.0)]),
            Blackbox("obj2", [_bowl(0.75, 0.3), _bowl(0.75, 0.0)]),
            Blackbox("con1", [con, con], is_constraint=True, threshold=0.0)]


def bo_loop(bb: int, x, fid, config_kw, log_dir):
    """run_bo_loop over the mesh (rank 0 writes `log_dir`): the final state."""
    from mobocmf_tpu_torch.bo.loop import BOConfig, run_bo_loop

    cfg = BOConfig(**config_kw, log_dir=log_dir, mesh=mesh(bb), device="cpu", dtype=F64)
    st = run_bo_loop(loop_blackboxes(), x, fid, cfg)
    return st.x, st.fidelities, st.ys, st.hypervolumes


def fail():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hang():
    if dist.get_rank() == 1:
        import time

        time.sleep(3600)
    dist.barrier()
