"""Pareto-conditioned MFDGP retraining (JES theta / omega factors)
(counterpart of mobocmf_tpu/fit/conditioned.py).

After a Pareto solution (set X*, front F*) is sampled, every objective and
constraint model is retrained jointly (one Adam over the variational
parameters; kernel hyperparameters and noises frozen, mask "fix_cond") on

    sum_obj [ -ELBO_o * N/B  - data_term(X* -> F*_o at top fidelity, no KL) ]
  + sum_con [ -ELBO_c * N/B  - theta_c(X*) ]
  - omega(x_tilde)

with 10 fresh uniform x_tilde points per iteration (reference :277) and

    theta_c = sum_p log[ (1-eps)^Phi(g) * eps^(1-Phi(g)) ],
              g = (mu_c(x*_p) - t_c) / sd_c(x*_p)                    (:227-233)
    omega   = sum_{p,j} log[ eps^q * (1-eps)^(1-q) ],
              q = prod_c Phi(g_c(x_j)) * prod_k Phi(g*_{p,k}(x_j)),
              g*_{p,k} = (F*_{p,k} - mu_k(x_j)) / sd_k(x_j)           (:235-243)

Objective and constraint models are stacked on one blackbox dim and their
inducing chains factored once per step (one K1 launch per layer for all of
them). The loss then takes one of the JAX package's two forms, the same
math on the same draws: fused (its default, MOBOCMF_FUSED_COND=1), one
forward at the rows [batch; X*; x_tilde]; or three forwards
(MOBOCMF_FUSED_COND=0), one each at the batch, at X* and at x_tilde, on
the matching columns of the step's normals. `FUSED_COND_DEFAULT` is read
at import, as the JAX package reads it; the phases read the module's value
when they start. Padded Pareto rows are masked out of the sums. Per step
the randomness is the minibatch (when it is smaller than the data),
x_tilde and the propagation normals; they come from a torch.Generator,
drawn a chunk of steps at a time before the chunk runs, or are injected
(`StepDraws`). The phase runs in bounded chunks as the unconditioned
phases do (fit/trainer.py, fit/graphs.py).

Over a mesh (`mesh=`, parallel/sharding.py) the split follows the
unconditioned phases' (fit/trainer.py), with three rules because the loss
is not a plain sum over rows or blackboxes: objectives and constraints
are sharded over 'bb' separately (each rank keeps its slice of each, and
each constraint its threshold); each 'dp' rank takes its block of the
batch rows and divides its minibatch term by the GLOBAL batch weight sum
(every rank has the whole chunk's draws), so the local terms add up over
'dp'; the Pareto and x_tilde terms (ll, theta, omega) are added by every
'dp' rank divided by the 'dp' size, so the gradient all-reduce counts them
once. omega multiplies over every objective and constraint at x_tilde:
the top layer's means and variances there are gathered over 'bb'
(`sharding.gather`) before the products.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mobocmf_tpu_torch.fit import graphs, trainer
from mobocmf_tpu_torch.mlls.elbo import _data_term, gaussian_expected_log_prob
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util.profiling import span
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map

NUM_OMEGA_POINTS = 10  # reference :277

# the JAX package's switch (mobocmf_tpu/fit/conditioned.py): one forward
# per step at [batch; X*; x_tilde] unless MOBOCMF_FUSED_COND=0
FUSED_COND_DEFAULT = os.environ.get("MOBOCMF_FUSED_COND", "1") == "1"


def loss_theta_factors(cs_mean, cs_var, threshold, eps: float, mask) -> torch.Tensor:
    """Reference :227-233, masked over padded Pareto rows; summed over the
    last dim (one value per leading index)."""
    gamma = (cs_mean - threshold) / torch.sqrt(cs_var)
    cdf = torch.special.ndtr(gamma)
    per_point = math.log(1.0 - eps) * cdf + math.log(eps) * (1.0 - cdf)
    return torch.sum(torch.where(mask, per_point, torch.zeros_like(per_point)), dim=-1)


def loss_omega_factors(
    fs_mean: torch.Tensor,  # (K, J) objective means at x_tilde
    fs_var: torch.Tensor,
    cs_mean: torch.Tensor,  # (C, J)
    cs_var: torch.Tensor,
    thresholds: torch.Tensor,  # (C,)
    pareto_front: torch.Tensor,  # (P, K)
    front_mask: torch.Tensor,  # (P,)
    eps: float,
) -> torch.Tensor:
    """Reference :235-243, masked over padded Pareto rows."""
    gamma_c = (cs_mean - thresholds[:, None]) / torch.sqrt(cs_var)  # (C, J)
    gamma_f = (pareto_front[:, :, None] - fs_mean[None]) / torch.sqrt(fs_var[None])  # (P, K, J)
    prob_feas = graphs.prod(torch.special.ndtr(gamma_c), dim=0)  # (J,)
    prob_dom = graphs.prod(torch.special.ndtr(gamma_f), dim=1)  # (P, J)
    q = prob_feas[None, :] * prob_dom
    per = math.log(eps) * q + math.log(1.0 - eps) * (1.0 - q)
    return torch.sum(torch.where(front_mask[:, None], per, torch.zeros_like(per)))


class ConditionedData(NamedTuple):
    x: torch.Tensor  # (N, d)
    ys_obj: torch.Tensor  # (O, N)
    ys_con: torch.Tensor  # (C, N)
    fidelities: torch.Tensor  # (N,)
    pareto_set: torch.Tensor  # (P, d)
    pareto_front: torch.Tensor  # (P, O)
    front_mask: torch.Tensor  # (P,) bool
    thresholds: torch.Tensor  # (C,)
    row_weights: Optional[torch.Tensor] = None  # (N,) 1 real / 0 padded rows


class StepDraws(NamedTuple):
    """One step's randomness: minibatch rows (None = the whole data),
    x_tilde (10, d), propagation normals (O+C, F-1, b+P+10) for the rows
    [batch; X*; x_tilde]."""

    batch_idx: Optional[torch.Tensor]
    x_tilde: torch.Tensor
    eps: torch.Tensor


def _stack(obj_params, con_params, obj_consts, con_consts):
    params = tree_map(lambda a, b: torch.cat([a, b], dim=0), obj_params, con_params)
    consts = obj_consts._replace(
        acq_eps=torch.cat([obj_consts.acq_eps, con_consts.acq_eps]),
        noise_lower=torch.cat([obj_consts.noise_lower, con_consts.noise_lower]),
        noise_upper=torch.cat([obj_consts.noise_upper, con_consts.noise_upper]),
    )
    return params, consts


class Shard(NamedTuple):
    """One rank's part of the conditioned loss over a mesh: its slices of
    the objectives and constraints, the share of the Pareto and x_tilde
    terms it adds (1 / dp), the 'bb' group omega gathers over (None when
    bb = 1) and the batch's global weight sum."""

    objs: slice
    cons: slice
    once: float
    bb_group: object
    weight_sum: torch.Tensor


def _forwards(params, consts, config, xs: Sequence[torch.Tensor], eps: torch.Tensor, states,
              fused: bool):
    """Each layer's (mu, var) at each row block of `xs`, one list per block;
    eps holds the blocks' normals side by side on its last dim. Fused: one
    forward at the blocks' rows together; else one forward per block."""
    sizes = [x.shape[0] for x in xs]
    if not fused:
        return [M.forward(params, consts, config, x, e, states=states)
                for x, e in zip(xs, eps.split(sizes, dim=-1))]
    outs = M.forward(params, consts, config, torch.cat(xs, dim=0), eps, states=states)
    parts = [list(zip(mu.split(sizes, dim=-1), var.split(sizes, dim=-1))) for mu, var in outs]
    return [[layer[i] for layer in parts] for i in range(len(xs))]


def _loss_stacked(
    params: M.MFDGPParams,
    consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    data: ConditionedData,
    eps_const: float,
    batch_idx: torch.Tensor,
    batch_w: torch.Tensor,
    x_tilde: torch.Tensor,
    eps: torch.Tensor,
    shard: Optional[Shard] = None,
    fused: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conditioned loss of O objectives followed by C constraints,
    stacked on one blackbox dim (O = rows of data.ys_obj), as (the
    blackboxes' terms, omega): the loss is terms - omega. With `shard`,
    params hold this rank's objectives then constraints and batch_idx its
    rows, and the terms are this rank's part (omega is whole). fused: one
    forward at [batch; X*; x_tilde], else three (the module docstring)."""
    objs = slice(None) if shard is None else shard.objs
    cons = slice(None) if shard is None else shard.cons
    once = 1.0 if shard is None else shard.once
    num_obj = data.ys_obj[objs].shape[0]
    top = config.num_fidelities - 1
    n_real = data.x.shape[0] if data.row_weights is None else torch.sum(data.row_weights)
    ys = torch.cat([data.ys_obj[objs], data.ys_con[cons]], dim=0)
    weight_sum = torch.sum(batch_w) if shard is None else shard.weight_sum

    states = trainer.states_stacked(params, consts, config)
    outs_b, outs_p, outs_t = _forwards(params, consts, config,
                                       (data.x[batch_idx], data.pareto_set, x_tilde), eps,
                                       states, fused)

    # minibatch ELBO of every model, rescaled to the real data size; the
    # divisor is clamped so an all-padded minibatch contributes exactly 0
    data_b = _data_term(params, consts, config, outs_b, ys[:, batch_idx],
                        data.fidelities[batch_idx], batch_w)
    kl = M.kl_all_layers(params, consts, config, states=states)
    elbo = data_b - kl * torch.sum(batch_w) / n_real
    losses = -elbo / torch.clamp(weight_sum, min=1.0) * n_real

    mu_p, var_p = outs_p[top]
    noise = M.likelihood_noise(params, consts, top)[:num_obj]
    ll = gaussian_expected_log_prob(
        data.pareto_front[:, objs].mT, mu_p[:num_obj], var_p[:num_obj], noise[:, None]
    )
    front_w = data.front_mask.to(ll.dtype)
    obj_terms = losses[:num_obj] - once * torch.sum(ll * front_w, dim=-1)
    theta = loss_theta_factors(
        mu_p[num_obj:], var_p[num_obj:], data.thresholds[cons, None], eps_const,
        data.front_mask,
    )
    con_terms = losses[num_obj:] - once * theta
    mu_t, var_t = outs_t[top]
    tilde = [mu_t[:num_obj], var_t[:num_obj], mu_t[num_obj:], var_t[num_obj:]]
    if shard is not None and shard.bb_group is not None:
        whole = (data.ys_obj.shape[0],) * 2 + (data.ys_con.shape[0],) * 2
        tilde = [sharding.gather(t, shard.bb_group, 0) if n else t
                 for t, n in zip(tilde, whole)]
    omega = loss_omega_factors(*tilde, data.thresholds, data.pareto_front, data.front_mask,
                               eps_const)
    return torch.sum(obj_terms) + torch.sum(con_terms), omega


def conditioned_loss(
    obj_params: M.MFDGPParams,  # stacked (O, ...)
    con_params: M.MFDGPParams,  # stacked (C, ...), C may be 0
    obj_consts: M.MFDGPConsts,
    con_consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    data: ConditionedData,
    eps_const: float,
    batch_idx: torch.Tensor,
    batch_w: torch.Tensor,
    x_tilde: torch.Tensor,
    eps_o: torch.Tensor,  # (O, F-1, b+P+10)
    eps_c: torch.Tensor,  # (C, F-1, b+P+10)
    fused: bool = True,
) -> torch.Tensor:
    """The conditioned loss with the draws given: x_tilde (10, d) and each
    model's normals for the rows [batch; X*; x_tilde] (the JAX function's
    eps_b, eps_p and eps_t side by side). fused: one forward at those rows
    (the default here and the phases' default); False, the three forwards
    of MOBOCMF_FUSED_COND=0. The JAX function's own default is
    fused=False."""
    params, consts = _stack(obj_params, con_params, obj_consts, con_consts)
    eps = torch.cat([eps_o, eps_c], dim=0)
    terms, omega = _loss_stacked(params, consts, config, data, eps_const, batch_idx, batch_w,
                                 x_tilde, eps, fused=fused)
    return terms - omega


def draw_chunk(
    generator: Optional[torch.Generator],
    data: ConditionedData,
    config: M.MFDGPConfig,
    batch_size: int,
    steps: int,
) -> StepDraws:
    """The draws of `steps` steps at once, each field with a leading step
    dim: minibatch rows (steps, b) (the first b of an argsort of f64
    uniforms; None when the batch is the whole data), x_tilde (steps, 10,
    d), normals (steps, O+C, F-1, b+P+10). A `cond.draw` span."""
    n, d = data.x.shape
    bsz = min(batch_size, n)
    dtype, device = data.x.dtype, data.x.device
    with span("cond.draw"):
        bidx = None
        if bsz < n:
            keys = torch.rand((steps, n), generator=generator, dtype=torch.float64,
                              device=device)
            bidx = torch.argsort(keys, dim=-1)[:, :bsz]
        x_tilde = torch.rand((steps, NUM_OMEGA_POINTS, d), generator=generator, dtype=dtype,
                             device=device)
        num_models = data.ys_obj.shape[0] + data.ys_con.shape[0]
        rows = bsz + data.pareto_set.shape[0] + NUM_OMEGA_POINTS
        eps = torch.randn((steps, num_models, max(config.num_fidelities - 1, 0), rows),
                          generator=generator, dtype=dtype, device=device)
        return StepDraws(batch_idx=bidx, x_tilde=x_tilde, eps=eps)


def _stack_draws(draws: Sequence[StepDraws]) -> StepDraws:
    """Per-step draws (the caller's) as one chunk."""
    bidx = None if draws[0].batch_idx is None else torch.stack([d.batch_idx for d in draws])
    return StepDraws(bidx, torch.stack([d.x_tilde for d in draws]),
                     torch.stack([d.eps for d in draws]))


class ConditionedPhase:
    """One conditioned phase: the stacked objective + constraint parameters,
    Adam, the buffers of a chunk of at most `chunk` steps, and the step that
    graphs.Steps runs. `run_chunk(draws)` runs as many steps as the chunk's
    draws have rows and returns their losses. mesh: this rank's slices of
    the objectives and constraints and its block of each step's rows (the
    module docstring); the draws are the whole phase's. fused: the loss's
    form (None: FUSED_COND_DEFAULT)."""

    def __init__(self, obj_params, con_params, obj_consts, con_consts, config, data,
                 lr: float, eps_const: float, batch_size: int, chunk: int = 1,
                 opt_state: Optional[dict] = None, mesh=None, fused: Optional[bool] = None):
        self.config, self.data, self.eps_const = config, data, eps_const
        self.mesh = mesh
        self.fused = FUSED_COND_DEFAULT if fused is None else fused
        num_obj, num_con = data.ys_obj.shape[0], data.ys_con.shape[0]
        objs, cons = trainer.model_block(mesh, num_obj), trainer.model_block(mesh, num_con)
        self.num_obj = objs.stop - objs.start
        n, d = data.x.shape
        dev, dtype = data.x.device, data.x.dtype

        def part(params, consts, sl):
            m = trainer.select_model(M.MFDGPModel(params, consts, config), sl.start, sl.stop)
            return m.params, m.consts

        (op, oc), (cp, cc) = part(obj_params, obj_consts, objs), part(con_params, con_consts, cons)
        all_p, self.consts = _stack(op, cp, oc, cc)
        self.trainable = graphs.Trainable(
            all_p, tree_leaves(trainer.MASK_BUILDERS["fix_cond"](all_p)), lr, opt_state)
        rw = data.row_weights
        self.rw = torch.ones((n,), dtype=dtype, device=dev) if rw is None else rw
        self.full = torch.arange(n, device=dev)

        bsz = min(batch_size, n)
        rows = bsz + data.pareto_set.shape[0] + NUM_OMEGA_POINTS
        # this rank's models in the draws' model dim, and its columns of
        # the rows [batch; X*; x_tilde] (its block of the batch, all of the rest)
        self.cols = trainer.dp_block(mesh, bsz)
        self.models = torch.cat([torch.arange(num_obj, device=dev)[objs],
                                 num_obj + torch.arange(num_con, device=dev)[cons]])
        self.eps_cols = torch.cat([torch.arange(bsz, device=dev)[self.cols],
                                   torch.arange(bsz, rows, device=dev)])
        self.shard = None
        if mesh is not None:
            bb = sharding.axis_size(mesh, "bb")
            self.shard = Shard(objs, cons, 1.0 / sharding.axis_size(mesh, "dp"),
                               mesh.get_group("bb") if bb > 1 else None, None)
        self.index = graphs.StepIndex(dev)
        self.bidx_buf = (None if bsz == n else
                         torch.zeros((chunk, bsz), dtype=torch.int64, device=dev))
        self.xt_buf = torch.zeros((chunk, NUM_OMEGA_POINTS, d), dtype=dtype, device=dev)
        self.eps_buf = torch.zeros((chunk, self.models.shape[0],
                                    max(config.num_fidelities - 1, 0), self.eps_cols.shape[0]),
                                   dtype=dtype, device=dev)
        self.loss_buf = torch.zeros((chunk,), dtype=dtype, device=dev)
        self.steps = graphs.Steps(self._step, dev, self.trainable.tensors,
                                  *sharding.capture_rule(mesh))

    def _step(self) -> None:
        ix = self.index
        bidx = self.full if self.bidx_buf is None else ix.take(self.bidx_buf)
        shard = self.shard
        if shard is not None:
            shard = shard._replace(weight_sum=torch.sum(self.rw[bidx]))
            bidx = bidx[self.cols]
        tr = self.trainable
        tr.zero_grad()
        terms, omega = _loss_stacked(tr.tree(), self.consts, self.config, self.data,
                                     self.eps_const, bidx, self.rw[bidx], ix.take(self.xt_buf),
                                     ix.take(self.eps_buf), shard, self.fused)
        loss = terms - (omega if shard is None else shard.once * omega)
        loss.backward()
        if shard is not None:
            # the logged loss: every rank's terms, and omega once
            logged = (terms - shard.once * omega / sharding.axis_size(self.mesh, "bb")).detach()
            trainer.sum_over_dp(self.mesh, tr.grads() + [logged])
            if shard.bb_group is not None:
                sharding.all_reduce(logged, shard.bb_group)
            loss = logged
        tr.step()
        ix.put(self.loss_buf, 0, loss)
        ix.advance()

    def run_chunk(self, draws: StepDraws) -> torch.Tensor:
        """Spans `cond.stage` (the draws into the buffers), `graphs.run`,
        `cond.log`."""
        steps = draws.x_tilde.shape[0]
        with span("cond.stage"):
            if self.bidx_buf is not None:
                self.bidx_buf[:steps].copy_(draws.batch_idx)
            self.xt_buf[:steps].copy_(draws.x_tilde)
            eps = draws.eps
            if self.shard is not None:
                eps = eps[:, self.models][..., self.eps_cols]
            self.eps_buf[:steps].copy_(eps)
            self.index.reset()
        self.steps.run(steps)
        with span("cond.log"):
            return self.loss_buf[:steps].clone()

    def result(self) -> Tuple[M.MFDGPParams, M.MFDGPParams]:
        """The whole objective and constraint stacks (gathered over 'bb')."""
        params = self.trainable.values()
        op = tree_map(lambda t: t[: self.num_obj], params)
        cp = tree_map(lambda t: t[self.num_obj:], params)
        if self.data.ys_con.shape[0] == 0:
            return trainer.gather_bb(self.mesh, op), cp
        return trainer.gather_bb(self.mesh, op), trainer.gather_bb(self.mesh, cp)

    def close(self) -> None:
        self.steps.close()


def _chunk_draws(generator, phase: ConditionedPhase, batch_size, start, count, draws):
    if draws is None:
        return draw_chunk(generator, phase.data, phase.config, batch_size, count)
    return _stack_draws(draws[start:start + count])


def train_conditioned_carry(
    obj_params: M.MFDGPParams,
    con_params: M.MFDGPParams,
    obj_consts: M.MFDGPConsts,
    con_consts: M.MFDGPConsts,
    config: M.MFDGPConfig,
    data: ConditionedData,
    generator: Optional[torch.Generator],
    num_iters: int,
    lr: float,
    eps_const: float,
    batch_size: int,
    opt_state: Optional[dict] = None,
    draws: Optional[Sequence[StepDraws]] = None,
    mesh=None,
    fused: Optional[bool] = None,
):
    """Joint conditioned Adam steps as one chunk with an explicit
    optimizer-state carry: opt_state None starts fresh, passing it back
    continues. Returns (obj_params, con_params, opt_state, losses
    (num_iters,)).

    Every model sees the same per-step minibatch (identical to the
    reference when batch_size >= N, the examples' default). draws: one
    StepDraws per step (default: drawn from `generator`). mesh: over
    ('bb', 'dp'); opt_state is then this rank's. fused: the loss's form
    (None: FUSED_COND_DEFAULT; the JAX function defaults to False)."""
    phase = ConditionedPhase(obj_params, con_params, obj_consts, con_consts, config, data, lr,
                             eps_const, batch_size, max(num_iters, 1), opt_state, mesh, fused)
    try:
        losses = torch.zeros((0,), dtype=data.x.dtype, device=data.x.device)
        if num_iters:
            losses = phase.run_chunk(_chunk_draws(generator, phase, batch_size, 0, num_iters,
                                                  draws))
        op, cp = phase.result()
        return op, cp, phase.trainable.opt.state_dict(), losses
    finally:
        phase.close()


def train_conditioned(
    obj_params, con_params, obj_consts, con_consts, config, data, generator,
    num_iters: int, lr: float, eps_const: float, batch_size: int,
    draws: Optional[Sequence[StepDraws]] = None,
    mesh=None,
    fused: Optional[bool] = None,
):
    """A fresh conditioned phase as one chunk: (obj_params, con_params,
    losses). fused: None reads FUSED_COND_DEFAULT."""
    op, cp, _, losses = train_conditioned_carry(
        obj_params, con_params, obj_consts, con_consts, config, data, generator,
        num_iters, lr, eps_const, batch_size, draws=draws, mesh=mesh, fused=fused,
    )
    return op, cp, losses


def _check_shared_inducing(obj_consts: M.MFDGPConsts, con_consts: Optional[M.MFDGPConsts]) -> None:
    """The stacked loss reuses one set of inducing inputs for objectives and
    constraints (the coupled-evaluation contract, reference
    blackbox_mfdgp_fitter.py:87-91): refuse models fit on other inputs."""
    if con_consts is None:
        return
    for ell, (zo, zc) in enumerate(zip(obj_consts.z_x, con_consts.z_x)):
        if zo.shape != zc.shape or not torch.equal(zo, zc):
            raise ValueError(
                "conditioned training requires objective and constraint models "
                f"with identical inducing inputs; layer {ell} differs "
                f"(shapes {tuple(zo.shape)} vs {tuple(zc.shape)})"
            )


def train_conditioned_chunked(
    obj_params, con_params, obj_consts, con_consts, config, data, generator,
    num_iters: int, lr: float, eps_const: float, batch_size: int,
    draws: Optional[Sequence[StepDraws]] = None,
    stats: Optional[dict] = None,
    mesh=None,
) -> Tuple[M.MFDGPParams, M.MFDGPParams, torch.Tensor]:
    """The fitter's entry point: checks the shared inducing inputs, then runs
    the phase as bounded chunks (trainer.chunk_sizes at the padded row
    count) with the Adam state carried across them and heartbeat
    `cond:chunk{ci}` after each. Each chunk's draws are made before it runs
    (or taken from `draws`, one StepDraws per step of the phase). `stats`,
    when given, receives the chunks and trainer.steps_stats (warm-up and
    capture seconds, the graph pool's bytes, replays, steps, whether the
    phase was captured and why). mesh: over ('bb', 'dp'). The
    loss's form is the module's FUSED_COND_DEFAULT as it stands at the call,
    as in the JAX package."""
    _check_shared_inducing(obj_consts, con_consts)
    sizes = trainer.chunk_sizes(num_iters, data.x.shape[0])
    phase = ConditionedPhase(obj_params, con_params, obj_consts, con_consts, config, data, lr,
                             eps_const, batch_size, max(sizes, default=1), mesh=mesh,
                             fused=FUSED_COND_DEFAULT)
    (op, cp), losses = trainer.run_chunks(
        phase, sizes,
        lambda start, size: phase.run_chunk(_chunk_draws(generator, phase, batch_size, start,
                                                         size, draws)),
        "cond", stats)
    empty = torch.zeros((0,), dtype=data.x.dtype, device=data.x.device)
    return op, cp, torch.cat(losses) if losses else empty


def empty_like_stack(params: M.MFDGPParams, consts: M.MFDGPConsts) -> Tuple[M.MFDGPParams, M.MFDGPConsts]:
    """Explicitly empty stacked params / consts (leading dim 0), for a
    problem with no constraints."""
    return tree_map(lambda a: a[:0], params), consts._replace(
        acq_eps=consts.acq_eps[:0],
        noise_lower=consts.noise_lower[:0],
        noise_upper=consts.noise_upper[:0],
    )

