"""Two-phase unconditioned MFDGP training, blackboxes stacked on dim 0
(counterpart of mobocmf_tpu/fit/trainer.py).

- phase 1: variational hypers FIXED (likelihood noises + variational
  Cholesky frozen; means + kernel params train), num_epochs_1 @ lr_1;
- phase 2: everything free, num_epochs_2 @ lr_2.

A phase is a run of Adam steps (eps 1e-8, a fresh state per phase) on the
stacked model: the loss is the sum of the blackboxes' negative ELBOs, so
each blackbox gets its own gradient, as under the JAX package's vmap.
Freezing multiplies `.grad` by a 0/1 mask before `step()`. Adam updates
each leaf, or one flat tensor under MOBOCMF_FLAT_ADAM=1 (fit/graphs.py::
Trainable), the JAX package's make_adam switch.

As in the JAX package, a phase runs in bounded chunks of epochs
(`chunk_size_for`, keyed on the padded row count) with the Adam state
carried across them and a heartbeat after each. The chunk's random numbers
are drawn at once before it runs, and on the card the chunk replays one
captured epoch from a CUDA graph (fit/graphs.py); the parameters are
checked for finiteness at every chunk end.

A full-batch epoch takes no permutation (the shuffle would only re-pair
eps draws with rows). The minibatch path follows DataLoader(shuffle=True,
drop_last=False): a fresh permutation per epoch and blackbox, the trailing
partial batch padded and masked with zero weights. The eps (and
permutations) come from a torch.Generator, a chunk at a time, or from the
caller for the whole phase (the parity tests inject the JAX key chain's
draws).
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from mobocmf_tpu_torch.fit import graphs
from mobocmf_tpu_torch.mlls.elbo import elbo_terms
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.parallel import sharding
from mobocmf_tpu_torch.util import heartbeat
from mobocmf_tpu_torch.util.profiling import span
from mobocmf_tpu_torch.util.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Freezing masks (reference mfdgp.py:198-218): one 0/1 factor per leaf
# ---------------------------------------------------------------------------


def _fill(tree, value: float):
    return tree_map(lambda _: value, tree)


def mask_fix_variational_hypers(params: M.MFDGPParams) -> M.MFDGPParams:
    """fix_variational_hypers(True): freeze raw noises + variational chol."""
    layers = tuple(
        M.MFDGPLayerParams(
            kernel=_fill(lp.kernel, 1.0),
            variational=lp.variational._replace(mean=1.0, chol_raw=0.0),
        )
        for lp in params.layers
    )
    return M.MFDGPParams(layers=layers, raw_noises=0.0)


def mask_all_free(params: M.MFDGPParams) -> M.MFDGPParams:
    return _fill(params, 1.0)


def mask_fix_cond(params: M.MFDGPParams) -> M.MFDGPParams:
    """fix_variational_hypers_cond(True): freeze raw noises + all kernel params."""
    layers = tuple(
        M.MFDGPLayerParams(kernel=_fill(lp.kernel, 0.0), variational=_fill(lp.variational, 1.0))
        for lp in params.layers
    )
    return M.MFDGPParams(layers=layers, raw_noises=0.0)


def apply_kernel_freeze(mask, config: M.MFDGPConfig):
    """Zero the kernel masks in freeze-to-prior mode (config.fix_kernel_params)."""
    if not config.fix_kernel_params:
        return mask
    layers = tuple(lp._replace(kernel=_fill(lp.kernel, 0.0)) for lp in mask.layers)
    return mask._replace(layers=layers)


MASK_BUILDERS = {
    "fix_variational_hypers": mask_fix_variational_hypers,
    "all_free": mask_all_free,
    "fix_cond": mask_fix_cond,
}


def build_mask(params: M.MFDGPParams, mask_kind: str, config: M.MFDGPConfig):
    return apply_kernel_freeze(MASK_BUILDERS[mask_kind](params), config)


# ---------------------------------------------------------------------------
# Stacking
# ---------------------------------------------------------------------------


def stack_models(models: List[M.MFDGPModel]) -> M.MFDGPModel:
    """Concatenate models (each with its own leading blackbox dim) on dim 0;
    z_x is shared, so all must have the same inputs and config."""
    config = models[0].config
    if any(m.config != config for m in models):
        raise ValueError("stacked blackboxes must share the same MFDGPConfig")
    params = tree_map(lambda *a: torch.cat(a, dim=0), *[m.params for m in models])
    c0 = models[0].consts
    consts = M.MFDGPConsts(
        z_x=c0.z_x,
        acq_eps=torch.cat([m.consts.acq_eps for m in models], dim=0),
        noise_lower=torch.cat([m.consts.noise_lower for m in models], dim=0),
        noise_upper=torch.cat([m.consts.noise_upper for m in models], dim=0),
    )
    return M.MFDGPModel(params=params, consts=consts, config=config)


def states_stacked(
    params: M.MFDGPParams, consts: M.MFDGPConsts, config: M.MFDGPConfig, with_inv: bool = False
) -> List[M.LayerState]:
    """Per-model layer states of a stacked model (the JAX package vmaps
    compute_layer_states; here the blackbox dim is already written out).
    x-independent: callers evaluating several terms or many candidates
    against the same models compute it once."""
    return M.compute_layer_states(params, consts, config, with_inv=with_inv)


def unstack_params(params: M.MFDGPParams, num_models: int) -> List[M.MFDGPParams]:
    """The B = 1 params of each stacked blackbox (views, no copies)."""
    return [tree_map(lambda a, i=i: a[i : i + 1], params) for i in range(num_models)]


def select_model(model: M.MFDGPModel, i: int, stop: Optional[int] = None) -> M.MFDGPModel:
    """Blackbox i of a stacked model, as a B = 1 model, or blackboxes
    [i, stop) (views, no copies)."""
    stop = i + 1 if stop is None else stop

    def take(a):
        return a[i:stop]

    c = model.consts
    consts = c._replace(
        acq_eps=take(c.acq_eps), noise_lower=take(c.noise_lower), noise_upper=take(c.noise_upper)
    )
    return M.MFDGPModel(params=tree_map(take, model.params), consts=consts, config=model.config)


# ---------------------------------------------------------------------------
# Phase trainer
# ---------------------------------------------------------------------------


class EpochLog(NamedTuple):
    loss: torch.Tensor  # (B, E) summed negative ELBO over the epoch's batches
    kl: torch.Tensor  # (B, E)


def model_block(mesh, num_models: int) -> slice:
    """This rank's contiguous slice of `num_models` stacked models over
    'bb' (all of them without a mesh)."""
    k = sharding.axis_size(mesh, "bb")
    if num_models % k:
        raise ValueError(f"{num_models} stacked models do not divide over bb={k}: a mesh's "
                         "'bb' axis must divide the blackbox stack")
    return sharding.block(num_models, k, sharding.axis_rank(mesh, "bb"))


def dp_block(mesh, n: int) -> slice:
    """This rank's contiguous block of n rows over 'dp' (all without a mesh)."""
    return sharding.block(n, sharding.axis_size(mesh, "dp"), sharding.axis_rank(mesh, "dp"))


def sum_over_dp(mesh, tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the mesh's 'dp' axis in place, in one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    sharding.all_reduce(flat, mesh.get_group("dp"))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def gather_bb(mesh, tree):
    """Every 'bb' rank's slice of a stacked tree, concatenated on dim 0."""
    if sharding.axis_size(mesh, "bb") == 1:
        return tree
    grp = mesh.get_group("bb")
    return tree_map(lambda t: sharding.all_gather(t, grp, 0), tree)


def _batch_plan(num_data: int, batch_size: int) -> Tuple[int, int]:
    batch_size = min(batch_size, num_data)
    return batch_size, math.ceil(num_data / batch_size)


# Chunk schedule, a copy of the JAX package's (mobocmf_tpu/fit/trainer.py):
# chunk sizes keyed on the padded row count = inducing count, so the plan is
# deterministic given the shapes (chunk boundaries set when draws are made).
_CHUNK_LADDER = ((256, 5000), (768, 1000), (1536, 250), (3072, 50))
_CHUNK_MIN = 25


def chunk_size_for(m: int) -> int:
    for cap, c in _CHUNK_LADDER:
        if m <= cap:
            return c
    return _CHUNK_MIN


def chunk_sizes(total: int, m: int) -> List[int]:
    """The chunks of a `total`-step phase at m rows: full chunks, then the
    remainder (read through this module, so a test can patch chunk_size_for)."""
    c = chunk_size_for(m)
    return [c] * (total // c) + ([total % c] if total % c else [])


def draw_chunk(generator, config: M.MFDGPConfig, epochs: int, num_models: int, n: int,
               batch_size: int, dtype, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One chunk's draws: eps (E, B, F-1, n) full batch or (E, B, F-1,
    num_batches*batch) minibatch, and the minibatch permutations (E, B, n)
    (argsort of f64 uniforms, one per epoch and blackbox), else None. A
    `train.draw` span."""
    with span("train.draw"):
        bsz, num_batches = _batch_plan(n, batch_size)
        if num_batches == 1:
            return M.sample_eps(generator, config, n, dtype, device, (epochs, num_models)), None
        perms = torch.argsort(torch.rand((epochs, num_models, n), generator=generator,
                                         dtype=torch.float64, device=device), dim=-1)
        eps = M.sample_eps(generator, config, bsz * num_batches, dtype, device,
                           (epochs, num_models))
        return eps, perms


class TrainPhase:
    """One phase on the stacked model: its parameters, Adam, the buffers of
    a chunk of at most `chunk` epochs, and the epoch step that
    graphs.Steps runs (one full-batch step, or one epoch of minibatch
    steps). `run_chunk(eps, perms)` runs as many epochs as eps has rows
    (the draws of the whole stack; over a mesh this rank takes its models
    and rows)."""

    def __init__(self, model: M.MFDGPModel, x, ys, fidelities, lr: float, mask_kind: str,
                 batch_size: int, row_weights=None, num_data=None, chunk: int = 1,
                 opt_state: Optional[dict] = None, mesh=None):
        n = x.shape[0]
        if row_weights is None:
            row_weights = torch.ones((n,), dtype=x.dtype, device=x.device)
        self.nd = torch.sum(row_weights) if num_data is None else num_data
        self.mesh = mesh
        self.total_models = ys.shape[0]
        self.models = model_block(mesh, self.total_models)
        model = select_model(model, self.models.start, self.models.stop)
        self.consts, self.config = model.consts, model.config
        self.x, self.ys, self.fid = x, ys[self.models], fidelities.reshape(-1)
        self.num_models = self.ys.shape[0]
        self.bsz, self.num_batches = _batch_plan(n, batch_size)
        padded = self.bsz * self.num_batches
        nf = max(self.config.num_fidelities - 1, 0)
        self.row_weights = row_weights
        # this rank's rows of a full-batch step, or columns of each minibatch
        self.rows = dp_block(mesh, n if self.num_batches == 1 else self.bsz)
        r = self.rows
        self.x_rows, self.ys_rows = x[r], self.ys[:, r]
        self.fid_rows, self.w_rows = self.fid[r], row_weights[r]

        self.trainable = graphs.Trainable(
            model.params, tree_leaves(build_mask(model.params, mask_kind, self.config)), lr,
            opt_state)

        dev, nb = x.device, self.num_models
        self.index = graphs.StepIndex(dev)
        rows = n if self.num_batches == 1 else padded
        self.eps_buf = torch.zeros((chunk, nb, nf, rows), dtype=x.dtype, device=dev)
        self.perm_buf = (None if self.num_batches == 1 else
                         torch.zeros((chunk, nb, n), dtype=torch.int64, device=dev))
        self.loss_buf = torch.zeros((nb, chunk), dtype=x.dtype, device=dev)
        self.kl_buf = torch.zeros((nb, chunk), dtype=x.dtype, device=dev)
        collectives = mesh if mesh is not None else getattr(self.consts, "inducing", None)
        self.steps = graphs.Steps(self._epoch, dev, self.trainable.tensors,
                                  *sharding.capture_rule(collectives))

    def _update(self, xb, yb, fb, wb, eb):
        tr = self.trainable
        tr.zero_grad()
        elbo, kl = elbo_terms(tr.tree(), self.consts, self.config, xb, yb, fb, eb, self.nd,
                              weights=wb)
        loss = -elbo
        torch.sum(loss).backward()
        loss, kl = loss.detach(), kl.detach()
        if self.mesh is not None:
            sum_over_dp(self.mesh, tr.grads() + [loss, kl])
        tr.step()
        return loss, kl

    def _epoch(self) -> None:
        x, ix = self.x, self.index
        eps = ix.take(self.eps_buf)
        if self.num_batches == 1:
            loss, kl = self._update(self.x_rows, self.ys_rows, self.fid_rows, self.w_rows,
                                    eps[..., self.rows])
        else:
            nb, n, bsz = self.num_models, x.shape[0], self.bsz
            perm = ix.take(self.perm_buf)
            pad = bsz * self.num_batches - n
            idx = torch.cat([perm, perm.new_zeros((nb, pad))], dim=1).reshape(nb, -1, bsz)
            w_all = torch.cat([self.row_weights[perm], x.new_zeros((nb, pad))], dim=1)
            w_all = w_all.reshape(nb, -1, bsz)
            e_all = eps.reshape(nb, eps.shape[1], self.num_batches, bsz)
            loss = kl = 0.0
            r = self.rows
            for i in range(self.num_batches):
                bidx = idx[:, i, r]
                lb, kb = self._update(x[bidx], torch.gather(self.ys, 1, bidx), self.fid[bidx],
                                      w_all[:, i, r], e_all[:, :, i, r])
                loss, kl = loss + lb, kl + kb
        ix.put(self.loss_buf, 1, loss)
        ix.put(self.kl_buf, 1, kl)
        ix.advance()

    def run_chunk(self, eps: torch.Tensor, perms: Optional[torch.Tensor]) -> EpochLog:
        """Spans `train.stage` (the draws into the buffers), `graphs.run`,
        `train.log`."""
        e = eps.shape[0]
        with span("train.stage"):
            self.eps_buf[:e].copy_(eps[:, self.models])
            if self.perm_buf is not None:
                self.perm_buf[:e].copy_(perms[:, self.models])
            self.index.reset()
        self.steps.run(e)
        with span("train.log"):
            return gather_bb(self.mesh, EpochLog(loss=self.loss_buf[:, :e].clone(),
                                                 kl=self.kl_buf[:, :e].clone()))

    def check_finite(self, where: str) -> None:
        """Raises unless every parameter is finite: one host read (a
        `train.check` span)."""
        with span("train.check"):
            finite = bool(torch.stack([torch.isfinite(t).all()
                                       for t in self.trainable.tensors]).all())
        if not finite:
            raise RuntimeError(
                f"{where}: unconditioned training produced non-finite parameters "
                "(f32 numerical escape; check safe_cholesky escalation and output scaling)"
            )

    def result(self) -> M.MFDGPParams:
        """The trained parameters of the whole stack (gathered over 'bb')."""
        return gather_bb(self.mesh, self.trainable.values())

    def close(self) -> None:
        self.steps.close()


def steps_stats(steps: graphs.Steps) -> dict:
    """A phase's capture record: the warm-up's and the capture's seconds,
    the graph pool's bytes, replays, steps, the layer states built through
    the explicit inverse (F a step in float64), that route's GEMM
    operations per step ("inv.gemm_flops" over the steps run) and the
    dense-equivalent operations its structured products skipped per step
    ("inv.gemm_skipped"), captured and why."""
    steps_run, counts = max(steps.steps, 1), steps.counts
    return dict(warmup_seconds=steps.warmup_seconds, capture_seconds=steps.capture_seconds,
                pool_bytes=steps.pool_bytes, replays=steps.replays, steps=steps.steps,
                inv_states=counts["inv.states"],
                inv_gemm_flops_per_step=counts["inv.gemm_flops"] / steps_run,
                inv_gemm_skipped_per_step=counts["inv.gemm_skipped"] / steps_run,
                captured=steps.capture,
                capture_reason=steps.capture_reason)


def run_chunks(phase, sizes: List[int], chunk: Callable[[int, int], object], tag: str,
               stats: Optional[dict] = None, after: Optional[Callable[[int], None]] = None):
    """The chunk loop of a training or conditioned phase's entry point:
    `chunk(start, size)` makes a chunk's draws and runs it, returning its
    log; after it, heartbeat `{tag}:chunk{ci}` and `after(ci)` where given.
    `stats`, when given, receives `steps_stats` and the chunks. Returns
    (phase.result(), the chunks' logs) and closes the phase either way."""
    try:
        logs, start = [], 0
        for ci, size in enumerate(sizes):
            logs.append(chunk(start, size))
            start += size
            heartbeat.beat(f"{tag}:chunk{ci}")
            if after is not None:
                after(ci)
        if stats is not None:
            stats.update(steps_stats(phase.steps), chunks=len(sizes))
        return phase.result(), logs
    finally:
        phase.close()


def _phase_draws(generator, phase: TrainPhase, start, count, eps, perms):
    """Draws of epochs [start, start + count): slices of the caller's
    (eps, perms) where given, else a fresh chunk from `generator`."""
    if eps is None:
        x = phase.x
        return draw_chunk(generator, phase.config, count, phase.total_models, x.shape[0],
                          phase.bsz, x.dtype, x.device)
    return eps[start:start + count], None if perms is None else perms[start:start + count]


def _empty_log(nb: int, like: torch.Tensor) -> EpochLog:
    empty = torch.zeros((nb, 0), dtype=like.dtype, device=like.device)
    return EpochLog(loss=empty, kl=empty)


def train_phase_stacked_carry(
    model: M.MFDGPModel,
    x: torch.Tensor,
    ys: torch.Tensor,
    fidelities: torch.Tensor,
    num_epochs: int,
    lr: float,
    mask_kind: str,
    batch_size: int,
    row_weights: Optional[torch.Tensor] = None,
    num_data=None,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
    perms: Optional[torch.Tensor] = None,
    opt_state: Optional[dict] = None,
    mesh=None,
) -> Tuple[M.MFDGPParams, dict, EpochLog]:
    """`num_epochs` epochs of Adam on the stacked model as one chunk, with an
    explicit optimizer-state carry (opt_state None starts fresh); returns
    (params, opt_state, logs), like the JAX package's train_phase_carry.

    x (N, d) shared; ys (B, N); fidelities (N,). row_weights (N,) marks real
    rows 1 / padded rows 0 and num_data is the REAL row count for the KL
    scaling; both default to the unpadded semantics. eps: optional
    precomputed propagation normals, (E, B, F-1, N) full batch or
    (E, B, F-1, num_batches*batch) minibatch; perms: optional (E, B, N)
    minibatch permutations. What is not given is drawn from `generator`.
    mesh: train over ('bb', 'dp') (the module docstring); opt_state is
    then this rank's slice of the models.
    """
    phase = TrainPhase(model, x, ys, fidelities, lr, mask_kind, batch_size, row_weights,
                       num_data, max(num_epochs, 1), opt_state, mesh)
    try:
        log = _empty_log(ys.shape[0], x)
        if num_epochs:
            log = phase.run_chunk(*_phase_draws(generator, phase, 0, num_epochs, eps, perms))
        return phase.result(), phase.trainable.opt.state_dict(), log
    finally:
        phase.close()


def train_phase_stacked(model, x, ys, fidelities, num_epochs: int, lr: float, mask_kind: str,
                        batch_size: int, row_weights=None, num_data=None, generator=None,
                        eps=None, perms=None, mesh=None) -> Tuple[M.MFDGPParams, EpochLog]:
    """A fresh phase as one chunk: (params, logs)."""
    params, _, logs = train_phase_stacked_carry(
        model, x, ys, fidelities, num_epochs, lr, mask_kind, batch_size, row_weights, num_data,
        generator, eps, perms, mesh=mesh,
    )
    return params, logs


def train_phase_stacked_chunked(
    model: M.MFDGPModel,
    x: torch.Tensor,
    ys: torch.Tensor,
    fidelities: torch.Tensor,
    num_epochs: int,
    lr: float,
    mask_kind: str,
    batch_size: int,
    row_weights: Optional[torch.Tensor] = None,
    num_data=None,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
    perms: Optional[torch.Tensor] = None,
    stats: Optional[dict] = None,
    label: str = "train",
    mesh=None,
) -> Tuple[M.MFDGPParams, EpochLog]:
    """A phase as bounded chunks (`chunk_sizes`) with the Adam state carried
    across them (the fitter's entry point; arguments as
    train_phase_stacked_carry, eps and perms for the whole phase). Each
    chunk's draws are made before it runs; after it, heartbeat
    `train:chunk{ci}`, then the parameters must be finite (RuntimeError
    naming `label` otherwise). `stats`, when given, receives the chunks
    and `steps_stats`: the warm-up and capture seconds, the graph pool's
    bytes, the replays, the steps and whether the phase was captured (and
    why). mesh: train over ('bb', 'dp')."""
    sizes = chunk_sizes(num_epochs, x.shape[0])
    phase = TrainPhase(model, x, ys, fidelities, lr, mask_kind, batch_size, row_weights,
                       num_data, max(sizes, default=1), mesh=mesh)
    params, logs = run_chunks(
        phase, sizes,
        lambda start, size: phase.run_chunk(*_phase_draws(generator, phase, start, size, eps,
                                                          perms)),
        "train", stats, lambda ci: phase.check_finite(f"[{label}] chunk {ci}"))
    if not logs:
        return params, _empty_log(ys.shape[0], x)
    return params, EpochLog(loss=torch.cat([l.loss for l in logs], dim=1),
                            kl=torch.cat([l.kl for l in logs], dim=1))


def train_phase(model: M.MFDGPModel, x, y, fidelities, num_epochs: int, lr: float,
                mask_kind: str, batch_size: int, row_weights=None, num_data=None,
                generator=None, eps=None, perms=None) -> Tuple[M.MFDGPParams, EpochLog]:
    """One phase of a single (B = 1) model, y (N,): (params, logs (E,)), the
    JAX package's train_phase. eps (E, F-1, N or the padded minibatch rows)
    and perms (E, N) are the phase's draws when given."""
    params, logs = train_phase_stacked(
        model, x, y.reshape(1, -1), fidelities, num_epochs, lr, mask_kind, batch_size,
        row_weights, num_data, generator, None if eps is None else eps[:, None],
        None if perms is None else perms[:, None])
    return params, EpochLog(loss=logs.loss[0], kl=logs.kl[0])


def train_mfdgp_two_phase(model: M.MFDGPModel, x, y, fidelities, generator, num_epochs_1: int,
                          num_epochs_2: int, lr_1: float, lr_2: float, batch_size: int,
                          draws=None) -> Tuple[M.MFDGPModel, EpochLog, EpochLog]:
    """The reference's single-model schedule (blackbox_mfdgp_fitter.py:154-
    176): variational hypers fixed for num_epochs_1 at lr_1, then all free
    for num_epochs_2 at lr_2. draws: ((eps, perms) of phase 1, of phase 2)
    for train_phase, else drawn from `generator`."""
    draws = draws or ((None, None), (None, None))
    p, log1 = train_phase(model, x, y, fidelities, num_epochs_1, lr_1, "fix_variational_hypers",
                          batch_size, generator=generator, eps=draws[0][0], perms=draws[0][1])
    model = model._replace(params=p)
    p, log2 = train_phase(model, x, y, fidelities, num_epochs_2, lr_2, "all_free", batch_size,
                          generator=generator, eps=draws[1][0], perms=draws[1][1])
    return model._replace(params=p), log1, log2
