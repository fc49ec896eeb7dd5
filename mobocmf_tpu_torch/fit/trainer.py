"""Two-phase unconditioned MFDGP training, blackboxes stacked on dim 0
(counterpart of mobocmf_tpu/fit/trainer.py).

- phase 1: variational hypers FIXED (likelihood noises + variational
  Cholesky frozen; means + kernel params train), num_epochs_1 @ lr_1;
- phase 2: everything free, num_epochs_2 @ lr_2.

A phase is one Python loop of Adam steps (eps 1e-8, a fresh state per
phase) on the stacked model: the loss is the sum of the blackboxes'
negative ELBOs, so each blackbox gets its own gradient, as under the JAX
package's vmap. Freezing multiplies `.grad` by a 0/1 mask before `step()`.

A full-batch epoch takes no permutation (the shuffle would only re-pair
eps draws with rows). The minibatch path follows DataLoader(shuffle=True,
drop_last=False): a fresh permutation per epoch and blackbox, the trailing
partial batch padded and masked with zero weights. The per-step eps (and
permutations) come from a torch.Generator, or precomputed from the caller
(the parity tests inject the JAX key chain's draws).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from mobocmf_tpu_torch.mlls.elbo import elbo_terms
from mobocmf_tpu_torch.models import mfdgp as M
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


def select_model(model: M.MFDGPModel, i: int) -> M.MFDGPModel:
    """Blackbox i of a stacked model, as a B = 1 model (views, no copies)."""
    def take(a):
        return a[i : i + 1]

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


def _batch_plan(num_data: int, batch_size: int) -> Tuple[int, int]:
    batch_size = min(batch_size, num_data)
    return batch_size, math.ceil(num_data / batch_size)


def train_phase_stacked(
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
) -> Tuple[M.MFDGPParams, EpochLog]:
    """One phase of Adam on the stacked model; returns (params, logs).

    x (N, d) shared; ys (B, N); fidelities (N,). row_weights (N,) marks real
    rows 1 / padded rows 0 and num_data is the REAL row count for the KL
    scaling; both default to the unpadded semantics. eps: optional
    precomputed propagation normals, (E, B, F-1, N) full batch or
    (E, B, F-1, num_batches*batch) minibatch; perms: optional (E, B, N)
    minibatch permutations. What is not given is drawn from `generator`.
    """
    config, consts = model.config, model.consts
    n = x.shape[0]
    nb_models = ys.shape[0]
    bsz, num_batches = _batch_plan(n, batch_size)
    padded = bsz * num_batches
    nf = max(config.num_fidelities - 1, 0)
    fid = fidelities.reshape(-1)
    if row_weights is None:
        row_weights = torch.ones((n,), dtype=x.dtype, device=x.device)
    nd = torch.sum(row_weights) if num_data is None else num_data

    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), model.params)
    leaves = tree_leaves(params)
    masks = tree_leaves(build_mask(params, mask_kind, config))
    opt = torch.optim.Adam(leaves, lr=lr, eps=1e-8)

    def step(xb, yb, fb, wb, eb):
        opt.zero_grad(set_to_none=True)
        elbo, kl = elbo_terms(params, consts, config, xb, yb, fb, eb, nd, weights=wb)
        loss = -elbo
        torch.sum(loss).backward()
        for p, m in zip(leaves, masks):
            if p.grad is not None and m != 1.0:
                p.grad.mul_(m)
        opt.step()
        return loss.detach(), kl.detach()

    losses, kls = [], []
    for e in range(num_epochs):
        if num_batches == 1:
            eb = eps[e] if eps is not None else M.sample_eps(
                generator, config, n, x.dtype, x.device, (nb_models,)
            )
            loss, kl = step(x, ys, fid, row_weights, eb)
        else:
            if perms is not None:
                perm = perms[e]
            else:
                perm = torch.stack([
                    torch.randperm(n, generator=generator, device=x.device)
                    for _ in range(nb_models)
                ])
            pad_idx = torch.zeros((nb_models, padded - n), dtype=perm.dtype, device=x.device)
            idx = torch.cat([perm, pad_idx], dim=1).reshape(nb_models, num_batches, bsz)
            w_pad = torch.zeros((nb_models, padded - n), dtype=x.dtype, device=x.device)
            w_all = torch.cat([row_weights[perm], w_pad], dim=1).reshape(
                nb_models, num_batches, bsz
            )
            e_all = eps[e] if eps is not None else M.sample_eps(
                generator, config, padded, x.dtype, x.device, (nb_models,)
            )
            e_all = e_all.reshape(nb_models, nf, num_batches, bsz)
            loss = kl = 0.0
            for i in range(num_batches):
                bidx = idx[:, i]
                lb, kb = step(
                    x[bidx], torch.gather(ys, 1, bidx), fid[bidx], w_all[:, i], e_all[:, :, i]
                )
                loss, kl = loss + lb, kl + kb
        losses.append(loss)
        kls.append(kl)

    params = tree_map(lambda t: t.detach(), params)
    if not losses:
        empty = torch.zeros((nb_models, 0), dtype=x.dtype, device=x.device)
        return params, EpochLog(loss=empty, kl=empty)
    return params, EpochLog(loss=torch.stack(losses, dim=1), kl=torch.stack(kls, dim=1))

