"""JESMOC acquisition over MFDGP models
(counterpart of mobocmf_tpu/acquisition/jesmoc.py).

Per-(blackbox, fidelity) information gain (reference JESMOC_MFDGP.py)

    a(x) = 0.5 * clamp( log var_uncond(x) - log var_cond(x), 0 )

where both variances come from predict_for_acquisition (25x fixed-eps
tiling + moment matching). The coupled acquisition sums over the
registered blackboxes at a fidelity; the next point maximizes it per
fidelity and takes the fidelity with the best cost-normalized value
(:151-176), or always the top fidelity (eval_highest_fidelity, :137-149).

The unconditioned and conditioned models of every registered blackbox are
stacked on ONE blackbox dim (2B models): their layer states are computed
once per search, and one forward scores both. The states carry the
explicit L^{-1}, so each per-x solve of the L-BFGS loop is a matrix
product, unless MOBOCMF_ACQ_INV=0 (the JAX package's switch, read at
import as `ACQ_INV_SOLVES`, by `pair_states` at each call): then they carry
none and every predictive solves with the triangular factor. Without
gradients (the raw-sample screening) each model's layer 0 runs through K2
with B = 2 x blackboxes either way (K2 factors its own Gram); the L-BFGS
loop keeps the plain predictive.

A q > 1 batch is filled at the chosen fidelity by greedy
local-penalization picks (`get_batch_coupled`, acquisition/batch.py), each
a search whose screening goes through K2 as well.

Construction follows the reference's contract: the passed fitter is
snapshotted as the unconditioned model, then, when model_cond is not
given, Pareto sampling and conditioned training run here and turn the
passed fitter into the conditioned model (:70-86).

Over a mesh (`mesh=`, parallel/sharding.py) the pair stack is sharded
over 'bb': a rank holds the same blackboxes of both halves (its slice of
the unconditioned models and of the conditioned ones), sums their gains
and the sum is all-reduced over 'bb' (`sharding.reduce`, with the point
entering through `sharding.enter` so its gradient is summed too). Every
rank then has the same value and gradient, and the L-BFGS line searches
take the same branches on every rank.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from mobocmf_tpu_torch.acquisition.batch import PAD_VALUE, penalized_acq
from mobocmf_tpu_torch.acquisition.optimize import optimize_acqf_box, optimize_acqf_box_multi
from mobocmf_tpu_torch.fit import trainer
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
from mobocmf_tpu_torch.models import mfdgp as M
from mobocmf_tpu_torch.parallel import sharding

# the acquisition states carry the explicit L^{-1}, so every per-x solve
# of the L-BFGS loop is a matrix product; MOBOCMF_ACQ_INV=0 keeps the
# triangular solves (the JAX package's switch, read at import)
ACQ_INV_SOLVES = os.environ.get("MOBOCMF_ACQ_INV", "1") == "1"


def _gain(var: torch.Tensor, num: int) -> torch.Tensor:
    """Information gain of the first `num` models (unconditioned) against
    the next `num` (conditioned), per blackbox."""
    return 0.5 * torch.clamp(torch.log(var[:num]) - torch.log(var[num:]), min=0.0)


def _pair(su_p, su_c, sc_p, sc_c, config, mesh=None) -> M.MFDGPModel:
    """The unconditioned models followed by the conditioned ones, stacked
    (over a mesh, this 'bb' rank's slice of each)."""
    models = [M.MFDGPModel(su_p, su_c, config), M.MFDGPModel(sc_p, sc_c, config)]
    if mesh is not None:
        b = trainer.model_block(mesh, su_p.raw_noises.shape[0])
        models = [trainer.select_model(m, b.start, b.stop) for m in models]
    return trainer.stack_models(models)


def _over_bb(acq, mesh):
    """acq summed over the mesh's 'bb' ranks (value and gradient in x)."""
    if mesh is None:
        return acq
    grp = mesh.get_group("bb")
    return lambda xx: sharding.reduce(acq(sharding.enter(xx, grp)), grp)


def pair_states(pair: M.MFDGPModel) -> List[M.LayerState]:
    """The pair stack's layer states, with L^{-1} when ACQ_INV_SOLVES (read
    at the call)."""
    with torch.no_grad():
        return trainer.states_stacked(pair.params, pair.consts, pair.config, with_inv=ACQ_INV_SOLVES)


def info_gain(params_u, consts_u, params_c, consts_c, config, fidelity: int, x) -> torch.Tensor:
    """JES information gain of each blackbox (reference :38-52): (B, N)."""
    _, var_u = M.predict_for_acquisition(params_u, consts_u, config, x, fidelity)
    _, var_c = M.predict_for_acquisition(params_c, consts_c, config, x, fidelity)
    return 0.5 * torch.clamp(torch.log(var_u) - torch.log(var_c), min=0.0)


def _coupled_gain_stacked(pair: M.MFDGPModel, fidelity: int, x, states) -> torch.Tensor:
    """Sum over blackboxes of the info gain at one fidelity: (N,)."""
    _, var = M.predict_for_acquisition(pair.params, pair.consts, pair.config, x, fidelity, states)
    return torch.sum(_gain(var, var.shape[0] // 2), dim=0)


def coupled_acq_stacked(su_p, su_c, sc_p, sc_c, config, fidelity: int, x,
                        mesh=None) -> torch.Tensor:
    pair = _pair(su_p, su_c, sc_p, sc_c, config, mesh)
    states = pair_states(pair)
    return _over_bb(lambda xx: _coupled_gain_stacked(pair, fidelity, xx, states), mesh)(x)


def _coupled_gain_all_stacked(pair: M.MFDGPModel, x, states) -> torch.Tensor:
    """(F, N) coupled gains at every fidelity from one all-layer forward,
    summed over blackboxes."""
    _, var = M.predict_for_acquisition_all(pair.params, pair.consts, pair.config, x, states)
    return torch.sum(_gain(var, var.shape[0] // 2), dim=0)


def optimize_coupled_jes(
    su_p, su_c, sc_p, sc_c, config, fidelity: int, generator, input_dim: int,
    num_restarts: int = 5, raw_samples: int = 200, maxiter: int = 200, raw=None,
):
    """Maximize the coupled JES acquisition at one fidelity over [0,1]^d."""
    pair = _pair(su_p, su_c, sc_p, sc_c, config)
    states = pair_states(pair)
    z = su_c.z_x[0]
    return optimize_acqf_box(
        lambda xx: _coupled_gain_stacked(pair, fidelity, xx, states), input_dim, generator,
        num_restarts=num_restarts, raw_samples=raw_samples, maxiter=maxiter,
        dtype=z.dtype, device=z.device, raw=raw,
    )


def optimize_coupled_jes_all_fidelities(
    su_p, su_c, sc_p, sc_c, config, generator, input_dim: int,
    num_restarts: int = 5, raw_samples: int = 200, maxiter: int = 200, raw=None, mesh=None,
):
    """Maximize the coupled JES acquisition at every fidelity in one search:
    the layer states are computed once, one screening scores every fidelity,
    and all F x num_restarts L-BFGS lanes run together. Returns
    (xs (F, d), values (F,)). mesh: the pair stack over 'bb' (the module
    docstring); every rank returns the same."""
    pair = _pair(su_p, su_c, sc_p, sc_c, config, mesh)
    states = pair_states(pair)
    z = su_c.z_x[0]
    return optimize_acqf_box_multi(
        _over_bb(lambda xx: _coupled_gain_all_stacked(pair, xx, states), mesh),
        config.num_fidelities,
        input_dim, generator, num_restarts=num_restarts, raw_samples=raw_samples,
        maxiter=maxiter, dtype=z.dtype, device=z.device, raw=raw, mesh=mesh,
    )


def optimize_coupled_jes_penalized(
    su_p, su_c, sc_p, sc_c, config, fidelity: int, chosen: torch.Tensor, generator,
    input_dim: int, rho: float, num_restarts: int = 5, raw_samples: int = 200,
    maxiter: int = 200, raw=None,
):
    """One greedy batch pick: the coupled JES acquisition at `fidelity` with
    a local-penalization repulsion factor around `chosen` (k, d),
    PAD_VALUE-padded (acquisition/batch.py). Its screening runs without
    gradients, so each model's layer 0 goes through K2 there."""
    pair = _pair(su_p, su_c, sc_p, sc_c, config)
    states = pair_states(pair)
    z = su_c.z_x[0]
    acq = penalized_acq(lambda xx: _coupled_gain_stacked(pair, fidelity, xx, states), chosen, rho)
    return optimize_acqf_box(
        acq, input_dim, generator, num_restarts=num_restarts, raw_samples=raw_samples,
        maxiter=maxiter, dtype=z.dtype, device=z.device, raw=raw,
    )


class _JES_MFDGP:
    """Per-blackbox, per-fidelity information gain (reference :19-53)."""

    def __init__(self, fidelity: int, mfdgp_uncond: M.MFDGPModel, mfdgp_cond: M.MFDGPModel):
        self.fidelity = fidelity
        self.mfdgp_uncond = mfdgp_uncond
        self.mfdgp_cond = mfdgp_cond

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim > 2:  # botorch-style (b, q=1, d) batches
            x = x[:, 0, :]
        u, c = self.mfdgp_uncond, self.mfdgp_cond
        return info_gain(u.params, u.consts, c.params, c.consts, u.config, self.fidelity, x)[0]


class JESMOC_MFDGP:
    def __init__(
        self,
        model: BlackBoxMFDGPFitter,
        num_fidelities: int = 1,
        model_cond: Optional[BlackBoxMFDGPFitter] = None,
        standard_bounds=None,
        eval_highest_fidelity: bool = False,
        seed: int = 0,
        acq_maxiter: int = 200,
        acq_raw_samples: int = 200,
    ):
        """acq_maxiter caps the candidate L-BFGS (reference: botorch
        maxiter 200, JESMOC_MFDGP.py:159-160); acq_raw_samples is the
        screening size (5 starts per fidelity, as the reference)."""
        self.standard_bounds = standard_bounds
        self.eval_highest_fidelity = eval_highest_fidelity
        self.acq_maxiter = int(acq_maxiter)
        self.acq_raw_samples = int(acq_raw_samples)
        self.blackbox_mfdgp_fitter_uncond = model.copy_uncond()
        self.generator = torch.Generator(device=model.device).manual_seed(seed)

        if model_cond is None:
            solution = model.sample_and_store_pareto_solution()
            self.pareto_set = solution.pareto_set
            self.pareto_front = solution.pareto_front
            model.train_conditioned_mfdgps()
            self.blackbox_mfdgp_fitter_cond = model
        else:
            self.pareto_set = model_cond.pareto_set
            self.pareto_front = model_cond.pareto_front
            self.blackbox_mfdgp_fitter_cond = model_cond

        self.num_fidelities = num_fidelities
        self.objectives: Dict[int, Dict[str, _JES_MFDGP]] = {}
        self.constraints: Dict[int, Dict[str, _JES_MFDGP]] = {}
        self.costs_blackboxes: Dict[int, Dict[str, float]] = {}
        for n_f in range(num_fidelities):
            self.objectives[n_f] = {}
            self.constraints[n_f] = {}
            self.costs_blackboxes[n_f] = {"total": 0.0}
        self._stacked_cache: Dict[int, Optional[tuple]] = {}
        # the last candidate search's best point and value, per fidelity searched
        self.last_points: Optional[torch.Tensor] = None
        self.last_values: Optional[torch.Tensor] = None

    def add_blackbox(
        self, fidelity: int, blackbox_name: str, cost_evaluation: float = 1.0,
        is_constraint: bool = False,
    ) -> _JES_MFDGP:
        mfdgp_uncond = self.blackbox_mfdgp_fitter_uncond.get_model(blackbox_name, is_constraint)
        mfdgp_cond = self.blackbox_mfdgp_fitter_cond.get_model(blackbox_name, is_constraint)
        jes = _JES_MFDGP(fidelity, mfdgp_uncond, mfdgp_cond)
        registry = self.constraints if is_constraint else self.objectives
        registry[fidelity][blackbox_name] = jes
        self.costs_blackboxes[fidelity]["total"] += cost_evaluation
        self.costs_blackboxes[fidelity][blackbox_name] = cost_evaluation
        self._stacked_cache.pop(fidelity, None)
        return jes

    def decoupled_acq(self, x, fidelity: int, blackbox_name: str, is_constraint=True):
        reg = self.constraints if is_constraint else self.objectives
        return reg[fidelity][blackbox_name](x)

    def _stacked(self, fidelity: int):
        """(su_p, su_c, sc_p, sc_c, config) of every blackbox registered at
        `fidelity`, or None when there is none."""
        if fidelity not in self._stacked_cache:
            items = list(self.objectives[fidelity].values()) + list(
                self.constraints[fidelity].values()
            )
            if not items:
                self._stacked_cache[fidelity] = None
            else:
                su = trainer.stack_models([j.mfdgp_uncond for j in items])
                sc = trainer.stack_models([j.mfdgp_cond for j in items])
                self._stacked_cache[fidelity] = (su.params, su.consts, sc.params, sc.consts,
                                                 su.config)
        return self._stacked_cache[fidelity]

    def coupled_acq(self, x: torch.Tensor, fidelity: int) -> torch.Tensor:
        if x.ndim > 2:
            x = x[:, 0, :]
        stacked = self._stacked(fidelity)
        if stacked is None:  # empty sum over registered blackboxes
            return torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        return coupled_acq_stacked(*stacked, fidelity, x)

    # -- candidate selection (reference :137-184) -------------------------------

    def _input_dim(self) -> int:
        for f in range(self.num_fidelities):
            some = next(iter(self.objectives[f].values()), None) or next(
                iter(self.constraints[f].values()), None
            )
            if some is not None:
                return some.mfdgp_uncond.consts.z_x[0].shape[1]
        raise ValueError("no blackboxes registered at any fidelity")

    def _optimize_fidelity(self, fidelity: int):
        stacked = self._stacked(fidelity)
        if stacked is None:
            return None, 0.0
        return optimize_coupled_jes(
            *stacked, fidelity, self.generator, self._input_dim(),
            raw_samples=self.acq_raw_samples, maxiter=self.acq_maxiter,
        )

    def _get_nextpoint_coupled_highest_fidelity(self, iteration=None, verbose=False):
        fidelity = self.num_fidelities - 1
        x_best, value = self._optimize_fidelity(fidelity)
        self.last_points = x_best[None]
        self.last_values = torch.as_tensor(value).reshape(1)
        if verbose:
            print(f"Iter: {iteration} Acquisition: "
                  f"{float(value) / self.costs_blackboxes[0]['total']} "
                  f"Evaluating fidelity {fidelity} at {x_best}")
        return x_best, fidelity

    def _fused_eligible(self):
        """The all-fidelity search needs the SAME blackbox set registered
        at every fidelity (the standard coupled campaign). Returns the
        shared stacked models, or None (per-fidelity searches)."""
        ref = None
        for f in range(self.num_fidelities):
            names = (tuple(self.objectives[f].keys()), tuple(self.constraints[f].keys()))
            if not (names[0] or names[1]):
                return None
            if ref is None:
                ref = names
            elif names != ref:
                return None
        return self._stacked(0)

    def _get_nextpoint_coupled(self, iteration=None, verbose=False) -> Tuple[torch.Tensor, int]:
        best_weighted, best_x, best_fid = None, None, 0
        fused = self._fused_eligible() if self.num_fidelities > 1 else None
        if fused is not None:
            xs, vals = optimize_coupled_jes_all_fidelities(
                *fused, self.generator, self._input_dim(),
                raw_samples=self.acq_raw_samples, maxiter=self.acq_maxiter,
            )
            self.last_points, self.last_values = xs, vals
            vals_host = vals.cpu().tolist()
            for fidelity in range(self.num_fidelities):
                weighted = vals_host[fidelity] / self.costs_blackboxes[fidelity]["total"]
                if best_weighted is None or weighted > best_weighted:
                    best_weighted, best_x, best_fid = weighted, xs[fidelity], fidelity
        else:
            found, points = [], []
            for fidelity in range(self.num_fidelities):
                x_f, value = self._optimize_fidelity(fidelity)
                if x_f is None:  # no blackboxes registered at this fidelity
                    continue
                found.append(float(value))
                points.append(x_f)
                weighted = float(value) / self.costs_blackboxes[fidelity]["total"]
                if best_weighted is None or weighted > best_weighted:
                    best_weighted, best_x, best_fid = weighted, x_f, fidelity
            self.last_values = torch.as_tensor(found)
            self.last_points = torch.stack(points) if points else None
        if best_x is None:
            raise ValueError("no blackboxes registered at any fidelity")
        if verbose:
            print(f"Iter: {iteration} Acquisition: "
                  f"{best_weighted * self.costs_blackboxes[best_fid]['total']} "
                  f"Evaluating fidelity {best_fid} at {best_x}")
        return best_x, best_fid

    def get_nextpoint_coupled(self, iteration=None, verbose=False):
        """(x (d,), fidelity) of the next coupled evaluation."""
        if self.eval_highest_fidelity:
            return self._get_nextpoint_coupled_highest_fidelity(iteration, verbose)
        return self._get_nextpoint_coupled(iteration, verbose)

    def get_batch_coupled(self, fidelity: int, q: int, x0=None, rho=None) -> torch.Tensor:
        """Greedy local-penalization q-batch at `fidelity` (the JAX
        package's :459-487; the reference is q=1 only). `x0` (k0, d) seeds
        the chosen set, so the q=1 maximizer can be the batch's first
        point. Returns (q, d) candidates."""
        stacked = self._stacked(fidelity)
        if stacked is None:
            raise ValueError(f"no blackboxes registered at fidelity {fidelity}")
        d = self._input_dim()
        z = stacked[1].z_x[0]
        if rho is None:
            rho = 0.05 * (d**0.5)
        seed = (
            torch.zeros((0, d), dtype=z.dtype, device=z.device) if x0 is None
            else torch.as_tensor(x0).to(z).reshape(-1, d)
        )
        k0 = seed.shape[0]
        chosen = torch.cat([seed, torch.full((q, d), PAD_VALUE, dtype=z.dtype, device=z.device)])
        for k in range(q):
            x_k, _ = optimize_coupled_jes_penalized(
                *stacked, fidelity, chosen, self.generator, d, float(rho),
                raw_samples=self.acq_raw_samples, maxiter=self.acq_maxiter,
            )
            chosen = chosen.clone()
            chosen[k0 + k] = x_k.detach()
        return chosen[k0:]
