"""Random acquisition baseline
(counterpart of mobocmf_tpu/acquisition/random_choice.py).

Re-implements the reference's Random_choice (acquisition_functions/
Random_choice.py:44-56): a uniform candidate in [0, 1]^d, its fidelity
drawn with probability proportional to 1 - cost_f / total_cost. Every draw
comes from one torch.Generator seeded by `seed`, on `device` (`cuda`
unless named).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mobocmf_tpu_torch.core.device import DeviceLike, resolve_device


class Random_choice:
    def __init__(self, input_size=None, num_fidelities: int = 1, seed=None,
                 device: DeviceLike = None):
        self.input_size = input_size
        self.num_fidelities = num_fidelities
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)

        self.costs_blackboxes: Dict[int, Dict[str, float]] = {}
        for n_f in range(num_fidelities):
            self.costs_blackboxes[n_f] = {"total": 0.0}
        self.coupled_costs_fidelities = torch.zeros((num_fidelities,), dtype=torch.float64)
        self.total_cost_fidelities = 0.0

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=torch.float64, device=self.device)

    def add_blackbox(self, fidelity: int, blackbox_name: str, cost_evaluation: float = 1.0):
        self.costs_blackboxes[fidelity][blackbox_name] = cost_evaluation
        self.coupled_costs_fidelities[fidelity] += cost_evaluation
        self.total_cost_fidelities += cost_evaluation

    def fidelity_probabilities(self) -> torch.Tensor:
        """p_f proportional to 1 - cost_f / total (reference :44-56)."""
        probs = 1.0 - self.coupled_costs_fidelities / self.total_cost_fidelities
        return probs / probs.sum()

    def decoupled_acq(self, x: torch.Tensor, fidelity: int, blackbox_name=None) -> torch.Tensor:
        return self._uniform((x.shape[0],))

    def coupled_acq(self, x: torch.Tensor, fidelity: int) -> torch.Tensor:
        return self._uniform((x.shape[0],))

    def get_batch_coupled(self, q: int, iteration=None, verbose=False) -> Tuple[torch.Tensor, int]:
        """q iid uniform candidates (q, d) at one sampled fidelity: the q > 1
        analogue of get_nextpoint_coupled, so BO loops can swap
        acquisitions."""
        x0, fidelity = self.get_nextpoint_coupled(iteration=iteration, verbose=verbose)
        if q == 1:
            return x0[None, :], fidelity
        extra = self._uniform((q - 1, self.input_size))
        return torch.cat([x0[None, :], extra]), fidelity

    def get_nextpoint_coupled(self, iteration=None, verbose=False) -> Tuple[torch.Tensor, int]:
        nextpoint = self._uniform((self.input_size,))
        probs = self.fidelity_probabilities().to(self.device)
        fidelity = int(torch.multinomial(probs, 1, generator=self.generator).item())
        if verbose:
            print(f"Iter: {iteration}  Evaluating fidelity {fidelity} at {nextpoint}")
        return nextpoint, fidelity
