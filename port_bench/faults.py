"""Faults planted under the timed path, for the tests that see `correct`
come out false and for the readings that set the limits (calibrate.py).
The benchmark's own runs never plant one. Each is a context manager that
patches the program for its length:

- `frozen`: every Adam step returns its state unchanged;
- `late_frozen`: the phase's first three steps run, every later one
  leaves the state (and the logs) unchanged: a fault that the first steps
  do not show;
- `half_batch`: half of the rows left out of the ELBO's data term, the
  rest counted twice (the mean taken over the rest);
- `altered`: one answer altered where it is produced: the update of the
  first layer's variational mean applied twice.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def frozen():
    from mobocmf_tpu_torch.fit import graphs

    with _patched(graphs.Trainable, "step", lambda self: None):
        yield


@contextlib.contextmanager
def late_frozen():
    from mobocmf_tpu_torch.fit import graphs

    run = graphs.Steps.run

    def run_late(self, n):
        if self.steps >= 3:
            self.steps += n
            return
        run(self, n)

    with _patched(graphs.Steps, "run", run_late):
        yield


@contextlib.contextmanager
def half_batch():
    from mobocmf_tpu_torch.fit import conditioned, trainer

    def halve(w, n):
        keep = (torch.arange(n, device=w.device) < n // 2).to(w.dtype)
        return w * 2.0 * keep

    elbo_terms = trainer.elbo_terms
    data_term = conditioned._data_term

    def elbo_half(params, consts, config, x, y, fid, eps, num_data, weights=None, states=None):
        return elbo_terms(params, consts, config, x, y, fid, eps, num_data,
                          weights=halve(weights, x.shape[-2]), states=states)

    def data_half(params, consts, config, outs, y, fid, weights):
        return data_term(params, consts, config, outs, y, fid, halve(weights, y.shape[-1]))

    with _patched(trainer, "elbo_terms", elbo_half), \
            _patched(conditioned, "_data_term", data_half):
        yield


@contextlib.contextmanager
def altered():
    from mobocmf_tpu_torch.fit import graphs

    step = graphs.Trainable.step

    def step_twice(self):
        leaf = self.tree().layers[0].variational.mean
        before = leaf.detach().clone()
        step(self)
        with torch.no_grad():
            leaf.add_(leaf - before)

    with _patched(graphs.Trainable, "step", step_twice):
        yield


FAULTS = {"frozen": frozen, "late_frozen": late_frozen, "half_batch": half_batch,
          "altered": altered}
