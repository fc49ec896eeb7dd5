"""The program's spans and capture counters on the CPU
(util/profiling.py::span, util/counters.py, fit/graphs.py::Steps,
fit/trainer.py, fit/conditioned.py, acquisition/lbfgs.py): no span without
a profiler, a chunk's spans under one, none recorded inside a step
closure, the search's spans, the counters' two tallies and a Steps'
counts, and the capture record's warm-up seconds and pool bytes."""

import contextlib

import numpy as np
import pytest
import torch

from mobocmf_tpu_torch.acquisition import lbfgs
from mobocmf_tpu_torch.fit import conditioned as C
from mobocmf_tpu_torch.fit import graphs, trainer
from mobocmf_tpu_torch.fit.fitter import BlackBoxMFDGPFitter
from mobocmf_tpu_torch.util import counters, profiling
from torch_threads import one_intra_op_thread  # noqa: F401

F64 = torch.float64
PREFIXES = ("graphs.", "train.", "cond.", "lbfgs.")


@pytest.fixture(scope="module")
def fitter():
    """One objective and one constraint on 14 points at 2 fidelities, m = 16."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(14, 2))
    fid = np.r_[np.zeros(10), np.ones(4)].astype(int)
    f = BlackBoxMFDGPFitter(2, 14, seed=3, pad_data=True, device="cpu", dtype=F64)
    f.initialize_mfdgp(x, np.sin(6 * x[:, 0]) + x[:, 1], fid, "obj")
    f.initialize_mfdgp(x, x[:, 0] - 0.5, fid, "con", is_constraint=True)
    return f


def _train(f):
    """A training phase of the stack and one chunk's run as the fitter
    drives it: draw, run, check."""
    model = trainer.stack_models([f.models_objs["obj"], f.models_cons["con"]])
    n = f.x_train.shape[0]
    phase = trainer.TrainPhase(model, f.x_train, torch.stack(f.ys_objs + f.ys_cons),
                               f.fidelities, 1e-3, "all_free", n, f.row_weights, chunk=2)

    def chunk():
        phase.run_chunk(*trainer.draw_chunk(f.generator, phase.config, 2, 2, n, n, F64, "cpu"))
        phase.check_finite("[test] chunk")

    return phase, chunk


def _cond(f):
    """A conditioned phase on a 3-point Pareto set and one chunk's run."""
    obj, con = f.models_objs["obj"], f.models_cons["con"]
    g = torch.Generator().manual_seed(5)
    data = C.ConditionedData(
        x=f.x_train, ys_obj=torch.stack(f.ys_objs), ys_con=torch.stack(f.ys_cons),
        fidelities=f.fidelities, pareto_set=torch.rand((3, 2), generator=g, dtype=F64),
        pareto_front=torch.randn((3, 1), generator=g, dtype=F64),
        front_mask=torch.ones((3,), dtype=torch.bool),
        thresholds=torch.zeros((1,), dtype=F64), row_weights=f.row_weights)
    n = f.x_train.shape[0]
    phase = C.ConditionedPhase(obj.params, con.params, obj.consts, con.consts, obj.config, data,
                               1e-3, 1e-8, n, chunk=2)

    def chunk():
        phase.run_chunk(C.draw_chunk(f.generator, data, phase.config, n, 2))

    return phase, chunk


PHASES = {"train": _train, "cond": _cond}


def _recorded(fn) -> list:
    """The program's span names recorded while fn runs under a CPU profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith(PREFIXES)]


def test_span_without_a_profiler_is_the_shared_noop():
    off = profiling.span("train.draw")
    assert off is profiling.span("cond.log") and isinstance(off, contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = profiling.span("train.draw")
        with on:
            pass
    assert on is not off and profiling.span("train.draw") is off
    assert [e.name for e in prof.events()] == ["train.draw"]


@pytest.mark.parametrize("kind", ["train", "cond"])
def test_chunk_records_its_spans(fitter, kind):
    phase, chunk = PHASES[kind](fitter)
    try:
        names = _recorded(chunk)
    finally:
        phase.close()
    want = {"train": ["train.draw", "train.stage", "graphs.run", "train.log", "train.check"],
            "cond": ["cond.draw", "cond.stage", "graphs.run", "cond.log"]}[kind]
    # in the order the host runs them, once each: the CPU runs the steps
    # eagerly, so graphs.warmup, graphs.capture and graphs.replay stay the card's
    assert names == want


@pytest.mark.parametrize("kind", ["train", "cond"])
def test_step_closure_records_no_span(fitter, kind):
    phase, chunk = PHASES[kind](fitter)
    try:
        chunk()
        phase.index.reset()
        assert _recorded(phase.steps.step) == []
    finally:
        phase.close()


def test_search_records_its_pieces_and_reads():
    z0 = torch.tensor([[1.0, -2.0], [0.5, 0.5]], dtype=F64)
    names = _recorded(lambda: lbfgs.lbfgs_lanes(lambda z: (z ** 2).sum(-1), z0, 3))
    st = lbfgs.last_stats
    count = {name: names.count(name) for name in set(names)}
    # the first iteration recomputes the start's value (optax's init: inf)
    pieces = dict(fresh=st["fresh"], prologue=st["iterations"],
                  step=st["evaluations"] - st["fresh"], epilogue=st["iterations"])
    assert count == {"lbfgs.read": st["iterations"] + pieces["step"],
                     "graphs.run": sum(pieces.values()),
                     **{f"lbfgs.{k}": v for k, v in pieces.items()}}


def test_capture_record_carries_warmup_and_pool(fitter):
    f = fitter
    model = trainer.stack_models([f.models_objs["obj"], f.models_cons["con"]])
    before = graphs.setup_seconds
    stats: dict = {}
    trainer.train_phase_stacked_chunked(
        model, f.x_train, torch.stack(f.ys_objs + f.ys_cons), f.fidelities, 3, 1e-3,
        "all_free", f.x_train.shape[0], f.row_weights, generator=f.generator, stats=stats)
    assert stats["warmup_seconds"] == 0.0 and stats["pool_bytes"] == 0
    assert stats["capture_seconds"] == 0.0 and stats["steps"] == 3 and stats["replays"] == 0
    assert graphs.setup_seconds == before


def test_counters_keep_what_a_capture_records_apart(monkeypatch):
    """An add while the current stream is capturing lands in the recorded
    tally, not in `get`; reset() clears both."""
    counters.reset()
    counters.add("k1.launches")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    counters.add("k1.launches", 3)
    assert counters.get("k1.launches") == 1 and counters.recorded["k1.launches"] == 3
    counters.reset()
    assert counters.get("k1.launches") == 0 and not counters.recorded


def test_steps_counts_what_its_runs_added():
    """A Steps' counts are what its runs added to the ran tally, and
    steps_stats derives the inverse route's keys from them."""
    counters.add("inv.states", 5)

    def step():
        counters.add("inv.states", 2)
        counters.add("inv.gemm_flops", 10)

    steps = graphs.Steps(step, torch.device("cpu"))
    steps.run(3)
    steps.run(1)
    assert steps.counts == {"inv.states": 8, "inv.gemm_flops": 40}
    stats = trainer.steps_stats(steps)
    assert (stats["inv_states"], stats["inv_gemm_flops_per_step"],
            stats["inv_gemm_skipped_per_step"]) == (8, 10.0, 0.0)
