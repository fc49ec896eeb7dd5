"""The profiler check of mobocmf_tpu_torch/profiling.py, on the CPU: a
session whose device events do not add up to whole calls is run again and
finally refused, never summed. Sessions are stood in for by lists of
(name, start, end) events."""

import pytest

from mobocmf_tpu_torch import profiling
from torch_threads import one_intra_op_thread  # noqa: F401

K2 = {"gram_factor_kernel": 1, "solve_kernel": 2}


def _events(calls, lose=()):
    """`calls` calls of K2's three launches, 10 us apart, each 2 us long
    (the predictive overlaps the [L_S | m] solve); drops the events whose
    index is in `lose`."""
    out = []
    for c in range(calls):
        t = 100 * c
        out += [("gram_factor_kernel<float, true>", t, t + 2),
                ("solve_kernel<float, 8, false>", t + 2, t + 4),
                ("solve_kernel<float, 8, true>", t + 3, t + 5)]
    return [e for i, e in enumerate(out) if i not in lose]


def _counts(events):
    out = {}
    for name, _, _ in events:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("expect", [None, K2])
def test_a_whole_session_lacks_nothing(expect):
    assert profiling.missing_events(_counts(_events(4)), 4, expect) == ""


@pytest.mark.parametrize("lose", [(0,), (1, 4), tuple(range(10))])
def test_lost_events_are_found(lose):
    assert "x" in profiling.missing_events(_counts(_events(4, lose)), 4, K2)


def test_a_kernel_lost_from_every_call_is_found_by_its_expected_count():
    events = [e for e in _events(4) if "true>" not in e[0]]
    assert profiling.missing_events(_counts(events), 4) == ""
    assert "solve_kernel x4, want 8" in profiling.missing_events(_counts(events), 4, K2)


def test_no_events_is_missing():
    assert profiling.missing_events({}, 4) == "no device events"


def test_per_kernel_us_reruns_a_session_with_lost_events(monkeypatch):
    sessions = iter([_events(4, lose=(5,)), _events(4)])
    monkeypatch.setattr(profiling, "_session", lambda fn, calls: next(sessions))
    us = profiling.per_kernel_us(lambda: None, 4, K2)
    assert us["gram_factor_kernel<float, true>"] == pytest.approx(2.0)
    assert us["solve_kernel<float, 8, true>"] == pytest.approx(2.0)
    assert us["span"] == pytest.approx(5.0)


def test_per_kernel_us_refuses_after_its_tries(monkeypatch):
    calls = []

    def short(fn, n):
        calls.append(n)
        return _events(n, lose=(0,))

    monkeypatch.setattr(profiling, "_session", short)
    with pytest.raises(RuntimeError, match="lost events"):
        profiling.per_kernel_us(lambda: None, 4, K2)
    assert len(calls) == profiling.TRIES


def test_device_ms_sums_the_named_kernels(monkeypatch):
    monkeypatch.setattr(profiling, "_session", lambda fn, calls: _events(calls))
    assert profiling.device_ms(lambda: None, 4, "solve_kernel", 2) == pytest.approx(4e-3)
    assert profiling.device_ms(lambda: None, 4) == pytest.approx(6e-3)
    with pytest.raises(RuntimeError, match="gram_factor_kernel x4, want 8"):
        profiling.device_ms(lambda: None, 4, "gram_factor_kernel", 2)
