"""The trace's reduction on made-up events: the busy union, the idle gaps
named by the harness's spans, the breakdown's form; and the readers'
silence where they find nothing to read."""

from port_bench import run as R
from port_bench import trace


def test_union_and_breakdown():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 3.0, 4.0), ("c", 4.5, 5.0)]
    busy = trace.union(ev)
    assert busy == [(0.0, 2.0), (3.0, 4.0), (4.5, 5.0)]
    host = [("bench.train_chunk", -1.0, 10.0), ("bench.cond_chunk", 2.1, 2.9)]
    out = trace.breakdown(ev, host, busy)
    assert out["device_ops"][0] == ["a", 2.0]
    assert out["idle_gaps"] == [["bench.cond_chunk", 1.0], ["bench.train_chunk", 0.5]]


def test_readers_silent_without_their_kernels():
    ctx = R.Ctx("train", dict(B=3, F=2, m=512, d=2, dtype="float64"), dict(steps=10), [("elementwise", 0.0, 1e-3)],
                0.1, 1e-3)
    assert R.reader("k1_roofline.train")(ctx) is None
    assert R.reader("trsm_ms.train")(ctx) is None
    assert R.reader("mfu.cond")(ctx) is None
    assert 0 < R.reader("mfu.train")(ctx) < 100
    assert R.reader("idle.train")(ctx) == 99.0


def test_work_is_what_lies_between_the_rounds_sentinels():
    """Device events on a clock 0.25 s behind the host's, with the previous
    round's last kernel recorded too: the work is what lies between the
    round's two sentinels, moved onto the host span's start."""
    dev = [("spin_kernel", -1.0, -0.99), ("old", -0.98, -0.97),
           ("spin_kernel", 0.05, 0.06), ("a", 0.07, 0.08), ("b", 0.09, 0.1),
           ("spin_kernel", 0.2, 0.21)]
    out = trace.work(dev, 0.3)
    assert [n for n, _, _ in out] == ["a", "b"]
    assert [(round(s, 9), round(e, 9)) for _, s, e in out] == [(0.31, 0.32), (0.33, 0.34)]
    assert trace.work(dev[-4:-1], 0.3) == trace.work([e for e in dev if e[0] != "spin_kernel"], 0.3) == []
