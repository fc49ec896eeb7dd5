"""The GEMM readers gemm_ms.train and inv_gemm_roofline.train on a
hand-made context: device time of the kernels named "gemm", and the
program's counter of the inverse route's GEMM operations
(fit/graphs.py::inv_gemm_flops_per_step) over it, silent in other kinds
of cell and where the program keeps no counter."""

import pytest

from port_bench import run as R

SHAPES = dict(B=4, F=3, m=2048, d=6, P=50, dtype="float64")
EVENTS = [("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize128x64x32", 0.0, 3e-3),
          ("void_trsm_left_kernel_int__double__256", 3e-3, 4e-3),
          ("void_cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x32_16x4>", 4e-3, 5e-3),
          ("chol_kernel", 5e-3, 6e-3)]


def _ctx(kind, events=EVENTS):
    return R.Ctx(kind, SHAPES, dict(steps=20), events, 0.1, 6e-3)


def test_gemm_ms_sums_the_gemm_kernels_per_step():
    assert R.reader("gemm_ms.train")(_ctx("train")) == pytest.approx(1e3 * 4e-3 / 20)
    assert R.reader("gemm_ms.train")(_ctx("cond")) is None
    assert R.reader("gemm_ms.train")(_ctx("train", EVENTS[1:2])) is None


def test_inv_gemm_roofline_reads_the_counter(monkeypatch):
    from mobocmf_tpu_torch.fit import graphs
    monkeypatch.setattr(graphs, "inv_gemm_flops_per_step", 6.7e9)
    # 20 steps x 6.7e9 operations at 67e12 per second: 2 ms of 4 ms of GEMM
    assert R.reader("inv_gemm_roofline.train")(_ctx("train")) == pytest.approx(50.0)
    assert R.reader("inv_gemm_roofline.train")(_ctx("cond")) is None
    assert R.reader("inv_gemm_roofline.train")(_ctx("train", EVENTS[1:2])) is None


def test_inv_gemm_roofline_silent_without_the_counter(monkeypatch):
    from mobocmf_tpu_torch.fit import graphs
    monkeypatch.delattr(graphs, "inv_gemm_flops_per_step")
    assert R.reader("inv_gemm_roofline.train")(_ctx("train")) is None
    assert R.reader("gemm_ms.train")(_ctx("train")) == pytest.approx(0.2)
