"""inv_gemm_roofline.train: the least time of the inverse route's GEMM
operations at the dtype's peak, over the device time of the kernels whose
names carry "gemm" in the traced window, in %. The operations are the
program's counter mobocmf_tpu_torch/fit/graphs.py::inv_gemm_flops_per_step
(2 rows inner cols per matrix of each product the route runs, counted
from shapes when the step is captured) times the traced steps. The GEMM
kernels' time also holds products the counter leaves out (the
predictive's own, cuBLAS's updates inside its solves), so the share reads
low and cannot pass 100. Silent where the program keeps no such counter."""

from port_bench.metrics import _flops


def read(ctx):
    if ctx.kind != "train":
        return None
    from mobocmf_tpu_torch.fit import graphs
    per_step = getattr(graphs, "inv_gemm_flops_per_step", None)
    times = [end - start for name, start, end in ctx.events if "gemm" in name.lower()]
    if per_step is None or not times:
        return None
    least = per_step * ctx.counts["steps"] / _flops.PEAK_FLOPS[ctx.shapes["dtype"]]
    return 100.0 * least / sum(times)
