"""k1_roofline.train: K1's least time over its device time in the traced
window, in %. Each launch (a "chol_kernel" event) factors B matrices of
m x m; its least time is the larger of B m^3/3 flops at the dtype's peak
and B 2 m^2 words at 3.35 TB/s (_flops.chol_bound_s)."""

from port_bench.metrics import _flops


def read(ctx):
    if ctx.kind != "train":
        return None
    times = [end - start for name, start, end in ctx.events if "chol_kernel" in name]
    if not times:
        return None
    bound = len(times) * _flops.chol_bound_s(ctx.shapes["B"], ctx.shapes["m"], ctx.shapes["dtype"])
    return 100.0 * bound / sum(times)
