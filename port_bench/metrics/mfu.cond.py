"""mfu.cond: the operations a conditioned step needs (_flops.cond_step_flops)
times the traced window's steps, over its wall clock and the peak of the
configuration's dtype, in %."""

from port_bench.metrics import _flops


def read(ctx):
    if ctx.kind != "cond":
        return None
    work = ctx.counts["steps"] * _flops.cond_step_flops(ctx.shapes)
    return 100.0 * work / ctx.window_s / _flops.PEAK_FLOPS[ctx.shapes["dtype"]]
