"""mfu.train: the operations a training step needs (_flops.train_step_flops,
from the cell's shapes) times the traced window's steps, over the window's
wall clock and the peak of the configuration's dtype, in %."""

from port_bench.metrics import _flops


def read(ctx):
    if ctx.kind != "train":
        return None
    work = ctx.counts["steps"] * _flops.train_step_flops(ctx.shapes)
    return 100.0 * work / ctx.window_s / _flops.PEAK_FLOPS[ctx.shapes["dtype"]]
