"""trsm_ms.cond: device time per step, in ms, of the kernels whose names
carry "trsm" (cuBLAS's triangular solves) in the traced window."""


def read(ctx):
    if ctx.kind != "cond":
        return None
    times = [end - start for name, start, end in ctx.events if "trsm" in name.lower()]
    if not times:
        return None
    return 1e3 * sum(times) / ctx.counts["steps"]
