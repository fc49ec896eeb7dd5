"""gemm_ms.train: device time per step, in ms, of the kernels whose names
carry "gemm" in the traced window: cuBLAS's matrix products, those of the
inverse route (linalg/ops.py) and the predictive's own, and the blocked
updates cuBLAS runs inside its triangular solves."""


def read(ctx):
    if ctx.kind != "train":
        return None
    times = [end - start for name, start, end in ctx.events if "gemm" in name.lower()]
    if not times:
        return None
    return 1e3 * sum(times) / ctx.counts["steps"]
