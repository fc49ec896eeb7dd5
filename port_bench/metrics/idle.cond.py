"""idle.cond: the share of the traced window, in %, in which no kernel or
copy ran on the device (one minus the union of their intervals)."""


def read(ctx):
    if ctx.kind != "cond":
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
