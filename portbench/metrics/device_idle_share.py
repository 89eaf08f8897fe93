"""The share of the traced window in which no operation ran on the
device: 1 - busy_s / window_s, busy_s the union of the intervals of the
kernels, copies and sets in the trace."""


def read(ctx):
    if ctx.device is None or ctx.device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.device["busy_s"] / ctx.device["window_s"])
