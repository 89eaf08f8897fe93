"""The median host time of the window's ``begin`` spans (the benchmark's
own span around each call)."""

import statistics


def read(ctx):
    d = ctx.spans.durations("begin")
    return statistics.median(d) * 1e3 if d else None
