"""The median host time of the window's ``end`` spans (the benchmark's
own span around each call)."""

import statistics


def read(ctx):
    d = ctx.spans.durations("end")
    return statistics.median(d) * 1e3 if d else None
