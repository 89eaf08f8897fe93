"""The median host time of the window's ``chapter`` spans (the benchmark's
own span around each call)."""

import statistics


def read(ctx):
    d = ctx.spans.durations("chapter")
    return statistics.median(d) * 1e3 if d else None
