"""The 95th percentile, over every batch of the window, of the time
from the client's align_batch_begin call to align_batch_end's return."""

import numpy as np


def read(ctx):
    lat = [d["latency_s"] for d in ctx.record.done]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
