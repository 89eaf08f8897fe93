"""The whole step's share of the chip's peak: the float32 operations of
Gaussian evaluation (K2) at 67 TFLOP/s plus the int32 operations of
senone evaluation (K3) and of the Viterbi (K6 or K4's carry form) at
33.5 TOP/s, summed over the window, over the traced window's
wall time."""


def read(ctx):
    if ctx.device is None or not ctx.work:
        return None
    return 100.0 * sum(w.peak_s for w in ctx.work.values()) \
        / ctx.device["window_s"]
