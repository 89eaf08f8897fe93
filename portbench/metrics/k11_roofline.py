"""The share of its roofline that K11 (``ms_dist_topn``, the continuous
scorer's fold and top-N) reaches: the least time of its work in the
window (``counts.fold``, from the cell's real shapes) over the device
time of its launches in the trace."""


def read(ctx):
    return ctx.roofline("k11", "ms_dist_topn_kernel")
