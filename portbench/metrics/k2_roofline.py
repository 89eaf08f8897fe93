"""The share of its roofline that K2 (``dist_topn_norm``) reaches: the
least time of its work in the window (``counts.fold``, from the cell's
real shapes) over the device time of its launches in the trace."""


def read(ctx):
    return ctx.roofline("k2", "dist_topn_norm_kernel")
