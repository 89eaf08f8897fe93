"""The share of its roofline that K6 (``viterbi_rows``) reaches: the
least time of its work in the window (``counts.viterbi_rows``, from
the cell's real shapes) over the device time of its launches in the
trace."""


def read(ctx):
    return ctx.roofline("k6", "viterbi_rows_kernel")
