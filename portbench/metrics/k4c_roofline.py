"""The share of its roofline that K4's carry form (``viterbi_chunk``)
reaches: the least time of its work in the window
(``counts.viterbi_chunk``, from the cell's real shapes) over the
device time of its launches in the trace."""


def read(ctx):
    return ctx.roofline("k4c", "viterbi_chunk_kernel")
