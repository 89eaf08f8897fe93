"""The share of its roofline that K12 (``ms_senone_eval``, the continuous
scorer's senone evaluation and best subtraction) reaches: the least
time of its work in the window (``counts.ms.senone_eval``, from the
cell's real shapes) over the device time of its two kernels in the
trace."""


def read(ctx):
    return ctx.roofline("k12", "ms_senone_eval_kernel", "ms_best_sub_kernel")
