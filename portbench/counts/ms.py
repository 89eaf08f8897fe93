"""The work of the fully continuous scorer's senone evaluation (K12,
``ms_senone_eval``), counted from the cell's inputs as ``counts`` counts
the other kernels'.  K11, its fold and top-N, is ``counts.fold``."""

from __future__ import annotations

from . import I32_OPS, Work


def senone_eval(frames: int, senones: int, codebooks: int, streams: int,
                topn: int, density: int) -> Work:
    """K12 over ``frames`` frames of every senone: per (frame, senone,
    stream, top-N entry) 8 int32 operations (the rounded shift, the
    weight's subtraction, the log-add's max, min, difference, table
    read and add, and the sum over streams); K11's top-N distances and
    densities read once (8 bytes an entry, every codebook), each
    senone's weights once, the int16 scores written once."""
    ops = 8.0 * frames * senones * streams * topn
    nbytes = (8.0 * frames * codebooks * streams * topn
              + 1.0 * senones * streams * density + 2.0 * frames * senones)
    return Work(ops, nbytes, I32_OPS)
