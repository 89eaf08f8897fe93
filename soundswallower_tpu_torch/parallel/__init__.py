"""Parallel forms of the port: the sequence-parallel long form
(seqpipe, the counterpart of soundswallower_tpu/parallel/seqpipe.py)."""

from .seqpipe import SeqRing, align_longform, seq_ring

__all__ = ["SeqRing", "align_longform", "seq_ring"]
