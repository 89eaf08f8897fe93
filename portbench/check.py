"""How ``correct`` is decided.

Three numbers are compared, each with its limit:

* ``rows_failed``: rows of the window with no result (None), of every
  batch or chapter.  Forced alignment of these transcripts to audio of
  about 3 s a sentence always reaches a final state.  Limit 0.
* ``rows_malformed``: rows of the kept sample (every row of a seeded
  reservoir of batches; every chapter) whose segments do not tile the
  row's frames in order, word by word and phone by phone, or whose
  words (alternate pronunciations ``word(n)`` read as ``word``, ``<sil>``
  left out) are not the transcript's.  Limit 0.
* ``rows_differing``: rows of a sample of those (the longest and others
  drawn from the seed; a chapter drawn from the seed) whose word and
  phone segments differ in any word, phone, start or duration from the
  plain reference's (``reference.align``), computed after the window
  from the model files, the audio and the transcripts alone.  The port
  is exact against its reference at every stage, so the limit is 0.

The control (``reference.align``'s ``precision="bf16"``) puts the
reference computed with a bfloat16 distance fold in the program's place
on the sampled rows, and the same numbers and limits judge it
(``numbers``, ``verdict``): it has to come out as not correct (PERF.md
gives the readings).
"""

from __future__ import annotations

import re

import numpy as np

from .reference.align import seg_rep

LIMITS = {"rows_failed": 0, "rows_malformed": 0, "rows_differing": 0}
_VARIANT = re.compile(r"\(\d+\)$")


def malformed(segs, n_frames: int, text: str) -> bool:
    """Whether a row's segments fail to tile [0, n_frames) or to spell
    its transcript."""
    if segs is None:
        return True
    rep = seg_rep(segs)
    t = 0
    for word, start, dur, phones in rep:
        if start != t or dur <= 0 or not phones:
            return True
        p = start
        for _, ps, pd in phones:
            if ps != p or pd <= 0:
                return True
            p += pd
        if p != start + dur:
            return True
        t += dur
    words = [_VARIANT.sub("", w) for w, *_ in rep if w != "<sil>"]
    return t != n_frames or words != text.split()


def sample_rows(kept: list, k: int, rng: np.random.Generator,
                length) -> list:
    """k (batch, row) pairs of the kept batches: the longest row
    (``length(b, r)``), and k - 1 drawn by rng from the others."""
    pairs = [(b, r) for b, (_, out) in enumerate(kept)
             for r in range(len(out))]
    longest = max(range(len(pairs)), key=lambda i: length(*pairs[i]))
    rest = [i for i in range(len(pairs)) if i != longest]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [pairs[i] for i in sorted([longest] + [rest[j] for j in pick])]


def differing(got: list, want: list) -> int:
    """Rows whose word and phone segments differ from the reference's."""
    return sum(seg_rep(a) != seg_rep(b) for a, b in zip(got, want))


def numbers(outs: list, want: list, frames: list, texts: list) -> dict:
    """LIMITS' numbers for rows ``outs`` put where the program's go (the
    control's), against the reference's ``want``."""
    return {"rows_failed": sum(o is None for o in outs),
            "rows_malformed": sum(malformed(o, n, t) for o, n, t in
                                  zip(outs, frames, texts)),
            "rows_differing": differing(outs, want)}


def limited(numbers: dict) -> dict:
    """Each compared number beside its limit."""
    return {k: {"value": numbers[k], "limit": lim}
            for k, lim in LIMITS.items()}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= v for k, v in LIMITS.items())
