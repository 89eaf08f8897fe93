"""``batches_cont``: the ``batches`` kind (many readers' readings of one
story, a paragraph a row; its traffic, warm-up, closed loop and kept
sample) on a fully continuous model of one 39-dim stream.

Its warm-up first asks the program how it reads the features of the
model's one stream (``TorchAligner.streams``) and stops the run
(``RunError``) where the answer is not one stream of 39 dims: a program
that would read K1's output as three streams of 13 cannot run this
configuration.  Its check and its work are its own.  The check holds the sampled rows
to ``reference.cont.ContReference``, built over the ``Reference`` the
harness hands it (whose scorer is the PTM one): every senone's
Gaussians and mixture, then the reference's Viterbi and segments, the
same numbers and limits as ``batches``; its control rounds the fold to
bfloat16.  The work counts K11 (``counts.fold`` over every codebook: a
continuous model's batches are scored dense), K12 (``counts.ms``) and
K6 from each reading's real frames and graphs.
"""

from __future__ import annotations

import collections

from .. import counts
from ..counts import ms
from ..reduce import dims, graph_row
from ..reference.cont import ContReference
from ..run import RunError
from . import batches
from .batches import Story, keeper, loop, make  # noqa: F401


def warm(al, traffic: Story) -> int:
    streams = getattr(al, "streams", None)
    if streams != (1, 39):
        raise RunError(f"the program reads the model's features as "
                       f"{streams!r}, not one stream of 39 dims")
    return batches.warm(al, traffic)


def check(ref, traffic: Story, kept: list, rec, params: dict, rng,
          control: str | None = None):
    return batches.check(ContReference.of(ref), traffic, kept, rec, params,
                         rng, control)


def work(ref, traffic: Story, rec, kept: list) -> dict:
    """Work by kernel over every batch of the window, each reading
    counted once and multiplied by the batches that sent it."""
    F, D, L, topn = dims(ref)
    C, S = ref.am.n_mgau, ref.am.n_sen
    n_best = min(topn, D) if topn > 0 else D
    times = collections.Counter(d["index"] % traffic.n_readings
                                for d in rec.done)
    out: dict = {}
    for r, n in times.items():
        lens = [len(a) for a in traffic.reading(r)]
        rows = [graph_row(ref, t, ref.fe.n_frames(m))
                for t, m in zip(traffic.texts, lens)]
        frames = sum(x.frames for x in rows)
        per = {"k11": counts.fold(frames, C, F, D, L, n_best),
               "k12": ms.senone_eval(frames, S, C, F, n_best, D),
               "k6": counts.viterbi_rows(rows)}
        for name, w in per.items():
            w = counts.Work(w.ops * n, w.nbytes * n, w.rate)
            if name in out:
                out[name] += w
            else:
                out[name] = w
    return out
