"""``longform``: one chapter a call, each with a new transcript.

Chapters of ``sentences_per_chapter`` [lo, hi] sentences of
``words_per_sentence`` [lo, hi] words (Zipf's law, ``zipf_s``), in
``chapter_sizes`` sizes evenly spaced over the range.  The sizes come
in one fixed order that alternates the longest and the shortest left,
so that every window of a few chapters holds about the same work; every
chapter of one size holds the same multiset of words, in an order of
its own.  ``transcripts`` transcripts are drawn in set-up, from the
seed, and the window's calls take them in turn; a chapter's audio is
the pool's chapter of its size (built once a size).  One client sends
one chapter a call through ``align_longform_batch([audio], [text])``
(a ring of one, its default), so every call's graph is built inside
the window, as a user's would be; span ``chapter`` times each call.

The check keeps every chapter and compares ``check_rows`` of them,
drawn from the seed, with the reference's same-transcript route.
"""

from __future__ import annotations

import time

import numpy as np

from .. import check as chk
from .. import counts, gen
from ..loops import Record
from ..reduce import codebooks, dims, graph_row


class Chapters:
    def __init__(self, params: dict, seed: int, words: list[str]):
        words = np.array(words)
        lo, hi = params["sentences_per_chapter"]
        k = params["chapter_sizes"]
        self.sizes = [int(round(lo + j * (hi - lo) / (k - 1)))
                      for j in range(k)]
        self.order = [self.sizes[j // 2] if j % 2 == 0
                      else self.sizes[-1 - j // 2] for j in range(k)]
        audio = gen.Audio(seed, params["dither_lsb"])
        self.audio = dict(zip(self.sizes, audio.rows(self.sizes)))
        rng = gen.rng_for(seed, 1)

        def text(n):
            return " ".join(gen.sentences(n, params["words_per_sentence"],
                                          words, params["zipf_s"], rng))

        self.texts = [text(self.size(i))
                      for i in range(params["transcripts"])]
        # the longest and the shortest chapter, with transcripts of
        # their own
        self.warm = [(self.audio[n], text(n))
                     for n in (max(self.sizes), min(self.sizes))]

    def size(self, i: int) -> int:
        """Chapter i's sentence count: the sizes in a fixed order, the
        longest and the shortest left in turn, over and over."""
        return self.order[i % len(self.order)]

    def chapter(self, i: int) -> tuple[np.ndarray, str]:
        return self.audio[self.size(i)], self.texts[i % len(self.texts)]


def make(params: dict, seed: int, words: list[str]) -> Chapters:
    if params["transcripts"] % params["chapter_sizes"]:
        raise ValueError("transcripts must be a multiple of chapter_sizes")
    return Chapters(params, seed, words)


def warm(al, traffic: Chapters) -> int:
    for audio, text in traffic.warm:
        al.align_longform_batch([audio], [text])
    return 0


class Keep(list):
    def offer(self, item) -> None:
        self.append(item)

    @property
    def items(self) -> list:
        return self


def keeper(params: dict, rng) -> Keep:
    return Keep()


def loop(al, traffic: Chapters, samprate: int, seconds: float, spans,
         keep: Keep, start: int = 0) -> Record:
    """The chapter loop from chapter ``start``; every chapter goes to
    ``keep`` as (audio, text, output)."""
    rec = Record()
    i = start
    rec.t0 = time.perf_counter()
    deadline = rec.t0 + seconds
    while i == start or time.perf_counter() < deadline:
        audio, text = traffic.chapter(i)
        t0 = time.perf_counter()
        with spans("chapter"):
            out = al.align_longform_batch([audio], [text])
        t1 = time.perf_counter()
        ok = out[0] is not None
        rec.done.append(dict(rows=1, failed=int(not ok), latency_s=t1 - t0,
                             audio_s=len(audio) / samprate if ok else 0.0,
                             index=i))
        keep.offer((audio, text, out[0]))
        i += 1
    rec.t1 = time.perf_counter()
    return rec


def check(ref, traffic: Chapters, kept: list, rec: Record, params: dict,
          rng, control: str | None = None):
    n_mal = sum(chk.malformed(segs, ref.fe.n_frames(len(a)), text)
                for a, text, segs in kept)
    pick = sorted(rng.choice(len(kept), size=min(params["check_rows"],
                                                 len(kept)), replace=False))
    audios = [kept[i][0] for i in pick]
    texts = [kept[i][1] for i in pick]
    want = [ref.align_long(a, t) for a, t in zip(audios, texts)]
    nums = {"rows_failed": rec.failed, "rows_malformed": n_mal,
            "rows_differing": chk.differing([kept[i][2] for i in pick],
                                            want),
            "rows_checked": len(pick)}
    if control is None:
        return nums, None
    low = [ref.align_long(a, t, control) for a, t in zip(audios, texts)]
    return nums, chk.numbers(low, want, [ref.fe.n_frames(len(a))
                                         for a in audios], texts)


def work(ref, traffic: Chapters, rec: Record, kept: list) -> dict:
    """Work by kernel over every chapter of the window: K2 over the
    codebooks of the chapter's graph, K3 over its senones, K4's carry
    form over its states."""
    F, D, L, topn = dims(ref)
    out = {"k2": counts.Work(rate=counts.F32_OPS),
           "k3": counts.Work(rate=counts.I32_OPS),
           "k4c": counts.Work(rate=counts.I32_OPS)}
    for audio, text, _ in kept:
        r = graph_row(ref, text, ref.fe.n_frames(len(audio)))
        out["k2"] += counts.fold(r.frames, codebooks(
            ref, ref.graph(text).senid.ravel()), F, D, L, topn)
        out["k3"] += counts.senone_eval(r.frames * r.senones, F, topn)
        out["k4c"] += counts.viterbi_chunk(r)
    return out
