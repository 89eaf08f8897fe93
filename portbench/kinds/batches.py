"""``batches``: many readers' readings of one story, a paragraph a row.

A story of ``paragraphs`` transcripts, each ``sentences_per_paragraph``
[lo, hi] sentences of ``words_per_sentence`` [lo, hi] words (Zipf's
law, ``zipf_s``).  The story's text is the same for every seed (drawn
from the mix's ``text_seed``); the seed puts its paragraphs in its own
order.  A batch is one reader's reading of the whole story in story
order, ``readings`` distinct readings cycled, each sentence with its
own cut and dither.  One client keeps ``in_flight`` batches dispatched
(``align_batch_begin`` of the next before ``align_batch_end`` of the
oldest); it stops sending at the deadline, finishes what is in flight,
and the window closes when the last result is back.  Spans ``begin``
and ``end`` time each call on the host clock.

The check keeps a seeded reservoir of ``check_batches`` whole batches,
and compares ``check_rows`` of their rows (the longest and others drawn
from the seed) with the reference's mixed route.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from .. import check as chk
from .. import counts, gen
from ..loops import Record, Reservoir
from ..reduce import codebooks, dims, graph_row


class Story:
    def __init__(self, params: dict, seed: int, words: list[str]):
        words = np.array(words)
        rng = gen.rng_for(params["text_seed"], 1)
        P = params["paragraphs"]
        per_par = gen.multiset(*params["sentences_per_paragraph"], P, rng)
        sents = gen.sentences(int(per_par.sum()),
                              params["words_per_sentence"], words,
                              params["zipf_s"], rng)
        ends = np.cumsum(per_par)
        texts = [" ".join(sents[e - c:e]) for c, e in zip(per_par, ends)]
        order = gen.rng_for(seed, 1).permutation(P)
        self.per_par = per_par[order]
        self.texts = [texts[i] for i in order]
        audio = gen.Audio(seed, params["dither_lsb"])
        self._readings = [audio.rows(list(self.per_par))
                          for _ in range(params["readings"])]
        self.in_flight = params["in_flight"]

    def reading(self, i: int) -> list[np.ndarray]:
        return self._readings[i % len(self._readings)]

    @property
    def n_readings(self) -> int:
        return len(self._readings)


def make(params: dict, seed: int, words: list[str]) -> Story:
    return Story(params, seed, words)


def warm(al, traffic: Story) -> int:
    for i in range(traffic.n_readings):
        al.align_batch_end(al.align_batch_begin(traffic.reading(i),
                                                traffic.texts))
    h = al.align_batch_begin(traffic.reading(0), traffic.texts)
    h2 = al.align_batch_begin(traffic.reading(1), traffic.texts)
    al.align_batch_end(h)
    al.align_batch_end(h2)
    return traffic.n_readings


def keeper(params: dict, rng) -> Reservoir:
    return Reservoir(params["check_batches"], rng)


def loop(al, traffic: Story, samprate: int, seconds: float, spans,
         keep: Reservoir, start: int = 0) -> Record:
    """The story loop from reading ``start``; kept batches go to
    ``keep`` as (reading index, outputs)."""
    rec = Record()
    texts = traffic.texts
    pending: collections.deque = collections.deque()
    i = start
    rec.t0 = time.perf_counter()
    deadline = rec.t0 + seconds
    while True:
        while len(pending) < traffic.in_flight and (
                not pending or time.perf_counter() < deadline):
            audios = traffic.reading(i)
            t0 = time.perf_counter()
            with spans("begin"):
                h = al.align_batch_begin(audios, texts)
            pending.append((i, h, t0))
            i += 1
        if not pending:
            break
        j, h, t0 = pending.popleft()
        with spans("end"):
            out = al.align_batch_end(h)
        t1 = time.perf_counter()
        lens = [len(a) for a in traffic.reading(j)]
        ok = [o is not None for o in out]
        rec.done.append(dict(
            rows=len(lens), failed=len(lens) - sum(ok), latency_s=t1 - t0,
            audio_s=sum(n for n, g in zip(lens, ok) if g) / samprate,
            index=j))
        keep.offer((j, out))
        if not pending and time.perf_counter() >= deadline:
            break
    rec.t1 = time.perf_counter()
    return rec


def check(ref, traffic: Story, kept: list, rec: Record, params: dict, rng,
          control: str | None = None):
    texts = traffic.texts
    n_mal = 0
    for j, out in kept:
        audios = traffic.reading(j)
        n_mal += sum(chk.malformed(segs, ref.fe.n_frames(len(audios[r])),
                                   texts[r]) for r, segs in enumerate(out))
    pairs = chk.sample_rows(kept, params["check_rows"], rng, lambda b, r: len(
        traffic.reading(kept[b][0])[r]))
    audios = [traffic.reading(kept[b][0])[r] for b, r in pairs]
    rows = [texts[r] for _, r in pairs]
    want = ref.align_rows(audios, rows, texts)
    got = [kept[b][1][r] for b, r in pairs]
    nums = {"rows_failed": rec.failed, "rows_malformed": n_mal,
            "rows_differing": chk.differing(got, want),
            "rows_checked": len(pairs)}
    if control is None:
        return nums, None
    low = ref.align_rows(audios, rows, texts, precision=control)
    return nums, chk.numbers(low, want, [ref.fe.n_frames(len(a))
                                         for a in audios], rows)


def work(ref, traffic: Story, rec: Record, kept: list) -> dict:
    """Work by kernel over every batch of the window: a batch is one
    reading of the story, so each reading is counted once and
    multiplied.  The scorer's columns are the union of the story's
    senones (its pad columns score senone 0, whose codebook joins the
    norm) or, once the union is dense, every senone and codebook: the
    frame's best over all of them is part of the result."""
    F, D, L, topn = dims(ref)
    senset = ref.union_senones(traffic.texts)
    if senset is None:
        n_cols, n_cb = ref.am.n_sen, codebooks(ref, np.arange(ref.am.n_sen))
    else:
        pad = max(256, -(-len(senset) // 256) * 256) > len(senset)
        n_cols = len(senset)
        n_cb = codebooks(ref, np.r_[senset, [0] if pad else []].astype(int))
    times = collections.Counter(d["index"] % traffic.n_readings
                                for d in rec.done)
    out: dict = {}
    for r, n in times.items():
        lens = [len(a) for a in traffic.reading(r)]
        rows = [graph_row(ref, t, ref.fe.n_frames(m))
                for t, m in zip(traffic.texts, lens)]
        frames = sum(x.frames for x in rows)
        per = {"k2": counts.fold(frames, n_cb, F, D, L, topn),
               "k3": counts.senone_eval(frames * n_cols, F, topn),
               "k6": counts.viterbi_rows(rows)}
        for name, w in per.items():
            w = counts.Work(w.ops * n, w.nbytes * n, w.rate)
            if name in out:
                out[name] += w
            else:
                out[name] = w
    return out
