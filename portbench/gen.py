"""The benchmark's traffic pieces, shared by the traffic kinds.

A traffic mix is a data file, ``traffic/<name>.json``; its ``kind``
names the module of ``kinds/`` that reads it (``kinds/<kind>.py``).
Every size is a fixed multiset that the seed only puts in another
order, so every seed asks for the same work: the counts of sentences a
paragraph or chapter holds, of words a sentence holds, how often each
of the dictionary's base words is used, and the samples cut from each
utterance.  What the seed draws is the order, the dither and (through
the model writer) the weights.

Words follow Zipf's law, as the words of English text do: in ``n``
words of text, the dictionary's base word of rank r (its place in the
dictionary file) is used about n r**-s / H times (``zipf_s`` = s, H the
sum of k**-s over the dictionary), the counts rounded to whole numbers
that sum to n (the largest remainders rounded up).

Audio is ``data/austen.raw`` (8 kHz, 23,920 samples, 298 frames: "he
was not an ill disposed young man", the repository's one recording of
speech), one copy per sentence, its end cut by a multiple of 37
samples below 592, dithered by +-``dither_lsb`` from a bank of seeded
noise.  The model's weights are random, so no text matches any audio:
forced alignment still has one best path, and a row's frames (about 3
s a sentence) outnumber its graph's states.
"""

from __future__ import annotations

import functools
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CUT_STEP = 37        # samples; cuts are CUT_STEP * k, k < CUT_KINDS
CUT_KINDS = 16
NOISE_BANK = 1 << 20


def base_audio() -> np.ndarray:
    return np.fromfile(os.path.join(DATA, "austen.raw"), np.int16)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream``) of ``seed``; any whole
    number is a seed (taken modulo 2**64)."""
    return np.random.Generator(np.random.PCG64([int(seed) % 2 ** 64,
                                                stream]))


def multiset(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n values cycling over lo..hi, in a seeded order."""
    v = lo + np.arange(n) % (hi - lo + 1)
    rng.shuffle(v)
    return v


def zipf_counts(n: int, n_words: int, s: float) -> np.ndarray:
    """How often each of ``n_words`` words (by rank) is used in ``n``
    words of text under Zipf's law with exponent ``s``."""
    w = np.arange(1, n_words + 1, dtype=np.float64) ** -s
    c = n * w / w.sum()
    k = np.floor(c).astype(np.int64)
    k[np.argsort(k - c, kind="stable")[:n - int(k.sum())]] += 1
    return k


@functools.lru_cache(maxsize=64)
def _zipf_ranks(n: int, n_words: int, s: float) -> np.ndarray:
    """The ranks of ``n`` words of text, each as often as zipf_counts
    says, in rank order."""
    k = zipf_counts(n, n_words, s)
    used = np.nonzero(k)[0]
    return np.repeat(used, k[used])


def sentences(n: int, wrange, words: np.ndarray, zipf_s: float,
              rng) -> list[str]:
    """n sentences whose word counts cycle over wrange and whose words
    (an array, by rank) are drawn by ``zipf_counts``, each in a seeded
    order."""
    wc = multiset(wrange[0], wrange[1], n, rng)
    pool = words[_zipf_ranks(int(wc.sum()), len(words), zipf_s)]
    rng.shuffle(pool)
    ends = np.cumsum(wc)
    return [" ".join(pool[e - c:e]) for c, e in zip(wc, ends)]


class Audio:
    """Sentence audio: the base utterance, cut and dithered."""

    def __init__(self, seed: int, dither: int):
        self.base = base_audio().astype(np.int32)
        rng = rng_for(seed, 2)
        self.noise = rng.integers(-dither, dither + 1, NOISE_BANK,
                                  dtype=np.int32)
        self.rng = rng_for(seed, 3)

    def rows(self, per_row: list[int]) -> list[np.ndarray]:
        """Rows of per_row[i] sentences each, every sentence with its
        own cut (a fixed multiset, shuffled) and dither."""
        n = int(sum(per_row))
        cuts = CUT_STEP * (np.arange(n) % CUT_KINDS)
        self.rng.shuffle(cuts)
        lens = len(self.base) - cuts
        offs = self.rng.integers(0, NOISE_BANK - len(self.base), n)
        sig = np.concatenate([self.base[:m] for m in lens])
        sig += np.concatenate([self.noise[o:o + m] for o, m in
                               zip(offs, lens)])
        sig = np.clip(sig, -32768, 32767).astype(np.int16)
        row_len = np.add.reduceat(lens, np.r_[0, np.cumsum(per_row)[:-1]])
        return np.split(sig, np.cumsum(row_len)[:-1])
