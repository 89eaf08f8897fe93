"""The ``synth`` model writer: a PTM acoustic model and its dictionary at
the sizes a configuration file gives, written from seeds.

The configuration's published numbers are the model's shape: CI phones
(CMU Sphinx en-us's 42, with SIL and two noise phones), senones and CI
senones, 3-state left-to-right HMMs, a codebook per CI phone of
``n_density`` Gaussians over 3 streams of 13 dims, top-N, the front
end's filter bank and FFT size, and the dictionary's entry count.  The
mixture weights are a 4-bit clustered sendump, as the published model
ships them (8-bit draws clustered to a 16-entry codebook).

Two seeds.  The configuration's ``writer.structure_seed`` draws the
dictionary and the tying, the same for every run: ``dictionary_words``
entries of synthetic words whose pronunciations (2-12 speech phones,
about 6.3 on average, as in CMUdict) cover every speech phone, about
one in 14 with an alternate pronunciation; triphones for every word
position the dictionary needs (all left contexts of a word's first
phone, all right contexts of its last), then random contexts until
every senone is used; the CD senones tied by base phone, so a senone's
codebook is its base phone's.  The run's seed draws the weights: means
and variances around the per-dimension statistics of
``data/austen-feat.f32``, mixture weights and transition matrices.  The
dictionary file lists the base words in rank order (the traffic draws
its text by rank).  Only numpy's MT19937 bits, IEEE arithmetic and
``math.fsum``/``sqrt`` are used, so the files are the same bytes on any
machine.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..reference.sst import s3file as s3

EN_US_PHONES = (
    "+NSN+ +SPN+ AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M "
    "N NG OW OY P R S SH SIL T TH UH UW V W Y Z ZH").split()
FILLERS = {"SIL", "+NSN+", "+SPN+"}
NOISE = [("<s>", "SIL"), ("</s>", "SIL"), ("<sil>", "SIL"),
         ("[NOISE]", "+NSN+"), ("[SPEECH]", "+SPN+")]
ALTERNATE_EVERY = 14
FEAT_STATS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "austen-feat.f32")


def _normal(rng: np.random.RandomState, shape) -> np.ndarray:
    """Approximately standard normal (Irwin-Hall of 12 uniforms):
    uniform bits and additions only, identical on every machine."""
    z = np.zeros(shape, np.float64)
    for _ in range(12):
        z = z + rng.random_sample(shape)
    return z - 6.0


def _feat_stats():
    """Per-(stream, dim) mean and standard deviation of the austen
    features, summed exactly (math.fsum)."""
    f = np.fromfile(FEAT_STATS, np.float32).reshape(-1, 3, 13)
    f = f.astype(np.float64)
    mean = np.zeros((3, 13))
    sd = np.zeros((3, 13))
    for i in range(3):
        for j in range(13):
            col = f[:, i, j].tolist()
            m = math.fsum(col) / len(col)
            mean[i, j] = m
            sd[i, j] = math.sqrt(math.fsum((x - m) ** 2 for x in col)
                                 / len(col))
    return mean, sd


class Dictionary:
    """``n_entries`` entries: ``n_base`` base words in rank order, about
    one in ALTERNATE_EVERY followed by an alternate pronunciation (one
    phone changed).  Pronunciations are codes into ``speech``: entry i's
    are ``codes[ends[i] - lens[i]:ends[i]]``."""

    def __init__(self, n_entries: int, speech: list[str],
                 rng: np.random.RandomState):
        S = len(speech)
        n_alt = n_entries // ALTERNATE_EVERY
        n_base = n_entries - n_alt
        lens = 2 + rng.binomial(10, 0.43, n_base)
        codes = rng.randint(S, size=int(lens.sum()))
        codes[:S] = np.arange(S)                 # every phone is used
        alt_of = (np.arange(n_alt) * n_base) // max(n_alt, 1)
        # alternates: a copy with one phone moved to another phone
        pos = (rng.random_sample(n_alt) * lens[alt_of]).astype(np.int64)
        shift = 1 + rng.randint(S - 1, size=n_alt)
        starts = np.cumsum(lens) - lens
        # entries in file order: base i, then its alternate if it has one
        has_alt = np.zeros(n_base, bool)
        has_alt[alt_of] = True
        entry_base = np.repeat(np.arange(n_base), 1 + has_alt)
        is_alt = np.zeros(len(entry_base), bool)
        is_alt[np.cumsum(1 + has_alt)[has_alt] - 1] = True
        elens = lens[entry_base]
        idx = np.repeat(starts[entry_base] - np.cumsum(elens) + elens,
                        elens) + np.arange(int(elens.sum()))
        ecodes = codes[idx]
        eends = np.cumsum(elens)
        alt_rows = np.nonzero(is_alt)[0]
        at = eends[alt_rows] - elens[alt_rows] + pos
        ecodes[at] = (ecodes[at] + shift) % S
        self.speech, self.lens, self.codes, self.ends = \
            speech, elens, ecodes, eends
        self.names = [f"w{i:06d}(2)" if a else f"w{i:06d}"
                      for i, a in zip(entry_base.tolist(), is_alt.tolist())]

    def lines(self) -> str:
        ph = np.array(self.speech)[self.codes]
        parts = np.split(ph, self.ends[:-1])
        return "".join(f"{w} {' '.join(p)}\n"
                       for w, p in zip(self.names, parts))


def _triphones(d: Dictionary, rng, pools):
    """(base, lc, rc, wpos) keys: every word position the dictionary
    needs, then random other contexts until each base phone has a
    triphone per senone of its largest state pool."""
    speech = d.speech
    ctx = speech + ["SIL"]
    C = len(ctx)
    first = d.ends - d.lens
    last = d.ends - 1
    c = np.arange(C)
    # a key as one number: ((base * 3 + wpos) * C + lc) * C + rc
    fb = np.unique(d.codes[first] * C + d.codes[first + 1])
    le = np.unique(d.codes[last] * C + d.codes[last - 1])
    inner = np.ones(len(d.codes), bool)
    inner[first] = False
    inner[last] = False
    m = np.nonzero(inner)[0]
    keys = np.concatenate([
        (((fb[:, None] // C * 3 + 0) * C + c[None]) * C + fb[:, None] % C),
        (((le[:, None] // C * 3 + 1) * C + le[:, None] % C) * C + c[None]),
        ((d.codes[m] * 3 + 2) * C + d.codes[m - 1]) * C + d.codes[m + 1],
    ], axis=None)
    keys = np.unique(keys)
    have = set(keys.tolist())
    per = np.bincount(keys // (3 * C * C), minlength=len(speech))
    extra = []
    for i, b in enumerate(speech):
        need = max(len(pl) for pl in pools[b])
        while per[i] < need:
            k = ((i * 3 + rng.randint(3)) * C + rng.randint(C)) * C \
                + rng.randint(C)
            if k not in have:
                have.add(k)
                extra.append(k)
                per[i] += 1
    keys = np.sort(np.concatenate([keys, np.array(extra, np.int64)]))
    k, r = np.divmod(keys, C)
    k, l = np.divmod(k, C)
    b, w = np.divmod(k, 3)
    return b, l, r, w


def quantize_16(mixw: np.ndarray, iters: int = 25):
    """uint8 mixture weights -> (cluster indices, 16-entry uint8
    codebook): a deterministic 1-D Lloyd on the value histogram, centres
    started at evenly spaced percentiles of the distinct values, ties to
    the lower centre."""
    hist = np.bincount(mixw.reshape(-1).astype(np.int64), minlength=256)
    support = np.nonzero(hist)[0]
    x = np.arange(256, dtype=np.int64)
    centers = support[np.linspace(0, len(support) - 1, 16).round()
                      .astype(np.int64)]
    for _ in range(iters):
        assign = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)
        new = centers.copy()
        for k in range(16):
            m = (assign == k) & (hist > 0)
            if m.any():
                new[k] = np.round(np.sum(x[m] * hist[m]) / np.sum(hist[m]))
        new = np.sort(new)
        if (new == centers).all():
            break
        centers = new
    assign = np.argmin(np.abs(x[:, None] - centers[None, :]),
                       axis=1).astype(np.uint8)
    return assign[mixw], centers.astype(np.uint8)


def write(outdir: str, conf: dict, seed: int) -> str:
    """Write mdef, means, variances, sendump, transition_matrices,
    feat_params.json, dict.txt and noisedict.txt into outdir: the model
    of configuration ``conf``, its weights drawn from ``seed`` (taken
    modulo 2**32, MT19937's seed range)."""
    phones = list(EN_US_PHONES)
    if conf["n_ciphone"] != len(phones) or conf["n_emit_state"] != 3 \
            or conf["n_codebook"] != len(phones):
        raise ValueError("the synth writer writes en-us's 42 phones, a "
                         "codebook each, 3-state HMMs")
    srng = np.random.RandomState(conf["writer"]["structure_seed"])
    rng = np.random.RandomState(seed % 2 ** 32)
    speech = [p for p in phones if p not in FILLERS]
    n_ci = len(phones)
    n_ci_sen = 3 * n_ci
    n_sen = conf["n_senone"]
    n_cd = n_sen - n_ci_sen
    D = conf["n_density"]
    words = Dictionary(conf["dictionary_words"], speech, srng)

    # CD senones: a contiguous block per base phone, split by HMM state
    pools, pos = {}, n_ci_sen
    for i, b in enumerate(speech):
        cnt = n_cd // len(speech) + (1 if i < n_cd % len(speech) else 0)
        block = np.arange(pos, pos + cnt)
        pos += cnt
        pools[b] = [block[j::3][srng.permutation(len(block[j::3]))]
                    for j in range(3)]
    tb, tl, tr, tw = _triphones(words, srng, pools)
    # triphone k of a base phone takes senone k of each state's pool
    k = np.arange(len(tb)) - np.searchsorted(tb, tb)
    sen = np.zeros((len(tb), 3), np.int64)
    for i, b in enumerate(speech):
        at = tb == i
        for j, pl in enumerate(pools[b]):
            sen[at, j] = pl[k[at] % len(pl)]
    ctx = speech + ["SIL"]
    pid = np.array([phones.index(p) for p in speech])
    lines = ["0.3", f"{n_ci} n_base", f"{len(tb)} n_tri",
             f"{4 * (n_ci + len(tb))} n_state_map", f"{n_sen} n_tied_state",
             f"{n_ci_sen} n_tied_ci_state", f"{n_ci} n_tied_tmat",
             "#", "# Columns definitions",
             "#base lft  rt p attrib tmat      ... state id's ..."]
    for i, p in enumerate(phones):
        attrib = "filler" if p in FILLERS else "n/a"
        lines.append(f"{p} - - - {attrib} {i} {3 * i} {3 * i + 1} "
                     f"{3 * i + 2} N")
    lines += [f"{speech[b]} {ctx[l]} {ctx[r]} {'bei'[w]} n/a {p} "
              f"{s0} {s1} {s2} N" for b, l, r, w, p, s0, s1, s2 in zip(
                  tb.tolist(), tl.tolist(), tr.tolist(), tw.tolist(),
                  pid[tb].tolist(), *sen.T.tolist())]
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "mdef"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    # Gaussians around the austen feature statistics
    mean, sd = _feat_stats()
    shape = (n_ci, 3, D, 13)
    means = mean[None, :, None, :] + 0.8 * sd[None, :, None, :] \
        * _normal(rng, shape)
    scale = sd[None, :, None, :] * (0.35 + 0.5 * rng.random_sample(shape))
    s3.write_gauden_params(os.path.join(outdir, "means"),
                           means.astype(np.float32), [13, 13, 13])
    s3.write_gauden_params(os.path.join(outdir, "variances"),
                           (scale * scale).astype(np.float32), [13, 13, 13])

    # mixture weights: negated log weights, a few strong densities,
    # clustered to 4 bits
    u = rng.random_sample((3, D, n_sen))
    mixw = (159 - np.floor(150.0 * (u * u * u * u))).astype(np.uint8)
    cw, cb = quantize_16(mixw)
    s3.write_sendump_4b(os.path.join(outdir, "sendump"), cw, cb, n_sen)

    # left-to-right transition matrices; odd phones get a 0->2 skip
    tp = np.zeros((n_ci, 3, 4), np.float64)
    for i in range(n_ci):
        stay = 0.55 + 0.3 * rng.random_sample(3)
        skip = 0.05 if i % 2 else 0.0
        tp[i, 0, 0], tp[i, 0, 1], tp[i, 0, 2] = stay[0], 1 - stay[0] - skip, skip
        tp[i, 1, 1], tp[i, 1, 2] = stay[1], 1 - stay[1]
        tp[i, 2, 2], tp[i, 2, 3] = stay[2], 1 - stay[2]
    s3.write_tmat_params(os.path.join(outdir, "transition_matrices"),
                         tp.astype(np.float32))

    feat = {"lowerf": conf["lowerf"], "upperf": conf["upperf"],
            "nfilt": conf["nfilt"], "nfft": conf["nfft"],
            "transform": "dct", "lifter": 22, "remove_noise": True,
            "cmn": "current", "feat": conf["feat"],
            "svspec": "0-12/13-25/26-38", "topn": conf["topn"]}
    with open(os.path.join(outdir, "feat_params.json"), "w") as fh:
        json.dump(feat, fh, indent=1, sort_keys=True)
    with open(os.path.join(outdir, "dict.txt"), "w") as fh:
        fh.write(words.lines())
    with open(os.path.join(outdir, "noisedict.txt"), "w") as fh:
        fh.writelines(f"{w} {p}\n" for w, p in NOISE)
    return outdir
