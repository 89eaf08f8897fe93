"""Write a synthetic acoustic model from a seed.

No acoustic model ships with the repository, so the PyTorch port's
tests and ``chip_smoke.py`` run on a model made here.  ``width="en-us"``
has the published width of CMU Sphinx en-us (ptm): 42 CI phones
(incl. SIL and two noise phones), 5,126 senones of which 126 are CI,
3-state left-to-right HMMs, 42 codebooks x 3 streams x 128 Gaussians x
13 dims, top-4.  ``width="small"`` keeps only the phones of its words,
32 Gaussians and a few CD senones per phone: the same code paths at a
size the CPU tests afford.

The weights are random, the shapes and tying are real: CD senones are
tied by base phone, so the PTM codebook of a senone is its base phone's
(``sen2cimap``), and triphones exist for every word position of the
dictionary's words, plus enough others to reference every senone.
Means and variances are drawn around the per-dimension statistics of
``tests/golden/austen-en/feat.f32`` so that top-4 sets are not
degenerate.  The mixture weights are an 8-bit sendump.

The other acoustic-model backends the loader selects (``am.py``) come
from the same draws, so that a variant differs from the ptm model only
in what its writer adds:

* ``backend="semi"``: one shared codebook (the first phone's), so
  ``n_mgau == 1`` selects the semi-continuous scorer;
* ``backend="ms"``: no sendump; float ``mixture_weights`` drawn after
  everything else and a ``senmgau`` map (each senone to its base
  phone's codebook), which selects the fully continuous backend;
* ``backend="ms1to1"``: no sendump, no senmgau; one codebook per senone
  (the first 8 of its base phone's Gaussians, moved by a further draw),
  so ``n_mgau == n_sen`` selects the ms backend's 1:1 fallback;
* ``sendump_bits=4`` (ptm and semi): the 8-bit weights clustered to a
  16-entry codebook (``tools/make_4b_sendump.py`` quantize_16) and
  written as a 4-bit clustered sendump;
* ``backend="ptm5st"``: the ptm model rewritten to 5-state HMMs the way
  ``tools/make_5st_model.py`` expands en-us: a text mdef with 5
  emitting states, each CI phone's states mapped to fresh CI senone ids
  that stand for its 3 senones as [s0, s0, s1, s1, s2], CD phones
  reusing their (shifted) senones the same way, a sendump with the
  columns duplicated to match, and a left-to-right [n_tmat, 5, 6]
  transition matrix with self, next and +2 skip transitions.

``make_cont_model`` writes a fully continuous model of the other
published layout, one stream of 39 dims (``1s_c_d_dd`` without
subvectors): the ms1to1 model's structure, then a codebook per senone
of ``n_density`` Gaussians over 39 dims (32 at en-us width, 8 small)
and float mixture weights, drawn from their own seed, and feat params
without ``svspec``.

Only numpy's MT19937 (``RandomState``) bits, IEEE arithmetic and
``math.fsum``/``sqrt`` are used, so the files are the same bytes on any
machine.  Usage: ``python tools/make_synth_model.py OUTDIR [en-us|small]
[ptm|semi|ms|ms1to1|ptm5st] [8|4]``; ``VARIANTS`` names the combinations the
tests and ``chip_smoke.py`` use.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

_TOOLS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TOOLS)
for _p in (_REPO, _TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from make_4b_sendump import quantize_16  # noqa: E402
from soundswallower_tpu_torch import s3file as s3  # noqa: E402

EN_US_PHONES = (
    "+NSN+ +SPN+ AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M "
    "N NG OW OY P R S SH SIL T TH UH UW V W Y Z ZH").split()
FILLERS = {"SIL", "+NSN+", "+SPN+"}
WORDS = [
    ("he", "HH IY"), ("was", "W AA Z"), ("was(2)", "W AH Z"),
    ("not", "N AA T"), ("an", "AE N"), ("an(2)", "AH N"), ("ill", "IH L"),
    ("disposed", "D IH S P OW Z D"), ("young", "Y AH NG"), ("man", "M AE N"),
]
NOISE = [("<s>", "SIL"), ("</s>", "SIL"), ("<sil>", "SIL"),
         ("[NOISE]", "+NSN+"), ("[SPEECH]", "+SPN+")]
# en-us feat_params (tests/test_fe.py) + batch CMN, 1s_c_d_dd, 3x13, top-4
FEAT_PARAMS = {
    "lowerf": 130, "upperf": 3700, "nfilt": 20, "transform": "dct",
    "lifter": 22, "remove_noise": True, "cmn": "current",
    "feat": "1s_c_d_dd", "svspec": "0-12/13-25/26-38", "topn": 4,
}
WIDTHS = {
    # n_cd: CD senones in all; n_density: Gaussians per codebook
    "en-us": dict(n_cd=5000, n_density=128),
    "small": dict(n_cd=18 * 12, n_density=32),
}
# variant name -> (backend, sendump_bits)
VARIANTS = {"ptm": ("ptm", 8), "ptm4b": ("ptm", 4), "semi": ("semi", 8),
            "semi4b": ("semi", 4), "ms": ("ms", 8), "ms1to1": ("ms1to1", 8),
            "ptm5st": ("ptm5st", 8)}
FEAT_GOLDEN = os.path.join(_REPO, "tests", "golden", "austen-en", "feat.f32")


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
    f = np.fromfile(FEAT_GOLDEN, np.float32).reshape(-1, 3, 13)
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


def _triphones(phones, rng, pools):
    """(base, lc, rc, wpos) keys: every word position the dictionary
    needs, then random other contexts until each base phone has a
    triphone per senone of its largest state pool."""
    speech = [p for p in phones if p not in FILLERS]
    ctx = speech + ["SIL"]
    keys: dict[str, list] = {b: [] for b in speech}
    seen = set()

    def add(b, l, r, w):
        if (b, l, r, w) not in seen:
            seen.add((b, l, r, w))
            keys[b].append((b, l, r, w))

    for _, pron in WORDS:
        p = pron.split()
        if len(p) == 1:
            for l in ctx:
                for r in ctx:
                    add(p[0], l, r, "s")
            continue
        for l in ctx:
            add(p[0], l, p[1], "b")
        for r in ctx:
            add(p[-1], p[-2], r, "e")
        for i in range(1, len(p) - 1):
            add(p[i], p[i - 1], p[i + 1], "i")
    for b in speech:
        need = max(len(pl) for pl in pools[b])
        while len(keys[b]) < need:
            add(b, ctx[rng.randint(len(ctx))], ctx[rng.randint(len(ctx))],
                "bei"[rng.randint(3)])
    return [k for b in speech for k in sorted(keys[b])]


def _five_state_mdef(lines: list, n_ci: int, n_tri: int, n_sen: int):
    """The 3-state text mdef ``lines`` rewritten to 5 emitting states
    (tools/make_5st_model.py): CI phone c gets the fresh senones 5c ..
    5c+4, the CD senones move up past them, and every phone's states
    read its 3 senones as [s0, s0, s1, s1, s2].  Returns the new lines
    and the map from each new senone to the 3-state senone whose
    mixture weights it takes."""
    n_ci_sen = 3 * n_ci
    shift = 5 * n_ci - n_ci_sen
    sen_map = np.concatenate([
        np.array([[3 * c, 3 * c, 3 * c + 1, 3 * c + 1, 3 * c + 2]
                  for c in range(n_ci)]).reshape(-1),
        np.arange(n_ci_sen, n_sen)])
    head = ["0.3", f"{n_ci} n_base", f"{n_tri} n_tri",
            f"{6 * (n_ci + n_tri)} n_state_map",
            f"{n_sen + shift} n_tied_state", f"{5 * n_ci} n_tied_ci_state",
            f"{n_ci} n_tied_tmat"]
    body = [ln for ln in lines[7:] if ln.startswith("#")]
    phones = [ln.split() for ln in lines[7:] if not ln.startswith("#")]
    for i, tok in enumerate(phones):
        if i < n_ci:
            sen = [5 * i + k for k in range(5)]
        else:
            s0, s1, s2 = (int(x) + shift for x in tok[6:9])
            sen = [s0, s0, s1, s1, s2]
        body.append(" ".join(tok[:6] + [str(x) for x in sen] + ["N"]))
    return head + body, sen_map


def _five_state_tmat(n_tmat: int) -> np.ndarray:
    """tools/make_5st_model.py's left-to-right 5-state topology: self
    0.55, next 0.35, +2 skip 0.10 (the last state: self 0.6, exit 0.4)."""
    tp = np.zeros((n_tmat, 5, 6), np.float64)
    for t in range(n_tmat):
        for i in range(4):
            tp[t, i, i] = 0.55
            tp[t, i, i + 1] = 0.35
            tp[t, i, i + 2] = 0.10
        tp[t, 4, 4] = 0.6
        tp[t, 4, 5] = 0.4
    return tp


def make_synth_model(outdir: str, seed: int = 0, width: str = "en-us",
                     backend: str = "ptm", sendump_bits: int = 8) -> str:
    """Write mdef, means, variances, the mixture weights (sendump, or
    mixture_weights [+ senmgau] for ms), transition_matrices,
    feat_params.json, dict.txt and noisedict.txt into outdir."""
    if backend not in ("ptm", "semi", "ms", "ms1to1", "ptm5st"):
        raise ValueError(f"unknown backend {backend!r}")
    if sendump_bits not in (8, 4) or (sendump_bits == 4
                                      and backend not in ("ptm", "semi")):
        raise ValueError(f"sendump_bits={sendump_bits} for {backend}")
    w = WIDTHS[width]
    rng = np.random.RandomState(seed)
    if width == "en-us":
        phones = list(EN_US_PHONES)
    else:
        used = {ph for _, pron in WORDS for ph in pron.split()}
        phones = sorted(used | {"SIL"})
    n_ci = len(phones)
    speech = [p for p in phones if p not in FILLERS]
    n_ci_sen = 3 * n_ci
    n_cd = w["n_cd"]
    n_sen = n_ci_sen + n_cd
    D = w["n_density"]

    # CD senones: a contiguous block per base phone, split by HMM state
    pools, pos = {}, n_ci_sen
    sen2ci = np.repeat(np.arange(n_ci), 3)
    sen2ci = np.concatenate([sen2ci, np.zeros(n_cd, np.int64)])
    for i, b in enumerate(speech):
        cnt = n_cd // len(speech) + (1 if i < n_cd % len(speech) else 0)
        sen2ci[pos:pos + cnt] = phones.index(b)
        block = np.arange(pos, pos + cnt)
        pos += cnt
        pools[b] = [block[j::3][rng.permutation(len(block[j::3]))]
                    for j in range(3)]
    tri = _triphones(phones, rng, pools)
    count = {b: 0 for b in speech}
    pid = {p: i for i, p in enumerate(phones)}
    lines = ["0.3", f"{n_ci} n_base", f"{len(tri)} n_tri",
             f"{4 * (n_ci + len(tri))} n_state_map", f"{n_sen} n_tied_state",
             f"{n_ci_sen} n_tied_ci_state", f"{n_ci} n_tied_tmat",
             "#", "# Columns definitions",
             "#base lft  rt p attrib tmat      ... state id's ..."]
    for i, p in enumerate(phones):
        attrib = "filler" if p in FILLERS else "n/a"
        lines.append(f"{p} - - - {attrib} {i} {3 * i} {3 * i + 1} "
                     f"{3 * i + 2} N")
    for b, l, r, wpos in tri:
        k = count[b]
        count[b] += 1
        sen = [int(pl[k % len(pl)]) for pl in pools[b]]
        lines.append(f"{b} {l} {r} {wpos} n/a {pid[b]} "
                     f"{sen[0]} {sen[1]} {sen[2]} N")
    if backend == "ptm5st":
        lines, sen_map = _five_state_mdef(lines, n_ci, len(tri), n_sen)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "mdef"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    # Gaussians around the austen feature statistics
    mean, sd = _feat_stats()
    shape = (n_ci, 3, D, 13)
    means = mean[None, :, None, :] + 0.8 * sd[None, :, None, :] \
        * _normal(rng, shape)
    scale = sd[None, :, None, :] * (0.35 + 0.5 * rng.random_sample(shape))
    var = scale * scale
    if backend == "semi":
        means, var = means[:1], var[:1]

    # 8-bit mixture weights: negated log weights, a few strong densities
    u = rng.random_sample((3, D, n_sen))
    mixw = (159 - np.floor(150.0 * (u * u * u * u))).astype(np.uint8)
    if backend == "ptm5st":
        s3.write_sendump_8b(os.path.join(outdir, "sendump"),
                            mixw[:, :, sen_map])
    if backend in ("ptm", "semi"):
        path = os.path.join(outdir, "sendump")
        if sendump_bits == 8:
            s3.write_sendump_8b(path, mixw)
        else:
            cw, cb = quantize_16(mixw)
            s3.write_sendump_4b(path, cw, cb, n_sen)

    # left-to-right transition matrices; odd phones get a 0->2 skip
    tp = np.zeros((n_ci, 3, 4), np.float64)
    for i in range(n_ci):
        stay = 0.55 + 0.3 * rng.random_sample(3)
        skip = 0.05 if i % 2 else 0.0
        tp[i, 0, 0], tp[i, 0, 1], tp[i, 0, 2] = stay[0], 1 - stay[0] - skip, skip
        tp[i, 1, 1], tp[i, 1, 2] = stay[1], 1 - stay[1]
        tp[i, 2, 2], tp[i, 2, 3] = stay[2], 1 - stay[2]
    if backend == "ptm5st":
        tp = _five_state_tmat(n_ci)
    s3.write_tmat_params(os.path.join(outdir, "transition_matrices"),
                         tp.astype(np.float32))

    if backend == "ms1to1":
        # a small codebook per senone, as 1:1 models have
        D = min(D, 8)
    if backend in ("ms", "ms1to1"):
        # float mixture weights [sen, feat, density], a few strong ones
        u = rng.random_sample((n_sen, 3, D))
        s3.write_mixw_float(os.path.join(outdir, "mixture_weights"),
                            (u * u * u * u + 1e-3).astype(np.float32))
    if backend == "ms":
        s3.write_senmgau(os.path.join(outdir, "senmgau"),
                         sen2ci.astype(np.uint32))
    elif backend == "ms1to1":
        # a codebook per senone: its base phone's, moved
        means = means[sen2ci, :, :D] + 0.25 * sd[None, :, None, :] \
            * _normal(rng, (n_sen, 3, D, 13))
        var = var[sen2ci, :, :D]
    s3.write_gauden_params(os.path.join(outdir, "means"),
                           means.astype(np.float32), [13, 13, 13])
    s3.write_gauden_params(os.path.join(outdir, "variances"),
                           var.astype(np.float32), [13, 13, 13])

    with open(os.path.join(outdir, "feat_params.json"), "w") as fh:
        json.dump(FEAT_PARAMS, fh, indent=1, sort_keys=True)
    with open(os.path.join(outdir, "dict.txt"), "w") as fh:
        fh.writelines(f"{wd} {pron}\n" for wd, pron in WORDS)
    with open(os.path.join(outdir, "noisedict.txt"), "w") as fh:
        fh.writelines(f"{wd} {pron}\n" for wd, pron in NOISE
                      if pron.split()[0] in pid)
    return outdir


CONT_DENSITY = {"en-us": 32, "small": 8}


def make_cont_model(outdir: str, seed: int = 0,
                    width: str = "small") -> str:
    """A fully continuous model of one 39-dim stream: the ms1to1 model's
    mdef, dictionary and transition matrices, then means and variances
    [n_sen, 1, CONT_DENSITY[width], 39] around the austen features'
    statistics (cepstra, delta, delta-delta in that order), float
    mixture weights [n_sen, 1, D], and feat params without svspec, all
    drawn from ``seed`` (a stream of its own)."""
    make_synth_model(outdir, seed, width, "ms1to1", 8)
    mdef_sen = None
    with open(os.path.join(outdir, "mdef")) as fh:
        for ln in fh:
            if ln.strip().endswith("n_tied_state"):
                mdef_sen = int(ln.split()[0])
    D = CONT_DENSITY[width]
    rng = np.random.RandomState([seed, 39])
    mean, sd = (x.reshape(1, 1, 1, 39) for x in _feat_stats())
    shape = (mdef_sen, 1, D, 39)
    means = mean + 0.8 * sd * _normal(rng, shape)
    scale = sd * (0.35 + 0.5 * rng.random_sample(shape))
    s3.write_gauden_params(os.path.join(outdir, "means"),
                           means.astype(np.float32), [39])
    s3.write_gauden_params(os.path.join(outdir, "variances"),
                           (scale * scale).astype(np.float32), [39])
    u = rng.random_sample((mdef_sen, 1, D))
    s3.write_mixw_float(os.path.join(outdir, "mixture_weights"),
                        (u * u * u * u + 1e-3).astype(np.float32))
    feat = {k: v for k, v in FEAT_PARAMS.items() if k != "svspec"}
    with open(os.path.join(outdir, "feat_params.json"), "w") as fh:
        json.dump(feat, fh, indent=1, sort_keys=True)
    return outdir


if __name__ == "__main__":
    a = sys.argv[1:]
    make_synth_model(a[0], 0, a[1] if len(a) > 1 else "en-us",
                     a[2] if len(a) > 2 else "ptm",
                     int(a[3]) if len(a) > 3 else 8)
