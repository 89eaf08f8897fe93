"""K12's senone groups (``senscore_torch.ms_groups``) and the ranges
that let K12 sum in int32, on the CPU.

The groups against a brute force over ``sen2cb`` on the 42-codebook ms
model at en-us width, the 1:1 model (a codebook a senone) and hand-made
maps; the weights' range from the loader (``quantize_mixw_ms``) and the
8-bit table's; and a host rendering of K12's grouped int32 evaluation
(packed terms, weights read through the groups, int32 log-add chain,
per-frame minimum) against ``ms_senone_eval_plain`` (int64), on
distances that reach the floor, the zero guards, the table's end, both
int16 clamps and the top of the int32 range.
"""

import numpy as np
import pytest
import torch

from _torch_synth import variant_dir

from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.am import quantize_mixw_ms
from soundswallower_tpu_torch.logmath import SENSCR_SHIFT, LogMath
from soundswallower_tpu_torch.ops import senscore_torch as st

INT_MIN = -2 ** 31
NARROW = np.float32(2147482624.0)   # K12's int32 terms hold distances below


@pytest.fixture(scope="module")
def ms_scorers(tmp_path_factory):
    """The dense ms scorers of the en-us-width 42-codebook model and of
    the small 1:1 model, on the CPU."""
    out = {}
    for variant, width in (("ms", "en-us"), ("ms1to1", "small")):
        d = variant_dir(tmp_path_factory, variant, width)
        out[variant] = TorchAligner(hmm=d, samprate=8000,
                                    device="cpu").dense
    return out


def brute_groups(sen2cb: np.ndarray):
    """The groups by their definition: the senones sorted by codebook
    (ties by senone), the largest power of two G <= 128 whose windows of
    G sorted senones each hold at most 8 codebooks; each window's
    codebooks ascending, each senone's place among them."""
    order = np.array(sorted(range(len(sen2cb)), key=lambda s: (sen2cb[s], s)))
    G = 128
    while True:
        wins = [sorted(set(sen2cb[order[i:i + G]].tolist()))
                for i in range(0, len(order), G)]
        if G == 1 or max(len(w) for w in wins) <= 8:
            break
        G //= 2
    slot = np.array([wins[p // G].index(sen2cb[s])
                     for p, s in enumerate(order)])
    return order, G, wins, slot


def check_groups(sen2cb: np.ndarray, mixw: np.ndarray):
    g = st.build_ms_groups(torch.from_numpy(sen2cb.astype(np.int32)),
                           torch.from_numpy(mixw.astype(np.int32)),
                           torch.zeros(4, dtype=torch.int32))
    order, G, wins, slot = brute_groups(sen2cb)
    assert g.G == G and g.U == max(len(w) for w in wins)
    assert g.order.dtype == g.slot.dtype == g.gcb.dtype == torch.int32
    assert np.array_equal(g.order.numpy(), order)
    assert np.array_equal(g.slot.numpy(), slot)
    want = np.full((len(wins), g.U), -1)
    for i, w in enumerate(wins):
        want[i, :len(w)] = w
    assert np.array_equal(g.gcb.numpy(), want)
    S, F, D = mixw.shape
    row = g.wts.shape[1]
    assert g.wts.dtype == torch.uint8 and row % 4 == 0 and (row // 4) % 2
    assert row >= F * D and row - F * D < 8
    w = g.wts.numpy()
    assert np.array_equal(w[:, :F * D].reshape(S, F, D), mixw[order])
    assert not w[:, F * D:].any()
    return g


@pytest.mark.parametrize("variant", ["ms", "ms1to1"])
def test_groups_match_brute_force(ms_scorers, variant):
    """The 42-codebook model takes groups of 128 spanning at most 3
    codebooks (41 groups, the last of 6 senones); the 1:1 model groups
    of 8, one codebook a senone."""
    ms = ms_scorers[variant]
    g = check_groups(ms.sen2cb.numpy(), ms.mixw.numpy())
    if variant == "ms":
        assert (g.G, g.U, ms.S) == (128, 3, 5126)
        assert g.gcb.shape[0] == 41 and ms.S - 40 * 128 == 6
    else:
        assert ms.det.shape[0] == ms.S and (g.G, g.U) == (8, 8)
    assert st.ms_groups(ms) is st.ms_groups(ms)      # built once


@pytest.mark.parametrize("seed", range(4))
def test_groups_of_hand_made_maps(seed):
    """Random maps: many small codebooks (G falls below 128), codebooks
    out of senone order, unused codebooks, S not a multiple of G, one
    senone, one codebook."""
    rng = np.random.RandomState(seed)
    for S, C in ((1, 1), (300, 1), (1000, 400), (777, 60), (5, 5),
                 (2000, 9)):
        sen2cb = rng.randint(0, C, S)
        mixw = rng.randint(0, 256, (S, 3, 7))
        g = check_groups(sen2cb, mixw)
        assert g.G & (g.G - 1) == 0 and g.U <= 8


def test_replaced_scorer_builds_its_own_groups(ms_scorers):
    """A scorer made by dataclasses.replace (another aw, top-N or
    table) does not inherit the groups: its own are built at first use."""
    import dataclasses
    ms = ms_scorers["ms"]
    g = st.ms_groups(ms)
    ms2 = dataclasses.replace(ms, aw=2)
    assert ms2.groups is None
    g2 = st.ms_groups(ms2)
    assert g2 is not g and torch.equal(g2.order, g.order)


def test_mixw_range_justifies_int32(ms_scorers):
    """quantize_mixw_ms yields uint8 in [0, 255] (its clamp at 255, and 0
    for a probability of one), the 8-bit log-add table is uint8: K12's
    uint8 weights and table are exact, and with |fden| <= 2^21 a
    stream's log-add stays within 2^22, F streams' sum within int32.
    The groups refuse weights or a table outside [0, 255]."""
    lmath = LogMath(1.0001, 0, True)
    pdf = np.full((3, 2, 8), 1e-30, np.float32)
    pdf[0, :, 0] = 1.0
    pdf[1] = np.random.RandomState(0).uniform(0, 1, (2, 8))
    pdf[2, :, :2] = 0.5
    q = quantize_mixw_ms(pdf, 1e-20, lmath)
    assert q.dtype == np.uint8 and q.min() == 0 and q.max() == 255
    t8 = LogMath(1.0001, SENSCR_SHIFT, True).table
    assert t8.dtype == np.uint8
    ms = ms_scorers["ms"]
    assert 0 <= int(ms.mixw.min()) and int(ms.mixw.max()) <= 255
    assert 0 <= int(ms.logadd.min()) and int(ms.logadd.max()) <= 255
    # the int32 bound of the sum: F streams of at most 2^21 + 255 and
    # (n - 1) table entries each
    F, n = 64, 256
    assert F * (2 ** 21 + 255 + (n - 1) * 255) < 2 ** 31
    sc = torch.zeros(2, dtype=torch.int32)
    for mixw, table in ((torch.full((2, 1, 4), 256), torch.zeros(3)),
                        (torch.full((2, 1, 4), -1), torch.zeros(3)),
                        (torch.zeros((2, 1, 4)), torch.full((3,), 256))):
        with pytest.raises(ValueError, match=r"\[0, 255\]"):
            st.build_ms_groups(sc, mixw.int(), table.int())


def grouped_eval_int32(dval: torch.Tensor, cw: torch.Tensor,
                       ms: st.MsScorer) -> np.ndarray:
    """K12's design on the host, in int32 throughout (numpy wraps on
    overflow, so a range the design misjudged shows as a difference):
    each (frame, codebook, stream, entry) packed as fden * 256 +
    density; each sorted senone reads its group's codebook through its
    slot and its weights from the grouped uint8 rows; the log-add chain
    on the table with a zero past its end; each frame's minimum over the
    scores; then the subtraction."""
    g = st.ms_groups(ms)
    S, F, D = ms.mixw.shape
    N, C, _, n = dval.shape
    dv = dval.numpy()
    assert (dv < NARROW).all()       # a tile past it takes int64
    i32 = np.int32
    floor = dv < np.float32(INT_MIN)
    fden = np.where(floor, i32(INT_MIN >> SENSCR_SHIFT),
                    (np.where(floor, 0, dv).astype(i32)
                     + i32((1 << SENSCR_SHIFT) - 1)) >> i32(SENSCR_SHIFT))
    fden = fden.astype(i32)
    terms = fden * i32(256) + cw.numpy().astype(i32)
    assert terms.dtype == i32
    wts = g.wts.numpy()[:, :F * D].reshape(S, F, D).astype(i32)
    tl = ms.logadd.shape[0]
    tab = np.append(ms.logadd.numpy().astype(i32), i32(0))
    zero = i32(ms.zero8)
    out = np.empty((N, S), np.int16)
    fmin = np.full(N, np.iinfo(i32).max, i32)
    fidx = np.arange(F)[None, :, None]
    for p, s in enumerate(g.order.numpy()):
        cb = g.gcb.numpy()[p // g.G, g.slot.numpy()[p]]
        t = terms[:, cb]                                  # [N, F, n]
        y = (t >> i32(8)) - wts[p][fidx, t & i32(0xFF)]
        fs = y[..., 0]
        for j in range(1, n):
            x, yj = fs, y[..., j]
            r = np.maximum(x, yj)
            d = r - np.minimum(x, yj)
            res = r + tab[np.minimum(d, i32(tl))]
            res = np.where(x <= zero, yj, res)
            fs = np.where(yj <= zero, np.where(x <= zero, res, x), res)
        assert fs.dtype == i32
        scr = -fs.sum(axis=1, dtype=i32)
        if ms.aw != 1:
            scr = np.sign(scr) * (np.abs(scr) // i32(ms.aw))
        scr = np.clip(scr, -32768, 32767).astype(i32)
        out[:, s] = scr
        fmin = np.minimum(fmin, scr)
    return np.clip(out.astype(i32) - fmin[:, None], -32768,
                   32767).astype(np.int16)


def edge_distances(N: int, C: int, F: int, n: int, D: int, rng):
    """Top-N distances and densities that reach the floor, the zero
    guard (fden - w <= zero8 = -2^19), differences past the table's end
    and inside it, the upper int16 clamp (large positive distances) and
    the top of K12's int32 range."""
    dv = rng.uniform(-4e5, 1e4, (N, C, F, n)).astype(np.float32)
    dv[0] = np.float32(INT_MIN) * np.float32(1.5)              # the floor
    dv[1, :, :, 0] = -5.4e8                                    # zero guard
    dv[2, :, :, 1:] = -6e8
    dv[3] = 2147482000.0                                       # the top
    dv[4, :C // 2 + 1, 0] = 3e8                                # clamps
    dv[5, :, :, ::2] = dv[5, :, :, 1::2] - 260 * 1024          # table end
    dv = np.sort(dv, axis=-1)[..., ::-1].copy()
    cw = rng.randint(0, D, (N, C, F, n)).astype(np.int32)
    return torch.from_numpy(dv), torch.from_numpy(cw)


@pytest.mark.parametrize("variant,aw", [("ms", 1), ("ms", 2), ("ms", 3),
                                        ("ms1to1", 1)])
def test_grouped_int32_evaluation_equals_plain(ms_scorers, variant, aw):
    """The grouped int32 evaluation equals the plain int64 version on the
    model's own distances of random frames and on edge distances."""
    import dataclasses
    ms = dataclasses.replace(ms_scorers[variant], aw=aw)
    rng = np.random.RandomState(aw)
    C, F, D, L = ms.means.shape
    feats = torch.from_numpy(
        (rng.standard_normal((24, F, L)) * 3).astype(np.float32))
    feats[0] = 1e5
    cases = [st.ms_dist_topn_plain(feats, ms),
             edge_distances(12, C, F, ms.n_best, D, rng)]
    for dval, cw in cases:
        want = st.ms_senone_eval_plain(dval, cw, ms).numpy()
        assert np.array_equal(grouped_eval_int32(dval, cw, ms), want)
    # the edge cases reach what they aim at
    dval, cw = cases[1]
    want = st.ms_senone_eval_plain(dval, cw, ms).numpy()
    assert (want == 32767).any()
