"""K6's bounded edge loop and K2's top-N edge cases, in plain PyTorch on
the CPU.

K6 loops over each phone's real predecessors only: the K-slot form over
slots 0 .. pred_n-1 of its padded tables (``pred_count`` per row), the
band form over its band slots with band_ok, listed in slot order
(``band_lists``); a phone of more than 8 predecessors is weighed by a
whole warp (``warp_enter``, held against the serial loop).
``list_enter`` below writes that loop out in plain PyTorch and is held
against the dense plain versions (``_band_enter``,
``_kslot_enter``) on random tables with ties and all-WORST phones, and,
inside the frame recurrence, against the JAX package's per-row Viterbi
(``TpuAligner._vit_full_mg``) on the mixed stacks (band and K-slot) and
the decode grammar's.  K2's plain version is held against the JAX
package's distance stage and top-N rounds with tied densities at top-N
1, 4 and 8.  Every comparison is exact; inputs are numpy draws from
fixed seeds."""

import dataclasses
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, model_dir, random_graph, stack_random
from make_torch_decode_golden import GRAMMAR, large_grammar
from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops import align_graph, senscore_jax
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.logmath import SENSCR_SHIFT
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)
W = at.WORST_SCORE
TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young",
         "ill disposed man", "man"]


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def ref(small_dir):
    return TpuAligner(hmm=small_dir, samprate=SAMPRATE)


@pytest.fixture(scope="module")
def port(small_dir):
    return TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")


def _stack(al, graphs, **kw):
    return align_graph.stack_graphs(graphs, al.am.tmat.astype(np.int32),
                                    np.arange(al.am.n_sen), **kw)


def _in_degree(graphs, B: int, P: int) -> np.ndarray:
    """Each row's in-degree per phone, from the graphs' edge lists."""
    out = np.zeros((B, P), np.int32)
    for b, g in enumerate(graphs):
        out[b, :len(g.senid)] = np.bincount(g.edge_dst, minlength=len(
            g.senid))
    return out


# -- pred_n and the band lists ---------------------------------------------------

@pytest.mark.parametrize("which", ["mixed", "decode", "large"])
def test_pred_n_per_row_of_stacks(port, which):
    """pred_count's prefix test holds row by row on stack_graphs' tables:
    the mixed transcripts' stack, the decode grammar's (cyclic, K-slot)
    beside a transcript, and the large grammar's; RowVitConsts carries
    the in-degrees."""
    if which == "mixed":
        graphs = [port.graph_for_text(t) for t in TEXTS]
    else:
        gram = GRAMMAR if which == "decode" else large_grammar()
        graphs = [port.set_grammar(jsgf_string=gram),
                  port.graph_for_text(TEXT)]
    raw = at.stack_graphs(graphs, port.am.tmat.astype(np.int32),
                          np.arange(port.am.n_sen))
    want = _in_degree(graphs, len(graphs), raw["P"])
    got = at.pred_count(raw["pred_ok"])
    assert got.dtype == np.int32 and np.array_equal(got, want)
    c = at.row_consts_from_numpy(raw)
    assert c.pred_n.dtype == torch.int32
    assert np.array_equal(c.pred_n.numpy(), want)
    assert (c.band_pen is not None) == (which == "mixed")
    if which != "mixed":
        assert c.lists()[0] == "K-slot"
        assert want.mean() * 4 < raw["K"]              # far below the pad
    bad = raw["pred_ok"].copy()
    bad[1, 0, :] = False
    bad[1, 0, 1] = True
    with pytest.raises(ValueError, match=r"\[\[1, 0\]\]"):
        at.pred_count(bad)


def _band_brute(band_pen, band_ok):
    """band_lists by a loop over every row, phone and slot."""
    B, Wd, P = band_ok.shape
    out = {}
    for b in range(B):
        for p in range(P):
            out[b, p] = [(p - (Wd - i), int(band_pen[b, i, p]))
                         for i in range(Wd)
                         if band_ok[b, i, p] and p - (Wd - i) >= 0]
    return out


@pytest.mark.parametrize("w_floor", [0, 24])
def test_band_lists_order_of_stack_graphs(ref, w_floor):
    """The band lists of the JAX package's stack (the port's equals it,
    test_torch_mixed.py), at its own width and padded to 24: each
    phone's band slots with band_ok in slot order, sources ascending, one entry a distinct edge (duplicates
    merged by the band's max penalty), and the lists' lengths at most
    the in-degree."""
    graphs = [ref.graph_for_text(t) for t in TEXTS]
    raw = _stack(ref, graphs, w_floor=w_floor)
    assert raw["W"] >= max(w_floor, 1) and raw["W"] % 8 == 0
    src, pen, n = (x.numpy() for x in at.band_lists(
        torch.from_numpy(raw["band_pen"]), torch.from_numpy(raw["band_ok"])))
    B, P = n.shape
    assert src.shape == pen.shape == (B, P, raw["W"])
    assert src.dtype == pen.dtype == n.dtype == np.int32
    brute = _band_brute(raw["band_pen"], raw["band_ok"])
    deg = _in_degree(graphs, B, P)
    for (b, p), want in brute.items():
        k = int(n[b, p])
        assert list(zip(src[b, p, :k].tolist(), pen[b, p, :k].tolist())) \
            == want
        assert (src[b, p, k:] == 0).all() and (pen[b, p, k:] == 0).all()
        assert all(x < y for x, y in zip(src[b, p, :k], src[b, p, 1:k]))
        assert k <= deg[b, p]
    edges = {(b, int(s), int(d)) for b, g in enumerate(graphs)
             for s, d in zip(g.edge_src, g.edge_dst)}
    assert sum(len(v) for v in brute.values()) == len(edges)


def test_band_lists_of_the_mixed_size_class():
    """The band lists of a B=256 stack of the mixed path's size class
    (P=96, W=16, about 2.5 edges a phone), built by tensor operations on
    the tables' device (here the CPU; its time is printed), against the
    loop on its first rows."""
    rng = np.random.RandomState(3)
    B, Wd, P = 256, 16, 96
    ok = rng.random_sample((B, Wd, P)) < 2.5 / Wd
    pen = -rng.randint(0, 4000, (B, Wd, P)).astype(np.int32)
    t0 = time.perf_counter()
    src, lp, n = at.band_lists(torch.from_numpy(pen),
                               torch.from_numpy(ok.astype(np.uint8)))
    ms = (time.perf_counter() - t0) * 1e3
    print(f"band_lists B={B} W={Wd} P={P}: {ms:.3f} ms")
    assert src.shape == (B, P, Wd) and int(n.sum()) == int(
        (ok & (np.arange(P) >= Wd - np.arange(Wd)[:, None])).sum())
    brute = _band_brute(pen[:4], ok[:4])
    for (b, p), want in brute.items():
        k = int(n[b, p])
        assert list(zip(src[b, p, :k].tolist(), lp[b, p, :k].tolist())) \
            == want


# -- the bounded loop in plain PyTorch ----------------------------------------

def list_enter(src, pen, n):
    """K6's edge loop (viterbi_step.h enter_strict_at) over per-row lists
    src/pen [B, P, Kn] and lengths n [B, P]: entries 0 .. n-1 of each
    phone in order, strict ``>`` from WORST_SCORE.  Returns (es, eh,
    eok) [B, P], eh -1 where not eok."""
    src = src.long()

    def enter(osc, ohi, anext):
        es = torch.full_like(osc, W)
        eh = torch.full_like(ohi, -1)
        eok = torch.zeros_like(anext)
        for k in range(src.shape[2]):
            s = src[:, :, k]
            ok = (k < n) & anext.gather(1, s)
            val = torch.where(ok, osc.gather(1, s) + pen[:, :, k],
                              torch.full_like(osc, W))
            upd = val > es
            es = torch.where(upd, val, es)
            eh = torch.where(upd, ohi.gather(1, s), eh)
            eok = torch.where(upd, ok, eok)
        return es, torch.where(eok, eh, torch.full_like(eh, -1)), eok
    return enter


CASES = ["random", "ties", "worst"]


def _state(B, P, rng, case):
    """out_score/out_hist/active_next [B, P] for one enter: random;
    "ties" draws scores from four values so predecessors tie; "worst"
    puts a third of the phones at or below WORST_SCORE."""
    if case == "ties":
        osc = rng.choice([-500, -300, -300, -100], (B, P))
    else:
        osc = -rng.randint(0, 5000, (B, P))
    if case == "worst":
        low = rng.random_sample((B, P)) < 0.35
        osc = np.where(low, W - rng.randint(0, 3, (B, P)), osc)
    ohi = rng.randint(0, 3 * P, (B, P))
    anext = rng.random_sample((B, P)) < 0.8
    return (torch.from_numpy(osc.astype(np.int32)),
            torch.from_numpy(ohi.astype(np.int32)),
            torch.from_numpy(anext))


@pytest.mark.parametrize("case", CASES)
def test_list_enter_equals_dense(case):
    """The loop over the lists == _kslot_enter over the padded K slots
    and == _band_enter over the band slots, on random stacks of three
    rows (in-degree 0..3, a full row of slots where K = 3, rows of only
    WORST predecessors), each of several states."""
    rng = np.random.RandomState(CASES.index(case))
    P, B = 40, 3
    graphs = [random_graph(P, 3, rng, K=3, cyclic=False) for _ in range(B)]
    st_np = stack_random(graphs, band_w=8)
    c = at.row_consts_from_numpy(st_np)
    assert c.band_pen is not None and c.lists()[0] == "band"
    kslot = at.row_consts_from_numpy(
        {k: v for k, v in st_np.items() if not k.startswith("band")})
    dense = {"band": at._band_enter(c.band_pen, c.band_ok),
             "K-slot": at._kslot_enter(c.pred_idx, c.pred_pen, c.pred_ok)}
    for cc in (c, kslot):
        form, src, pen, n = cc.lists()
        bounded = list_enter(src, pen, n)
        for rep in range(4):
            osc, ohi, anext = _state(B, P, rng, case)
            if rep == 3:
                osc[1] = W                   # a row of WORST predecessors
            got = bounded(osc, ohi, anext)
            want = dense[form](osc, ohi, anext)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (form, rep)


def warp_enter(src, pen, n, lanes: int = 32):
    """K6's weighing of a heavy phone by a warp, in plain PyTorch: lane
    l takes slots l, l + lanes, ... in order with the strict ``>`` from
    WORST_SCORE (its first maximum), then the warp takes the lanes' max
    and the lowest slot holding it; the out_hist is that slot's."""
    src = src.long()
    B, P, Kn = src.shape

    def enter(osc, ohi, anext):
        k_all = torch.arange(Kn)
        vals = torch.full((B, P, Kn), W, dtype=torch.int32)
        for k in range(Kn):
            s = src[:, :, k]
            ok = (k < n) & anext.gather(1, s)
            vals[:, :, k] = torch.where(ok, osc.gather(1, s) + pen[:, :, k],
                                        torch.full_like(osc, W))
        lv = torch.full((B, P, lanes), W, dtype=torch.int32)
        lk = torch.full((B, P, lanes), 1 << 30, dtype=torch.int64)
        for k in range(Kn):                       # each lane in slot order
            lane = k % lanes
            upd = vals[:, :, k] > lv[:, :, lane]
            lv[:, :, lane] = torch.where(upd, vals[:, :, k], lv[:, :, lane])
            lk[:, :, lane] = torch.where(upd, k_all[k], lk[:, :, lane])
        m = lv.amax(-1)
        kmin = torch.where(lv == m[..., None], lk,
                           torch.full_like(lk, 1 << 30)).amin(-1)
        eok = kmin < (1 << 30)
        at_ = src.gather(2, kmin.clamp(max=Kn - 1)[..., None])[..., 0]
        eh = torch.where(eok, ohi.gather(1, at_), torch.full_like(ohi, -1))
        return m, eh, eok
    return enter


@pytest.mark.parametrize("case", CASES)
def test_warp_split_equals_serial_loop(case):
    """The warp's weighing of a heavy phone (lanes over strided slots,
    then max and lowest slot) == the serial loop, on phones of in-degree
    up to 120 with ties and WORST predecessors, at 32 lanes and at 4
    (several slots a lane)."""
    rng = np.random.RandomState(10 + CASES.index(case))
    B, P, Kn = 2, 50, 120
    src = torch.from_numpy(rng.randint(0, P, (B, P, Kn)).astype(np.int32))
    pen = torch.from_numpy(
        rng.choice([0, -10, -10, -200], (B, P, Kn)).astype(np.int32))
    n = torch.from_numpy(rng.randint(0, Kn + 1, (B, P)).astype(np.int32))
    n[0, :3] = torch.tensor([0, 1, Kn], dtype=torch.int32)
    serial = list_enter(src, pen, n)
    for lanes in (32, 4):
        split = warp_enter(src, pen, n, lanes)
        for rep in range(3):
            osc, ohi, anext = _state(B, P, rng, case)
            for a, b in zip(split(osc, ohi, anext), serial(osc, ohi, anext)):
                assert a.dtype == b.dtype and torch.equal(a, b), (lanes, rep)


def _jax_rows(ref, st_np, sen, Ts, with_scores):
    fake = types.SimpleNamespace(want_scores=with_scores)
    return TpuAligner._vit_full_mg(fake, st_np, sen, Ts)


def _assert_equal_jax(got, want, with_scores):
    path, ps, fs = got
    path_j, ps_j, fs_j = want
    assert path.numpy().dtype == np.asarray(path_j).dtype
    assert np.array_equal(path.numpy(), np.asarray(path_j))
    assert np.array_equal(fs.numpy(), np.asarray(fs_j))
    if with_scores:
        assert np.array_equal(ps.numpy(), np.asarray(ps_j))
    else:
        assert ps is None and ps_j is None


@pytest.mark.parametrize("form", ["band", "kslot", "decode"])
@pytest.mark.parametrize("with_scores", [False, True])
def test_bounded_rows_equal_jax(ref, form, with_scores):
    """K6's recurrence with the loop over the lists, then the masked
    select and backtrace, == the JAX package's per-row Viterbi
    (_vit_full_mg) and == viterbi_rows_plain: the mixed transcripts'
    stack with its band and without, and the decode grammar's cyclic
    graph (K-slot) beside two transcripts; full rows, short rows, a row
    too short to reach a final node, scores crossing the
    renormalization threshold."""
    if form == "decode":
        graphs = [ref.set_grammar(jsgf_string=GRAMMAR)] * 2 + [
            ref.graph_for_text(t) for t in TEXTS[:2]]
    else:
        graphs = [ref.graph_for_text(t) for t in TEXTS]
    st_np = _stack(ref, graphs)
    if form == "kslot":
        st_np = {k: v for k, v in st_np.items() if not k.startswith("band")}
    assert ("band_pen" in st_np) == (form == "band")
    B, S, T = len(graphs), st_np["sencols"].shape[1], 96
    rng = np.random.RandomState(B * 11 + with_scores)
    sen = (6_000_000 * (rng.random_sample((B, 1, 1)) < 0.5)
           + rng.randint(0, 3000, (B, T, S))).astype(np.int32)
    Ts = np.array([T, 70, 3, T, 50, 96, 33][:B], np.int32)
    want = _jax_rows(ref, st_np, sen, Ts, with_scores)
    c = at.row_consts_from_numpy(st_np)
    _, src, pen, n = c.lists()
    sen_t, n_t = torch.from_numpy(sen), torch.from_numpy(Ts)
    got = at._rows_plain(sen_t, n_t, c, list_enter(src, pen, n), with_scores)
    _assert_equal_jax(got, want, with_scores)
    plain = at.viterbi_rows_plain(sen_t, n_t, c, with_scores)
    for a, b in zip(got, plain):
        assert (a is None and b is None) or torch.equal(a, b)


# -- K2: tied densities at top-N 1 and 8 ---------------------------------------

@pytest.mark.parametrize("topn", [1, 4, 8])
@pytest.mark.parametrize("dist_mode", ["fold", "mxu"])
def test_dist_topn_ties_equal_jax(ref, topn, dist_mode):
    """dist_topn_norm_plain == the JAX package's _dist_stage_graph, then
    _topn_argmax at ``topn`` and codebook_norm, with densities 1 and 2
    copies of density 0 and density 5 of 4 in every codebook and stream
    (ties at every frame), a frame whose distances all clamp at INT_MIN
    and one where some do."""
    gs_j = senscore_jax.GraphScorer.build(
        ref.am, ref.tables, ref.graph_for_text(TEXT).senid.reshape(-1))

    def dup(a):
        a = np.asarray(a).copy()
        a[:, :, 1] = a[:, :, 0]
        a[:, :, 2] = a[:, :, 0]
        a[:, :, 5] = a[:, :, 4]
        return jnp.asarray(a)

    gs_j = dataclasses.replace(gs_j, means=dup(gs_j.means),
                               var_t=dup(gs_j.var_t), det=dup(gs_j.det))
    feats = golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))[:97]
    feats = feats.copy()
    feats[0] = 1e5
    feats[1, :, :4] = 3e3
    di = senscore_jax._dist_stage_graph(gs_j, jnp.asarray(feats), dist_mode)
    sc, cw = (np.asarray(x) for x in senscore_jax._topn_argmax(di, topn))
    shifted = sc >> SENSCR_SHIFT
    norm = shifted[..., 0].max(axis=1, keepdims=True)
    want_s = np.minimum(-(shifted - norm[..., None]), st.MAX_NEG_ASCR)
    gs = dataclasses.replace(st.scorer_from_jax_arrays(gs_j), topn=topn)
    s, c = st.dist_topn_norm_plain(torch.from_numpy(feats), gs, dist_mode)
    assert s.shape == (97,) + gs.det.shape[:2] + (topn,)
    assert np.array_equal(c.numpy(), cw) and np.array_equal(s.numpy(),
                                                            want_s)
    assert (c[0, :, :, :topn] == torch.arange(topn)).all()
    if topn > 1:
        # a tie broken to the lower index somewhere past the clamp frame
        assert bool(((c[2:, :, :, 0] == 0) & (c[2:, :, :, 1] == 1)).any())



# -- the entry points' device ------------------------------------------------

def test_aligner_and_ring_default_to_the_card(small_dir):
    """TorchAligner and the long form's ring run on the card unless asked
    for the CPU: without a card, the defaults raise."""
    from soundswallower_tpu_torch.parallel import seq_ring

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAligner(hmm=small_dir, samprate=SAMPRATE)
    with pytest.raises(RuntimeError, match="CUDA"):
        seq_ring(2)
    assert TorchAligner(hmm=small_dir, samprate=SAMPRATE,
                        device="cpu").device.type == "cpu"
