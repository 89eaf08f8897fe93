"""The mixed-transcript slice against the JAX package, bit-equal on the
CPU: stacked graphs, K6's plain version (band and K-slot forms, with and
without scores), K5's and K7's plain versions, the union scorer's state,
the full-inventory scores the Viterbi sees, and TorchAligner's
align_batch (union, dense, and grouped under SST_MIXED=grouped) /
align_batch_scored against TpuAligner's."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner, _gather_cols
from soundswallower_tpu.aligner import result_json_from_segs as ref_json
from soundswallower_tpu.ops import align_graph, senscore_jax
from soundswallower_tpu.ops.align_jax import _eval_emit
from soundswallower_tpu_torch.aligner import (TorchAligner,
                                              result_json_from_segs)
from soundswallower_tpu_torch.fe.feat import feat
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young",
         "ill disposed man"]


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def ref(small_dir):
    return TpuAligner(hmm=small_dir, samprate=SAMPRATE)


def _fresh(model: str):
    """A new pair of aligners: the union scorer's state is per aligner."""
    return (TorchAligner(hmm=model, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=model, samprate=SAMPRATE))


def _scored(out):
    """Segments with their scores and states, comparable across packages."""
    return [None if segs is None else
            [(s.word, s.start, s.duration, s.score, list(s.phones),
              s.states) for s in segs] for segs in out]


def _stack(ref, texts, **kw):
    graphs = [ref.graph_for_text(t) for t in texts]
    return graphs, align_graph.stack_graphs(
        graphs, ref.am.tmat.astype(np.int32), ref.tables.sen_remap, **kw)


@pytest.mark.parametrize("w_cap", [64, 1], ids=["band", "no-band"])
def test_stack_graphs_equals_shared(ref, w_cap):
    kw = dict(p_floor=96, k_floor=6, w_floor=16, w_cap=w_cap)
    graphs, want = _stack(ref, TEXTS, **kw)
    got = at.stack_graphs(graphs, ref.am.tmat.astype(np.int32),
                          ref.tables.sen_remap, **kw)
    assert ("band_pen" in want) == (w_cap == 64)
    assert sorted(got) == sorted(want)
    assert (got["P"], got["K"], got["W"]) == (want["P"], want["K"], want["W"])
    assert got["P"] == 96 and got["K"] == 6
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and (got[k] == v).all(), k


@pytest.mark.parametrize("form", ["band", "kslot"])
@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("base", [0, 6_000_000])
def test_viterbi_rows_matches_jax(ref, form, with_scores, base):
    """viterbi_rows_plain == align_viterbi_batch (per-row form) + the
    masked select of _vit_full_mg + backtrace_batch; full rows, short
    rows, a row too short to reach a final node, and (base) scores that
    cross the renormalization threshold."""
    _, st_np = _stack(ref, TEXTS + ["man"])
    if form == "kslot":
        st_np = {k: v for k, v in st_np.items() if not k.startswith("band")}
    B, S, T = len(TEXTS) + 1, st_np["sencols"].shape[1], 128
    rng = np.random.RandomState(B * 7 + with_scores)
    sen = (base + rng.randint(0, 3000, (B, T, S))).astype(np.int32)
    Ts = np.array([T, 100, 77, T, 60, 3, 128], np.int32)
    fake = types.SimpleNamespace(want_scores=with_scores)
    path_j, ps_j, fs_j = TpuAligner._vit_full_mg(fake, st_np, sen, Ts)
    c = at.row_consts_from_numpy(st_np)
    assert (c.band_pen is not None) == (form == "band")
    path, ps, fs = at.viterbi_rows(torch.from_numpy(sen), torch.from_numpy(Ts),
                                   c, with_scores)
    assert path.dtype == torch.int16 and fs.dtype == torch.int32
    assert (path.numpy() == np.asarray(path_j)).all()
    assert (fs.numpy() == np.asarray(fs_j)).all()
    assert np.asarray(path_j)[5, Ts[5] - 1] < 0            # the failed row
    if with_scores:
        assert ps.dtype == torch.int32
        assert (ps.numpy() == np.asarray(ps_j)).all()
    else:
        assert ps is None and ps_j is None


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_gather_cols_matches_jax(dtype):
    rng = np.random.RandomState(3)
    B, T, Sx, S = 3, 7, 50, 20
    src = rng.randint(-30000, 30000, (B, T, Sx)).astype(dtype)
    cols = rng.randint(0, Sx, (B, S)).astype(np.int32)
    cols[:, :4] = [-1, -Sx, Sx - 1, Sx]       # wrap once; one past the end
    want = np.asarray(_gather_cols(src, cols)).astype(np.int32)
    got = st.gather_cols(torch.from_numpy(src), torch.from_numpy(cols))
    assert got.dtype == torch.int32 and (got.numpy() == want).all()


def test_frame_best_sub_matches_jax_tail():
    """K7 == the tail of _sen_eval on int32 scores, wrapping ones too."""
    rng = np.random.RandomState(4)
    x = rng.randint(0, 1 << 20, (9, 40)).astype(np.int32)
    x[0] = rng.randint(-5, 5, 40)
    out = x.astype(np.int16)
    want = out - x.min(axis=1, keepdims=True).astype(np.int16)
    got = st.frame_best_sub(torch.from_numpy(x))
    assert got.dtype == torch.int16 and (got.numpy() == want).all()


def test_union_state_follows_reference(small_dir):
    """Over a sequence of three batches (the second grows the working
    set, the third needs nothing new) the union's senone set, column
    count, positions and version, its tables and the segments equal
    TpuAligner's."""
    port, ref = _fresh(small_dir)
    batches = [TEXTS[:3], TEXTS[2:], TEXTS[1:4]]
    vers = []
    for texts in batches:
        audios = [austen_audio(i) for i in range(len(texts))]
        want = [segs_rep(s) for s in ref.align_batch(audios, texts)]
        assert [segs_rep(s) for s in port.align_batch(audios, texts)] == want
        u, v = port._uni, ref._uni
        for k in ("ver", "Spad", "dense"):
            assert u[k] == v[k], k
        assert (u["senset"] == v["senset"]).all()
        assert (u["pos"] == v["pos"]).all()
        gs = st.scorer_from_jax_arrays(v["gs"])
        for name in ("means", "var_t", "det", "mixw", "cb_pos"):
            assert torch.equal(getattr(u["gs"], name), getattr(gs, name))
        vers.append(u["ver"])
    assert vers == [1, 2, 2]
    # pad columns score senone 0: its codebook is in the union
    sen2cb = np.asarray(port.am.sen2cb)
    assert u["pos"][0] < 0 and u["Spad"] > len(u["senset"])
    rows = np.unique(sen2cb[np.concatenate([u["senset"], [0]])])
    assert u["gs"].means.shape[0] == len(rows)


@pytest.mark.parametrize("width,rows", [("small", 8), ("en-us", 2)])
def test_dense_scores_match_reference(tmp_path_factory, width, rows):
    """What K6 sees on the full-inventory route, [B, T, S], equals
    _gather_cols(score_frames(...), sencols) of the JAX package."""
    d = model_dir(tmp_path_factory, width)
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    texts = (TEXTS * 2)[:rows]
    audios = [austen_audio(i) for i in range(rows)]
    Ts = np.array([port.fe.n_frames(len(a)) for a in audios], np.int32)
    Tmax = -(-int(Ts.max()) // 64) * 64
    pl = torch.from_numpy(port.native_fe.process_list_i16p(
        audios, Tmax, port.wire_scale))
    flat = feat(pl, torch.from_numpy(Ts), 1.0 / port.wire_scale,
                port.do_cmn).view(rows * Tmax, 3, -1)
    graphs, st_ref = _stack(ref, texts)
    dense = np.asarray(senscore_jax.score_frames(ref.tables, flat.numpy()))
    want = np.asarray(_gather_cols(dense.reshape(rows, Tmax, -1),
                                   st_ref["sencols"])).astype(np.int32)
    st_port = at.stack_graphs(graphs, port.am.tmat.astype(np.int32),
                              np.arange(port.am.n_sen))
    src = st.score_frames(port.dense, flat).view(rows, Tmax, -1)
    assert src.dtype == torch.int16 and src.shape[2] == port.am.n_sen
    got = st.gather_cols(src, torch.from_numpy(st_port["sencols"]))
    assert (got.numpy() == want).all()
    # the port's tables are the reference's, ungrouped
    tab = st.dense_scorer_from_jax_tables(ref.tables)
    for name in ("means", "var_t", "det", "mixw", "cb_pos"):
        assert torch.equal(getattr(port.dense, name), getattr(tab, name))


@pytest.mark.parametrize("route", ["union", "dense"])
def test_mixed_align_batch_matches_reference(small_dir, route):
    port, ref = _fresh(small_dir)
    texts = TEXTS + ["he was a xyzzy"]                  # unknown word: None
    audios = [austen_audio(i) for i in range(len(texts))]
    if route == "dense":
        for al in (port, ref):
            al.align_batch(audios[:2], texts[:2])
            al._uni["dense"] = True
    want = [segs_rep(s) for s in ref.align_batch(audios, texts)]
    assert want[-1] is None and all(w is not None for w in want[:-1])
    assert [segs_rep(s) for s in port.align_batch(audios, texts)] == want
    assert port._uni["dense"] == (route == "dense")
    h = port.align_batch_begin(audios[:-1], texts[:-1])
    assert [segs_rep(s) for s in port.align_batch_end(h)] == want[:-1]
    with pytest.raises(KeyError):
        port.align_batch_begin(audios, texts)


def test_grouped_mixed_matches_reference(small_dir, monkeypatch):
    """SST_MIXED=grouped: a same-transcript dispatch per text, collected
    after all are dispatched (TpuAligner._align_batch_grouped), the
    union scorer untouched; a text with an unknown word leaves its rows
    None.  Row 1's "young" lasts 251 frames there, 270 on the union."""
    monkeypatch.setenv("SST_MIXED", "grouped")
    port, ref = _fresh(small_dir)
    texts = TEXTS + ["he was a xyzzy", TEXTS[1]]
    audios = [austen_audio(i) for i in range(len(texts))]
    want = [segs_rep(s) for s in ref.align_batch(audios, texts)]
    assert want[6] is None and all(w is not None for w in want[:6])
    assert [segs_rep(s) for s in port.align_batch(audios, texts)] == want
    assert port._uni is None
    assert [w[2] for w in want[1] if w[0] == "young"] == [251]
    monkeypatch.delenv("SST_MIXED")
    union = port.align_batch(audios, texts)[1]
    assert [s.duration for s in union if s.word == "young"] == [270]


@pytest.mark.parametrize("want_states", [False, True])
def test_align_batch_scored_matches_reference(small_dir, want_states):
    port, ref = _fresh(small_dir)
    port.want_states = ref.want_states = want_states
    texts = TEXTS[:4] + [TEXTS[0]]
    audios = [austen_audio(i) for i in range(len(texts))]
    want = ref.align_batch_scored(audios, texts)
    got = port.align_batch_scored(audios, texts)
    assert _scored(got) == _scored(want)
    assert any(s.score for s in got[0])
    assert all(s.states is not None for s in got[0]) == want_states
    assert port.want_scores is False
    for a, segs_g, segs_w in zip(audios, got, want):
        T = port.fe.n_frames(len(a))
        for level in (0, 1, 2):
            assert result_json_from_segs(segs_g, port.lmath, T, 100,
                                         align_level=level) \
                == ref_json(segs_w, ref.lmath, T, 100, align_level=level)
    with pytest.raises(KeyError):
        port.align_batch_scored(audios[:1], ["he was a xyzzy"])


def test_unported_surfaces_still_raise(small_dir):
    """What is still to be ported raises NotImplementedError naming its
    ROADMAP item.  Ported since: want_scores on a same-transcript batch,
    decode_batch(_scored) (they need set_grammar first, as in the JAX
    package), S >= 32767 (int32 token stacks), 5-state models,
    align_longform_batch and dist_mode="mxu"; an HMM topology the JAX
    package refuses (neither 3 nor 5 states) is refused here too."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    a = austen_audio(0)
    port.want_scores = True
    assert port.align_batch([a, a], [TEXT, TEXT])[0] is not None
    port.want_scores = False
    for call in (lambda: port.decode_batch_scored([a]),
                 lambda: port.decode_batch([a])):
        with pytest.raises(RuntimeError, match="set_grammar"):
            call()
    for call in (lambda: port.use_mesh(None),
                 lambda: port.update_mllr("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    assert port.align_batch_scored([a], [TEXT], dist_mode="mxu")[0]
    S = 3 * 11000                                    # int32 token stacks
    with pytest.raises(ValueError, match="graphs for"):
        at.viterbi_rows(torch.zeros((1, 4, S), dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32),
                        types.SimpleNamespace(P=S // 3, E=3,
                                              tp=torch.zeros((2, 1))))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A14"):
        TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu",
                     mllr="mllr_matrix")
    # a 4-state topology: align_jax.py _eval_emit refuses it, so does the
    # port, when the tables are made
    tp = np.zeros((3, 4, 5), np.int32)
    with pytest.raises(NotImplementedError, match="3/5 emitting states"):
        at.graph_consts_from_numpy(dict(
            tp=tp, pi=np.zeros((3, 1)), pp=np.zeros((3, 1)),
            pk=np.zeros((3, 1), bool), ast=np.zeros(3), aen=np.zeros(3),
            entry=np.zeros(3), fin=np.zeros(1)))
    with pytest.raises(NotImplementedError, match="3/5 emitting states"):
        _eval_emit(*(jnp.zeros((3, 4)),) * 4 + (jnp.zeros((3, 4)),
                                                  jnp.asarray(tp),
                                                  jnp.ones(3, bool)),
                   lanes=False)
