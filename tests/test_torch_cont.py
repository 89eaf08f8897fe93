"""A fully continuous model of one 39-dim stream (``1s_c_d_dd`` without
subvectors, a codebook a senone) on the port's batch routes, on the CPU:
the features' one-stream view against the feature registry, the blocked
continuous scorer against one call, both front ends' batch routes
against the plain reference (``tests/plain_cont.py``) in int16 scores
and segments, the reference's bfloat16 control, the layouts the routes
refuse, and a 3-stream model on its old path."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, variant_dir
from make_synth_model import make_cont_model
from plain_cont import PlainCont
from portbench.reference.align import seg_rep
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.fe import feat as fm
from soundswallower_tpu_torch.ops import senscore_torch as st

TEXTS = [TEXT, "he was not an ill", "young man", TEXT]


@pytest.fixture(scope="module")
def cont_model(tmp_path_factory):
    return make_cont_model(str(tmp_path_factory.mktemp("cont")), 0, "small")


def _aligner(model, fe, monkeypatch):
    monkeypatch.setenv("SST_FE", fe)
    al = TorchAligner(hmm=model, samprate=SAMPRATE, device="cpu")
    assert (al.native_fe is None) == (fe == "device")
    return al


def _audios():
    return [austen_audio(i) for i in range(4)]


def test_model_is_one_stream_of_39_dims(cont_model):
    al = TorchAligner(hmm=cont_model, samprate=SAMPRATE, device="cpu")
    assert al.am.backend == "ms" and al.am.n_feat == 1
    assert list(al.am.veclen) == [39] and al.streams == (1, 39)
    assert al.am.n_mgau == al.am.n_sen and al.config["svspec"] is None
    assert al.dense.means.shape[1:] == (1, 8, 39)


def test_one_stream_view_is_the_registry_1s_c_d_dd(cont_model):
    """K1's [T, 3, 13] output (its plain version, batch CMN) viewed as
    one stream [T, 1, 39] equals the feature registry's 1s_c_d_dd
    without subvectors, frame by frame, bit for bit."""
    al = TorchAligner(hmm=cont_model, samprate=SAMPRATE, device="cpu")
    audio = austen_audio(1)
    T = al.fe.n_frames(len(audio))
    cep = al.native_fe.process_batch(audio[None], np.array([len(audio)]), T)
    k1 = fm.feat_f32(torch.from_numpy(np.ascontiguousarray(cep, np.float32)),
                     torch.tensor([T], dtype=torch.int32), True)[0]
    got = al._scorer_view(k1)
    reg = fm.FeatPipeline("1s_c_d_dd", 13)
    assert reg.shape == (1, 39)
    want = reg.compute_full(np.asarray(cep[0, :T], np.float32), "batch")
    assert got.shape == (T, 1, 39)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("layout,want", [
    ((3, [13] * 3, "1s_c_d_dd", "0-12/13-25/26-38", None), (3, 13)),
    ((3, [13] * 3, "1s_c_d_dd", None, None), (3, 13)),
    ((1, [39], "1s_c_d_dd", None, None), (1, 39)),
    ((1, [39], "1s_c_d_dd", "0-38", None), (1, 39)),
    ((1, [39], "s3_1x39", None, None), None),
    ((1, [39], "1s_c_d_dd", None, "feature_transform"), None),
    ((1, [39], "1s_c_d_dd", "38,0-37", None), None),
    ((2, [26, 13], "1s_c_d_dd", "0-25/26-38", None), None),
    ((4, [12, 24, 3, 12], "s2_4x", None, None), None),
    ((1, [32], "1s_c_d_dd", None, None), None),
])
def test_scorer_streams_layouts(layout, want):
    """The layouts K1's features are read in, and the ones refused with
    a ValueError that names the layout."""
    n_feat, veclen, ftype, svspec, lda = layout
    if want is not None:
        assert fm.scorer_streams(n_feat, veclen, 13, ftype, svspec,
                                 lda) == want
        return
    with pytest.raises(ValueError, match=f"{n_feat} stream"):
        fm.scorer_streams(n_feat, veclen, 13, ftype, svspec, lda)


def test_route_refuses_a_layout_it_cannot_read(cont_model, tmp_path):
    """A one-stream model whose features another type orders (s3_1x39)
    loads, and its batch route raises ValueError naming the layout
    rather than misreading K1's output."""
    import shutil

    d = str(tmp_path / "s3")
    shutil.copytree(cont_model, d)
    p = os.path.join(d, "feat_params.json")
    with open(p) as fh:
        feat = json.load(fh)
    feat["feat"] = "s3_1x39"
    with open(p, "w") as fh:
        json.dump(feat, fh)
    al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    with pytest.raises(ValueError, match="s3_1x39"):
        al.align_batch(_audios()[:2], [TEXT, TEXT])


def _tables(L: int, C: int = 40, D: int = 8, seed: int = 0):
    rng = np.random.RandomState(seed + L)
    from soundswallower_tpu_torch.logmath import SENSCR_SHIFT, LogMath
    means = rng.standard_normal((C, 1, D, L)).astype(np.float32)
    var_t = rng.uniform(0.5, 3.0, (C, 1, D, L)).astype(np.float32)
    det = rng.uniform(-3e3, -1.0, (C, 1, D)).astype(np.float32)
    lm = LogMath(1.0001, SENSCR_SHIFT, True)
    ms = st.ms_scorer_from_numpy(means, var_t, det,
                                 rng.randint(0, 256, (C, 1, D)),
                                 np.arange(C), np.asarray(lm.table, np.int32),
                                 lm.zero, 1, 4, "cpu")
    x = torch.from_numpy((rng.standard_normal((300, 1, L)) * 2)
                         .astype(np.float32))
    return ms, x


@pytest.mark.parametrize("L", [39, 7])
@pytest.mark.parametrize("block", [37, 64, 100, 128, 299, 300])
def test_blocked_scorer_equals_one_call(L, block):
    """score_frames_ms in blocks (of 37, a tile, blocks that split a row
    of 128 frames, one frame short of the whole, the whole) equals one
    K11 and one K12 over every frame, and counts its blocks and the
    largest on the span recorder."""
    from soundswallower_tpu_torch import spans

    ms, x = _tables(L)
    want = st.ms_senone_eval(*st.ms_dist_topn(x, ms), ms)
    rec = spans.Recorder()
    spans.install(rec)
    try:
        got = st.score_frames_ms(ms, x, block=block)
    finally:
        spans.uninstall()
    assert torch.equal(got, want)
    assert rec.counts["ms.blocks"] == -(-300 // block)
    assert rec.counts["ms.block_frames"] == block


def test_k11_names_the_frame_form_for_one_stream():
    """K11's wrapper names the frame form "frame top-N" and accepts it
    for the continuous model's one stream (39 dims, 32 densities, top 4),
    its every top N up to 8 and every density, and only the density
    forms elsewhere (which form the launcher takes and counts, a card
    test pins); a forced form the launcher does not accept raises, on
    the CPU too, while an accepted one runs the plain version there."""
    frame = st.MS_FORMS[st.MS_FRAME_FORM]
    assert frame == "frame top-N"
    for D, ne in ((32, 4), (32, 1), (32, 8), (32, 32), (20, 20), (100, 3)):
        assert st.ms_dist_topn_forms(D, 39, ne) == {st.MS_FRAME_FORM, 0}
    assert st.ms_dist_topn_forms(32, 39, 9) == {0}
    assert st.ms_dist_topn_forms(128, 13, 4) == {13, 0}
    assert st.ms_dist_topn_forms(32, 7, 4) == {0}
    ms, x = _tables(39)
    want = st.ms_dist_topn_plain(x, ms)
    for form in (st.MS_FRAME_FORM, 0):
        got = st.ms_dist_topn(x, ms, form=form, parts=3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(RuntimeError, match="form 13"):
        st.ms_dist_topn(x, ms, form=13)
    ms7, x7 = _tables(7)
    with pytest.raises(RuntimeError, match="form 1 "):
        st.ms_dist_topn(x7, ms7, form=st.MS_FRAME_FORM)
    ms9 = dataclasses.replace(_tables(39, D=12)[0], topn=9)
    with pytest.raises(RuntimeError, match="top 9"):
        st.ms_dist_topn(x, ms9, form=st.MS_FRAME_FORM)


def test_block_frames_bound_the_intermediate():
    """A block's K11 intermediate stays within MS_BLOCK_BYTES: at the
    continuous model's width (5,126 codebooks, one stream, top-4) a
    multiple of 64 frames under it; the 3-stream ms model's 42 codebooks
    take a whole story chunk in one block."""
    class Shape:
        def __init__(self, C, F, n):
            self.means = torch.empty((C, F, 1, 1))
            self.n_best = n

    n = st.ms_block_frames(Shape(5126, 1, 4))
    assert n % 64 == 0 and 8 * 5126 * 4 * n <= st.MS_BLOCK_BYTES
    assert 8 * 5126 * 4 * (n + 64) > st.MS_BLOCK_BYTES
    assert st.ms_block_frames(Shape(42, 3, 4)) > 128 * 3648


@pytest.mark.parametrize("fe", ["host", "device"])
def test_batch_scores_equal_the_plain_reference(cont_model, fe, monkeypatch):
    """The int16 scores the batch route computes for a chunk (K1, the
    one-stream view, K11 and K12 in blocks) equal the plain reference's
    on every real frame, on either front end."""
    al = _aligner(cont_model, fe, monkeypatch)
    ref = PlainCont(cont_model, SAMPRATE, host_fe=fe == "host")
    audios, Ts, Tmax = al._batch_shape(_audios())
    Ts_d = torch.from_numpy(Ts.astype(np.int32))
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    got = st.score_frames_ms(al.dense, al._scorer_view(feats), block=500)
    got = got.view(len(audios), Tmax, -1)
    want = ref.scores(audios[:4])
    for b in range(4):
        assert torch.equal(got[b, :int(Ts[b])], want[b]), b


@pytest.mark.parametrize("route", ["same", "mixed"])
@pytest.mark.parametrize("fe", ["host", "device"])
def test_batch_routes_equal_the_plain_reference(cont_model, fe, route,
                                                monkeypatch):
    """align_batch_begin/_end on one transcript and on different ones
    (both the multi-graph route on every senone) equal the plain
    reference's segments; the bfloat16 control differs."""
    al = _aligner(cont_model, fe, monkeypatch)
    ref = PlainCont(cont_model, SAMPRATE, host_fe=fe == "host")
    texts = [TEXT] * 4 if route == "same" else TEXTS
    got = al.align_batch_end(al.align_batch_begin(_audios(), texts))
    want = ref.align_rows(_audios(), texts)
    assert all(w is not None for w in want)
    assert [seg_rep(s) for s in got] == [seg_rep(s) for s in want]
    if route == "mixed":
        low = ref.align_rows(_audios(), texts, precision="bf16")
        assert sum(seg_rep(a) != seg_rep(b) for a, b in zip(low, want)) > 0


def test_bf16_fold_differs(cont_model):
    """The control's bfloat16 fold moves the int16 scores."""
    ref = PlainCont(cont_model, SAMPRATE, host_fe=True)
    a = _audios()[:1]
    assert not torch.equal(ref.scores(a)[0], ref.scores(a, "bf16")[0])


def test_single_utterance_scores_read_the_model_layout(cont_model,
                                                       monkeypatch):
    """The single-utterance dense scores (decode_search's input) on the
    device front end read one 39-dim stream and equal the reference's."""
    al = _aligner(cont_model, "device", monkeypatch)
    ref = PlainCont(cont_model, SAMPRATE, host_fe=False)
    audio = austen_audio(2)
    got = al._dense_scores_utt(audio)
    assert np.array_equal(got, ref.scores([audio])[0].numpy())


def test_three_stream_model_keeps_its_path(tmp_path_factory, monkeypatch):
    """A 3-stream ms model (the 1:1 fallback) still reads K1's features
    as 3 streams of 13: its batch route's scores are those of the
    [N, 3, 13] view, in one block."""
    from soundswallower_tpu_torch import spans

    d = variant_dir(tmp_path_factory, "ms1to1")
    al = _aligner(d, "host", monkeypatch)
    assert al.streams == (3, 13)
    audios, Ts, Tmax = al._batch_shape(_audios()[:2])
    _, _, feats = next(iter(al._chunk_feats(
        audios, torch.from_numpy(Ts.astype(np.int32)), Tmax)))
    assert torch.equal(al._scorer_view(feats), feats.view(-1, 3, 13))
    rec = spans.Recorder()
    spans.install(rec)
    try:
        al.align_batch(_audios()[:2], [TEXT, "young man"])
    finally:
        spans.uninstall()
    assert rec.counts["ms.blocks"] == 1
    assert rec.counts["ms.block_frames"] == len(audios) * Tmax


def test_trace_cell_reads_the_ms_counters():
    """tools/trace_cell.py's ``ms`` entry: K11's forms, the frame blocks
    in all and per ``score`` span, and the largest block, from the span
    recorder; nothing where the continuous scorer did not run."""
    import trace_cell
    from soundswallower_tpu_torch import spans

    rec = spans.Recorder()
    assert trace_cell.ms_counts(rec) == {}
    ms, x = _tables(39)
    spans.install(rec)
    try:
        for n in (300, 100):
            with spans.span("score"):
                st.score_frames_ms(ms, x[:n], block=128)
    finally:
        spans.uninstall()
    rec.add("ms_dist_topn.forms[runtime L]", 4)
    got = trace_cell.ms_counts(rec)
    assert got == {"ms_dist_topn.forms": {"runtime L": 4},
                   "ms.blocks": 4, "ms.blocks_per_score": 2.0,
                   "ms.block_frames": 128}
