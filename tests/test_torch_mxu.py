"""dist_mode="mxu" (the expanded distance, K2's mxu form) against the
JAX package, bit-equal on the CPU: the int32 distances and the scores
of the graph-restricted and full-inventory scorers on the small and
en-us-width models, and every entry point that takes the mode (align on
both front ends, align_batch on the same-transcript, union and dense
routes, align_batch_scored, decode_batch, decode_batch_scored,
decode_search); an ms model computes the fold under either mode, as the
JAX package's score_frames routes it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, model_dir, segs_rep,
                          variant_dir)
from make_torch_decode_golden import GRAMMAR, decode_rep, search_rep
from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops import senscore_jax as sj
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young",
         "ill disposed man"]


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


def _feats(n: int = 192) -> np.ndarray:
    """n frames of the C oracle's austen features; frame 0 blown up so
    that every distance is far out, frame 1 so that some are."""
    f = golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))[:n].copy()
    f[0] = 1e5
    f[1, :, :4] = 3e3
    return f


@pytest.mark.parametrize("width", ["small", "en-us"])
def test_mxu_distances_and_scores_equal_jax(tmp_path_factory, width):
    """The int32 distances of _dist_stage_graph / _dist_stage under mxu
    (the expanded distance, the per-table constants made on the host)
    and the scores after them: score_frames_graph's int32 on a
    transcript's graph, score_frames' int16 over the full inventory."""
    d = model_dir(tmp_path_factory, width)
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    feats = _feats()
    x = torch.from_numpy(feats)
    g = ref.graph_for_text(TEXT)
    gs_j = sj.GraphScorer.build(ref.am, ref.tables, g.senid)
    gs = st.GraphScorer.build(port.am, g.senid, "cpu")
    want = np.asarray(sj._dist_stage_graph(gs_j, jnp.asarray(feats), "mxu"))
    got = st.int_distances_plain(x, gs, "mxu").numpy()
    assert np.array_equal(got, want[:, :got.shape[1]])
    fold = st.int_distances_plain(x, gs).numpy()
    assert (fold != got).any()                  # the forms differ
    want = np.asarray(sj.score_frames_graph(gs_j, jnp.asarray(feats), "mxu"))
    assert np.array_equal(
        st.score_frames_graph(gs, x, dist_mode="mxu").numpy(), want)
    want = np.asarray(sj._dist_stage(ref.tables, jnp.asarray(feats), "mxu"))
    assert np.array_equal(
        st.int_distances_plain(x, port.dense, "mxu").numpy(), want)
    want = sj.ungroup(ref.tables, np.asarray(
        sj.score_frames(ref.tables, jnp.asarray(feats), "mxu")))
    assert np.array_equal(
        st.score_frames(port.dense, x, "mxu").numpy(), want)


def _scored(out):
    return [None if segs is None else
            [(s.word, s.start, s.duration, s.score, list(s.phones))
             for s in segs] for segs in out]


def test_mxu_entry_points_equal_reference(small_dir):
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    audios = [austen_audio(i) for i in range(len(TEXTS))]
    a = audios[0]
    assert segs_rep(port.align(a, TEXT, dist_mode="mxu")) \
        == segs_rep(ref.align(a, TEXT, dist_mode="mxu"))
    for texts in ([TEXT] * 6, TEXTS):
        want = [segs_rep(s) for s in ref.align_batch(audios, texts, "mxu")]
        assert [segs_rep(s) for s in port.align_batch(audios, texts, "mxu")] \
            == want
    for al in (port, ref):                      # the dense route
        al._uni["dense"] = True
    want = [segs_rep(s) for s in ref.align_batch(audios, TEXTS, "mxu")]
    assert [segs_rep(s) for s in port.align_batch(audios, TEXTS, "mxu")] \
        == want
    want = _scored(ref.align_batch_scored(audios[:3], TEXTS[:3], "mxu"))
    assert _scored(port.align_batch_scored(audios[:3], TEXTS[:3], "mxu")) \
        == want
    for al in (port, ref):
        al.set_grammar(jsgf_string=GRAMMAR)
    rows = audios[:3]
    want = [decode_rep(r) for r in ref.decode_batch(rows, "mxu")]
    assert [decode_rep(r) for r in port.decode_batch(rows, "mxu")] == want
    want = [decode_rep(r) for r in ref.decode_batch_scored(rows, "mxu")]
    assert [decode_rep(r) for r in port.decode_batch_scored(rows, "mxu")] \
        == want
    assert search_rep(port.decode_search(a, "mxu"), None, []) \
        == search_rep(ref.decode_search(a, "mxu"), None, [])


def test_mxu_on_the_device_front_end(small_dir, monkeypatch):
    """align's single-utterance device path (K8-K10, K1, K2 mxu, K3,
    K4's carry form)."""
    monkeypatch.setenv("SST_FE", "device")
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    assert port.native_fe is None and ref.native_fe is None
    a = austen_audio(2)
    assert segs_rep(port.align(a, TEXT, dist_mode="mxu")) \
        == segs_rep(ref.align(a, TEXT, dist_mode="mxu"))


def test_ms_takes_mxu_as_the_fold(tmp_path_factory):
    d = variant_dir(tmp_path_factory, "ms")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    audios = [austen_audio(i) for i in range(2)]
    want = [segs_rep(s) for s in ref.align_batch(audios, [TEXT] * 2, "mxu")]
    assert want == [segs_rep(s) for s in ref.align_batch(audios, [TEXT] * 2)]
    assert [segs_rep(s) for s in port.align_batch(audios, [TEXT] * 2,
                                                  "mxu")] == want
