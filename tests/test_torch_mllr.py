"""MLLR on the port against the JAX package on the CPU, bit-equal.

The transform is tools/make_mllr.py's (seed 42, 3 streams of 13) on the
small synthetic model.  ``TorchAligner.update_mllr`` and ``mllr=`` at
init against ``TpuAligner``'s: the transformed Gaussians, the dense
int16 scores, a graph's int32 scores (its scorer built before the
update, so a stale cache would show), the same-transcript and scored
segments and a mixed batch on the union scorer, each made before the
update and again after it; the exact ``Decoder``'s ``update_mllr`` and
``mllr=`` at init against the JAX ``Decoder``'s: the senone scores of
its host scorer and the two-pass alignment's result JSON.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep
from make_torch_api_golden import mllr_file, mllr_results
from make_torch_mixed_golden import scored_rep
from tests.conftest import golden

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.decoder import Decoder as JaxDecoder
from soundswallower_tpu.ops import senscore_jax as sj
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.decoder import Decoder
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)

BEAMS = dict(beam=1e-200, pbeam=1e-200, wbeam=1e-200)
MIXED = [TEXT, "young man", "he was not", "an ill man"]
SHORT = 12000
SHORT_TEXT = "he was not an ill"


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def mllr(tmp_path_factory):
    return mllr_file(str(tmp_path_factory.mktemp("mllr")))


def _feats() -> np.ndarray:
    return golden("austen-en", "feat.f32", np.float32, (-1, 3, 13))[:64]


def _dense(port, ref):
    feats = _feats()
    want = sj.ungroup(ref.tables, np.asarray(
        sj.score_frames(ref.tables, jnp.asarray(feats))))
    got = st.score_frames(port.dense, torch.from_numpy(feats)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


def _graph(port, ref, g):
    feats = _feats()
    gs = sj.GraphScorer.build(ref.am, ref.tables, g.senid.reshape(-1))
    want = np.asarray(sj.score_frames_graph(gs, jnp.asarray(feats)))
    got = st.score_frames_graph(port._graph_consts(g).gs,
                                torch.from_numpy(feats)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    return got


def _segs(al):
    audios = [austen_audio(i) for i in range(4)]
    return ([segs_rep(s) for s in al.align_batch(audios, [TEXT] * 4)],
            [scored_rep(s) for s in al.align_batch_scored(audios, [TEXT] * 4)],
            [segs_rep(s) for s in al.align_batch(audios, MIXED)])


def test_update_mllr_equals_reference(small_dir, mllr):
    """Before and after update_mllr on one aligner of each package: the
    model's Gaussians, dense and graph scores, same-transcript, scored
    and mixed segments; the caches made before the update (the graph's
    scorer, the stacked graphs, the union scorer) are not reused."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    g = port.graph_for_text(TEXT)
    dense0, graph0 = _dense(port, ref), _graph(port, ref, g)
    assert _segs(port) == _segs(ref)
    assert port._uni is not None and port._graph_const_cache
    for al in (port, ref):
        al.update_mllr(mllr)
    for name in ("means", "var_t", "det"):
        a, b = getattr(port.am, name), getattr(ref.am, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port._uni is None and not port._stack_cache
    assert not np.array_equal(_dense(port, ref), dense0)
    assert not np.array_equal(_graph(port, ref, g), graph0)
    assert _segs(port) == _segs(ref)


def test_mllr_at_init_equals_reference(small_dir, mllr):
    """config["mllr"] at init: the same scores as the JAX aligner's, and
    the segments of tools/make_torch_api_golden.py's scenario equal to
    those of update_mllr after init, in both packages."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu",
                        mllr=mllr)
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE, mllr=mllr)
    _dense(port, ref)
    _graph(port, ref, port.graph_for_text(TEXT))
    want = mllr_results(TpuAligner, small_dir, mllr)
    assert mllr_results(TorchAligner, small_dir, mllr, device="cpu") == want
    audios = [austen_audio(i) for i in range(8)]
    assert [segs_rep(s) for s in port.align_batch(audios, [TEXT] * 8)] == \
        want["same"]


@pytest.mark.parametrize("at_init", [False, True])
def test_decoder_mllr_equals_reference(small_dir, mllr, at_init):
    """The exact Decoder with the transform (update_mllr, or mllr= at
    init): its host scorer's senone scores on 8 frames and the two-pass
    alignment's result JSON at align level 2 equal the JAX Decoder's."""
    kw = dict(mllr=mllr) if at_init else {}
    port = Decoder(hmm=small_dir, samprate=SAMPRATE, device="cpu", **BEAMS,
                   **kw)
    ref = JaxDecoder(hmm=small_dir, samprate=SAMPRATE, **BEAMS, **kw)
    if not at_init:
        for dec in (port, ref):
            dec.update_mllr(mllr)
    assert np.array_equal(port.am.means, ref.am.means)
    feats = _feats()
    for dec in (port, ref):
        dec.scorer.start_utt()
    for t in range(8):
        assert np.array_equal(port.scorer.frame_eval(feats[t], t),
                              ref.scorer.frame_eval(feats[t], t)), t
    a = austen_audio(7)[:SHORT]
    for dec in (port, ref):
        dec.set_align_text(SHORT_TEXT)
        dec.start_utt()
        dec.process_raw(a)
        dec.end_utt()
    assert port.hyp.text == SHORT_TEXT
    assert port.result_json(align_level=2) == ref.result_json(align_level=2)
