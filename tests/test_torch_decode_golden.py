"""The port's plain path at the published en-us width against the JAX-made
golden of the grammar decode, 5-state and large-graph paths
(tests/golden/torch-synth/decode.json and .npz,
tools/make_torch_decode_golden.py), on the rows the CPU affords: the
decode graphs, decode_batch with the failing row, decode_batch_scored,
decode on both front ends; the ptm5st
model's same-transcript, union and scored rows and align on the device
front end; the large grammar (S >= 32,767) and the same-transcript
scores.  A row's result does not depend on the other rows of its batch
(on the union route, once the union holds the golden's 32 transcripts),
so a subset is compared, 8 rows at a time (the smallest batch bucket:
fewer rows cost as much); chip_smoke.py checks every row on the card."""

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, variant_dir
from make_torch_decode_golden import (GRAMMAR, GRAPH_FIELDS, N_UTT,
                                      decode_audio, decode_rep, large_grammar,
                                      load_decode_golden)
from make_torch_mixed_golden import mixed_audio, mixed_texts, scored_rep
from make_torch_synth_golden import segs_rep

from soundswallower_tpu_torch.aligner import TorchAligner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    g = load_decode_golden()
    assert g["grammar"] == GRAMMAR and g["samprate"] == SAMPRATE
    return g


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The en-us-width 8-bit ptm and ptm5st models, written once."""
    return {v: variant_dir(tmp_path_factory, v, "en-us")
            for v in ("ptm", "ptm5st")}


def _aligner(models, variant, monkeypatch=None, device_fe=False):
    d = models[variant]
    if device_fe:
        monkeypatch.setenv("SST_FE", "device")
    al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    assert (al.native_fe is None) == device_fe
    return al


def _check_graph(g, golden, prefix):
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(g, f)), golden[f"{prefix}/{f}"]
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_decode_matches_golden(models, golden):
    """The decode grammar (``GRAMMAR``) on 8-bit ptm: the graph, decode_batch on rows
    0-6 and the truncated one, decode_batch_scored on rows 1-7 and the
    truncated one, and decode (host FE).  The history search
    (decode_search, lattice, nbest) is tests/test_torch_decode.py's, on
    the small model, and chip_smoke.py's."""
    want = golden["decode"]
    al = _aligner(models, "ptm")
    g = al.set_grammar(jsgf_string=GRAMMAR)
    _check_graph(g, golden, "graph")
    assert (len(g.senid), int(np.bincount(g.edge_dst).max())) == \
        (want["P"], want["K"])
    for run, key, idx in ((al.decode_batch, "batch", range(7)),
                          (al.decode_batch_scored, "scored", range(1, 8))):
        idx = [*idx, N_UTT]
        assert [decode_rep(r) for r in run([decode_audio(i) for i in idx])] \
            == [want[key][i] for i in idx]
        assert want[key][N_UTT] is None
    assert decode_rep(al.decode(austen_audio(0))) == want["decode"]


def test_decode_device_fe_matches_golden(models, golden,
                                         monkeypatch):
    al = _aligner(models, "ptm", monkeypatch, device_fe=True)
    al.set_grammar(jsgf_string=GRAMMAR)
    assert decode_rep(al.decode(austen_audio(0))) == \
        golden["decode"]["decode_device"]


def test_5st_matches_golden(models, golden):
    """ptm5st: the same-transcript rows; rows 0-7 of the mixed set on
    the union of its 32 transcripts, then scored."""
    want = golden["5st"]
    al = _aligner(models, "ptm5st")
    assert al.am.mdef.n_emit_state == 5
    same = [segs_rep(s) for s in al.align_batch(
        [austen_audio(i) for i in range(N_UTT)], [TEXT] * N_UTT)]
    assert same == want["same"]
    texts = mixed_texts()
    al._union_scorer([al.graph_for_text(t) for t in texts])
    audios = [mixed_audio(i) for i in range(8)]
    assert [segs_rep(s) for s in al.align_batch(audios, texts[:8])] == \
        want["union"][:8]
    assert [scored_rep(s) for s in al.align_batch_scored(
        audios, texts[:8])] == want["scored"][:8]


def test_5st_align_device_fe_matches_golden(models, golden,
                                            monkeypatch):
    al = _aligner(models, "ptm5st", monkeypatch, device_fe=True)
    assert segs_rep(al.align(austen_audio(0), TEXT)) == \
        golden["5st"]["align_device"]


def test_large_grammar_matches_golden(models, golden):
    """The large grammar (S >= 32,767: int32 tokens and paths): the
    graph, and decode_batch_scored on the 8 rows (the graph-restricted
    plain scorer over 39,477 states takes a minute here: decode_batch
    is tests/test_torch_large_graph.py's at the small width, and
    chip_smoke.py's)."""
    want = golden["large"]
    al = _aligner(models, "ptm")
    g = al.set_grammar(jsgf_string=large_grammar())
    _check_graph(g, golden, "large")
    assert 3 * len(g.senid) == want["S"] >= 32767
    assert [decode_rep(r) for r in al.decode_batch_scored(
        [austen_audio(i) for i in range(N_UTT)])] == want["scored"]


def test_same_transcript_scores_match_golden(models, golden):
    al = _aligner(models, "ptm")
    al.want_scores = True
    assert [scored_rep(s) for s in al.align_batch(
        [austen_audio(i) for i in range(N_UTT)], [TEXT] * N_UTT)] == \
        golden["scores_same"]
