"""TorchAligner (plain PyTorch on the CPU) against TpuAligner: the whole
same-transcript slice gives equal word and phone segments."""

import hashlib
import os

import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, load_golden,
                          make_synth_model, model_dir, segs_rep)

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.aligner import result_json_from_segs as ref_json
from soundswallower_tpu_torch.aligner import (TorchAligner,
                                              result_json_from_segs)

torch.set_num_threads(1)

B = 5  # bucketed to 8 rows by both aligners


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = model_dir(tmp_path_factory, "small")
    return (TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=d, samprate=SAMPRATE))


def _reps(out):
    return [segs_rep(s) for s in out]


def test_align_single(small):
    port, ref = small
    a = austen_audio(3)
    got, want = port.align(a, TEXT), ref.align(a, TEXT)
    assert segs_rep(got) == segs_rep(want)
    T = port.fe.n_frames(len(a))
    for level in (0, 1):
        assert result_json_from_segs(got, port.lmath, T, 100,
                                     align_level=level) \
            == ref_json(want, ref.lmath, T, 100, align_level=level)


def test_align_batch_and_pipelined(small):
    port, ref = small
    audios = [austen_audio(i) for i in range(B)]
    want = _reps(ref.align_batch(audios, [TEXT] * B))
    assert all(w is not None for w in want)
    assert _reps(port.align_batch(audios, [TEXT] * B)) == want
    h1 = port.align_batch_begin(audios, [TEXT] * B)
    h2 = port.align_batch_begin(audios[::-1], [TEXT] * B)
    assert _reps(port.align_batch_end(h1)) == want
    assert _reps(port.align_batch_end(h2)) == want[::-1]


def test_mixed_batch_equals_reference(small):
    """A batch of different transcripts against TpuAligner's default
    single multi-graph dispatch (union scorer + per-row Viterbi)."""
    port, ref = small
    texts = [TEXT, "young man", TEXT, "he was not", "young man", "an ill man",
             "he was a xyzzy"]                      # unknown word: None
    audios = [austen_audio(i) for i in range(len(texts))]
    want = _reps(ref.align_batch(audios, texts))
    assert want[-1] is None
    assert _reps(port.align_batch(audios, texts)) == want
    h = port.align_batch_begin(audios[:-1], texts[:-1])
    assert _reps(port.align_batch_end(h)) == want[:-1]
    with pytest.raises(KeyError):
        port.align_batch_begin(audios, texts)


def test_full_width_golden(tmp_path_factory):
    """At the published en-us width, both packages give the committed
    golden (tests/golden/torch-synth/segs.json)."""
    g = load_golden()
    d = model_dir(tmp_path_factory, "en-us")
    audios = [austen_audio(i) for i in range(len(g["segs"]))]
    texts = [g["text"]] * len(audios)
    port = TorchAligner(hmm=d, samprate=g["samprate"], device="cpu")
    assert _reps(port.align_batch(audios, texts)) == g["segs"]
    ref = TpuAligner(hmm=d, samprate=g["samprate"])
    assert _reps(ref.align_batch(audios, texts)) == g["segs"]


SYNTH_SHA256 = {
    "en-us": "11134a9731233d1a5c373b42c01d5c222c1163ed77c5504ef3902027a21b4b44",
    "small": "f8fe307f1f96cecd637a949d8c773796165eaf868e3557cc1c0040524d6f8d6a",
}


@pytest.mark.parametrize("width", sorted(SYNTH_SHA256))
def test_synth_model_bytes_pinned(tmp_path, width):
    d = make_synth_model(str(tmp_path), seed=0, width=width)
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode())
        with open(os.path.join(d, name), "rb") as fh:
            h.update(fh.read())
    assert h.hexdigest() == SYNTH_SHA256[width]


def test_unported_surfaces_raise(small):
    """What is still to be ported raises NotImplementedError naming its
    ROADMAP item; want_scores on a same-transcript batch, decode,
    align_longform_batch and dist_mode="mxu", which once did, are ported
    (tests/test_torch_large_graph.py, tests/test_torch_decode.py,
    tests/test_torch_longform.py, tests/test_torch_mxu.py)."""
    port, _ = small
    a = austen_audio(0)
    with pytest.raises(RuntimeError, match="set_grammar"):
        port.decode(a)
    for call, item in ((lambda: port.use_mesh(None), "A13"),
                       (lambda: port.update_mllr("x"), "A14")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            call()
    assert port.align(a, TEXT, dist_mode="mxu")


def test_cuda_device_is_never_a_silent_fallback(tmp_path_factory):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchAligner(hmm=model_dir(tmp_path_factory, "small"),
                     samprate=SAMPRATE, device="cuda")
