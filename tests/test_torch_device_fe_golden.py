"""The port's device front end (plain PyTorch on the CPU) reproduces
tests/golden/torch-synth/device_fe.json and device_fe.npz (made by
tools/make_torch_device_fe_golden.py with TpuAligner under SST_FE=device)
at the published en-us width: the single-utterance path, the
spectrogram, the stream with its checkpoint, and the same-transcript
batch.  chip_smoke.py holds the kernels to the same goldens on the card,
the mixed rows included."""

import os

import numpy as np
import pytest
import torch

from _torch_synth import model_dir
from make_torch_device_fe_golden import (CKPT_SAMPLES, STREAM_SPLIT,
                                         load_device_fe_golden, pieces)
from make_torch_mixed_golden import mixed_audio
from make_torch_synth_golden import N_UTT, austen_audio, segs_rep

from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.streaming import AlignStream

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_device_fe_golden()


@pytest.fixture(scope="module")
def port(tmp_path_factory, golden):
    d = model_dir(tmp_path_factory, "en-us")
    prev = os.environ.get("SST_FE")
    os.environ["SST_FE"] = "device"
    try:
        al = TorchAligner(hmm=d, samprate=golden["samprate"], device="cpu")
    finally:
        if prev is None:
            del os.environ["SST_FE"]
        else:
            os.environ["SST_FE"] = prev
    assert al.native_fe is None
    return al


def test_align_and_spectrogram_equal_golden(port, golden):
    a = austen_audio(0)
    assert segs_rep(port.align(a, golden["text"])) == golden["align"]
    for smooth, key in ((False, "spec_raw"), (True, "spec_smooth")):
        got = port.spectrogram(a, smooth)
        assert got.dtype == np.float32
        assert np.array_equal(got, golden[key])


def test_stream_and_checkpoint_equal_golden(port, golden):
    """Pushed in the golden's pieces: state() at its cut equals the
    golden checkpoint key for key, and the segments equal its; the
    golden checkpoint restored in the port continues to the same."""
    a = austen_audio(0)
    s = port.stream(golden["text"])
    pushed = 0
    for p in pieces(a, STREAM_SPLIT):
        s.push(p)
        pushed += len(p)
        if pushed == CKPT_SAMPLES:
            got, want = s.state(), golden["state"]
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                xs, ws = (got[k], w) if isinstance(w, tuple) \
                    else ((got[k],), (w,))
                for x, v in zip(xs, ws):
                    if isinstance(v, (np.ndarray, np.generic)):
                        assert np.asarray(x).dtype == v.dtype, k
                        assert np.array_equal(x, v), k
                    else:
                        assert x == v, k
    assert segs_rep(s.end()) == golden["stream"]
    r = AlignStream.restore(port, golden["state"])
    for p in pieces(a[CKPT_SAMPLES:], STREAM_SPLIT):
        r.push(p)
    assert segs_rep(r.end()) == golden["stream"]


def test_same_transcript_batch_equals_golden(port, golden):
    audios = [austen_audio(i) for i in range(N_UTT)]
    got = port.align_batch(audios, [golden["text"]] * N_UTT)
    assert [segs_rep(s) for s in got] == golden["same"]


def test_mixed_rows_equal_golden(port, golden):
    """The first 8 mixed rows on the union the golden's 32 transcripts
    build (a row's result on a given union does not depend on the other
    rows of its batch)."""
    texts = golden["texts"]
    port._uni = None
    port._union_scorer([port.graph_for_text(t) for t in texts])
    got = port.align_batch([mixed_audio(i) for i in range(8)], texts[:8])
    assert [segs_rep(s) for s in got] == golden["mixed"][:8]
