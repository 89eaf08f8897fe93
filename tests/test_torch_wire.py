"""The host front end's wire (SST_WIRE, SST_WIRE_SCALE) in TorchAligner
against TpuAligner, bit-equal on the CPU: exact float32 cepstra under
SST_WIRE=f32 on the same-transcript route, the mixed route and
align_batch_scored, and the byte-plane wire at a scale the environment
sets.  Each aligner is built after the environment is set, as both read
it once."""

import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.aligner import TorchAligner

torch.set_num_threads(1)

MIXED = [TEXT, "young man", "he was not", "an ill man", "was not young",
         "ill disposed man", TEXT, "young man"]


@pytest.fixture(scope="module")
def enus_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "en-us")


def _pair(d, monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    assert (port.wire, port.wire_scale) == (ref.wire, ref.wire_scale)
    assert port.native_fe is not None and ref.native_fe is not None
    return port, ref


def _scored(out):
    return [None if segs is None else
            [(s.word, s.start, s.duration, s.score, list(s.phones))
             for s in segs] for segs in out]


@pytest.mark.parametrize("env", [dict(SST_WIRE="f32"),
                                 dict(SST_WIRE_SCALE="128"),
                                 dict(SST_WIRE_SCALE="256")])
def test_same_transcript_follows_the_wire(enus_dir, monkeypatch, env):
    """The en-us-width model, 8 austen rows, one transcript: under
    SST_WIRE=f32 row 6's "disposed" lasts 80 frames on both packages
    (79 on the default byte-plane wire)."""
    port, ref = _pair(enus_dir, monkeypatch, **env)
    audios = [austen_audio(i) for i in range(8)]
    want = [segs_rep(s) for s in ref.align_batch(audios, [TEXT] * 8)]
    assert [segs_rep(s) for s in port.align_batch(audios, [TEXT] * 8)] \
        == want
    if env.get("SST_WIRE") == "f32":
        assert [w[2] for w in want[6] if w[0] == "disposed"] == [80]


def test_mixed_and_scored_follow_the_f32_wire(enus_dir, monkeypatch):
    """SST_WIRE=f32 on the multi-graph route (the union scorer) and on
    align_batch_scored (the full inventory, with scores)."""
    port, ref = _pair(enus_dir, monkeypatch, SST_WIRE="f32")
    audios = [austen_audio(i) for i in range(8)]
    want = [segs_rep(s) for s in ref.align_batch(audios, MIXED)]
    assert [segs_rep(s) for s in port.align_batch(audios, MIXED)] == want
    want = _scored(ref.align_batch_scored(audios, [TEXT] * 8))
    assert _scored(port.align_batch_scored(audios, [TEXT] * 8)) == want
