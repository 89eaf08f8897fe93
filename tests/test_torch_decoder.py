"""The port's exact Decoder against the JAX package's on the CPU: the
same configuration and audio give equal strings and arrays.

Small synthetic model at 8 kHz with wide beams (the default beams prune
the small model's search before the final state); the Decoder's front
end runs its plain PyTorch version (``device="cpu"``).  Covered: the
alignment through ``set_align_text`` (hyp, seg, ``alignment`` and
``result_json`` at align levels 0-2), the slice's decode grammar with
``nbest``, a JSGF file grammar with ``add_word``, ``lattice`` and
``nbest``, a live decode in 1,600-sample pieces; live chunks, the CMN
state, dither and ``spectrogram`` are in test_torch_decoder_live.py.
"""

import itertools
import os

import pytest
import torch

from _torch_synth import SAMPRATE, austen_audio, model_dir
from make_torch_api_golden import decoder_results
from make_torch_synth_golden import REPO

from soundswallower_tpu.decoder import Decoder as JaxDecoder
from soundswallower_tpu_torch.decoder import Decoder

torch.set_num_threads(1)

BEAMS = dict(beam=1e-200, pbeam=1e-200, wbeam=1e-200)
WORDS_GRAM = os.path.join(REPO, "tests", "data", "austen_words.gram")
SHORT = 12000            # samples of the short cuts (1.5 s)
SHORT_TEXT = "he was not an ill"


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


def _pair(d, **kw):
    return (Decoder(hmm=d, samprate=SAMPRATE, device="cpu", **BEAMS, **kw),
            JaxDecoder(hmm=d, samprate=SAMPRATE, **BEAMS, **kw))


def _decode(dec, audio, piece: int = 0):
    dec.start_utt()
    if piece:
        for i in range(0, len(audio), piece):
            dec.process_raw(audio[i:i + piece], full_utt=False)
    else:
        dec.process_raw(audio)
    dec.end_utt()


def _al_rep(al):
    return [[(e.id if not isinstance(e.id, tuple) else tuple(e.id)),
             e.start, e.duration, e.score, e.parent]
            for level in (al.words, al.phones, al.states) for e in level]


def _links(dag):
    return [(l.src.node_id, l.dst.node_id, l.ascr, l.ef)
            for n in dag.nodes for l in n.exits]


def test_scenario_equals_reference(small_dir):
    """The API golden's Decoder scenario, run on both packages: the
    alignment's hyp, segments and result_json at align levels 0-2; the
    decode grammar's hyp, segments and first 5 n-best; a live decode in
    1,600-sample pieces with its CMN state (on short cuts of the audio
    and of the transcript)."""
    def short(i):
        return austen_audio(i)[:SHORT]

    got = decoder_results(Decoder, small_dir, audio=short, text=SHORT_TEXT,
                          device="cpu", **BEAMS)
    want = decoder_results(JaxDecoder, small_dir, audio=short,
                           text=SHORT_TEXT, **BEAMS)
    assert got == want
    assert got["align"]["hyp"][0] == SHORT_TEXT
    assert len(got["grammar"]["nbest"]) == 5


def test_alignment_entries_equal_reference(small_dir):
    """alignment(): every word, phone and state entry (id, start,
    duration, score, parent) of the two-pass alignment."""
    port, ref = _pair(small_dir)
    a = austen_audio(4)[:SHORT]
    for dec in (port, ref):
        dec.set_align_text("he was not an ill")
        _decode(dec, a)
    got, want = port.alignment(), ref.alignment()
    assert got is not None and _al_rep(got) == _al_rep(want)
    assert list(port.seg) == list(ref.seg)


def test_jsgf_file_grammar_with_added_words(small_dir):
    """tests/data/austen_words.gram, whose 'she' and 'well' the
    dictionary lacks: add_word on both, then set_jsgf_file; hyp, seg,
    the lattice's nodes and links, and the first 5 n-best."""
    port, ref = _pair(small_dir)
    a = austen_audio(5)[:4000]
    for dec in (port, ref):
        assert dec.add_word("she", "HH IY") == dec.add_word("well", "W IH L")\
            - 1
        dec.set_jsgf_file(WORDS_GRAM)
        _decode(dec, a)
    assert port.hyp == ref.hyp and port.hyp.text
    assert list(port.seg) == list(ref.seg)
    assert port.lookup_word("she") == ref.lookup_word("she") == "HH IY"
    dp, dr = port.lattice(), ref.lattice()
    assert [(n.wid, n.sf, n.fef, n.lef, n.node_id) for n in dp.nodes] == \
        [(n.wid, n.sf, n.fef, n.lef, n.node_id) for n in dr.nodes]
    assert _links(dp) == _links(dr) and _links(dp)
    assert list(itertools.islice(port.nbest(), 5)) == \
        list(itertools.islice(ref.nbest(), 5))


def test_decoder_defaults_to_the_card(small_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder(hmm=small_dir, samprate=SAMPRATE)
    dec = Decoder.create(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    assert dec.device.type == "cpu"
