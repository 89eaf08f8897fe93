"""The port's exact Decoder against the JAX package's on the CPU, live
input and front-end state: chunked ``process_raw`` in 777- and
1,600-sample pieces, the CMN state across the two packages, dither and
``spectrogram`` (small synthetic model, wide beams, the front end's
plain PyTorch version; test_torch_decoder.py has the rest).
"""

import numpy as np
import pytest
import torch

from _torch_synth import austen_audio
from test_torch_decoder import SHORT, SHORT_TEXT, _decode, _pair, small_dir  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("piece", [777, 1600])
def test_live_chunks_equal_reference(small_dir, piece):
    """Chunked process_raw (full_utt=False) in 777- and 1,600-sample
    pieces: hyp, result_json at align level 1, the live CMN state."""
    port, ref = _pair(small_dir)
    a = austen_audio(6)[:SHORT]
    for dec in (port, ref):
        dec.set_align_text(SHORT_TEXT)
        _decode(dec, a, piece)
    assert port.hyp == ref.hyp
    assert port.result_json(align_level=1) == ref.result_json(align_level=1)
    assert port.get_cmn(update=True) == ref.get_cmn(update=True)


def test_cmn_state_across_packages(small_dir):
    """get_cmn of one package's decoder restores into the other's with
    set_cmn: the next live decodes are equal."""
    port, ref = _pair(small_dir)
    a = austen_audio(2)[:SHORT]
    for dec in (port, ref):
        dec.set_align_text(SHORT_TEXT)
    ref.set_cmn("40.0,1.5,-3.25,2,0,0,0,0,0,0,0,0,0")
    port.set_cmn(ref.get_cmn())
    assert port.get_cmn() == ref.get_cmn()
    for dec in (port, ref):
        _decode(dec, a, 1600)
    assert port.result_json() == ref.result_json()
    state = port.get_cmn(update=True)
    assert state == ref.get_cmn(update=True)
    port2, ref2 = _pair(small_dir)
    ref2.set_cmn(state)
    port2.set_cmn(ref.get_cmn())
    assert port2.get_cmn() == ref2.get_cmn()


def test_dither_and_spectrogram_equal_reference(small_dir):
    """dither=True (the MT19937 stream seeded from ``seed``) on a full
    utterance; spectrogram raw and smooth."""
    port, ref = _pair(small_dir, dither=True, seed=77)
    a = austen_audio(3)[:SHORT]
    for dec in (port, ref):
        dec.set_align_text(SHORT_TEXT)
        _decode(dec, a)
    assert port.result_json() == ref.result_json()
    assert port.get_cmn() == ref.get_cmn()
    for smooth in (False, True):
        s, w = port.spectrogram(a, smooth), ref.spectrogram(a, smooth)
        assert s.dtype == w.dtype == np.float32 and (s == w).all()
