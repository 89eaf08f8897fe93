"""TorchAligner (plain PyTorch on the CPU) against TpuAligner on the
acoustic-model backends beside 8-bit ptm (small synthetic models, seed
0): same-transcript, mixed (union, then forced dense; ms models are
dense from the start) and scored batches give equal segments and
scores, and the single-utterance align equal segments."""

import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, segs_rep,
                          variant_dir)
from make_torch_mixed_golden import scored_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.aligner import TorchAligner

torch.set_num_threads(1)

SMALL = ["ptm4b", "semi", "semi4b", "ms", "ms1to1"]
TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young"]


@pytest.fixture(scope="module", params=SMALL)
def pair(request, tmp_path_factory):
    d = variant_dir(tmp_path_factory, request.param)
    return (request.param, TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=d, samprate=SAMPRATE))


def test_segments_equal(pair):
    """Same-transcript, mixed (union, then forced dense) and scored
    batches: TorchAligner's segments (and scores) are TpuAligner's."""
    variant, port, ref = pair
    audios = [austen_audio(i) for i in range(len(TEXTS))]
    for texts in ([TEXT] * len(TEXTS), TEXTS):
        want = [segs_rep(s) for s in ref.align_batch(audios, texts)]
        assert all(w is not None for w in want)
        assert [segs_rep(s) for s in port.align_batch(audios, texts)] == want
    if not variant.startswith("ms"):
        assert port._uni["gs"] is not None and not port._uni["dense"]
        for al in (port, ref):
            al._uni["dense"] = True
        want = [segs_rep(s) for s in ref.align_batch(audios, TEXTS)]
        assert [segs_rep(s) for s in port.align_batch(audios, TEXTS)] == want
    else:
        assert port._uni["dense"] and port._uni["gs"] is None
    want = [scored_rep(s) for s in ref.align_batch_scored(audios, TEXTS)]
    assert [scored_rep(s) for s in port.align_batch_scored(audios, TEXTS)] \
        == want
    if not variant.startswith("ms"):   # for ms, the same-transcript route
        a = austen_audio(5)
        assert segs_rep(port.align(a, TEXT)) == segs_rep(ref.align(a, TEXT))
