"""Both packages reproduce tests/golden/torch-synth/mixed_segs.json (made
by tools/make_torch_mixed_golden.py) at the published en-us width on the
CPU: the union, forced-dense and scored results of 32 mixed
transcripts, in that order on one aligner."""

import pytest
import torch

from _torch_synth import model_dir
from make_torch_mixed_golden import (N_MIXED, load_mixed_golden, mixed_audio,
                                     mixed_texts, scored_rep)
from make_torch_synth_golden import segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.aligner import TorchAligner

torch.set_num_threads(1)

PORT_ROWS = 8


@pytest.fixture(scope="module")
def golden():
    g = load_mixed_golden()
    assert g["texts"] == mixed_texts() and len(g["union"]) == N_MIXED
    return g


def _run(al, g, rows: int):
    """The golden's sequence on one fresh aligner: the union built from
    all 32 transcripts, then the first ``rows`` rows on it, forced
    dense, and scored."""
    texts = g["texts"][:rows]
    audios = [mixed_audio(i) for i in range(rows)]
    al._union_scorer([al.graph_for_text(t) for t in g["texts"]])
    union = [segs_rep(s) for s in al.align_batch(audios, texts)]
    assert len(al._uni["senset"]) == 462 and al._uni["Spad"] == 512
    al._uni["dense"] = True
    dense = [segs_rep(s) for s in al.align_batch(audios, texts)]
    scored = [scored_rep(s) for s in al.align_batch_scored(audios, texts)]
    return union, dense, scored


def test_jax_reproduces_mixed_golden(tmp_path_factory, golden):
    al = TpuAligner(hmm=model_dir(tmp_path_factory, "en-us"),
                    samprate=golden["samprate"])
    assert _run(al, golden, N_MIXED) == (golden["union"], golden["dense"],
                                         golden["scored"])


def test_port_reproduces_mixed_golden(tmp_path_factory, golden):
    """The port's plain versions on the first 8 rows (a row's result on
    a given union, or on the full inventory, does not depend on the
    other rows of its batch; chip_smoke.py checks all 32 on the card)."""
    al = TorchAligner(hmm=model_dir(tmp_path_factory, "en-us"),
                      samprate=golden["samprate"], device="cpu")
    union, dense, scored = _run(al, golden, PORT_ROWS)
    assert union == golden["union"][:PORT_ROWS]
    assert dense == golden["dense"][:PORT_ROWS]
    assert scored == golden["scored"][:PORT_ROWS]
    assert union != dense                 # the two routes really differ
