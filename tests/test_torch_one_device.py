"""The port's batch routes on one device (aligner.py) on the CPU,
against TpuAligner: a dispatched batch's handle holds one part, its
rows the bucketed batch size at the bucket's edges, on the
same-transcript and the mixed route; two mixed batches in flight, the
second growing the union scorer."""

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.aligner import TorchAligner, _Part

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man",
         "disposed young man he was"]


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def pair(small_dir):
    """One port and one TpuAligner, which every test below drives
    through the same calls in the same order (the union scorer depends
    on the mixed batches before it)."""
    return (TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=small_dir, samprate=SAMPRATE))


@pytest.mark.parametrize("route", ["same", "mixed"])
@pytest.mark.parametrize("realB,B", [(1, 8), (8, 8), (9, 16)])
def test_handle_holds_one_part(pair, route, realB, B):
    """_batch_begin (one transcript) and _batch_begin_mixed (a graph a
    row) hand back one part of B rows, B the bucket of the real rows (8
    at least, the next power of two), the frame axis TpuAligner's; the
    real rows' segments are TpuAligner's."""
    port, ref = pair
    audios = [austen_audio(i) for i in range(realB)]
    if route == "same":
        h = port._batch_begin(port.graph_for_text(TEXT), audios)
        rh = ref._batch_begin(ref.graph_for_text(TEXT), audios, "fold")
    else:
        texts = [TEXTS[i % len(TEXTS)] for i in range(realB)]
        h = port._batch_begin_mixed([port.graph_for_text(t) for t in texts],
                                    audios)
        rh = ref._batch_begin_mixed([ref.graph_for_text(t) for t in texts],
                                    audios, "fold")
    assert isinstance(h.part, _Part) and h.realB == realB
    assert h.part.paths.shape == rh[2].shape and h.part.paths.shape[0] == B
    assert h.part.fscore.shape == (B,) and h.part.pscore is None
    assert len(h.graphs) == len(h.Ts) == realB
    paths, pscores = h.fetch()
    assert paths.shape == rh[2].shape and pscores is None
    got = [segs_rep(s) for s in port._batch_end(h)]
    want = [segs_rep(s) for s in ref._batch_end(rh)]
    assert len(got) == realB and all(s is not None for s in got)
    assert got == want


@pytest.mark.parametrize("realB,B", [(64, 64), (65, 128)])
def test_batch_shape_at_the_bucket_edge(pair, realB, B):
    """Past 64 rows the batch rounds up to a multiple of 64: the padded
    list repeats the last utterance, a frame count a row, Tmax a
    multiple of 64 that holds the longest row."""
    port, _ = pair
    audios = [austen_audio(i % 4) for i in range(realB)]
    padded, Ts, Tmax = port._batch_shape(audios)
    assert len(padded) == len(Ts) == B
    assert padded[:realB] == audios
    assert all(a is audios[-1] for a in padded[realB:])
    assert list(Ts) == [port.fe.n_frames(len(a)) for a in padded]
    assert Tmax % 64 == 0 and Tmax - 64 < Ts.max() <= Tmax


def test_mixed_batches_in_flight_grow_the_union(small_dir):
    """Two mixed batches dispatched before either is fetched, the second
    adding senones to the union scorer (a new version and scorer, the
    same device): each batch's segments are TpuAligner's on the same
    calls, the first's unchanged by the scorer it no longer uses."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    first = (["young man", "he was not"], [austen_audio(0),
                                           austen_audio(1)])
    second = (["an ill man", "disposed young man he was", TEXT],
              [austen_audio(i) for i in range(2, 5)])
    got, want = [], []
    for al, out in ((port, got), (ref, want)):
        h1 = al.align_batch_begin(first[1], first[0])
        if al is port:
            ver, gs, senset = (port._uni["ver"], port._uni["gs"],
                               port._uni["senset"])
        h2 = al.align_batch_begin(second[1], second[0])
        out += [segs_rep(s) for s in al.align_batch_end(h1)]
        out += [segs_rep(s) for s in al.align_batch_end(h2)]
    u = port._uni
    assert not u["dense"] and u["ver"] == ver + 1 and u["gs"] is not gs
    assert len(u["senset"]) > len(senset)
    assert np.isin(senset, u["senset"]).all()
    assert all(s is not None for s in got)
    assert got == want
