"""The plain reference against the port on the CPU, and its control.

On the CPU the port runs its kernels' plain versions; the reference is
built from frozen copies of them, with the graphs, tables and scorer
worked out again from the model files.  The control, the reference
with a bfloat16 distance fold, has to come out as different (the
cells' control, kept at a size a test run holds).  The reference's
frame loops, replayed a step at a time (``replay``), are held to the
port's plain versions.
"""

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.kinds import batches, longform
from portbench.reference import replay
from portbench.reference.align import Reference, seg_rep
from portbench.reference.sst import viterbi
from portbench.run import dictionary_words
from soundswallower_tpu_torch.fe import frontend as port_fe
from soundswallower_tpu_torch.ops import align_torch as port_vit

MIX = {"kind": "batches", "text_seed": 0, "paragraphs": 4,
       "sentences_per_paragraph": [1, 2], "words_per_sentence": [3, 9],
       "zipf_s": 1.0, "in_flight": 2, "readings": 1, "dither_lsb": 2}
# a story of three short sentences: a union under 60% of the senones;
# of 24 paragraphs: past it, the full inventory
ROUTES = {"union": dict(MIX, paragraphs=3, sentences_per_paragraph=[1, 1],
                        words_per_sentence=[3, 3]),
          "dense": dict(MIX, paragraphs=24)}


@pytest.mark.parametrize("route", ["union", "dense"])
@pytest.mark.parametrize("fe", ["host", "device"])
def test_rows_equal_the_port(small_model, route, fe, monkeypatch):
    monkeypatch.setenv("SST_FE", fe)
    from soundswallower_tpu_torch.aligner import TorchAligner

    st = batches.make(ROUTES[route], 11, dictionary_words(small_model))
    al = TorchAligner(hmm=small_model, samprate=8000, device="cpu")
    ref = Reference(small_model, 8000, host_fe=fe == "host")
    assert (ref.union_senones(st.texts) is None) == (route == "dense")
    got = al.align_batch(st.reading(0), st.texts)
    want = ref.align_rows(st.reading(0), st.texts, st.texts)
    assert [seg_rep(s) for s in got] == [seg_rep(s) for s in want]
    low = ref.align_rows(st.reading(0), st.texts, st.texts, "bf16")
    assert sum(seg_rep(a) != seg_rep(b) for a, b in zip(low, want)) > 0


def test_long_form_equals_the_port(small_model, monkeypatch):
    monkeypatch.setenv("SST_FE", "host")
    from soundswallower_tpu_torch.aligner import TorchAligner

    ch = longform.make({"kind": "longform", "sentences_per_chapter": [3, 4],
                        "chapter_sizes": 2, "words_per_sentence": [3, 9],
                        "zipf_s": 1.0, "transcripts": 2, "dither_lsb": 2},
                       12, dictionary_words(small_model))
    audio, text = ch.chapter(0)
    al = TorchAligner(hmm=small_model, samprate=8000, device="cpu")
    ref = Reference(small_model, 8000, host_fe=True)
    want = seg_rep(ref.align_long(audio, text))
    assert seg_rep(al.align_longform_batch([audio], [text])[0]) == want
    assert seg_rep(ref.align_long(audio, text, "bf16")) != want


def noise_case(dev):
    rng = np.random.default_rng(5)
    spec = np.exp(rng.normal(8.0, 3.0, (3, 200, 20)))
    spec[1, 50:60] = 0.0                    # silent frames: p = 0
    return torch.from_numpy(spec).to(dev)


def viterbi_case(model, dev):
    """Three stacked graphs of the small model over random scores."""
    ref = Reference(model, 8000, host_fe=True)
    words = dictionary_words(model)
    graphs = [ref.graph(" ".join(words[i:i + n]))
              for i, n in ((0, 3), (3, 4), (9, 4))]
    st = viterbi.stack_graphs(graphs, ref.am.tmat.astype(np.int32),
                              np.arange(ref.am.n_sen))
    rng = np.random.default_rng(6)
    S = st["sencols"].shape[1]
    sen = torch.from_numpy(rng.integers(0, 3000, (3, 90, S))
                           .astype(np.int32)).to(dev)
    n = torch.tensor([90, 71, 64], dtype=torch.int32, device=dev)
    return sen, n, st, graphs[0], ref


def check_noise(dev):
    spec = noise_case(dev)
    carry = tuple(torch.zeros((3, 20), dtype=torch.float64, device=dev)
                  for _ in range(4)) + (torch.ones(3, dtype=torch.bool,
                                                   device=dev),)
    want, _ = port_fe.fe_noise_plain(None, spec, carry, None)
    got = replay.fe_noise(spec)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def check_viterbi(model, dev):
    sen, n, st, g, ref = viterbi_case(model, dev)
    want, _, _ = port_vit.viterbi_rows_plain(
        sen, n, port_vit.row_consts_from_numpy(st, dev))
    got = replay.viterbi_rows(sen, n, viterbi.row_consts_from_numpy(st, dev))
    assert torch.equal(got, want)
    pi, pp, pk = viterbi.build_pred_table(g.edge_src, g.edge_dst,
                                          g.edge_pen, len(g.senid))
    one = dict(tp=ref.am.tmat.astype(np.int32)[g.tmatid], pi=pi, pp=pp,
               pk=pk, ast=g.astart, aen=g.aend,
               entry=np.where(g.is_entry, g.entry_pen, viterbi.WORST_SCORE),
               fin=g.final_nodes)
    s1 = sen[:, :, :len(g.senid) * 3].contiguous()
    want, _, _ = port_vit.viterbi_batch_plain(
        s1, n, port_vit.graph_consts_from_numpy(one, dev))
    assert torch.equal(replay.viterbi_batch(
        s1, n, viterbi.graph_consts_from_numpy(one, dev)), want)


def test_replayed_noise_equals_the_plain_version():
    check_noise("cpu")


def test_replayed_viterbi_equals_the_plain_versions(small_model):
    check_viterbi(small_model, "cpu")


@pytest.mark.gpu
def test_replayed_loops_on_the_card(small_model):
    """The same, with each step replayed from a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_noise("cuda")
    check_viterbi(small_model, "cuda")
