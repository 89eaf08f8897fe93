"""Grammar decode in TorchAligner (plain PyTorch on the CPU) against
TpuAligner on the small synthetic model: the decode graph from
set_grammar (a JSGF string, a JSGF file, a text FSG), decode_batch with
a row that fails, decode_batch_scored, decode on both front ends,
decode_search, lattice and nbest, the decode-path extraction's re-entry
rule, and the stacked form decode graphs take (K-slot, no band).  Every
comparison is exact."""

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, austen_audio, model_dir
from make_torch_decode_golden import (GRAMMAR, GRAPH_FIELDS, TRUNCATED,
                                      decode_rep, search_rep)

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.fsg import FsgModel as JaxFsgModel
from soundswallower_tpu.ops import align_graph
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.fsg import FsgModel
from soundswallower_tpu_torch.jsgf import Jsgf
from soundswallower_tpu_torch.ops import align_torch as at

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def pair(small_dir):
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    port.set_grammar(jsgf_string=GRAMMAR)
    ref.set_grammar(jsgf_string=GRAMMAR)
    return port, ref


def _rows():
    """Three austen rows and one too short to reach a final node."""
    return [austen_audio(i) for i in range(3)] \
        + [austen_audio(3)[:TRUNCATED]]


def _assert_same_graph(g, w):
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("source", ["jsgf_string", "jsgf_file", "fsg_file"])
def test_grammar_graph_equals_reference(small_dir, tmp_path, source):
    """set_grammar builds the JAX package's decode graph and grammar,
    filler self-loops and alternate pronunciations included, from each
    kind of grammar input."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    if source == "jsgf_string":
        g = port.set_grammar(jsgf_string=GRAMMAR)
        w = ref.set_grammar(jsgf_string=GRAMMAR)
    elif source == "jsgf_file":
        path = tmp_path / "slice.gram"
        path.write_text(GRAMMAR)
        g = port.set_grammar(jsgf_file=str(path))
        w = ref.set_grammar(jsgf_file=str(path))
    else:
        j = Jsgf.parse_string(GRAMMAR)
        text = j.build_fsg(j.default_rule(), port.lmath,
                           port.config.get_float("lw")).write_fsg_text()
        path = tmp_path / "slice.fsg"
        path.write_text(text)
        lw = port.config.get_float("lw")
        g = port.set_grammar(FsgModel.read_fsg_file(str(path), port.lmath,
                                                    lw))
        w = ref.set_grammar(JaxFsgModel.read_fsg_file(str(path), ref.lmath,
                                                      lw))
    _assert_same_graph(g, w)
    pf, rf = port._decode_fsg, ref._decode_fsg
    assert list(pf.vocab) == list(rf.vocab)
    assert pf.write_fsg_text() == rf.write_fsg_text()
    # what the grammar exercises: the filler self-loops, was(2) and
    # an(2), and a cycle (the Kleene loop re-enters its nodes)
    assert "<sil>" in pf.vocab and {"was(2)", "an(2)"} <= set(pf.vocab)
    assert (g.aend == 1 << 30).all()
    back = g.edge_dst <= g.edge_src
    assert back.any()


def test_decode_batch_equals_reference(pair):
    port, ref = pair
    rows = _rows()
    want = [decode_rep(r) for r in ref.decode_batch(rows)]
    assert want[-1] is None and all(w is not None for w in want[:-1])
    assert [decode_rep(r) for r in port.decode_batch(rows)] == want


def test_decode_batch_scored_equals_reference(pair):
    port, ref = pair
    rows = _rows()
    want = [decode_rep(r) for r in ref.decode_batch_scored(rows)]
    assert any(s[4] != 0 for s in want[0][1])      # scores, not zeros
    assert [decode_rep(r) for r in port.decode_batch_scored(rows)] == want


@pytest.mark.parametrize("fe", ["host", "device"])
def test_decode_equals_reference(small_dir, monkeypatch, fe):
    """decode of one utterance: through decode_batch on the host front
    end, on the single-utterance device path (K8-K10, K1, K2/K3, K4's
    carry form) on the device front end; a row that reaches no final
    node raises RuntimeError in both."""
    if fe == "device":
        monkeypatch.setenv("SST_FE", "device")
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    assert (port.native_fe is None) == (ref.native_fe is None) \
        == (fe == "device")
    port.set_grammar(jsgf_string=GRAMMAR)
    ref.set_grammar(jsgf_string=GRAMMAR)
    a = austen_audio(1)
    assert decode_rep(port.decode(a)) == decode_rep(ref.decode(a))
    for al in (port, ref):
        with pytest.raises(RuntimeError, match="final state"):
            al.decode(a[:TRUNCATED])


def test_decode_search_lattice_nbest_equal_reference(pair):
    """The full-inventory scores of one utterance fed to the host history
    search: its hyp and segments, the lattice's nodes and links, and the
    first 5 of nbest."""
    port, ref = pair
    out = []
    for al in (port, ref):
        a = austen_audio(2)
        search = al.decode_search(a)
        out.append(search_rep(search, al.lattice(a),
                              [x for _, x in zip(range(5), al.nbest(a))]))
    assert out[0] == out[1]
    assert out[0]["lattice_nodes"] > 0 and len(out[0]["nbest"]) == 5
    # the scores the search reads are the reference's dense scores
    a = austen_audio(2)
    assert np.array_equal(port._dense_scores_utt(a), ref._dense_scores_utt(a))


def test_extract_decode_reentry_equals_reference(pair):
    """A path that re-enters the same node (a state decrease within it)
    starts a new phone, and a phone position that does not advance a new
    word, in both packages; with and without path scores."""
    port, ref = pair
    g = port._grammar()
    E = g.senid.shape[1]
    rng = np.random.RandomState(11)
    nodes = [int(g.final_nodes[0])]
    for _ in range(12):
        nodes.insert(0, int(rng.randint(len(g.senid))))
    nodes[3] = nodes[2]                          # the same node, re-entered
    path = []
    for nd in nodes:
        for s in range(E):
            path += [nd * E + s] * int(rng.randint(1, 4))
    path = np.array(path, np.int16)
    T = len(path)
    pscore = np.cumsum(-rng.randint(0, 500, T)).astype(np.int32)
    for ps in (None, pscore):
        got = port._extract_decode(g, path, T, ps)
        want = ref._extract_decode(ref._decode_graph, path, T, ps)
        assert decode_rep(("", got)) == decode_rep(("", want))
    bad = path.copy()
    bad[-1] = -1
    for al, gr in ((port, g), (ref, ref._decode_graph)):
        with pytest.raises(RuntimeError, match="final state"):
            al._extract_decode(gr, bad, T)


def test_decode_graphs_take_the_kslot_form(pair):
    """stack_graphs gives cyclic decode graphs the K-slot form (no band)
    and forward align graphs the band, as the JAX package's does; the
    stacked arrays are equal."""
    port, ref = pair
    tmat = ref.am.tmat.astype(np.int32)
    remap = np.arange(ref.am.n_sen, dtype=np.int32)
    dg = ref._decode_graph
    ag = ref.graph_for_text("he was not")
    for graphs, band in (([dg, dg], False), ([dg, ag], False),
                         ([ag, ag], True)):
        want = align_graph.stack_graphs(graphs, tmat, remap)
        got = at.stack_graphs(graphs, tmat, remap)
        assert ("band_pen" in want) == ("band_pen" in got) == band
        assert (got["P"], got["K"], got["W"]) == \
            (want["P"], want["K"], want["W"])
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and (got[k] == v).all(), k
