"""Large graphs and the same-transcript scores in the port (plain
PyTorch on the CPU) against the JAX package: K4, K6 and K4's carry form
past the shared-memory size of the card's kernels (P > 7,040) and at S
>= 32,767, where token stacks and paths become int32, on random graphs;
a same-transcript batch whose int32 paths go through the native
extraction, cast to int16 as the reference casts them; a decode graph
of S >= 32,767 end to end; and want_scores on the same-transcript
route.  Every comparison is exact."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, model_dir,
                          random_graph, segs_rep, stack_random)
from make_torch_decode_golden import (GRAPH_FIELDS, TRUNCATED, decode_rep,
                                      distinct_senones, large_grammar)
from make_torch_mixed_golden import scored_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at

torch.set_num_threads(1)

# (E, P): over the shared-memory limit with int16 tokens; S >= 32767
# with 3 and with 5 states
SIZES = [(3, 7100), (3, 11000), (5, 6600)]


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def pair(small_dir):
    return (TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=small_dir, samprate=SAMPRATE))


def _equal(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("E,P", SIZES)
def test_plain_viterbi_large_equals_reference(E, P):
    """K4 (with and without scores), K6 (K slots, scores) and the
    single-utterance carry form on a random graph of P phones, T = 6:
    _vit_full, _vit_full_mg and _viterbi_graph, int32 paths from S =
    32,767."""
    T, S = 6, E * P
    rng = np.random.RandomState(P + E)
    g = random_graph(P, E, rng, T=T)
    g["ast"][:] = np.minimum(g["ast"], 1)
    sen = rng.randint(0, 4, (2, T, S)).astype(np.int32)
    Ts = np.array([T, 4], np.int32)
    c = at.graph_consts_from_numpy(g)
    jc = {k: jnp.asarray(v) for k, v in g.items()}
    for ws in (False, True):
        fake = types.SimpleNamespace(_graph_consts=lambda _: jc,
                                     want_scores=ws)
        want = TpuAligner._vit_full(fake, None, jnp.asarray(sen),
                                    jnp.asarray(Ts))
        got = at.viterbi_batch(torch.from_numpy(sen), torch.from_numpy(Ts),
                               c, ws)
        _equal(got, want)
        assert got[0].dtype == at.tok_dtype(S) \
            == (torch.int32 if S >= 32767 else torch.int16)
    st = stack_random([g, random_graph(P, E, rng, T=T)])
    want = TpuAligner._vit_full_mg(types.SimpleNamespace(want_scores=True),
                                   st, jnp.asarray(sen), jnp.asarray(Ts))
    _equal(at.viterbi_rows(torch.from_numpy(sen), torch.from_numpy(Ts),
                           at.row_consts_from_numpy(st), True), want)
    fake = types.SimpleNamespace(_graph_consts=lambda _: jc)
    gg = types.SimpleNamespace(senid=np.zeros((P, E), np.int32))
    want = TpuAligner._viterbi_graph(fake, gg, jnp.asarray(sen[0]),
                                     jnp.int32(T))
    _equal(at.viterbi_single(torch.from_numpy(sen[0]), T, c), want)


def _walk(g) -> np.ndarray:
    """A state path through graph g: from its first entry node along each
    node's first forward edge to a final node, every state one frame."""
    succ: dict[int, int] = {}
    for s, d in zip(g.edge_src.tolist(), g.edge_dst.tolist()):
        if d > s:
            succ.setdefault(s, d)
    E = g.senid.shape[1]
    node = int(np.nonzero(g.is_entry)[0][0])
    fin = set(g.final_nodes.tolist())
    path = []
    while True:
        path += [node * E + e for e in range(E)]
        if node in fin:
            return np.array(path, np.int32)
        node = succ[node]


def test_int32_paths_through_native_extraction(pair):
    """Same-transcript paths of a graph with S >= 32,767 are int32; the
    native extraction casts them to int16 in both packages (the
    reference's defect, ROADMAP.md section C: state 32,768 wraps to
    -32,768, and the row reads as failed), so its segments equal the
    reference's: a row whose path passes state 32,767 gives None, where
    the Python extraction of the int32 path gives its words, and a row
    cut before that state gives its segments."""
    port, ref = pair
    per = len(port.graph_for_text(TEXT).senid)
    text = " ".join([TEXT] * (10923 // per + 2))
    g = port.graph_for_text(text)
    S = 3 * len(g.senid)
    assert S >= 32767 and at.tok_dtype(S) == torch.int32
    path = _walk(g)
    T = len(path)
    cut = int(np.argmax(path >= 32768))
    assert 0 < cut < T
    paths = np.stack([path, path])
    Ts = np.array([T, cut])
    gr = ref.graph_for_text(text)
    got = port._extract_batch_native([g, g], paths, Ts, 2)
    want = ref._extract_batch_native(gr, paths, Ts, 2)
    assert [segs_rep(s) for s in got] == [segs_rep(s) for s in want]
    assert got[0] is None and got[1]
    py = port._extract_safe(g, path, T)
    assert segs_rep(py) == segs_rep(ref._extract_safe(gr, path, T, 0))
    assert py and py[-1].start + py[-1].duration == T


def test_large_decode_graph_equals_reference(pair):
    """A grammar whose decode graph has S >= 32,767 states: the graph,
    then decode_batch on 130 frames (only the sentence's branch fits)
    and on a row that fails, whose int32 path holds -2^30 where int16
    held 0.  (decode_batch_scored on such a graph:
    tests/test_torch_decode_golden.py.)"""
    port, ref = pair
    gram = large_grammar(n_alt=36)
    g = port.set_grammar(jsgf_string=gram)
    with distinct_senones():
        w = ref.set_grammar(jsgf_string=gram)
        for f in GRAPH_FIELDS:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert 3 * len(g.senid) >= 32767
        rows = [austen_audio(0)[:130 * 80], austen_audio(1)[:TRUNCATED]]
        want = [decode_rep(r) for r in ref.decode_batch(rows)]
        assert want[0] is not None and want[1] is None
        assert [decode_rep(r) for r in port.decode_batch(rows)] == want
    c = port._graph_consts(g)
    sen = torch.zeros((1, 8, c.gs.S), dtype=torch.int32)
    path, _, _ = at.viterbi_batch(sen, torch.tensor([8], dtype=torch.int32),
                                  c.vit)
    assert path.dtype == torch.int32
    assert int(path[0, 0]) == at.MISSING and int(path[0, 7]) < 0


def test_same_transcript_want_scores_equals_reference(small_dir):
    """want_scores on a same-transcript batch (K4's token and path
    scores): the reference's word and phone scores, pipelined too."""
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    port.want_scores = ref.want_scores = True
    audios = [austen_audio(i) for i in range(3)] + [austen_audio(3)[:1200]]
    want = [scored_rep(s) for s in ref.align_batch(audios, [TEXT] * 4)]
    assert want[-1] is None and any(w[3] for w in want[0])
    assert [scored_rep(s) for s in port.align_batch(audios, [TEXT] * 4)] \
        == want
    h = port.align_batch_begin(audios, [TEXT] * 4)
    assert [scored_rep(s) for s in port.align_batch_end(h)] == want
