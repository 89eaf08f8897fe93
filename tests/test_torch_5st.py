"""5-state HMMs in the port (plain PyTorch on the CPU) against the JAX
package: the ptm5st synthetic model (tools/make_synth_model.py) and its
bytes, the model arrays and graphs both packages load from it, K4, K6
and K4's carry form in their E=5 forms on random graphs (guards and
ties forced) against align_viterbi_batch, align_viterbi and
make_vit_step, every batch route's segments and align, and a stream,
which fails in both packages (its carry has 3 states).  Every comparison
is exact."""

import hashlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, make_synth_model,
                          random_graph, segs_rep, stack_random, variant_dir)
from make_torch_mixed_golden import scored_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops.align_jax import make_vit_step
from soundswallower_tpu.ops.align_jax import vit_carry0 as jax_carry0
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young"]
PTM5ST_SHA256 = {
    "small":
        "6158dc7cf2bb5392e7572b7bbceedc335bd88582dfefd15615442a134ee1cd93",
    "en-us":
        "29ac867546998d70a94cb8eaa67cb3afea0b4489cabdc16ac9a415d6f814d916",
}


@pytest.fixture(scope="module")
def m5(tmp_path_factory):
    return variant_dir(tmp_path_factory, "ptm5st")


@pytest.fixture(scope="module")
def pair(m5):
    return (TorchAligner(hmm=m5, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=m5, samprate=SAMPRATE))


@pytest.mark.parametrize("width", sorted(PTM5ST_SHA256))
def test_ptm5st_bytes_pinned(tmp_path, width):
    d = make_synth_model(str(tmp_path), 0, width, "ptm5st", 8)
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        h.update(name.encode())
        with open(os.path.join(d, name), "rb") as fh:
            h.update(fh.read())
    assert h.hexdigest() == PTM5ST_SHA256[width]


def test_model_arrays_and_graphs_equal(pair):
    """Both packages load ptm5st as a 5-state model with the same arrays
    and build the same 5-state phone graphs; each CI phone's states
    read its senones as [s0, s0, s1, s1, s2]."""
    port, ref = pair
    a, b = port.am, ref.am
    assert a.mdef.n_emit_state == b.mdef.n_emit_state == 5
    assert a.tmat.shape[1:] == (5, 6)
    for name in ("tmat", "means", "var_t", "det", "mixw"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    mixw = a.mixw
    for c in range(a.mdef.n_ciphone):
        sen = 5 * c + np.arange(5)
        assert np.array_equal(mixw[..., sen[0]], mixw[..., sen[1]])
        assert np.array_equal(mixw[..., sen[2]], mixw[..., sen[3]])
    fields = ("ssid", "tmatid", "senid", "edge_src", "edge_dst", "edge_pen",
              "entry_pen", "is_entry", "astart", "aend", "word_of",
              "variant_of", "pos_of", "cipid", "final_nodes")
    for text in TEXTS:
        g, w = port.graph_for_text(text), ref.graph_for_text(text)
        assert g.senid.shape[1] == 5
        for f in fields:
            x, y = getattr(g, f), getattr(w, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (text, f)


# -- the Viterbi forms on random graphs --------------------------------------

CASES = ["random", "ties", "guards", "renorm"]


def _inputs(case: str, P: int, B: int, T: int, seed: int):
    """A random 5-state graph and scores [B, T, 5P] for one case: "ties"
    draws scores and transition costs from {0, 1} (every select ties
    often), "guards" gives a fifth of the states a score that drives
    them below WORST (the gates of states 3, 4 and the exit close),
    "renorm" crosses the renormalization threshold."""
    rng = np.random.RandomState(seed)
    g = random_graph(P, 5, rng, T=T)
    S = 5 * P
    sen = rng.randint(0, 4000, (B, T, S))
    if case == "ties":
        g["tp"] = rng.randint(0, 2, g["tp"].shape).astype(np.int32)
        sen = rng.randint(0, 2, (B, T, S))
    elif case == "guards":
        sen[rng.random_sample(sen.shape) < 0.2] = 0x30000000
    elif case == "renorm":
        sen = sen + 6_000_000
    return g, sen.astype(np.int32), rng


def _jax_consts(g: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in g.items()}


def _equal(got, want):
    """Port tensors (or None) against JAX arrays (or None), dtypes
    included."""
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_scores", [False, True])
def test_viterbi_batch_5st_equals_reference(case, with_scores):
    """K4's plain version == align_viterbi_batch + _vit_full's select and
    backtrace: full rows, a short row and a row that fails."""
    T = 40
    g, sen, _ = _inputs(case, 30, 3, T, 5 + CASES.index(case))
    Ts = np.array([T, T - 7, 2], np.int32)
    fake = types.SimpleNamespace(_graph_consts=lambda _: _jax_consts(g),
                                 want_scores=with_scores)
    want = TpuAligner._vit_full(fake, None, jnp.asarray(sen),
                                jnp.asarray(Ts))
    got = at.viterbi_batch(torch.from_numpy(sen), torch.from_numpy(Ts),
                           at.graph_consts_from_numpy(g), with_scores)
    _equal(got, want)
    assert got[0].dtype == torch.int16


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["kslot", "band"])
def test_viterbi_rows_5st_equals_reference(case, form):
    """K6's plain version == align_viterbi_batch's per-row form (K slots
    on cyclic graphs, the band on forward ones) + _vit_full_mg's masked
    select, with token and path scores."""
    T = 40
    g0, sen, rng = _inputs(case, 24, 3, T, 17 + CASES.index(case))
    if form == "kslot":
        st = stack_random([g0, random_graph(24, 5, rng, T=T), g0])
    else:
        graphs = [random_graph(24, 5, rng, T=T, cyclic=False)
                  for _ in range(3)]
        for gr in graphs:
            gr["tp"] = g0["tp"]
        st = stack_random(graphs, band_w=8)
    Ts = np.array([T, T - 3, 2], np.int32)
    fake = types.SimpleNamespace(want_scores=True)
    want = TpuAligner._vit_full_mg(fake, st, jnp.asarray(sen),
                                   jnp.asarray(Ts))
    c = at.row_consts_from_numpy(st)
    assert (c.band_pen is not None) == (form == "band")
    _equal(at.viterbi_rows(torch.from_numpy(sen), torch.from_numpy(Ts), c,
                           True), want)


@pytest.mark.parametrize("case", CASES)
def test_viterbi_carry_form_5st_equals_reference(case):
    """K4's carry form in 12-frame chunks == make_vit_step scanned from
    vit_carry0(n_emit=5) (carry and tokens after each chunk), and
    viterbi_single == _viterbi_graph's select and backtrace."""
    T, n = 36, 31
    g, sen3, _ = _inputs(case, 26, 1, T, 29 + CASES.index(case))
    sen = sen3[0]
    P, S = 26, 5 * 26
    c = at.graph_consts_from_numpy(g)
    senid = jnp.arange(S, dtype=jnp.int32).reshape(P, 5)
    step = make_vit_step(senid, jnp.asarray(g["tp"]), jnp.asarray(g["pi"]),
                         jnp.asarray(g["pp"]), jnp.asarray(g["pk"]),
                         jnp.asarray(g["ast"]), jnp.asarray(g["aen"]),
                         jnp.int32(n), False, jnp.int16)
    jcarry = jax_carry0(P, jnp.asarray(g["entry"]), n_emit=5)
    pcarry = at.vit_carry0(c)
    for t0 in range(0, T, 12):
        ts = t0 + jnp.arange(12, dtype=jnp.int32)
        jcarry, (jtok, _) = jax.lax.scan(
            step, jcarry, (ts, jnp.asarray(sen[t0:t0 + 12])[:, senid]))
        pcarry, ptok = at.viterbi_chunk(torch.from_numpy(sen[t0:t0 + 12]),
                                        pcarry, t0, n, c)
        _equal((ptok,) + tuple(pcarry), (jtok,) + tuple(jcarry))
    fake = types.SimpleNamespace(_graph_consts=lambda _: _jax_consts(g))
    gg = types.SimpleNamespace(senid=np.zeros((P, 5), np.int32))
    for nn in (n, 2):
        want = TpuAligner._viterbi_graph(fake, gg, jnp.asarray(sen),
                                         jnp.int32(nn))
        _equal(at.viterbi_single(torch.from_numpy(sen), nn, c), want)


# -- the aligner's routes ----------------------------------------------------

def _reps(out):
    return [segs_rep(s) for s in out]


def test_same_transcript_batch_and_pipelined(pair):
    port, ref = pair
    audios = [austen_audio(i) for i in range(4)]
    want = _reps(ref.align_batch(audios, [TEXT] * 4))
    assert all(w is not None for w in want)
    assert _reps(port.align_batch(audios, [TEXT] * 4)) == want
    h = port.align_batch_begin(audios[:2], [TEXT] * 2)
    h2 = port.align_batch_begin(audios[2:], [TEXT] * 2)
    assert _reps(port.align_batch_end(h) + port.align_batch_end(h2)) == want
    assert segs_rep(port.align(audios[1], TEXT)) == \
        segs_rep(ref.align(audios[1], TEXT))


def test_mixed_and_scored_batches(m5):
    """The union route, then the forced dense route, then
    align_batch_scored (scores and states), each on fresh aligners (the
    union's state is part of the result)."""
    audios = [austen_audio(i) for i in range(len(TEXTS))]
    port = TorchAligner(hmm=m5, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=m5, samprate=SAMPRATE)
    assert _reps(port.align_batch(audios, TEXTS)) == \
        _reps(ref.align_batch(audios, TEXTS))
    for al in (port, ref):
        al._uni["dense"] = True
    assert _reps(port.align_batch(audios, TEXTS)) == \
        _reps(ref.align_batch(audios, TEXTS))
    port.want_states = ref.want_states = True

    def rep(out):
        return [None if segs is None else
                (scored_rep(segs), [s.states for s in segs]) for segs in out]

    got = rep(port.align_batch_scored(audios, TEXTS))
    assert got == rep(ref.align_batch_scored(audios, TEXTS))
    assert got[0] is not None and any(w[3] for w in got[0][0])
    assert got[0][1][0]                                  # states present


def test_align_on_device_fe(m5, monkeypatch):
    monkeypatch.setenv("SST_FE", "device")
    port = TorchAligner(hmm=m5, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=m5, samprate=SAMPRATE)
    assert port.native_fe is None and ref.native_fe is None
    a = austen_audio(3)
    assert segs_rep(port.align(a, TEXT)) == segs_rep(ref.align(a, TEXT))


def test_stream_fails_as_reference(pair):
    """The JAX stream starts from vit_carry0's 3-state carry, so on a
    5-state model its first Viterbi chunk raises TypeError (the scan's
    carry changes shape); the port's stream raises TypeError at the same
    push, and at end()."""
    port, ref = pair
    audio = austen_audio(0)
    ps, rs = port.stream(TEXT), ref.stream(TEXT)
    fails = []
    for i in range(0, len(audio), 1600):
        piece = audio[i:i + 1600]
        raised = []
        for s in (ps, rs):
            try:
                s.push(piece)
                raised.append(False)
            except TypeError:
                raised.append(True)
        assert raised[0] == raised[1], i
        if raised[0]:
            fails.append(i)
            break
    assert fails, "no Viterbi chunk ran"
    for s in (port.stream(TEXT), ref.stream(TEXT)):
        s.push(audio[:3200])
        with pytest.raises(TypeError):
            s.end()
