"""The device front end in TorchAligner (plain PyTorch on the CPU)
against TpuAligner, both under SST_FE=device, on the small synthetic
model: the batch routes, the single-utterance path, the spectrogram, the
Viterbi carry form against a JAX make_vit_step scan, and the repair
(no host FE library: device FE; no segment library: Python
extraction).  Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops.align_jax import (WORST_SCORE, build_pred_table,
                                              make_vit_step, vit_carry0)
from soundswallower_tpu_torch import aligner as port_aligner
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at

torch.set_num_threads(1)

TEXTS = [TEXT, "young man", "he was not", "an ill man", "was not young"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = model_dir(tmp_path_factory, "small")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SST_FE", "device")
        port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
        ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    assert port.native_fe is None and ref.native_fe is None
    return port, ref, d


def _reps(out):
    return [segs_rep(s) for s in out]


def _audios(n):
    return [austen_audio(i) for i in range(n)]


def test_align_batch_same_transcript(small):
    port, ref, _ = small
    audios = _audios(3)
    want = _reps(ref.align_batch(audios, [TEXT] * 3))
    assert all(w is not None for w in want)
    assert _reps(port.align_batch(audios, [TEXT] * 3)) == want


def test_align_batch_mixed_transcripts(small):
    port, ref, _ = small
    audios = _audios(len(TEXTS))
    want = _reps(ref.align_batch(audios, TEXTS))
    assert _reps(port.align_batch(audios, TEXTS)) == want


def test_align_single_device_path(small):
    port, ref, _ = small
    a = austen_audio(5)
    assert segs_rep(port.align(a, TEXT)) == segs_rep(ref.align(a, TEXT))


@pytest.mark.parametrize("smooth", [False, True])
def test_spectrogram(small, smooth):
    port, ref, _ = small
    a = austen_audio(2)
    got, want = port.spectrogram(a, smooth), ref.spectrogram(a, smooth)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def _jax_scan(g, tmat, sen, carry, t0, n):
    """make_vit_step scanned over one chunk, as AlignStream._vit_chunk."""
    pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen,
                                  len(g.senid))
    P, E = g.senid.shape
    senid = jnp.arange(P * E, dtype=jnp.int32).reshape(P, E)
    st = make_vit_step(senid, jnp.asarray(tmat[g.tmatid]), jnp.asarray(pi),
                       jnp.asarray(pp), jnp.asarray(pk), jnp.asarray(g.astart),
                       jnp.asarray(g.aend), jnp.int32(n), False, jnp.int16)
    ts = t0 + jnp.arange(sen.shape[0], dtype=jnp.int32)
    sen_g = jnp.asarray(sen)[:, senid]
    return jax.lax.scan(st, carry, (ts, sen_g))


def test_viterbi_chunk_matches_make_vit_step(small):
    """Chunks of 40 frames carried across, the last one partial (n=93 of
    120): carry and tokens after every chunk, and the single-utterance
    path and backtrace, equal to the JAX scan's."""
    port, ref, _ = small
    g = port.graph_for_text(TEXT)
    c = port._graph_consts(g).vit
    S = 3 * c.P
    rng = np.random.RandomState(7)
    sen = rng.randint(0, 4000, (120, S)).astype(np.int32)
    n = 93
    tmat = ref.am.tmat.astype(np.int32)
    entry = np.where(g.is_entry, g.entry_pen, WORST_SCORE).astype(np.int32)
    jcarry = vit_carry0(c.P, jnp.asarray(entry))
    pcarry = at.vit_carry0(c)
    toks = []
    for t0 in range(0, 120, 40):
        jcarry, (jtok, _) = _jax_scan(g, tmat, sen[t0:t0 + 40], jcarry, t0, n)
        pcarry, ptok = at.viterbi_chunk(torch.from_numpy(sen[t0:t0 + 40]),
                                        pcarry, t0, n, c)
        assert np.array_equal(np.asarray(jtok), ptok.numpy())
        for a, b in zip(jcarry, pcarry):
            assert np.asarray(a).dtype == b.numpy().dtype
            assert np.array_equal(np.asarray(a), b.numpy())
        toks.append(ptok)
    # the single-utterance path: _viterbi_graph's select and backtrace
    gc = ref._graph_consts(g)
    jpath, jfs = ref._viterbi_graph(g, jnp.asarray(sen), jnp.int32(n))
    path, fs = at.viterbi_single(torch.from_numpy(sen), n, c)
    assert np.array_equal(np.asarray(jpath), path.numpy())
    assert int(jfs) == int(fs)
    assert gc is not None


def test_viterbi_single_unreached_final_state(small):
    """A 2-frame utterance reaches no final state: the path holds the
    JAX program's values (its lookup of state -1 wraps)."""
    port, ref, _ = small
    g = port.graph_for_text(TEXT)
    c = port._graph_consts(g).vit
    sen = np.random.RandomState(3).randint(0, 4000, (16, 3 * c.P)) \
        .astype(np.int32)
    jpath, jfs = ref._viterbi_graph(g, jnp.asarray(sen), jnp.int32(2))
    path, fs = at.viterbi_single(torch.from_numpy(sen), 2, c)
    assert np.array_equal(np.asarray(jpath), path.numpy())
    assert int(jfs) == int(fs)


def test_repair_no_native_libraries(small, monkeypatch):
    """Without the host FE library the port takes the device FE, and
    without libsst_seg.so it extracts segments in Python, where
    TpuAligner does; the results are the reference's."""
    port, ref, d = small
    monkeypatch.delenv("SST_FE", raising=False)
    monkeypatch.setattr(port_aligner.NativeFrontend, "load",
                        classmethod(lambda cls, fe: None))
    monkeypatch.setattr(port_aligner.native_build, "load_native",
                        lambda soname: None)
    al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    assert al.native_fe is None
    audios = _audios(2)
    want = _reps(ref.align_batch(audios, [TEXT] * 2))
    assert _reps(al.align_batch(audios, [TEXT] * 2)) == want
    assert al._seg_lib() is None
