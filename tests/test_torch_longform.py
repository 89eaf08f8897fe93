"""The long form (parallel/seqpipe.py, K13) against the JAX package,
bit-equal on the CPU: ``align_longform`` on local rings of 1, 2 and 8
ranks against the JAX function on as many virtual devices (ragged frame
counts, senone columns gathered by senid) and against the
single-device Viterbi; ``TorchAligner.align_longform_batch`` against
``TpuAligner.align_longform_batch`` and the port's ``align_batch`` on
the default wire and under SST_WIRE=f32; K13's plain version against
the single-utterance backtrace rule on random token chunks; a 5-state
model failing as the JAX package's does; and a two-rank gloo ring, in
processes of its own, equal to the local ring."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_synth import (SAMPRATE, TEXT, austen_audio, model_dir, segs_rep,
                          variant_dir)

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.parallel.seqpipe import align_longform as jax_longform
from soundswallower_tpu.parallel.seqpipe import seq_mesh
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.parallel import SeqRing, align_longform, seq_ring

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


@pytest.fixture(scope="module")
def pair(small_dir):
    return (TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu"),
            TpuAligner(hmm=small_dir, samprate=SAMPRATE))


@pytest.fixture(scope="module")
def ring_inputs(pair):
    """Full-inventory int16 scores [B, T, n_sen] of AUSTEN tiled twice,
    cut to five ragged lengths (as tests/test_seqpipe.py), T a multiple
    of 64, and the transcript's graph tables with senid the senone of
    each state."""
    port, _ = pair
    k = 2
    text = " ".join([TEXT] * k)
    audio = np.tile(austen_audio(0), k)
    T_real = port.fe.n_frames(len(audio))
    scores = port._dense_scores_utt(audio)                  # [T, n_sen]
    lens = [T_real, T_real - 17, T_real - 40, 128, T_real - 5]
    Tpad = -(-T_real // 64) * 64
    sen = np.zeros((len(lens), Tpad, scores.shape[1]), np.int16)
    for i, n in enumerate(lens):
        sen[i, :n] = scores[:n]
    g = port.graph_for_text(text)
    P = len(g.senid)
    pi, pp, pk = at.build_pred_table(g.edge_src, g.edge_dst, g.edge_pen, P)
    return (sen, g.senid.astype(np.int32),
            port.am.tmat.astype(np.int32)[g.tmatid], pi, pp, pk,
            g.astart, g.aend, np.asarray(lens, np.int32),
            np.where(g.is_entry, g.entry_pen, at.WORST_SCORE).astype(
                np.int32), g.final_nodes)


@pytest.mark.parametrize("nseq", [1, 2, 8])
def test_align_longform_matches_jax(ring_inputs, nseq):
    want_p, want_s = jax_longform(seq_mesh(nseq), *ring_inputs)
    ring = seq_ring(nseq, "cpu")
    assert isinstance(ring, SeqRing) and ring.ranks() == list(range(nseq))
    path, score = align_longform(ring, *ring_inputs)
    assert path.dtype == torch.int32 and score.dtype == torch.int32
    assert np.array_equal(path.numpy(), np.asarray(want_p))
    assert np.array_equal(score.numpy(), np.asarray(want_s))


def test_align_longform_matches_single_device(ring_inputs):
    """Each row through K4's carry form over the whole utterance, its
    final select and backtrace (viterbi_single), and through K4
    (viterbi_batch): the same paths and scores as a ring of 8."""
    sen, senid, tp, pi, pp, pk, ast, aen, nfr, entry, fin = ring_inputs
    path, score = align_longform(seq_ring(8, "cpu"), *ring_inputs)
    vit = at.graph_consts_from_numpy(dict(
        tp=tp, pi=pi, pp=pp, pk=pk, ast=ast, aen=aen, entry=entry,
        fin=fin), "cpu")
    cols = torch.from_numpy(senid.reshape(-1).astype(np.int64))
    gathered = torch.from_numpy(sen).index_select(2, cols).to(torch.int32)
    for b, n in enumerate(nfr):
        p1, s1 = at.viterbi_single(gathered[b], int(n), vit)
        assert torch.equal(p1, path[b]) and int(s1) == int(score[b])
    pb, _, sb = at.viterbi_batch(gathered, torch.from_numpy(nfr), vit)
    assert torch.equal(pb.to(torch.int32), path)
    assert torch.equal(sb, score)


@pytest.mark.parametrize("wire", ["i16p", "f32"])
def test_align_longform_batch_matches_reference(small_dir, monkeypatch,
                                                wire):
    """Two rows of AUSTEN tiled twice, of different lengths: the JAX
    long form on its 8 virtual devices and the port's on a local ring of
    8 give the same segments; on the default wire also the port's
    default ring (one rank) and its align_batch."""
    if wire == "f32":
        monkeypatch.setenv("SST_WIRE", "f32")
    port = TorchAligner(hmm=small_dir, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=small_dir, samprate=SAMPRATE)
    assert port.wire == ref.wire == wire
    k = 2
    text = " ".join([TEXT] * k)
    audio = np.tile(austen_audio(1), k)
    audios = [audio, audio[:-5000]]
    want = [segs_rep(s) for s in ref.align_longform_batch(audios,
                                                          [text] * 2)]
    assert len(jax.devices()) == 8 and all(w is not None for w in want)
    got = port.align_longform_batch(audios, [text] * 2,
                                    ring=seq_ring(8, "cpu"))
    assert [segs_rep(s) for s in got] == want
    if wire == "i16p":
        got = port.align_longform_batch(audios, [text] * 2)
        assert [segs_rep(s) for s in got] == want
        assert [segs_rep(s) for s in port.align_batch(audios, [text] * 2)] \
            == want
    with pytest.raises(ValueError, match="one shared"):
        port.align_longform_batch(audios, [text, TEXT])


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_backtrace_chunk_plain_matches_single(dtype):
    """Random token stacks (states and -1, S >= 32,767 for int32), cut
    into chunks walked back to front with K13's plain version from start
    states that include negative ones, equal _backtrace_single over the
    whole stack."""
    rng = np.random.RandomState(7 if dtype == torch.int16 else 8)
    S = 900 if dtype == torch.int16 else 40000
    T, C = 96, 24
    for start in (5, S - 1, -1, -7, -S - 3):
        tok = rng.randint(-1, S, (T, S)).astype(
            np.int16 if dtype == torch.int16 else np.int32)
        tok[rng.random_sample((T, S)) < 0.05] = -1
        for n in (T, T - 13, 1, 0):
            want = at._backtrace_single(tok, start, n)
            cur = torch.tensor([start], dtype=torch.int32)
            parts = []
            for p in range(T // C - 1, -1, -1):
                chunk = torch.from_numpy(tok[None, p * C:(p + 1) * C])
                path, cur = at.backtrace_chunk_plain(
                    chunk, cur, p * C, torch.tensor([n], dtype=torch.int32))
                parts.insert(0, path[0])
            assert np.array_equal(torch.cat(parts).numpy(), want), (start, n)


def test_five_states_fail_as_reference(tmp_path_factory):
    """Rank 0 starts every row from the 3-state carry, as the JAX
    function does, so on a 5-state model both raise TypeError."""
    d = variant_dir(tmp_path_factory, "ptm5st")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    a = [austen_audio(0)]
    with pytest.raises(TypeError):
        ref.align_longform_batch(a, [TEXT])
    with pytest.raises(TypeError, match="carry shapes"):
        port.align_longform_batch(a, [TEXT], ring=seq_ring(2, "cpu"))


GLOO_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from soundswallower_tpu_torch.parallel import align_longform, seq_ring

rank, addr, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=addr, world_size=2, rank=rank)
z = np.load(path + "/in.npz")
args = [z[f"a{i}"] for i in range(11)]
ring = seq_ring(device="cpu", distributed=True)
assert ring.nseq == 2 and ring.ranks() == [rank]
p, s = align_longform(ring, *args)
np.savez(path + f"/out{rank}.npz", path=p.numpy(), score=s.numpy())
dist.destroy_process_group()
"""


def test_gloo_ring_equals_local_ring(ring_inputs, tmp_path):
    """Two ranks, a process each, carries over gloo send/recv: both get
    the local ring's paths and scores back.  The processes run under
    their own 120 s limit, so a hang fails here."""
    np.savez(tmp_path / "in.npz",
             **{f"a{i}": np.asarray(a) for i, a in enumerate(ring_inputs)})
    (tmp_path / "worker.py").write_text(GLOO_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"),
                               str(r), addr, str(tmp_path)], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    want_p, want_s = align_longform(seq_ring(2, "cpu"), *ring_inputs)
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        assert np.array_equal(out["path"], want_p.numpy())
        assert np.array_equal(out["score"], want_s.numpy())
