"""The designs of K13 (csrc/backtrace_chunk.cu) and K3 (csrc/senscore.cu)
rendered on the host, on the CPU: the exactness evidence of both where
no card is present.

K13: the segmented backtrace's three phases (a map per segment over
every state index, their composition from the row's start, each
segment's walk from its entering state) for several segment lengths,
against ``backtrace_chunk_plain`` on random chunks (tokens of -1 and
past either end, negative starts, frame counts inside a segment, at 0
and past the chunk, t0 != 0), against the JAX package's ``chunk_back``
rule (``_backward`` on a ring of virtual devices), and on a long-form
token chunk of the synthetic model.

K3: a block's work (its columns' distinct codebooks in order of first
occurrence, their terms staged in passes of frames, each term packed in
16 bits as (s << 7) | cw, a pass with an s outside [0, 511] read
unpacked) against
``senone_eval_plain`` on graph, union, full-inventory and all-distinct
column maps, with wrap_u8 and the table's edges.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir

from soundswallower_tpu.parallel.seqpipe import _backward, seq_mesh
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)


# -- K13 ----------------------------------------------------------------------

def tok_index(x, S: int):
    """The index a raw state reads its token at: wrapped once, clamped."""
    x = np.asarray(x, np.int64)
    return np.clip(np.where(x < 0, x + S, x), 0, S - 1)


def segmented_backtrace(tok: np.ndarray, start, t0: int, n, L: int):
    """K13's three phases on the host: tok [R, C, S], start and n [R],
    segments of L frames -> (path int32 [R, C], leaving state int32
    [R])."""
    R, C, S = tok.shape
    K = -(-C // L)
    path = np.empty((R, C), np.int32)
    out = np.empty(R, np.int32)
    for r in range(R):
        nr = int(n[r])
        tk = tok[r].astype(np.int64)
        # phase 1: the state leaving segment k for each entering index
        maps = {}
        for k in range(K):
            lo, hi = k * L, min(k * L + L, C)
            top = min(hi - 1, nr - 2 - t0)
            if top < lo:
                continue       # no lookup: the identity on raw states
            x = np.arange(S)
            for c in range(top, lo - 1, -1):
                x = tk[c, tok_index(x, S)]
            maps[k] = x
        # phase 2: the raw state entering each segment
        enter = [0] * K
        x = int(start[r])
        for k in range(K - 1, 0, -1):
            enter[k] = x
            if k in maps:
                x = int(maps[k][tok_index(x, S)])
        enter[0] = x
        # phase 3: each segment's walk by the per-step rule
        for k in range(K):
            cid = enter[k]
            for c in range(min(k * L + L, C) - 1, k * L - 1, -1):
                t = t0 + c
                path[r, c] = cid if t < nr else -1
                if t < nr - 1:
                    cid = int(tk[c, tok_index(cid, S)])
            if k == 0:
                out[r] = cid
    return path, out


def random_chunk(rng, R: int, C: int, S: int, dtype):
    """Tokens of states and -1, and a few past either end."""
    tok = rng.randint(-1, S, (R, C, S))
    wild = rng.random_sample((R, C, S)) < 0.03
    tok[wild] = rng.randint(-S - 9, S + 9, int(wild.sum()))
    return tok.astype(dtype)


@pytest.mark.parametrize("L", [1, 3, 10, 11, 82, 83])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_segments_equal_plain_on_random_chunks(dtype, L):
    """Segments of 1 frame, 3, about sqrt(C) (10 and 11, C not a multiple
    of either), C - 1 and C (one segment: the one-chain walk) against
    K13's plain version."""
    rng = np.random.RandomState(L + (0 if dtype == np.int16 else 100))
    R, C, S, t0 = 7, 83, 300, 166
    tok = random_chunk(rng, R, C, S, dtype)
    start = np.array([0, 5, S - 1, -1, -7, -S - 3, 2 * S], np.int32)
    # the chunk's last frame, inside a segment, the first frame, before
    # the chunk, 0, past the chunk, one past the chunk's end
    n = np.array([t0 + C, t0 + 37, t0 + 1, t0, 0, 10 ** 6, t0 + C + 1],
                 np.int32)
    path, out = segmented_backtrace(tok, start, t0, n, L)
    want_p, want_o = at.backtrace_chunk_plain(
        torch.from_numpy(tok), torch.from_numpy(start), t0,
        torch.from_numpy(n))
    assert np.array_equal(path, want_p.numpy())
    assert np.array_equal(out, want_o.numpy())


def jax_backward(tok: np.ndarray, final_state, nfr, nseq: int) -> np.ndarray:
    """The JAX package's reverse wavefront (seqpipe._backward, whose
    chunk_back walks each device's chunk) on nseq virtual devices."""
    mesh = seq_mesh(nseq)
    bwd = jax.jit(jax.shard_map(
        partial(_backward, nseq=nseq), mesh=mesh,
        in_specs=(P(None, "seq", None), P(), P(), P()),
        out_specs=P(None, "seq")))
    return np.asarray(bwd(jnp.asarray(tok), jnp.asarray(final_state),
                          jnp.asarray(nfr), {}))


@pytest.mark.parametrize("nseq,L", [(1, 5), (2, 4), (4, 3), (4, 24)])
def test_segments_equal_jax_chunk_back(nseq, L):
    """The segmented walk of each rank's chunk, back to front, each from
    the state the next rank leaves, equals the JAX package's
    chunk_back over the same token stack on nseq devices."""
    rng = np.random.RandomState(nseq * 10 + L)
    B, S, C = 5, 200, 24
    T = C * nseq
    tok = random_chunk(rng, B, T, S, np.int16)
    final = np.array([0, S - 1, -1, -S - 3, 77], np.int32)
    nfr = np.array([T, T - 13, 1, 0, C + 2], np.int32)
    want = jax_backward(tok, final, nfr, nseq)
    state = final
    parts = []
    for p in range(nseq - 1, -1, -1):
        path, state = segmented_backtrace(tok[:, p * C:(p + 1) * C], state,
                                          p * C, nfr, L)
        parts.insert(0, path)
    assert np.array_equal(np.concatenate(parts, axis=1), want)


@pytest.fixture(scope="module")
def small_aligner(tmp_path_factory):
    return TorchAligner(hmm=model_dir(tmp_path_factory, "small"),
                        samprate=SAMPRATE, device="cpu")


def test_segments_equal_plain_on_a_long_form_chunk(small_aligner):
    """Rank 0's token chunk of a long-form batch (the synthetic model,
    AUSTEN's sentence twice, a ring of 2 ranks; tokens from K4's carry
    form), walked from random start states and from negative ones, at
    the segment lengths about sqrt(C), 2 and C."""
    al = small_aligner
    k = 2
    text = " ".join([TEXT] * k)
    audios = [np.tile(austen_audio(i), k) for i in range(3)]
    c = al._graph_consts(al.graph_for_text(text))
    Ts = np.array([al.fe.n_frames(len(a)) for a in audios])
    Ts[1] -= 40
    Tmax = -(-int(Ts.max()) // 128) * 128
    Ts_d = torch.from_numpy(Ts.astype(np.int32))
    sen = al._graph_scores(c.gs, audios, Ts_d, Tmax, "fold")
    C = Tmax // 2
    carry0 = tuple(x.expand(len(audios), *x.shape)
                   for x in at.vit_carry0(c.vit, n_emit=3))
    _, tok = at.viterbi_chunk_rows(sen[:, :C].contiguous(), carry0, 0, Ts_d,
                                   c.vit)
    S = tok.shape[2]
    rng = np.random.RandomState(3)
    starts = [rng.randint(0, S, len(audios)).astype(np.int32),
              np.array([-1, -S - 3, S - 1], np.int32)]
    for start in starts:
        want_p, want_o = at.backtrace_chunk_plain(
            tok, torch.from_numpy(start), 0, Ts_d)
        for L in (int(np.ceil(np.sqrt(C))), 2, C):
            path, out = segmented_backtrace(tok.numpy(), start, 0, Ts, L)
            assert np.array_equal(path, want_p.numpy()), L
            assert np.array_equal(out, want_o.numpy()), L


# -- K3 -----------------------------------------------------------------------

def range_codebooks(cb_pos: np.ndarray, c0: int, G: int):
    """A block's codebooks: the distinct ones of columns c0 .. c0+G-1 in
    order of first occurrence, and each column's slot among them."""
    cols = cb_pos[c0:c0 + G]
    distinct = list(dict.fromkeys(cols.tolist()))
    return distinct, np.array([distinct.index(c) for c in cols.tolist()])


def pack_term(s, cw):
    """A term in 16 bits: (s << 7) | cw, for s in [0, 511], cw < 128."""
    return ((np.asarray(s, np.uint32) << 7) | np.asarray(cw, np.uint32)
            ).astype(np.uint16)


def unpack_term(t):
    t = np.asarray(t, np.int32)
    return t >> 7, t & 127


K3_TAB = 768  # the table's entries K3 stages, zero-padded


def block_senone_eval(s, cw, mixw, cb_pos, table, wrap, G, NT, sub):
    """K3's blocks on the host: columns in ranges of G, frames in tiles
    of NT, each range's codebooks' terms staged a pass of ``sub`` frames
    at a time, packed, against the table zero-padded to K3_TAB entries
    and read at min(diff, K3_TAB - 1) with no guard; a pass with an s
    outside [0, 511], or a table of K3_TAB entries or more, read
    unpacked against the table with the guard; int32 [N, S]."""
    N, Cu, F, topn = s.shape
    S = cb_pos.shape[0]
    out = np.full((N, S), 12345, np.int64)
    n_tab = table.shape[0]
    staged = np.zeros(K3_TAB, np.int64)
    staged[:min(n_tab, K3_TAB)] = table[:K3_TAB]

    def chain(terms_sc, col, wide):
        ascore = np.int64(0)
        for f in range(F):
            fden = 0
            for e in range(topn):
                sv, cv = terms_sc[f * topn + e]
                term = int(mixw[f, cv, col]) + int(sv)
                if wrap:
                    term &= 0xFF
                if e == 0:
                    fden = term
                elif wide:
                    diff = abs(fden - term)
                    fden = min(fden, term) - (int(table[diff])
                                              if diff < n_tab else 0)
                else:
                    diff = abs(fden - term)
                    fden = min(fden, term) - int(
                        staged[min(diff, K3_TAB - 1)])
            ascore += fden
        return ascore

    for c0 in range(0, S, G):
        distinct, slots = range_codebooks(cb_pos, c0, G)
        for t0 in range(0, N, NT):
            for n0 in range(t0, min(t0 + NT, N), sub):
                frames = range(n0, min(n0 + sub, t0 + NT, N))
                raw = s[frames.start:frames.stop][:, distinct].reshape(
                    len(frames), len(distinct), F * topn)
                rcw = cw[frames.start:frames.stop][:, distinct].reshape(
                    len(frames), len(distinct), F * topn)
                wide = (n_tab >= K3_TAB
                        or bool(((raw < 0) | (raw > 511)).any()))
                packed = pack_term(np.clip(raw, 0, 511), rcw & 127)
                for j, sl in enumerate(slots):
                    for qi, n in enumerate(frames):
                        if wide:
                            terms = list(zip(raw[qi, sl], rcw[qi, sl]))
                        else:
                            terms = list(zip(*unpack_term(packed[qi, sl])))
                        out[n, c0 + j] = chain(terms, c0 + j, wide)
    return out.astype(np.int32)


def k3_inputs(layout: str, N, S, Cu, F, D, topn, rng, high=False):
    """Random K3 inputs: s in [0, 96] with cw in [0, D) (K2's range), or
    with ``high`` s in [400, 511] with cw 0 (weight 255) or 1 (weight
    0), so that the running log-add falls far below 0 and a later
    difference passes the staged table's end."""
    if layout == "graph":
        cb = np.repeat(rng.randint(0, Cu, -(-S // 3)), 3)[:S]
    elif layout == "union":
        cb = np.zeros(S, np.int64)
    elif layout == "inventory":
        cb = np.sort(rng.randint(0, Cu, S))
    else:
        cb = np.arange(S) % Cu
    mixw = rng.randint(0, 256, (F, D, S)).astype(np.uint8)
    mixw[:, 0, ::7] = 255
    mixw[:, 1, ::5] = 0
    s = rng.randint(0, 97, (N, Cu, F, topn)).astype(np.int32)
    cwv = rng.randint(0, D, (N, Cu, F, topn)).astype(np.int32)
    if high:
        mixw[:, 0], mixw[:, 1] = 255, 0
        s = rng.randint(400, 512, (N, Cu, F, topn)).astype(np.int32)
        cwv = rng.randint(0, 2, (N, Cu, F, topn)).astype(np.int32)
        # terms 0, 0, ..., then 766: the log-add at -255 (at -tab[0]),
        # then a difference of 1,021
        s[2], cwv[2] = 0, 1
        s[2, :, :, -1], cwv[2, :, :, -1] = 511, 0
    for q, top in ((0, 96), (1, 0)):   # differences of 351 and 255
        s[q, :, :, 0], cwv[q, :, :, 0] = top, 0
        s[q, :, :, -1], cwv[q, :, :, -1] = 0, 1
    return s, cwv, mixw, cb.astype(np.int32)


def k3_table(n: int) -> np.ndarray:
    """A log-add table of n entries from 255 down, 0 from entry 510."""
    return np.maximum(0, 255 - np.arange(n) // 2).astype(np.int32)


K3_CASES = [
    # layout, S, Cu, F, D, topn, wrap, G, NT, frames a pass
    ("graph", 174, 42, 3, 128, 4, False, 64, 16, 16),
    ("graph", 70, 20, 1, 128, 8, False, 32, 8, 3),
    ("union", 100, 1, 3, 128, 4, True, 128, 8, 8),
    ("inventory", 300, 9, 3, 100, 1, False, 128, 8, 5),
    ("inventory", 300, 9, 3, 128, 4, True, 64, 6, 4),
    ("distinct", 150, 128, 3, 128, 8, False, 128, 4, 1),
    # s in [400, 511]; then the same against a table past the staged one
    ("graph", 174, 42, 3, 128, 8, False, 64, 16, 16, "high"),
    ("graph", 100, 42, 3, 128, 4, True, 64, 8, 3, "high"),
    ("graph", 100, 42, 3, 128, 8, False, 64, 8, 8, "high", 800),
]


def _k3_id(c) -> str:
    return (f"{c[0]}-S{c[1]}-G{c[7]}-tile{c[8]}-pass{c[9]}"
            f"{'-wrap' if c[6] else ''}"
            + "".join(f"-{x}" if isinstance(x, str) else f"-table{x}"
                      for x in c[10:]))


@pytest.mark.parametrize("case", K3_CASES, ids=[_k3_id(c) for c in K3_CASES])
def test_k3_blocks_equal_plain(case):
    """K3's blocks (ranges of 32-128 columns with S not a multiple, frame
    tiles with a remainder, their terms in one pass or in passes of a
    few frames, passes not dividing the tile) on packed terms, and a
    frame whose s lies outside the packed range (its pass reads
    unpacked), against senone_eval_plain: the table's last entry and
    its end, a running log-add below 0 whose next difference passes the
    staged table's end (s in [400, 511]), a table longer than the staged
    one, top-N 1, 4, 8, F 1 and 3, wrap_u8."""
    import types

    layout, S, Cu, F, D, topn, wrap, G, NT, sub = case[:10]
    high = "high" in case[10:]
    n_tab = case[11] if len(case) > 11 else 256
    rng = np.random.RandomState(S + Cu)
    N = 2 * NT + 3
    s, cwv, mixw, cb = k3_inputs(layout, N, S, Cu, F, D, topn, rng, high)
    s[-1, :, 0, :] = np.resize([-3, 600, 2 ** 20, 7], topn)
    table = k3_table(n_tab)
    got = block_senone_eval(s, cwv, mixw, cb, table, wrap, G, NT, sub)
    gs = types.SimpleNamespace(mixw=torch.from_numpy(mixw),
                               cb_pos=torch.from_numpy(cb),
                               logadd=torch.from_numpy(table), S=S,
                               wrap_u8=wrap)
    want = st.senone_eval_plain(torch.from_numpy(s), torch.from_numpy(cwv),
                                gs)
    assert np.array_equal(got, want.numpy())


def test_k3_terms_pack_in_16_bits_on_the_path(small_aligner):
    """Every (s, cw) the path's K2 can hand K3 packs and unpacks exactly
    (s in [0, 96] after the norm, cw < D <= 128), on the small model's
    graph and full-inventory scorers; and a range's codebooks are the
    distinct ones in order of first occurrence, every column's slot
    pointing at its own codebook."""
    s_all, cw_all = np.meshgrid(np.arange(512), np.arange(128),
                                indexing="ij")
    assert np.array_equal(unpack_term(pack_term(s_all, cw_all)),
                          (s_all, cw_all))
    al = small_aligner
    rng = np.random.RandomState(5)
    for sc in (al._graph_consts(al.graph_for_text(TEXT)).gs, al.dense):
        D = sc.means.shape[2]
        L = sc.means.shape[3]
        feats = torch.from_numpy(rng.standard_normal(
            (40, sc.means.shape[1], L)).astype(np.float32))
        s, cwv = st.dist_topn_norm_plain(feats, sc)
        assert 0 <= int(s.min()) and int(s.max()) <= 96
        assert 0 <= int(cwv.min()) and int(cwv.max()) < D <= 128
        cb = sc.cb_pos.numpy()
        for G in (32, 64, 128):
            for c0 in range(0, sc.S, G):
                distinct, slots = range_codebooks(cb, c0, G)
                assert len(set(distinct)) == len(distinct) <= G
                assert [distinct[u] for u in slots] == \
                    cb[c0:c0 + G].tolist()
                # slot u first appears before slot u + 1
                firsts = [int(np.argmax(slots == u))
                          for u in range(len(distinct))]
                assert firsts == sorted(firsts)
