"""K4's and its carry form's bounded edge loop, the R-row carry entry and
the long form's rank-major forward, in plain PyTorch on the CPU.

The kernels loop over each phone's real predecessor slots only
(``pred_count``: slots 0 .. n-1 of its K padded ones).  ``bounded_enter``
below writes that loop out in plain PyTorch, with the carry form's extra
WORST_SCORE candidate (the first padded slot) and K4's plain stop, and is
held against the dense [P, K] plain versions (``_kslot_enter``,
``_argmax_enter``) and, inside the frame recurrence, against the JAX
package's ``make_vit_step`` and ``align_viterbi_batch`` on random graphs
with the traps forced: real slots all below WORST_SCORE, zero in-degree,
a full K, ties, 3 and 5 states.  Every comparison is exact.  Inputs are
numpy draws from fixed seeds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, model_dir, random_graph
from make_torch_decode_golden import GRAMMAR, large_grammar

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.ops.align_jax import make_vit_step
from soundswallower_tpu.ops.align_jax import vit_carry0 as jax_carry0
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import align_torch as at
from soundswallower_tpu_torch.parallel import seqpipe

torch.set_num_threads(1)
W = at.WORST_SCORE


# -- pred_count ----------------------------------------------------------------

def test_pred_count_of_build_pred_table():
    """Random edge lists, padded to their own K and to a larger k_pad:
    the count is each node's in-degree."""
    rng = np.random.RandomState(0)
    for P, E in ((1, 0), (50, 120), (300, 900)):
        dst = rng.randint(0, P, E)
        src = rng.randint(0, P, E)
        pen = -rng.randint(0, 4000, E)
        want = np.bincount(dst, minlength=P).astype(np.int32)
        for k_pad in (None, int(want.max(initial=1)) + 3):
            _, _, pk = at.build_pred_table(src, dst, pen, P, k_pad=k_pad)
            got = at.pred_count(pk)
            assert got.dtype == np.int32 and np.array_equal(got, want)
            assert np.array_equal(at.pred_count(torch.from_numpy(pk)), want)


@pytest.fixture(scope="module")
def small_aligner(tmp_path_factory):
    return TorchAligner(hmm=model_dir(tmp_path_factory, "small"),
                        samprate=SAMPRATE, device="cpu")


def test_pred_count_of_decode_and_large_graphs(small_aligner):
    """The decode grammar's graph and the large grammar's: the count is
    the in-degree, most phones far below the padded K, and the aligner's
    constants carry it."""
    al = small_aligner
    for gram in (GRAMMAR, large_grammar()):
        g = al.set_grammar(jsgf_string=gram)
        P = len(g.senid)
        _, _, pk = at.build_pred_table(g.edge_src, g.edge_dst, g.edge_pen, P)
        want = np.bincount(g.edge_dst, minlength=P).astype(np.int32)
        assert np.array_equal(at.pred_count(pk), want)
        assert want.mean() * 4 < pk.shape[1]
    vit = al._graph_consts(al.set_grammar(jsgf_string=GRAMMAR)).vit
    assert vit.pred_n.dtype == torch.int32
    assert torch.equal(vit.pred_n, vit.pred_ok.sum(1).to(torch.int32))


def test_pred_count_raises_where_slots_are_not_a_prefix():
    pk = np.zeros((4, 3), bool)
    pk[0, :2] = True
    pk[2, :3] = True
    assert np.array_equal(at.pred_count(pk), [2, 0, 3, 0])
    pk[3, 1] = True                                  # slot 0 empty
    with pytest.raises(ValueError, match=r"phones \[3\]"):
        at.pred_count(pk)
    g = random_graph(4, 3, np.random.RandomState(1))
    g["pk"] = pk
    with pytest.raises(ValueError, match="not a prefix"):
        at.graph_consts_from_numpy(g)


# -- the bounded loop in plain PyTorch ----------------------------------------

def bounded_enter(pred_idx, pred_pen, pred_n, argmax: bool):
    """The kernels' bounded edge loop (viterbi_step.h enter_strict_at and
    enter_argmax) over tables [P, K] and state [B, P]: slots 0 .. n-1 of
    each phone in order, K4's strict ``>`` from WORST_SCORE, or the
    carry form's first maximum from slot 0 followed by the first padded
    slot (WORST_SCORE, not ok) where n < K.  Returns (es, eh, eok) [B,
    P], eh -1 where not eok."""
    P, K = pred_idx.shape
    n = pred_n.long()
    nmax = int(n.max()) if P else 0

    def enter(osc, ohi, anext):
        es = torch.full_like(osc, W)
        eh = torch.full_like(ohi, -1)
        eok = torch.zeros_like(anext)
        for k in range(nmax):
            src = pred_idx[:, k].long()
            ok = anext[:, src]
            val = torch.where(ok, osc[:, src] + pred_pen[:, k],
                              torch.full_like(es, W))
            upd = (k < n) & (((k == 0) | (val > es)) if argmax
                             else (val > es))
            es = torch.where(upd, val, es)
            eh = torch.where(upd, ohi[:, src], eh)
            eok = torch.where(upd, ok, eok)
        if argmax:
            pad = (n < K) & ((n == 0) | (W > es))
            es = torch.where(pad, torch.full_like(es, W), es)
            eok = eok & ~pad
        eh = torch.where(eok, eh, torch.full_like(eh, -1))
        return es, eh, eok
    return enter


def _tables(P: int, K: int, rng, case: str):
    """Prefix slot tables [P, K] for one case: in-degrees 0..K with zero
    and full K both present; "ties" draws penalties from {0, -1}."""
    n = rng.randint(0, K + 1, P)
    n[0], n[1] = 0, K
    pi = np.zeros((P, K), np.int32)
    pp = np.zeros((P, K), np.int32)
    pk = np.arange(K)[None] < n[:, None]
    pi[pk] = rng.randint(0, P, int(pk.sum()))
    lo, hi = {"ties": (0, 2), "below_worst": (1, 4000)}.get(case, (0, 4000))
    pp[pk] = -rng.randint(lo, hi, int(pk.sum()))
    return pi, pp, pk


def _state(P: int, rng, case: str):
    """osc, ohi, anext [1, P] for one case: "below_worst" puts every
    out_score at WORST_SCORE, so every real slot's value falls below it
    and a padded slot must win; "ties" draws scores from {0, 1}."""
    if case == "below_worst":
        osc = np.full(P, W, np.int64)
    elif case == "ties":
        osc = rng.randint(0, 2, P)
    else:
        osc = np.where(rng.random_sample(P) < 0.1, W,
                       -rng.randint(0, 10 ** 6, P))
    ohi = rng.randint(-1, 3 * P, P)
    anext = rng.random_sample(P) < (1.0 if case == "below_worst" else 0.7)
    return (torch.from_numpy(osc.astype(np.int32))[None],
            torch.from_numpy(ohi.astype(np.int32))[None],
            torch.from_numpy(anext)[None])


@pytest.mark.parametrize("case", ["random", "below_worst", "ties"])
@pytest.mark.parametrize("K", [1, 4, 125])
def test_bounded_enter_equals_dense(case, K):
    """bounded_enter == _kslot_enter (strict) and _argmax_enter (first
    maximum) over the padded tables, per phone, with zero in-degree and a
    full K in every draw; below WORST the carry form takes the padded
    slot (es WORST_SCORE, not ok) where K4 takes nothing."""
    rng = np.random.RandomState(K + len(case))
    P = 300
    pi, pp, pk = _tables(P, K, rng, case)
    pi_t, pp_t, pk_t = (torch.from_numpy(x) for x in (pi, pp, pk))
    n = torch.from_numpy(at.pred_count(pk))
    osc, ohi, anext = _state(P, rng, case)
    want = at._kslot_enter(pi_t[None], pp_t[None], pk_t[None])(osc, ohi,
                                                               anext)
    got = bounded_enter(pi_t, pp_t, n, False)(osc, ohi, anext)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    es, eh, eok = at._argmax_enter(pi_t, pp_t, pk_t)(osc, ohi, anext)
    eh = torch.where(eok, eh, torch.full_like(eh, -1))
    got = bounded_enter(pi_t, pp_t, n, True)(osc, ohi, anext)
    for a, b in zip(got, (es, eh, eok)):
        assert torch.equal(a, b)
    if case == "below_worst":
        # the padded slot wins wherever there is one; a real slot's value
        # below WORST_SCORE only at a full K
        assert bool((got[0][0][n < K] == W).all())
        assert not bool(got[2][0][n < K].any())
        full = n == K
        assert bool(full.any()) and bool((got[0][0][full] < W).all())
        assert bool(got[2][0][full].all())
        assert not bool(want[2].any())


CASES = ["random", "ties", "guards"]


def _graph(P: int, E: int, T: int, B: int, case: str, seed: int):
    """A random graph (in-degrees 0..3, so zero and full K occur) and
    scores [B, T, E*P] for one case: "ties" from {0, 1}, "guards" with a
    fifth of the scores driving states below WORST_SCORE (out_scores at
    WORST_SCORE, so real slots fall below it)."""
    rng = np.random.RandomState(seed)
    g = random_graph(P, E, rng, T=T)
    sen = rng.randint(0, 4000, (B, T, E * P))
    if case == "ties":
        g["tp"] = rng.randint(0, 2, g["tp"].shape).astype(np.int32)
        sen = rng.randint(0, 2, (B, T, E * P))
    elif case == "guards":
        sen[rng.random_sample(sen.shape) < 0.2] = 0x30000000
    n = at.pred_count(g["pk"])
    assert (n == 0).any() and (n == g["pk"].shape[1]).any()
    return g, sen.astype(np.int32)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("E", [3, 5])
def test_bounded_carry_form_equals_make_vit_step(case, E):
    """The carry form's frame recurrence with the bounded loop ==
    make_vit_step scanned from vit_carry0: carry and tokens after every
    12-frame chunk, frames past n included."""
    T, n, P = 36, 31, 26
    g, sen = _graph(P, E, T, 1, case, 40 + E + CASES.index(case))
    sen = sen[0]
    c = at.graph_consts_from_numpy(g)
    enter = bounded_enter(c.pred_idx, c.pred_pen, c.pred_n, True)
    senid = jnp.arange(E * P, dtype=jnp.int32).reshape(P, E)
    step = make_vit_step(senid, jnp.asarray(g["tp"]), jnp.asarray(g["pi"]),
                         jnp.asarray(g["pp"]), jnp.asarray(g["pk"]),
                         jnp.asarray(g["ast"]), jnp.asarray(g["aen"]),
                         jnp.int32(n), False, jnp.int16)
    jcarry = jax_carry0(P, jnp.asarray(g["entry"]), n_emit=E)
    carry = tuple(x[None] for x in at.vit_carry0(c))
    for t0 in range(0, T, 12):
        ts = t0 + jnp.arange(12, dtype=jnp.int32)
        jcarry, (jtok, _) = jax.lax.scan(
            step, jcarry, (ts, jnp.asarray(sen[t0:t0 + 12])[:, senid]))
        tok, _, carry = at._forward_plain(
            torch.from_numpy(sen[None, t0:t0 + 12]),
            torch.tensor([n], dtype=torch.int32), c.tp, c.astart, c.aend,
            None, enter, False, carry=carry, t0=t0)
        assert np.array_equal(tok[0].numpy(), _np(jtok))
        for a, b in zip(carry, jcarry):
            assert np.array_equal(a[0].numpy(), _np(b))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("E", [3, 5])
def test_bounded_batch_equals_reference(case, E):
    """K4's recurrence with the bounded loop (strict, stopping at n),
    then the final select and backtrace, == align_viterbi_batch +
    _vit_full's select and backtrace, with scores: full rows, a short
    row and one that fails."""
    T, P = 40, 30
    g, sen = _graph(P, E, T, 3, case, 60 + E + CASES.index(case))
    Ts = np.array([T, T - 7, 2], np.int32)
    fake = types.SimpleNamespace(
        _graph_consts=lambda _: {k: jnp.asarray(v) for k, v in g.items()},
        want_scores=True)
    want = TpuAligner._vit_full(fake, None, jnp.asarray(sen),
                                jnp.asarray(Ts))
    c = at.graph_consts_from_numpy(g)
    sen_t, n_t = torch.from_numpy(sen), torch.from_numpy(Ts)
    tok, tsc, (_, _, osc, ohi, _) = at._forward_plain(
        sen_t, n_t, c.tp, c.astart, c.aend, c.entry,
        bounded_enter(c.pred_idx, c.pred_pen, c.pred_n, False), True)
    rows = torch.arange(3)
    fnode = c.fin.long()[at._first_argmax(osc[:, c.fin.long()])]
    fscore = osc[rows, fnode]
    path, pscore = at._backtrace_plain(tok, tsc, ohi[rows, fnode], fscore,
                                       n_t)
    for a, b in zip((path, pscore, fscore), want):
        assert a.numpy().dtype == _np(b).dtype
        assert np.array_equal(a.numpy(), _np(b))
    for a, b in zip((path, pscore, fscore),
                    at.viterbi_batch_plain(sen_t, n_t, c, True)):
        assert torch.equal(a, b)


# -- the R-row carry entry -------------------------------------------------------

@pytest.mark.parametrize("E", [3, 5])
def test_chunk_rows_equals_single_rows(E):
    """viterbi_chunk_rows over R rows == R single-row viterbi_chunk calls
    from the same carries: rows of mixed frame counts (one past the
    chunk, one ending inside it, one at t0, one before t0), n as an int
    and as a tensor, tokens into ``out``."""
    P, R, C, t0 = 24, 4, 16, 16
    g, sen = _graph(P, E, t0 + C, R, "random", 80 + E)
    c = at.graph_consts_from_numpy(g)
    ns = [t0 + C + 3, t0 + 5, t0, t0 - 4]
    carries = []
    for r in range(R):
        carry, _ = at.viterbi_chunk(torch.from_numpy(sen[r, :t0]),
                                    at.vit_carry0(c), 0, ns[r], c)
        carries.append(carry)
    stacked = tuple(torch.stack([cr[i] for cr in carries]) for i in range(5))
    chunk = torch.from_numpy(sen[:, t0:])
    want = [at.viterbi_chunk(chunk[r], carries[r], t0, ns[r], c)
            for r in range(R)]
    out = torch.empty((R, C, E * P), dtype=torch.int16)
    new, tok = at.viterbi_chunk_rows(
        chunk, stacked, t0, torch.tensor(ns, dtype=torch.int32), c, out=out)
    assert tok is out
    for r in range(R):
        assert torch.equal(tok[r], want[r][1])
        for a, b in zip(new, want[r][0]):
            assert torch.equal(a[r], b)
    # n as one int for every row
    new1, tok1 = at.viterbi_chunk_rows(chunk, stacked, t0, ns[0], c)
    for r in range(R):
        carry, tk = at.viterbi_chunk(chunk[r], carries[r], t0, ns[0], c)
        assert torch.equal(tok1[r], tk)
        assert all(torch.equal(a[r], b) for a, b in zip(new1, carry))
    with pytest.raises(TypeError, match="carry shapes"):
        at.viterbi_chunk_rows(chunk[:2], stacked, t0, ns[0], c)


# -- the long form's rank-major forward -------------------------------------------

@pytest.mark.parametrize("nseq", [1, 2, 8])
def test_longform_forward_one_launch_per_rank(monkeypatch, nseq):
    """A local ring's forward calls the R-row carry entry once per rank
    with all B rows (rank p at frame p * C), and the paths equal the
    single-utterance Viterbi's."""
    P, E, B, T = 20, 3, 3, 64
    g, sen = _graph(P, E, T, B, "random", 100 + nseq)
    ns = np.array([T, T - 9, 30], np.int32)
    calls = []
    real = seqpipe.viterbi_chunk_rows

    def counted(sen_p, carry, t0, n, c, out=None):
        calls.append((tuple(sen_p.shape), t0))
        return real(sen_p, carry, t0, n, c, out=out)

    monkeypatch.setattr(seqpipe, "viterbi_chunk_rows", counted)
    c = at.graph_consts_from_numpy(g)
    path, score = seqpipe.align_longform(seqpipe.seq_ring(nseq, "cpu"),
                                         sen, c, ns)
    C = T // nseq
    assert calls == [((B, C, E * P), p * C) for p in range(nseq)]
    for b in range(B):
        p1, s1 = at.viterbi_single(torch.from_numpy(sen[b]), int(ns[b]), c)
        assert torch.equal(path[b], p1) and int(score[b]) == int(s1)
