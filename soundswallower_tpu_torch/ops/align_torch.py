"""Viterbi, final-node select and backtrace (kernels K4 and K6).

Port of ``soundswallower_tpu/ops/align_jax.py`` align_viterbi_batch
(make_vit_step_lanes, _eval_3st_lanes, _eval_5st, vit_carry0_lanes) and
backtrace_batch, in its two graph forms:

* K4 ``viterbi_batch``: one graph shared by the batch, with the
  final-node select of ``soundswallower_tpu/aligner.py`` _vit_full.run
  and, under ``with_scores``, the token-score stack and path scores;
* K6 ``viterbi_rows``: a graph per row (``stack_graphs``), with the
  masked select of _vit_full_mg.run, the banded predecessor form and,
  under ``with_scores``, the token-score stack and path scores;

and of the single-utterance programs (make_vit_step, vit_carry0,
align_viterbi, backtrace), as K4's carry form (which also runs each
chunk of the long form's ring, parallel/seqpipe.py):

* ``viterbi_chunk``: frames t0 .. t0+C-1 of one utterance from a carry
  (score, hist [P, E], out_score, out_hist [P], best_prev []) to the
  next, tokens [C, S] (AlignStream's 128-frame chunks);
* ``viterbi_single``: a whole utterance from ``vit_carry0``, then
  _viterbi_graph's final-node select and backtrace: path int32 [T],
  -1 at and after n;

and K13 ``backtrace_chunk``, the long form's backtrace over one rank's
token chunk (seqpipe.py _backward's chunk_back).

Graph-state scores [B, T, S=P*E] int32 in (E = 3 or 5 emitting states),
the decoded state path [B, T] and the final score [B] int32 out.  Token
stacks and paths are int16 below S = 32767 and int32 from there, where
align_jax.py switches (``tok_dtype``).

Per frame, as the JAX step: the renormalization rule
(state_align_search.c:193-197) per row, hmm.c's 3-state update with the
t2 reuse when the 0->2 skip is absent or its 5-state update (each select
on its own transition row, states 3 and 4 and the exit gated by the
state two below), the best score over active phones, the predecessor
max with a strict ``>`` (K slots in edge order, or band slots in
offset-descending order), the enter rule, and the token record.  A row
whose final state is negative (no final node reached) gets the path
values of the JAX program: its masked lookup yields -2^30, which int16
holds as 0 and int32 as -2^30, and ``path[n-1] < 0`` is what extraction
reads.

Each kernel keeps a row's Viterbi state in shared memory while it fits
a block's (``sst_viterbi_smem_bytes(P, E)`` <= 232,448 bytes: 7,040
phones of 3 states, 4,741 of 5) and in a global scratch beyond that
(``state_scratch``); both layouts give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import cuda_build, to_device
from .align_graph import pad_graph_to

WORST_SCORE = -0x20000000
TMAT_WORST = -255
MISSING = -(1 << 30)         # backtrace_batch's masked-max floor
MAX_SMEM_BYTES = 232448      # dynamic shared memory a Hopper block can use


def build_pred_table(edge_src, edge_dst, edge_pen, n_nodes: int,
                     k_pad: int | None = None):
    """Edge list -> dense predecessor table (pred_idx [P, K] int32,
    pred_pen [P, K] int32, pred_ok [P, K] bool), slots in edge order.
    A copy of align_jax.build_pred_table, whose module imports jax."""
    edge_src = np.asarray(edge_src)
    edge_dst = np.asarray(edge_dst)
    edge_pen = np.asarray(edge_pen)
    counts = np.bincount(edge_dst, minlength=n_nodes)
    K = max(1, int(counts.max()) if len(edge_dst) else 1)
    if k_pad is not None:
        if K > k_pad:
            raise ValueError(f"in-degree {K} exceeds k_pad {k_pad}")
        K = k_pad
    pred_idx = np.zeros((n_nodes, K), np.int32)
    pred_pen = np.zeros((n_nodes, K), np.int32)
    pred_ok = np.zeros((n_nodes, K), bool)
    slot = np.zeros(n_nodes, np.int64)
    for s, d, p in zip(edge_src, edge_dst, edge_pen):
        k = slot[d]
        pred_idx[d, k] = s
        pred_pen[d, k] = p
        pred_ok[d, k] = True
        slot[d] += 1
    return pred_idx, pred_pen, pred_ok


def stack_graphs(graphs: list, tmat: np.ndarray, sen_remap: np.ndarray,
                 p_mult: int = 32, k_mult: int = 2,
                 p_floor: int = 0, k_floor: int = 0,
                 w_mult: int = 8, w_floor: int = 0,
                 w_cap: int = 64) -> dict:
    """A batch of (generally different) graphs padded to one (P, K, W)
    size class and stacked, as the JAX package's
    ``ops/align_graph.stack_graphs`` does.

    Returns host arrays: tp [B,P,3,4] int32, pred_idx/pred_pen [B,P,K]
    int32, pred_ok [B,P,K] bool, astart/aend/entry [B,P] int32,
    final_mask [B,P] bool, sencols [B,P*3] int32 (``sen_remap`` of each
    state's senone), P, K, W; and, when every edge is a forward edge of
    span 1..``w_cap``, band_pen/band_ok [B,W,P] with slot i holding the
    edge p-(W-i) -> p (duplicate edges merged by max penalty)."""
    B = len(graphs)
    E = graphs[0].senid.shape[1]
    P = max(len(g.ssid) for g in graphs)
    P = max(-(-P // p_mult) * p_mult, p_floor)
    K = 1
    for g in graphs:
        if len(g.edge_dst):
            K = max(K, int(np.bincount(g.edge_dst).max()))
    K = max(-(-K // k_mult) * k_mult, k_floor)
    tp = np.zeros((B, P) + tmat.shape[1:], np.int32)
    pi = np.zeros((B, P, K), np.int32)
    pp = np.zeros((B, P, K), np.int32)
    pk = np.zeros((B, P, K), bool)
    astart = np.ones((B, P), np.int32)
    aend = np.zeros((B, P), np.int32)
    entry = np.full((B, P), WORST_SCORE, np.int32)
    final_mask = np.zeros((B, P), bool)
    sencols = np.zeros((B, P * E), np.int32)
    dmax = 0
    banded = True
    for g in graphs:
        if len(g.edge_dst):
            off = g.edge_dst - g.edge_src
            if off.min() < 1 or off.max() > w_cap:
                banded = False
                break
            dmax = max(dmax, int(off.max()))
    W = 0
    band_pen = band_ok = None
    if banded and dmax:
        W = max(-(-dmax // w_mult) * w_mult, w_floor)
        band_pen = np.full((B, W, P), -(1 << 30), np.int32)
        band_ok = np.zeros((B, W, P), bool)
    for b, g0 in enumerate(graphs):
        g = pad_graph_to(g0, P)
        tp[b] = tmat[g.tmatid]
        pi[b], pp[b], pk[b] = build_pred_table(
            g.edge_src, g.edge_dst, g.edge_pen, P, k_pad=K)
        astart[b] = g.astart
        aend[b] = g.aend
        entry[b] = np.where(g.is_entry, g.entry_pen, WORST_SCORE)
        final_mask[b, g.final_nodes] = True
        sencols[b] = sen_remap[g.senid].reshape(-1)
        if band_pen is not None and len(g.edge_dst):
            slot = W - (g.edge_dst - g.edge_src)
            np.maximum.at(band_pen[b], (slot, g.edge_dst), g.edge_pen)
            band_ok[b][slot, g.edge_dst] = True
    out = dict(tp=tp, pred_idx=pi, pred_pen=pp, pred_ok=pk,
               astart=astart, aend=aend, entry=entry,
               final_mask=final_mask, sencols=sencols, P=P, K=K, W=W)
    if band_pen is not None:
        out["band_pen"] = band_pen
        out["band_ok"] = band_ok
    return out


@dataclass(eq=False)
class VitConsts:
    """Device constants of one graph's Viterbi (K4)."""

    tp: torch.Tensor         # int32 [P, E, E+1] quantized negated tmat
    pred_idx: torch.Tensor   # int32 [P, K]
    pred_pen: torch.Tensor   # int32 [P, K]
    pred_ok: torch.Tensor    # uint8 [P, K]
    astart: torch.Tensor     # int32 [P]
    aend: torch.Tensor       # int32 [P]
    entry: torch.Tensor      # int32 [P] entry score, WORST_SCORE if none
    fin: torch.Tensor        # int32 [n_fin] final nodes

    @property
    def P(self) -> int:
        return self.tp.shape[0]

    @property
    def E(self) -> int:
        return self.tp.shape[1]


@dataclass(eq=False)
class RowVitConsts:
    """Device constants of a stacked batch of graphs, one per row (K6)."""

    tp: torch.Tensor         # int32 [B, P, E, E+1]
    pred_idx: torch.Tensor   # int32 [B, P, K]
    pred_pen: torch.Tensor   # int32 [B, P, K]
    pred_ok: torch.Tensor    # uint8 [B, P, K]
    astart: torch.Tensor     # int32 [B, P]
    aend: torch.Tensor       # int32 [B, P]
    entry: torch.Tensor      # int32 [B, P]
    final_mask: torch.Tensor  # uint8 [B, P]
    band_pen: torch.Tensor | None = None  # int32 [B, W, P]
    band_ok: torch.Tensor | None = None   # uint8 [B, W, P]

    @property
    def P(self) -> int:
        return self.tp.shape[1]

    @property
    def E(self) -> int:
        return self.tp.shape[2]


def _check_topology(tp) -> None:
    """3 or 5 emitting states, as _eval_emit (align_jax.py:207-223)."""
    if tuple(np.shape(tp)[-2:]) not in ((3, 4), (5, 6)):
        raise NotImplementedError(
            f"the Viterbi supports 3/5 emitting states, got tp "
            f"{tuple(np.shape(tp))}")


def graph_consts_from_numpy(c: dict, device="cpu") -> VitConsts:
    """VitConsts from host arrays under the keys of the JAX aligner's
    ``_graph_consts`` dict (tp, pi, pp, pk, ast, aen, entry, fin)."""
    def dev(a, dtype):
        return to_device(a, dtype, device)

    _check_topology(c["tp"])
    return VitConsts(
        tp=dev(c["tp"], np.int32), pred_idx=dev(c["pi"], np.int32),
        pred_pen=dev(c["pp"], np.int32), pred_ok=dev(c["pk"], np.uint8),
        astart=dev(c["ast"], np.int32), aend=dev(c["aen"], np.int32),
        entry=dev(c["entry"], np.int32), fin=dev(c["fin"], np.int32))


def row_consts_from_numpy(st: dict, device="cpu") -> RowVitConsts:
    """RowVitConsts from host arrays under the keys of ``stack_graphs``
    (the port's or the JAX package's, or the JAX aligner's
    ``_stacked_graphs`` read as numpy); no band when the dict has
    none."""
    def dev(key, dtype):
        return to_device(st[key], dtype, device)

    _check_topology(st["tp"])
    band = "band_pen" in st and st["band_pen"] is not None
    return RowVitConsts(
        tp=dev("tp", np.int32), pred_idx=dev("pred_idx", np.int32),
        pred_pen=dev("pred_pen", np.int32), pred_ok=dev("pred_ok", np.uint8),
        astart=dev("astart", np.int32), aend=dev("aend", np.int32),
        entry=dev("entry", np.int32),
        final_mask=dev("final_mask", np.uint8),
        band_pen=dev("band_pen", np.int32) if band else None,
        band_ok=dev("band_ok", np.uint8) if band else None)


# -- plain versions ------------------------------------------------------------

def _kslot_enter(pred_idx, pred_pen, pred_ok):
    """Predecessor max over K slots in edge order, strict ``>`` from
    WORST (the first slot wins ties; a value at or below WORST wins
    nothing); tables [B or 1, P, K].  Computed over the table's edges
    (the slots with pred_ok), not its padded [P, K]: decode graphs pad a
    few nodes' in-degree of a hundred onto every node."""
    Bt, P, K = pred_idx.shape
    bi, di, ki = pred_ok.bool().nonzero(as_tuple=True)  # in (b, p, k) order
    cols = (pred_idx[bi, di, ki].long(), di, ki.to(torch.int32),
            pred_pen[bi, di, ki], torch.ones_like(di, dtype=torch.bool))
    if Bt > 1:
        cols = _per_row(bi, cols, Bt)               # [B, E_max] each
    else:
        cols = tuple(x[None] for x in cols)         # [1, E]

    def enter(osc, ohi, anext):
        B = osc.shape[0]
        src, dst, slot, pen, real = (x.expand(B, -1) for x in cols)
        worst = torch.full_like(osc, WORST_SCORE)
        live = real & anext.gather(1, src)
        val = torch.where(live, osc.gather(1, src) + pen,
                          torch.full_like(pen, WORST_SCORE))
        m = worst.scatter_reduce(1, dst, val, "amax")
        hit = (val == m.gather(1, dst)) & (val > WORST_SCORE)
        first = torch.full_like(osc, K).scatter_reduce(
            1, dst, torch.where(hit, slot, K), "amin")
        eok = first < K
        at = pred_idx.expand(B, -1, -1).gather(
            2, first.clamp(max=K - 1).long()[..., None])[..., 0].long()
        es = torch.where(eok, m, worst)
        eh = torch.where(eok, ohi.gather(1, at), torch.full_like(ohi, -1))
        return es, eh, eok
    return enter


def _per_row(bi, cols, B: int):
    """Edge columns of per-row tables laid out [B, E_max], each row's
    edges first, then padding (``real`` False)."""
    counts = torch.bincount(bi, minlength=B)
    E = int(counts.max()) if len(bi) else 0
    pos = torch.arange(len(bi), device=bi.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    out = []
    for x in cols:
        y = torch.zeros((B, E), dtype=x.dtype, device=x.device)
        y[bi, pos] = x
        out.append(y)
    return tuple(out)


def _argmax_enter(pred_idx, pred_pen, pred_ok):
    """make_vit_step's predecessor choice, jnp.argmax over the K slots
    (tables [P, K], state [1, P]): the first maximum, starting at slot
    0, so a slot at or below WORST_SCORE can win where the strict ``>``
    of _kslot_enter takes none."""
    src = pred_idx.long()
    ok_t = pred_ok.bool()

    def enter(osc, ohi, anext):
        ok = ok_t & anext[0][src]
        val = torch.where(ok, osc[0][src] + pred_pen,
                          torch.full_like(pred_pen, WORST_SCORE))
        k = val.argmax(1, keepdim=True)          # the first maximum
        es = val.gather(1, k)[:, 0]
        eh = ohi[0][src.gather(1, k)[:, 0]]
        eok = ok.gather(1, k)[:, 0]
        return es[None], eh[None], eok[None]
    return enter


def _shift_down(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x [B, P] with column p reading column p-d; the first d take fill."""
    out = torch.full_like(x, fill)
    if d < x.shape[1]:
        out[:, d:] = x[:, :-d]
    return out


def _band_enter(band_pen, band_ok):
    """Predecessor max over band slots i = 0..W-1 (the edge p-(W-i) ->
    p: offset descending, source ascending), strict ``>``."""
    W = band_pen.shape[1]
    ok_b = band_ok.bool()

    def enter(osc, ohi, anext):
        worst = torch.full_like(osc, WORST_SCORE)
        es, eh = worst, torch.full_like(ohi, -1)
        eok = torch.zeros_like(anext)
        for i in range(W):
            d = W - i
            ok = ok_b[:, i] & _shift_down(anext, d, False)
            val = torch.where(ok, _shift_down(osc, d, WORST_SCORE)
                              + band_pen[:, i], worst)
            upd = val > es
            es = torch.where(upd, val, es)
            eh = torch.where(upd, _shift_down(ohi, d, -1), eh)
            eok = torch.where(upd, ok, eok)
        return es, eh, eok
    return enter


def _hmm3(score, hist, osc, ohi, s, tprob, active, worst, int_min):
    """_eval_3st_lanes on senone-subtracted scores s [B, P, 3]: hmm.c's
    3-state update with the t2 reuse when the 0->2 skip is absent.
    Returns the new score, hist, out_score, out_hist and each phone's
    best [B, P] (WORST where inactive)."""
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    h0, h1, h2 = hist[..., 0], hist[..., 1], hist[..., 2]
    # state 3 (exit); t2 carries into state 2 when 0->2 is absent
    t1 = s2 + tprob(2, 3)
    t2 = torch.where(tprob(1, 3) > TMAT_WORST, s1 + tprob(1, 3), int_min)
    s3 = torch.maximum(torch.where(t1 > t2, t1, t2), worst)
    do3 = active & (s1 > WORST_SCORE)
    osc = torch.where(do3, s3, osc)
    ohi = torch.where(do3, torch.where(t1 > t2, h2, h1), ohi)
    best = torch.where(do3, s3, worst)
    a0 = s2 + tprob(2, 2)
    a1 = s1 + tprob(1, 2)
    a2 = torch.where(tprob(0, 2) > TMAT_WORST, s0 + tprob(0, 2), t2)
    ns2, nh2 = _sel3(a0, a1, a2, h2, h1, h0, worst)
    b0 = s1 + tprob(1, 1)
    b1 = s0 + tprob(0, 1)
    ns1 = torch.maximum(torch.where(b0 > b1, b0, b1), worst)
    nh1 = torch.where(b0 > b1, h1, h0)
    ns0 = torch.maximum(s0 + tprob(0, 0), worst)
    for v in (ns2, ns1, ns0):
        best = torch.maximum(best, torch.where(active, v, worst))
    act = active[..., None]
    score = torch.where(act, torch.stack([ns0, ns1, ns2], -1), score)
    hist = torch.where(act, torch.stack([h0, nh1, nh2], -1), hist)
    return score, hist, osc, ohi, best


def _sel3(t0, t1, t2, h_self, h_t1, h_t2, worst):
    """C's nested select: if t0 > t1 (t2 > t0 ? t2 : t0) else (t2 > t1 ?
    t2 : t1), strict, with the history of the branch taken."""
    br = t0 > t1
    use2 = torch.where(br, t2 > t0, t2 > t1)
    ns = torch.maximum(torch.where(use2, t2, torch.where(br, t0, t1)), worst)
    nh = torch.where(use2, h_t2, torch.where(br, h_self, h_t1))
    return ns, nh


def _hmm5(score, hist, osc, ohi, s, tprob, active, worst, int_min):
    """_eval_5st on senone-subtracted scores s [B, P, 5]: each 3-way
    select reads its own transition row; the exit (state 5) is written
    where s3 > WORST, state 4 updated where s2 > WORST and state 3 where
    s1 > WORST, else they keep their score and history."""
    sv = [s[..., i] for i in range(5)]
    h = [hist[..., i] for i in range(5)]

    def t(i, j):
        return sv[i] + tprob(i, j)

    x1, x2 = t(4, 5), t(3, 5)
    s5 = torch.maximum(torch.where(x1 > x2, x1, x2), worst)
    do5 = active & (sv[3] > WORST_SCORE)
    osc = torch.where(do5, s5, osc)
    ohi = torch.where(do5, torch.where(x1 > x2, h[4], h[3]), ohi)
    best = torch.where(do5, s5, worst)
    g4 = active & (sv[2] > WORST_SCORE)
    ns4, nh4 = _sel3(t(4, 4), t(3, 4), t(2, 4), h[4], h[3], h[2], worst)
    best = torch.maximum(best, torch.where(g4, ns4, worst))
    g3 = active & (sv[1] > WORST_SCORE)
    ns3, nh3 = _sel3(t(3, 3), t(2, 3), t(1, 3), h[3], h[2], h[1], worst)
    best = torch.maximum(best, torch.where(g3, ns3, worst))
    ns2, nh2 = _sel3(t(2, 2), t(1, 2), t(0, 2), h[2], h[1], h[0], worst)
    b0, b1 = t(1, 1), t(0, 1)
    ns1 = torch.maximum(torch.where(b0 > b1, b0, b1), worst)
    nh1 = torch.where(b0 > b1, h[1], h[0])
    ns0 = torch.maximum(t(0, 0), worst)
    for v in (ns2, ns1, ns0):
        best = torch.maximum(best, torch.where(active, v, worst))
    score = torch.stack([
        torch.where(active, ns0, score[..., 0]),
        torch.where(active, ns1, score[..., 1]),
        torch.where(active, ns2, score[..., 2]),
        torch.where(g3, ns3, score[..., 3]),
        torch.where(g4, ns4, score[..., 4])], -1)
    hist = torch.stack([
        h[0], torch.where(active, nh1, h[1]), torch.where(active, nh2, h[2]),
        torch.where(g3, nh3, h[3]), torch.where(g4, nh4, h[4])], -1)
    return score, hist, osc, ohi, best


def tok_dtype(S: int) -> torch.dtype:
    """The token stack's and path's dtype for S graph states
    (align_jax.py tok_dtype): int16 below 32767, else int32."""
    return torch.int16 if S < 32767 else torch.int32


def _forward_plain(sen, n_frames, tp, astart, aend, entry, enter,
                   with_scores: bool, carry=None, t0: int = 0):
    """The frame recurrence: sen int32 [B, T, S]; tp [P, E, E+1] (shared)
    or [B, P, E, E+1], E = 3 or 5; astart/aend/entry [P] or [B, P];
    ``enter`` the predecessor max; frames t0 .. t0+T-1 from ``carry``
    (score, hist [B, P, E], out_score, out_hist [B, P], best_prev [B])
    or, without one, from the entry scores.  Returns the token stack
    [B, T, S] (int16, or int32 where S >= 32767), the token scores
    (int32, or None) and the carry after the last frame."""
    B, T, S = sen.shape
    E = tp.shape[-2]
    P = S // E
    update = {3: _hmm3, 5: _hmm5}[E]
    dev = sen.device
    i32 = torch.int32

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    def rowwise(x):                                             # [B|1, P]
        return x[None] if x.ndim == 1 else x

    def tprob(i, j):
        return rowwise(-tp[..., i, j])

    worst = torch.tensor(WORST_SCORE, dtype=i32, device=dev)
    int_min = torch.tensor(-2147483648, dtype=i32, device=dev)
    ast, aen = rowwise(astart), rowwise(aend)
    n = n_frames.to(i32)[:, None]                               # [B, 1]
    if carry is None:
        score = full((B, P, E), WORST_SCORE)
        score[:, :, 0] = rowwise(entry)
        hist = full((B, P, E), -1)
        osc = full((B, P), WORST_SCORE)
        ohi = full((B, P), -1)
        best_prev = full((B,), 0)
    else:
        score, hist, osc, ohi, best_prev = (x.to(i32).clone() for x in carry)
    sidx = torch.arange(S, dtype=i32, device=dev).view(1, P, E)
    tok = torch.empty((B, T, S), dtype=tok_dtype(S), device=dev)
    tsc = torch.empty((B, T, S), dtype=i32, device=dev) if with_scores \
        else None
    for c in range(T):
        t = t0 + c
        valid = t < n
        active = (t >= ast) & (t <= aen) & valid                # [B, P]
        renorm = ((best_prev - 0x300000) < WORST_SCORE)[:, None, None]
        score = torch.where(renorm & (score > WORST_SCORE),
                            score - best_prev[:, None, None], score)
        s = score - sen[:, c].view(B, P, E)
        score, hist, osc, ohi, best = update(score, hist, osc, ohi, s, tprob,
                                             active, worst, int_min)
        best = torch.where(active, best, worst).amax(dim=1)     # [B]

        # phone transitions and the enter rule
        nf = t + 1
        es, eh, eok = enter(osc, ohi, active & (nf <= aen))
        eh = torch.where(eok, eh, torch.full_like(eh, -1))
        can = eok & (nf >= ast) & (nf <= aen) & valid
        enter_now = can & (~active | (es > score[..., 0]))
        score[..., 0] = torch.where(enter_now, es, score[..., 0])
        hist[..., 0] = torch.where(enter_now, eh, hist[..., 0])
        rec = (active | enter_now)[..., None]
        tok[:, c] = torch.where(rec, hist, -1).to(tok.dtype).view(B, S)
        if with_scores:
            tsc[:, c] = torch.where(rec, score, -1).view(B, S)
        hist = torch.where(rec, sidx, hist)
        best_prev = best
    return tok, tsc, (score, hist, osc, ohi, best_prev)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along dim 1."""
    n = x.shape[1]
    idx = torch.arange(n, device=x.device)[None]
    return torch.where(x == x.amax(dim=1, keepdim=True), idx, n).amin(1)


def _backtrace_plain(tok, tsc, cur, cur_score, n_frames):
    """backtrace_batch: walk the token stack from the final state ``cur``
    [B]; path int16 [B, T] and, with token scores, the path scores
    int32 [B, T] (starting from ``cur_score``)."""
    B, T, S = tok.shape
    i32 = torch.int32
    rows = torch.arange(B, device=tok.device)
    nn = n_frames.to(i32)
    path = torch.empty((B, T), dtype=i32, device=tok.device)
    pscore = None if tsc is None else torch.empty_like(path)
    for t in range(T - 1, -1, -1):
        inside = (cur >= 0) & (cur < S)
        at = cur.clamp(0, S - 1).long()
        cand = torch.where(inside, tok[rows, t, at].to(i32), MISSING)
        path[:, t] = torch.where(t < nn, cur, -1)
        move = t < nn - 1
        if tsc is not None:
            csc = torch.where(inside, tsc[rows, t, at], MISSING)
            pscore[:, t] = torch.where(t < nn, cur_score, -1)
            cur_score = torch.where(move, csc, cur_score)
        cur = torch.where(move, cand, cur)
    return path.to(tok.dtype), pscore


def viterbi_batch_plain(sen: torch.Tensor, n_frames: torch.Tensor,
                        c: VitConsts, with_scores: bool = False):
    """Plain PyTorch version of K4: sen int32 [B, T, S], n_frames int32
    [B] -> (path [B, T] int16, or int32 where S >= 32767, pscore int32
    [B, T] or None, fscore int32 [B])."""
    tok, tsc, (_, _, osc, ohi, _) = _forward_plain(
        sen, n_frames, c.tp, c.astart, c.aend, c.entry,
        _kslot_enter(c.pred_idx[None], c.pred_pen[None], c.pred_ok[None]),
        with_scores)
    # final-node select: first max over the final nodes
    rows = torch.arange(sen.shape[0], device=sen.device)
    fnode = c.fin.long()[_first_argmax(osc[:, c.fin.long()])]
    fscore = osc[rows, fnode]
    path, pscore = _backtrace_plain(tok, tsc, ohi[rows, fnode], fscore,
                                    n_frames)
    return path, pscore, fscore


def viterbi_rows_plain(sen: torch.Tensor, n_frames: torch.Tensor,
                       c: RowVitConsts, with_scores: bool = False):
    """Plain PyTorch version of K6: sen int32 [B, T, S], n_frames int32
    [B] -> (path [B, T] int16, or int32 where S >= 32767, pscore int32
    [B, T] or None, fscore int32 [B])."""
    if c.band_pen is not None:
        enter = _band_enter(c.band_pen, c.band_ok)
    else:
        enter = _kslot_enter(c.pred_idx, c.pred_pen, c.pred_ok)
    tok, tsc, (_, _, osc, ohi, _) = _forward_plain(
        sen, n_frames, c.tp, c.astart, c.aend, c.entry, enter, with_scores)
    # masked select: first max over node index; a row that reached no
    # final node backtraces from -1
    rows = torch.arange(sen.shape[0], device=sen.device)
    fsc = torch.where(c.final_mask.bool(), osc,
                      torch.full_like(osc, WORST_SCORE))
    node = _first_argmax(fsc)
    fscore = fsc[rows, node]
    fstate = torch.where(fscore > WORST_SCORE, ohi[rows, node],
                         torch.full_like(fscore, -1))
    path, pscore = _backtrace_plain(tok, tsc, fstate, fscore, n_frames)
    return path, pscore, fscore


def vit_carry0(c: VitConsts, n_emit: int | None = None):
    """The Viterbi carry before frame 0 (vit_carry0 with the graph's
    entry scores): score, hist int32 [P, E], out_score, out_hist int32
    [P], best_prev int32 []; E is the graph's unless ``n_emit`` says
    otherwise (the JAX function's own default is 3)."""
    P, dev = c.P, c.tp.device
    E = c.E if n_emit is None else n_emit
    score = torch.full((P, E), WORST_SCORE, dtype=torch.int32, device=dev)
    score[:, 0] = c.entry
    return (score, torch.full((P, E), -1, dtype=torch.int32, device=dev),
            torch.full((P,), WORST_SCORE, dtype=torch.int32, device=dev),
            torch.full((P,), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def viterbi_chunk_plain(sen: torch.Tensor, carry: tuple, t0: int, n: int,
                        c: VitConsts):
    """Plain PyTorch version of K4's carry form: sen int32 [C, S],
    frames t0 .. t0+C-1 of an utterance of n frames -> (new carry, tok
    [C, S] int16, or int32 where S >= 32767)."""
    tok, _, new = _forward_plain(
        sen[None], torch.tensor([n], dtype=torch.int32, device=sen.device),
        c.tp, c.astart, c.aend, None,
        _argmax_enter(c.pred_idx, c.pred_pen, c.pred_ok), False,
        carry=tuple(x[None] for x in carry), t0=t0)
    return tuple(x[0] for x in new), tok[0]


def _backtrace_single(tok: np.ndarray, cur: int, n: int) -> np.ndarray:
    """align_jax.py backtrace over tok [T, S]: path int32 [T], -1 at and
    after n; the lookup wraps a negative state and clamps, as jnp
    indexing does."""
    T, S = tok.shape
    path = np.empty(T, np.int32)
    for t in range(T - 1, -1, -1):
        path[t] = cur if t < n else -1
        if t < n - 1:
            cur = int(tok[t, min(max(cur + S if cur < 0 else cur, 0), S - 1)])
    return path


def backtrace_chunk_plain(tok: torch.Tensor, start: torch.Tensor, t0: int,
                          n_frames: torch.Tensor):
    """Plain PyTorch version of K13: tok int16/int32 [R, C, S] (frames
    t0 .. t0+C-1 of R rows), start int32 [R] the state entering from the
    next chunk, n_frames int32 [R] -> (path int32 [R, C], the state
    leaving the chunk int32 [R]), _backtrace_single's rule per row."""
    R, C, S = tok.shape
    rows = torch.arange(R, device=tok.device)
    n = n_frames.to(torch.int32)
    cid = start.to(torch.int32).clone()
    path = torch.empty((R, C), dtype=torch.int32, device=tok.device)
    for c in range(C - 1, -1, -1):
        t = t0 + c
        path[:, c] = torch.where(t < n, cid, -1)
        at = torch.where(cid < 0, cid + S, cid).clamp(0, S - 1).long()
        cid = torch.where(t < n - 1, tok[rows, c, at].to(torch.int32), cid)
    return path, cid


def backtrace_chunk(tok: torch.Tensor, start: torch.Tensor, t0: int,
                    n_frames: torch.Tensor):
    """K13: the backtrace over one chunk of token stacks (the long form's
    reverse pass, parallel/seqpipe.py): tok int16/int32 [R, C, S], start
    int32 [R], the chunk's first frame t0, n_frames int32 [R] -> (path
    int32 [R, C], the state leaving the chunk int32 [R])."""
    if tok.device.type == "cpu":
        return backtrace_chunk_plain(tok, start, t0, n_frames)
    if tok.device.type != "cuda":
        raise ValueError(f"backtrace_chunk: unsupported device {tok.device}")
    if tok.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"backtrace_chunk: token dtype {tok.dtype}")
    R, C, S = tok.shape
    dev = tok.device
    ck = cuda_build.check_tensor
    ck(tok, tok.dtype, "tok")
    ck(start, torch.int32, "start", dev)
    ck(n_frames, torch.int32, "n_frames", dev)
    if start.shape != (R,) or n_frames.shape != (R,):
        raise ValueError(f"backtrace_chunk: start {tuple(start.shape)} and "
                         f"n_frames {tuple(n_frames.shape)} for {R} rows")
    path = torch.empty((R, C), dtype=torch.int32, device=dev)
    out = torch.empty(R, dtype=torch.int32, device=dev)
    err = cuda_build.lib().sst_backtrace_chunk(
        tok.data_ptr(), tok.element_size(), start.data_ptr(),
        n_frames.data_ptr(), path.data_ptr(), out.data_ptr(), R, C, S,
        int(t0), cuda_build.stream(tok))
    cuda_build.check(err, "backtrace_chunk")
    form = "int32" if tok.dtype == torch.int32 else "int16"
    backtrace_chunk.launches += 1
    backtrace_chunk.forms[form] = backtrace_chunk.forms.get(form, 0) + 1
    return path, out


backtrace_chunk.launches = 0
backtrace_chunk.forms = {}


def viterbi_single_plain(sen: torch.Tensor, n: int, c: VitConsts):
    """Plain PyTorch version of viterbi_single: sen int32 [T, S] ->
    (path int32 [T], final score int32 [])."""
    (_, _, osc, ohi, _), tok = viterbi_chunk_plain(sen, vit_carry0(c), 0, n,
                                                   c)
    fin = c.fin.long()
    fnode = fin[_first_argmax(osc[fin][None])[0]]
    path = _backtrace_single(tok.cpu().numpy(), int(ohi[fnode]), n)
    return torch.from_numpy(path).to(sen.device), osc[fnode].clone()


# -- kernels -----------------------------------------------------------------

def _check_viterbi_shape(name: str, sen: torch.Tensor, P: int,
                         E: int) -> None:
    S = sen.shape[-1]
    if S != E * P:
        raise ValueError(f"{name}: S={S} for P={P} phones of {E} states")
    if sen.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {sen.device}")


def _count(fn, E: int, dt, state, with_scores: bool) -> None:
    """One launch of fn's kernel: its count, and the count of its form
    in ``fn.forms``, named "3-state" or "5-state", then ", int32" (token
    stacks), ", global" (the state's layout) and ", scores" where they
    apply."""
    form = (f"{E}-state" + (", int32" if dt == torch.int32 else "")
            + (", global" if state is not None else "")
            + (", scores" if with_scores else ""))
    fn.launches += 1
    fn.forms[form] = fn.forms.get(form, 0) + 1


def state_scratch(lib, P: int, E: int, rows: int, dev):
    """The global-state layout's scratch (``rows`` rows of P phones of E
    states) where the state does not fit a block's shared memory, else
    None: the shared-memory layout, the fast path."""
    if lib.sst_viterbi_smem_bytes(P, E) <= MAX_SMEM_BYTES:
        return None
    return torch.empty(rows * lib.sst_viterbi_state_bytes(P, E),
                       dtype=torch.uint8, device=dev)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def viterbi_batch(sen: torch.Tensor, n_frames: torch.Tensor, c: VitConsts,
                  with_scores: bool = False):
    """K4: sen int32 [B, T, S], n_frames int32 [B] -> (path [B, T] int16,
    or int32 where S >= 32767, pscore int32 [B, T] or None, fscore int32
    [B])."""
    _check_viterbi_shape("viterbi_batch", sen, c.P, c.E)
    if sen.device.type == "cpu":
        return viterbi_batch_plain(sen, n_frames, c, with_scores)
    B, T, S = sen.shape
    lib = cuda_build.lib()
    dev = sen.device
    ck = cuda_build.check_tensor
    ck(sen, torch.int32, "sen")
    ck(n_frames, torch.int32, "n_frames", dev)
    for name in ("tp", "pred_idx", "pred_pen", "astart", "aend", "entry",
                 "fin"):
        ck(getattr(c, name), torch.int32, name, dev)
    ck(c.pred_ok, torch.uint8, "pred_ok", dev)
    dt = tok_dtype(S)
    tok = torch.empty((B, T, S), dtype=dt, device=dev)
    path = torch.empty((B, T), dtype=dt, device=dev)
    fscore = torch.empty(B, dtype=torch.int32, device=dev)
    tsc = pscore = None
    if with_scores:
        tsc = torch.empty((B, T, S), dtype=torch.int32, device=dev)
        pscore = torch.empty((B, T), dtype=torch.int32, device=dev)
    gstate = state_scratch(lib, c.P, c.E, B, dev)
    err = lib.sst_viterbi_batch(
        sen.data_ptr(), n_frames.data_ptr(), c.tp.data_ptr(),
        c.pred_idx.data_ptr(), c.pred_pen.data_ptr(), c.pred_ok.data_ptr(),
        c.astart.data_ptr(), c.aend.data_ptr(), c.entry.data_ptr(),
        c.fin.data_ptr(), B, T, c.P, c.E, c.pred_idx.shape[1],
        c.fin.shape[0], tok.data_ptr(), tok.element_size(), _ptr(tsc),
        path.data_ptr(), _ptr(pscore), fscore.data_ptr(), _ptr(gstate),
        cuda_build.stream(sen))
    cuda_build.check(err, "viterbi_batch")
    _count(viterbi_batch, c.E, dt, gstate, with_scores)
    return path, pscore, fscore


viterbi_batch.launches = 0
viterbi_batch.forms = {}


def viterbi_rows(sen: torch.Tensor, n_frames: torch.Tensor,
                 c: RowVitConsts, with_scores: bool = False):
    """K6: sen int32 [B, T, S], n_frames int32 [B], a graph per row ->
    (path [B, T] int16, or int32 where S >= 32767, pscore int32 [B, T]
    or None, fscore int32 [B])."""
    _check_viterbi_shape("viterbi_rows", sen, c.P, c.E)
    B, T, S = sen.shape
    if c.tp.shape[0] != B:
        raise ValueError(f"viterbi_rows: {c.tp.shape[0]} graphs for "
                         f"{B} rows")
    if sen.device.type == "cpu":
        return viterbi_rows_plain(sen, n_frames, c, with_scores)
    lib = cuda_build.lib()
    dev = sen.device
    ck = cuda_build.check_tensor
    ck(sen, torch.int32, "sen")
    ck(n_frames, torch.int32, "n_frames", dev)
    for name in ("tp", "pred_idx", "pred_pen", "astart", "aend", "entry"):
        ck(getattr(c, name), torch.int32, name, dev)
    ck(c.pred_ok, torch.uint8, "pred_ok", dev)
    ck(c.final_mask, torch.uint8, "final_mask", dev)
    W = 0
    if c.band_pen is not None:
        ck(c.band_pen, torch.int32, "band_pen", dev)
        ck(c.band_ok, torch.uint8, "band_ok", dev)
        W = c.band_pen.shape[1]
    dt = tok_dtype(S)
    tok = torch.empty((B, T, S), dtype=dt, device=dev)
    path = torch.empty((B, T), dtype=dt, device=dev)
    fscore = torch.empty(B, dtype=torch.int32, device=dev)
    tsc = pscore = None
    if with_scores:
        tsc = torch.empty((B, T, S), dtype=torch.int32, device=dev)
        pscore = torch.empty((B, T), dtype=torch.int32, device=dev)
    gstate = state_scratch(lib, c.P, c.E, B, dev)
    err = lib.sst_viterbi_rows(
        sen.data_ptr(), n_frames.data_ptr(), c.tp.data_ptr(),
        c.pred_idx.data_ptr(), c.pred_pen.data_ptr(), c.pred_ok.data_ptr(),
        _ptr(c.band_pen), _ptr(c.band_ok), c.astart.data_ptr(),
        c.aend.data_ptr(), c.entry.data_ptr(), c.final_mask.data_ptr(), B, T,
        c.P, c.E, c.pred_idx.shape[2], W, tok.data_ptr(), tok.element_size(),
        _ptr(tsc), path.data_ptr(), _ptr(pscore), fscore.data_ptr(),
        _ptr(gstate), cuda_build.stream(sen))
    cuda_build.check(err, "viterbi_rows")
    _count(viterbi_rows, c.E, dt, gstate, with_scores)
    return path, pscore, fscore


viterbi_rows.launches = 0
viterbi_rows.forms = {}


def _launch_chunk(sen, carry, t0: int, n: int, c: VitConsts, fin):
    """One launch of K4's carry form (see sst_viterbi_chunk); the carry
    tensors are copies, written in place by the kernel."""
    _check_viterbi_shape("viterbi_chunk", sen, c.P, c.E)
    C, S = sen.shape
    lib = cuda_build.lib()
    dev = sen.device
    ck = cuda_build.check_tensor
    ck(sen, torch.int32, "sen")
    for name in ("tp", "pred_idx", "pred_pen", "astart", "aend", "fin"):
        ck(getattr(c, name), torch.int32, name, dev)
    ck(c.pred_ok, torch.uint8, "pred_ok", dev)
    new = tuple(x.to(device=dev, dtype=torch.int32).contiguous().clone()
                for x in carry)
    dt = tok_dtype(S)
    tok = torch.empty((C, S), dtype=dt, device=dev)
    path = fscore = None
    if fin is not None:
        path = torch.empty(C, dtype=torch.int32, device=dev)
        fscore = torch.empty((), dtype=torch.int32, device=dev)
    # the global layout runs on the carry in place, with an active_next
    anext = None
    if lib.sst_viterbi_smem_bytes(c.P, c.E) > MAX_SMEM_BYTES:
        anext = torch.empty(c.P, dtype=torch.uint8, device=dev)
    err = lib.sst_viterbi_chunk(
        sen.data_ptr(), int(t0), int(n), c.tp.data_ptr(),
        c.pred_idx.data_ptr(), c.pred_pen.data_ptr(), c.pred_ok.data_ptr(),
        c.astart.data_ptr(), c.aend.data_ptr(), *(x.data_ptr() for x in new),
        C, c.P, c.E, c.pred_idx.shape[1], tok.data_ptr(), tok.element_size(),
        _ptr(fin), 0 if fin is None else fin.shape[0], _ptr(path),
        _ptr(fscore), _ptr(anext), cuda_build.stream(sen))
    cuda_build.check(err, "viterbi_chunk")
    _count(viterbi_chunk, c.E, dt, anext, False)
    return new, tok, path, fscore


def viterbi_chunk(sen: torch.Tensor, carry: tuple, t0: int, n: int,
                  c: VitConsts):
    """K4's carry form: sen int32 [C, S], the carry before frame t0, the
    utterance's frame count n (frames >= n are padding) -> (carry after
    frame t0+C-1, tok [C, S] int16, or int32 where S >= 32767)."""
    _check_carry(carry, c)
    if sen.device.type == "cpu":
        return viterbi_chunk_plain(sen, carry, t0, n, c)
    if sen.device.type != "cuda":
        raise ValueError(f"viterbi_chunk: unsupported device {sen.device}")
    new, tok, _, _ = _launch_chunk(sen, carry, t0, n, c, None)
    return new, tok


def _check_carry(carry: tuple, c: VitConsts) -> None:
    """The carry must have the shapes of the carry the chunk returns, as
    the JAX scan requires of its carry (TypeError there too)."""
    shapes = ((c.P, c.E), (c.P, c.E), (c.P,), (c.P,), ())
    got = tuple(tuple(x.shape) for x in carry)
    if got != shapes:
        raise TypeError(f"viterbi_chunk: carry shapes {list(got)}, the "
                        f"chunk's {list(shapes)}")


viterbi_chunk.launches = 0
viterbi_chunk.forms = {}


def viterbi_single(sen: torch.Tensor, n: int, c: VitConsts):
    """One utterance through K4's carry form from vit_carry0, with the
    final-node select and backtrace in the same launch: sen int32 [T, S]
    -> (path int32 [T], final score int32 [])."""
    if sen.device.type == "cpu":
        return viterbi_single_plain(sen, n, c)
    if sen.device.type != "cuda":
        raise ValueError(f"viterbi_single: unsupported device {sen.device}")
    _, _, path, fscore = _launch_chunk(sen, vit_carry0(c), 0, n, c, c.fin)
    return path, fscore
