"""Frozen copy of ``soundswallower_tpu_torch/ops/align_torch.py``
for the benchmark's reference (see ``__init__``).

Viterbi, final-node select and backtrace (kernels K4 and K6).

Port of ``soundswallower_tpu/ops/align_jax.py`` align_viterbi_batch
(make_vit_step_lanes, _eval_3st_lanes, _eval_5st, vit_carry0_lanes) and
backtrace_batch, in its two graph forms:

* K4 ``viterbi_batch``: one graph shared by the batch, with the
  final-node select of ``soundswallower_tpu/aligner.py`` _vit_full.run
  and, under ``with_scores``, the token-score stack and path scores;
* K6 ``viterbi_rows``: a graph per row (``stack_graphs``), with the
  masked select of _vit_full_mg.run, the banded predecessor form and,
  under ``with_scores``, the token-score stack and path scores; it
  loops over each phone's real predecessors only, from the K-slot
  tables up to ``pred_n`` or from the band's ``band_lists``, and holds
  a row in one block or, past what one block holds at two phones a
  thread, in a thread-block cluster of up to 16 blocks
  (``rows_layout``);

and of the single-utterance programs (make_vit_step, vit_carry0,
align_viterbi, backtrace), as K4's carry form, one launch over R rows:

* ``viterbi_chunk_rows``: frames t0 .. t0+C-1 of R utterances, each
  from its carry (score, hist [R, P, E], out_score, out_hist [R, P],
  best_prev [R]) to the next, tokens [R, C, S] (a rank's chunk of all
  rows of the long form's ring, parallel/seqpipe.py);
* ``viterbi_chunk``: the same for one utterance, tokens [C, S]
  (AlignStream's 128-frame chunks);
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

K4 and its carry form keep a row's Viterbi state in shared memory while
it fits a block's (``sst_viterbi_smem_bytes(P, E)`` <= 232,448 bytes:
7,040 phones of 3 states, 4,741 of 5) and in a global scratch beyond
that (``state_scratch``); K6 spreads it over a cluster's shared
memories first, and keeps it in global memory only past a cluster of
16 blocks or where one block is asked for.  Every layout gives the same
bits.  K4 and its carry
form loop over each phone's real predecessor slots only (``pred_n``, a
prefix of the K padded ones: ``pred_count``); their launchers choose
how a frame reads its constants and scores from the graph's size
(viterbi.cu), which changes no bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .utils import to_device
from .align_graph import pad_graph_to

WORST_SCORE = -0x20000000
TMAT_WORST = -255
MISSING = -(1 << 30)         # backtrace_batch's masked-max floor


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


def pred_count(pred_ok) -> np.ndarray:
    """Each phone's in-degree, int32 [P], from pred_ok [P, K] (numpy or
    tensor): the number of its real slots, which must be slots 0 ..
    n-1, as build_pred_table fills them; raises ValueError where a real
    slot follows a padded one.  K4 and its carry form loop over these."""
    ok = np.asarray(pred_ok.cpu() if isinstance(pred_ok, torch.Tensor)
                    else pred_ok).astype(bool)
    n = ok.sum(axis=-1)
    prefix = np.arange(ok.shape[-1]) < n[..., None]
    if not np.array_equal(ok, prefix):
        bad = np.argwhere((ok != prefix).any(axis=-1))   # [row,] phone
        bad = bad[:, 0] if bad.shape[1] == 1 else bad
        raise ValueError(f"the real predecessor slots of phones "
                         f"{bad[:8].tolist()} are not a prefix of their "
                         f"{ok.shape[-1]} slots")
    return n.astype(np.int32)


def band_lists(band_pen: torch.Tensor, band_ok: torch.Tensor):
    """The band form's predecessors as per-row lists, for K6's bounded
    loop: for each row and phone p, the band slots i with band_ok whose
    source p-(W-i) is a phone, in i order (offset descending, source
    ascending, the order the band form weighs them in; not pred_idx's
    edge order, which breaks ties differently).  band_pen int32 /
    band_ok [B, W, P], on any device, the lists built there (no host
    round trip) -> (src, pen int32 [B, P, W], n int32 [B, P]), the slots
    past n zero.  Exact under the strict ``>``: a slot without band_ok
    has the value WORST_SCORE, which never wins."""
    B, W, P = band_ok.shape
    dev = band_ok.device
    i = torch.arange(W, device=dev)
    src = torch.arange(P, device=dev)[:, None] - (W - i)           # [P, W]
    ok = band_ok.permute(0, 2, 1).bool() & (src >= 0)              # [B, P, W]
    # the listed slots first, each part in i order (the keys are distinct)
    order = torch.where(ok, i, i + W).argsort(dim=-1)
    n = ok.sum(dim=-1, dtype=torch.int32)
    keep = i < n[..., None]
    lsrc = src.expand(B, P, W).gather(-1, order)
    lpen = band_pen.permute(0, 2, 1).gather(-1, order)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(keep, lsrc.int(), zero).contiguous(),
            torch.where(keep, lpen.int(), zero).contiguous(), n)


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
    """Device constants of one graph's Viterbi (K4), with slot-major
    copies of the tmat rows and predecessor slots (tp_t [E*(E+1), P],
    pred_idx_t/pred_pen_t [K, P]) for the kernels where they read a
    phone's constants at every frame, built once per graph."""

    tp: torch.Tensor         # int32 [P, E, E+1] quantized negated tmat
    pred_idx: torch.Tensor   # int32 [P, K]
    pred_pen: torch.Tensor   # int32 [P, K]
    pred_ok: torch.Tensor    # uint8 [P, K]
    pred_n: torch.Tensor     # int32 [P] real slots a phone (pred_count)
    astart: torch.Tensor     # int32 [P]
    aend: torch.Tensor       # int32 [P]
    entry: torch.Tensor      # int32 [P] entry score, WORST_SCORE if none
    fin: torch.Tensor        # int32 [n_fin] final nodes
    tp_t: torch.Tensor = field(init=False)
    pred_idx_t: torch.Tensor = field(init=False)
    pred_pen_t: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.tp_t = self.tp.reshape(self.tp.shape[0], -1).t().contiguous()
        self.pred_idx_t = self.pred_idx.t().contiguous()
        self.pred_pen_t = self.pred_pen.t().contiguous()

    def kernel_tables(self) -> list:
        """Pointers to the tables in the kernels' order: tp, pred_idx,
        pred_pen, then their slot-major copies."""
        return [getattr(self, name).data_ptr() for name in VIT_TABLES]

    @property
    def P(self) -> int:
        return self.tp.shape[0]

    @property
    def E(self) -> int:
        return self.tp.shape[1]


@dataclass(eq=False)
class RowVitConsts:
    """Device constants of a stacked batch of graphs, one per row (K6):
    the stack, each phone's in-degree (pred_n) and, with a band, its
    band slots as lists (band_lists); K6 loops over the lists of its
    form, the plain version over the dense tables."""

    tp: torch.Tensor         # int32 [B, P, E, E+1]
    pred_idx: torch.Tensor   # int32 [B, P, K]
    pred_pen: torch.Tensor   # int32 [B, P, K]
    pred_ok: torch.Tensor    # uint8 [B, P, K]
    pred_n: torch.Tensor     # int32 [B, P] real slots a phone (pred_count)
    astart: torch.Tensor     # int32 [B, P]
    aend: torch.Tensor       # int32 [B, P]
    entry: torch.Tensor      # int32 [B, P]
    final_mask: torch.Tensor  # uint8 [B, P]
    band_pen: torch.Tensor | None = None  # int32 [B, W, P]
    band_ok: torch.Tensor | None = None   # uint8 [B, W, P]
    band_src: torch.Tensor | None = None  # int32 [B, P, W] band_lists
    band_pen_c: torch.Tensor | None = None  # int32 [B, P, W]
    band_n: torch.Tensor | None = None    # int32 [B, P]

    @property
    def P(self) -> int:
        return self.tp.shape[1]

    @property
    def E(self) -> int:
        return self.tp.shape[2]

    def lists(self) -> tuple:
        """What K6 loops over: (form, src, pen, n), the band lists where
        the stack has a band, else the K-slot tables and pred_n."""
        if self.band_pen is not None:
            return "band", self.band_src, self.band_pen_c, self.band_n
        return "K-slot", self.pred_idx, self.pred_pen, self.pred_n


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
        pred_n=dev(pred_count(c["pk"]), np.int32),
        astart=dev(c["ast"], np.int32), aend=dev(c["aen"], np.int32),
        entry=dev(c["entry"], np.int32), fin=dev(c["fin"], np.int32))


def row_consts_from_numpy(st: dict, device="cpu") -> RowVitConsts:
    """RowVitConsts from host arrays under the keys of ``stack_graphs``
    (the port's or the JAX package's, or the JAX aligner's
    ``_stacked_graphs`` read as numpy), with pred_n (pred_count per row)
    and, where the dict has a band, band_lists; no band when it has
    none."""
    def dev(a, dtype):
        return to_device(a, dtype, device)

    _check_topology(st["tp"])
    band = {}
    if st.get("band_pen") is not None:
        band = dict(band_pen=dev(st["band_pen"], np.int32),
                    band_ok=dev(st["band_ok"], np.uint8))
        band.update(zip(("band_src", "band_pen_c", "band_n"),
                        band_lists(band["band_pen"], band["band_ok"])))
    return RowVitConsts(
        tp=dev(st["tp"], np.int32), pred_idx=dev(st["pred_idx"], np.int32),
        pred_pen=dev(st["pred_pen"], np.int32),
        pred_ok=dev(st["pred_ok"], np.uint8),
        pred_n=dev(pred_count(st["pred_ok"]), np.int32),
        astart=dev(st["astart"], np.int32), aend=dev(st["aend"], np.int32),
        entry=dev(st["entry"], np.int32),
        final_mask=dev(st["final_mask"], np.uint8), **band)


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



def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along dim 1."""
    n = x.shape[1]
    idx = torch.arange(n, device=x.device)[None]
    return torch.where(x == x.amax(dim=1, keepdim=True), idx, n).amin(1)






