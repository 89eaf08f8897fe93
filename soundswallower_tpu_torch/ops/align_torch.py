"""Shared-graph batch Viterbi, final-node select and backtrace (kernel K4).

Port of ``soundswallower_tpu/ops/align_jax.py`` align_viterbi_batch
(make_vit_step_lanes, _eval_3st_lanes, vit_carry0_lanes) and
backtrace_batch, with the final-node select of
``soundswallower_tpu/aligner.py`` _vit_full.run: graph-state scores
[B, T, S=P*3] int32 in, the decoded state path [B, T] int16 and the
final score [B] int32 out.

Per frame, as the JAX step: the renormalization rule
(state_align_search.c:193-197) per row, hmm.c's 3-state update with the
t2 reuse when the 0->2 skip is absent, the best score over active
phones, K predecessor slots in edge order with a strict ``>``, the enter
rule, and the int16 token record.  After the last frame: the first max
over the final nodes, then the backtrace.  A row whose final state is
negative (no final node reached) gets the path values of the JAX
program: its masked lookup yields -2^30, which int16 holds as 0, and
``path[n-1] < 0`` is what extraction reads.

The 3-state topology and S < 32767 (int16 token stacks) only; the
5-state branch and int32 stacks are still to be ported (ROADMAP.md B4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import cuda_build, to_device

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


@dataclass(eq=False)
class VitConsts:
    """Device constants of one graph's Viterbi."""

    tp: torch.Tensor         # int32 [P, 3, 4] quantized negated tmat
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


def graph_consts_from_numpy(c: dict, device="cpu") -> VitConsts:
    """VitConsts from host arrays under the keys of the JAX aligner's
    ``_graph_consts`` dict (tp, pi, pp, pk, ast, aen, entry, fin)."""
    def dev(a, dtype):
        return to_device(a, dtype, device)

    tp = np.asarray(c["tp"])
    if tp.shape[1:] != (3, 4):
        raise NotImplementedError(
            "only 3-state HMMs are ported (ROADMAP.md B4: 5-state branch)")
    return VitConsts(
        tp=dev(tp, np.int32), pred_idx=dev(c["pi"], np.int32),
        pred_pen=dev(c["pp"], np.int32), pred_ok=dev(c["pk"], np.uint8),
        astart=dev(c["ast"], np.int32), aend=dev(c["aen"], np.int32),
        entry=dev(c["entry"], np.int32), fin=dev(c["fin"], np.int32))


def viterbi_batch_plain(sen: torch.Tensor, n_frames: torch.Tensor,
                        c: VitConsts):
    """Plain PyTorch version of K4: sen int32 [B, T, S], n_frames int32
    [B] -> (path int16 [B, T], fscore int32 [B])."""
    B, T, S = sen.shape
    P = S // 3
    dev = sen.device
    i32 = torch.int32

    def full(shape, v):
        return torch.full(shape, v, dtype=i32, device=dev)

    worst = torch.tensor(WORST_SCORE, dtype=i32, device=dev)
    int_min = torch.tensor(-2147483648, dtype=i32, device=dev)
    tp = c.tp

    def tprob(i, j):
        return -tp[:, i, j][None]                               # [1, P]

    ast, aen = c.astart[None], c.aend[None]
    pred_ok = c.pred_ok.bool()
    n = n_frames.to(i32)[:, None]                               # [B, 1]
    score = full((B, P, 3), WORST_SCORE)
    score[:, :, 0] = c.entry[None]
    hist = full((B, P, 3), -1)
    osc = full((B, P), WORST_SCORE)
    ohi = full((B, P), -1)
    best_prev = full((B,), 0)
    sidx = torch.arange(S, dtype=i32, device=dev).view(1, P, 3)
    tok = torch.empty((B, T, S), dtype=torch.int16, device=dev)
    for t in range(T):
        valid = t < n
        active = (t >= ast) & (t <= aen) & valid                # [B, P]
        renorm = ((best_prev - 0x300000) < WORST_SCORE)[:, None, None]
        score = torch.where(renorm & (score > WORST_SCORE),
                            score - best_prev[:, None, None], score)
        sen_t = sen[:, t].view(B, P, 3)
        s0 = score[..., 0] - sen_t[..., 0]
        s1 = score[..., 1] - sen_t[..., 1]
        s2 = score[..., 2] - sen_t[..., 2]
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
        br = a0 > a1
        use2 = torch.where(br, a2 > a0, a2 > a1)
        ns2 = torch.maximum(torch.where(use2, a2, torch.where(br, a0, a1)),
                            worst)
        nh2 = torch.where(use2, h0, torch.where(br, h2, h1))
        b0 = s1 + tprob(1, 1)
        b1 = s0 + tprob(0, 1)
        ns1 = torch.maximum(torch.where(b0 > b1, b0, b1), worst)
        nh1 = torch.where(b0 > b1, h1, h0)
        ns0 = torch.maximum(s0 + tprob(0, 0), worst)
        for v in (ns2, ns1, ns0):
            best = torch.maximum(best, torch.where(active, v, worst))
        act3 = active[..., None]
        score = torch.where(act3, torch.stack([ns0, ns1, ns2], -1), score)
        hist = torch.where(act3, torch.stack([h0, nh1, nh2], -1), hist)
        best = torch.where(active, best, worst).amax(dim=1)     # [B]

        # phone transitions: K slots in edge order, strict > (first wins)
        nf = t + 1
        active_next = active & (nf <= aen)
        es = full((B, P), WORST_SCORE)
        eh = full((B, P), -1)
        eok = torch.zeros((B, P), dtype=torch.bool, device=dev)
        for k in range(c.pred_idx.shape[1]):
            src = c.pred_idx[:, k].long()
            ok_k = pred_ok[:, k][None] & active_next[:, src]
            val_k = torch.where(ok_k, osc[:, src] + c.pred_pen[:, k][None],
                                worst)
            upd = val_k > es
            es = torch.where(upd, val_k, es)
            eh = torch.where(upd, ohi[:, src], eh)
            eok = torch.where(upd, ok_k, eok)
        eh = torch.where(eok, eh, torch.full_like(eh, -1))
        can = eok & (nf >= ast) & (nf <= aen) & valid
        enter = can & (~active | (es > score[..., 0]))
        score[..., 0] = torch.where(enter, es, score[..., 0])
        hist[..., 0] = torch.where(enter, eh, hist[..., 0])
        rec = (active | enter)[..., None]
        tok[:, t] = torch.where(rec, hist, -1).to(torch.int16).view(B, S)
        hist = torch.where(rec, sidx, hist)
        best_prev = best

    # final-node select: first max over the final nodes
    rows = torch.arange(B, device=dev)
    fsc = osc[:, c.fin.long()]                                  # [B, F]
    nfin = fsc.shape[1]
    first = torch.where(fsc == fsc.amax(dim=1, keepdim=True),
                        torch.arange(nfin, device=dev)[None], nfin).amin(1)
    fnode = c.fin.long()[first]
    fscore = osc[rows, fnode]
    cur = ohi[rows, fnode]
    # backtrace (backtrace_batch)
    nn = n_frames.to(i32)
    path = torch.empty((B, T), dtype=i32, device=dev)
    for t in range(T - 1, -1, -1):
        inside = (cur >= 0) & (cur < S)
        cand = torch.where(inside, tok[rows, t, cur.clamp(0, S - 1).long()]
                           .to(i32), MISSING)
        path[:, t] = torch.where(t < nn, cur, -1)
        cur = torch.where(t < nn - 1, cand, cur)
    return path.to(torch.int16), fscore


def viterbi_batch(sen: torch.Tensor, n_frames: torch.Tensor, c: VitConsts):
    """K4: sen int32 [B, T, S], n_frames int32 [B] -> (path int16
    [B, T], fscore int32 [B])."""
    B, T, S = sen.shape
    if S != 3 * c.P:
        raise ValueError(f"viterbi_batch: S={S} for P={c.P} 3-state phones")
    if S >= 32767:
        raise NotImplementedError(
            "S >= 32767 needs int32 token stacks (ROADMAP.md B4)")
    if sen.device.type == "cpu":
        return viterbi_batch_plain(sen, n_frames, c)
    if sen.device.type != "cuda":
        raise ValueError(f"viterbi_batch: unsupported device {sen.device}")
    lib = cuda_build.lib()
    need = lib.sst_viterbi_smem_bytes(c.P)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"viterbi_batch: P={c.P} phones need {need} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    dev = sen.device
    ck = cuda_build.check_tensor
    ck(sen, torch.int32, "sen")
    ck(n_frames, torch.int32, "n_frames", dev)
    for name in ("tp", "pred_idx", "pred_pen", "astart", "aend", "entry",
                 "fin"):
        ck(getattr(c, name), torch.int32, name, dev)
    ck(c.pred_ok, torch.uint8, "pred_ok", dev)
    tok = torch.empty((B, T, S), dtype=torch.int16, device=dev)
    path = torch.empty((B, T), dtype=torch.int16, device=dev)
    fscore = torch.empty(B, dtype=torch.int32, device=dev)
    err = lib.sst_viterbi_batch(
        sen.data_ptr(), n_frames.data_ptr(), c.tp.data_ptr(),
        c.pred_idx.data_ptr(), c.pred_pen.data_ptr(), c.pred_ok.data_ptr(),
        c.astart.data_ptr(), c.aend.data_ptr(), c.entry.data_ptr(),
        c.fin.data_ptr(), B, T, c.P, c.pred_idx.shape[1], c.fin.shape[0],
        tok.data_ptr(), path.data_ptr(), fscore.data_ptr(),
        cuda_build.stream(sen))
    cuda_build.check(err, "viterbi_batch")
    viterbi_batch.launches += 1
    return path, fscore


viterbi_batch.launches = 0
