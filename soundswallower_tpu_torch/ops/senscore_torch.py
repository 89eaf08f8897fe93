"""Graph-restricted senone scoring (kernels K2 and K3).

Port of the graph-restricted scorer of
``soundswallower_tpu/ops/senscore_jax.py`` (GraphScorer,
_dist_stage_graph, _topn_sen_stage_graph, score_frames_graph): distances
and top-N only for the codebooks a graph uses, mixture evaluation only
for its S = P*3 states, scores in graph-state order, not 0-normalized.

* K2 ``dist_topn_norm``: the float32 Mahalanobis fold
  ``d = det - sum_l (x_l - mu_l)^2 * var_l`` in dim order, truncation to
  int32 with an INT_MIN clamp, the top N of D densities (lowest index on
  ties, distinct indices even at the clamp), then codebook_norm: ``>>
  SENSCR_SHIFT``, the max over codebooks of each stream's top score,
  negated and clamped to 96.
* K3 ``senone_eval``: per (frame, state) the sum over streams of the
  8-bit log-add over j of ``mixw[f, cw_j, s] + s_j`` (``& 0xFF`` for the
  semi 4-bit quirk).  mixw is gathered directly from [F, D, S] uint8 and
  the log-add reads the 8-bit table, which equals the JAX package's
  staircase.

Two TPU devices of the JAX scorer are gone: the bf16 one-hot ``wsel``
matmul (a direct gather here) and the duplicate codebook row at
``Cu % 8 == 0`` (it dodged a slow top_k lowering; a duplicate row cannot
change the cross-codebook max).

The plain versions use no ``torch.topk`` (its tie order is unspecified),
no matmul and no ``torch.sum``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._shared import load
from ..utils import cuda_build, to_device

SENSCR_SHIFT = load("logmath").SENSCR_SHIFT
MAX_NEG_ASCR = 96
INT_MIN = -2147483648


@dataclass(eq=False)
class GraphScorer:
    """Device tables of one graph's restricted scorer."""

    means: torch.Tensor      # f32 [Cu, F, D, L] used-codebook rows
    var_t: torch.Tensor      # f32 [Cu, F, D, L]
    det: torch.Tensor        # f32 [Cu, F, D]
    mixw: torch.Tensor       # uint8 [F, D, S] mixture weights per state
    cb_pos: torch.Tensor     # int32 [S] graph state -> used-codebook row
    logadd: torch.Tensor     # int32 [n] 8-bit log-add table
    topn: int = 4
    wrap_u8: bool = False

    @property
    def S(self) -> int:
        return self.cb_pos.shape[0]

    @classmethod
    def build(cls, am, senid_flat: np.ndarray, device) -> "GraphScorer":
        """Host selection of GraphScorer.build (senscore_jax.py): the
        used codebooks, each state's codebook row, and the states'
        mixture weights.  ``am`` is the shared AcousticModel."""
        if am.backend == "ms":
            raise NotImplementedError(
                "the ms backend is not ported (ROADMAP.md B8)")
        senid_flat = np.asarray(senid_flat, np.int64).reshape(-1)
        sen2cb = np.asarray(am.sen2cb, np.int64)
        used_cb = np.unique(sen2cb[senid_flat])
        cb_row = np.full(int(sen2cb.max()) + 1, -1, np.int64)
        cb_row[used_cb] = np.arange(len(used_cb))
        cb_pos = cb_row[sen2cb[senid_flat]]
        return scorer_from_numpy(
            np.asarray(am.means)[used_cb], np.asarray(am.var_t)[used_cb],
            np.asarray(am.det)[used_cb], am.mixw_dense(senid_flat), cb_pos,
            logadd_table(am), am.max_topn, am.mixw_wrap_u8, device)


def logadd_table(am) -> np.ndarray:
    """The 8-bit log-add table (fast_logmath_add) as int32."""
    return np.asarray(am.lmath_8b.table, np.int32)


def scorer_from_numpy(means, var_t, det, mixw_s, cb_pos, logadd_table,
                      topn: int, wrap_u8: bool, device) -> GraphScorer:
    """GraphScorer from host arrays: means/var_t [Cu, F, D, L], det
    [Cu, F, D], mixw_s [F, D, S], cb_pos [S], the 8-bit log-add table."""
    def dev(a, dtype):
        return to_device(a, dtype, device)

    mixw_s = np.asarray(mixw_s)
    if mixw_s.min() < 0 or mixw_s.max() > 255:
        raise ValueError("mixture weights must fit uint8")
    return GraphScorer(
        means=dev(means, np.float32), var_t=dev(var_t, np.float32),
        det=dev(det, np.float32), mixw=dev(mixw_s, np.uint8),
        cb_pos=dev(cb_pos, np.int32), logadd=dev(logadd_table, np.int32),
        topn=int(topn), wrap_u8=bool(wrap_u8))


def scorer_from_jax_arrays(gs, device="cpu") -> GraphScorer:
    """The port's GraphScorer holding exactly the tables of a JAX
    ``GraphScorer`` (its arrays read as numpy): the mixture weights come
    back out of the one-hot matrix, ``mixw_s[f, d, s] = wsel[f,
    cb_pos[s] * D + d, s]``, the pad row is dropped, and the log-add
    table is rebuilt from its staircase thresholds."""
    cb_pos = np.asarray(gs.cb_pos).astype(np.int64)
    Cu = int(cb_pos.max()) + 1
    means = np.asarray(gs.means, np.float32)[:Cu]
    D = means.shape[2]
    wsel = np.asarray(gs.wsel, np.float32)
    S = len(cb_pos)
    rows = cb_pos[None, :] * D + np.arange(D)[:, None]          # [D, S]
    mixw_s = wsel[:, rows, np.arange(S)[None, :]]               # [F, D, S]
    thresh = np.asarray(gs.table_thresh, np.int64)
    d = np.arange(int(thresh.max()) + 1)
    table = (d[:, None] < thresh[None, :]).sum(1)
    return scorer_from_numpy(
        means, np.asarray(gs.var_t, np.float32)[:Cu],
        np.asarray(gs.det, np.float32)[:Cu], mixw_s.astype(np.int64),
        cb_pos, table, gs.max_topn, gs.wrap_u8, device)


# -- K2 ----------------------------------------------------------------------

def dist_topn_norm_plain(feats: torch.Tensor, gs: GraphScorer):
    """Plain PyTorch version of K2: feats f32 [N, F, L] -> (s, cw) int32
    [N, Cu, F, topn]."""
    N, _, L = feats.shape
    d = gs.det[None].expand((N,) + tuple(gs.det.shape)).clone()
    for i in range(L):                                          # dim order
        diff = feats[:, None, :, None, i] - gs.means[None, :, :, :, i]
        d = d - (diff * diff) * gs.var_t[None, :, :, :, i]
    di = torch.clamp(d, min=float(INT_MIN)).to(torch.int32)     # trunc, clamp
    D = di.shape[-1]
    lane = torch.arange(D, dtype=torch.int32, device=di.device)
    taken = torch.zeros(di.shape, dtype=torch.bool, device=di.device)
    scs, cws = [], []
    for _ in range(gs.topn):
        cand = torch.where(taken, torch.tensor(INT_MIN, dtype=torch.int32,
                                               device=di.device), di)
        m = cand.amax(dim=-1, keepdim=True)
        # lowest untaken index at the max: distinct even at the clamp
        sel = (cand == m) & ~taken
        idx = torch.where(sel, lane, torch.tensor(D, dtype=torch.int32,
                                                  device=di.device))
        idx = idx.amin(dim=-1, keepdim=True)
        scs.append(m)
        cws.append(idx)
        taken = taken | (lane == idx)
    shifted = torch.cat(scs, -1) >> SENSCR_SHIFT
    norm = shifted[..., 0].amax(dim=1, keepdim=True)            # [N, 1, F]
    s = torch.clamp(-(shifted - norm[..., None]), max=MAX_NEG_ASCR)
    return s.to(torch.int32), torch.cat(cws, -1).to(torch.int32)


def dist_topn_norm(feats: torch.Tensor, gs: GraphScorer):
    """K2: feats f32 [N, F, L] -> (s, cw) int32 [N, Cu, F, topn]."""
    if feats.device.type == "cpu":
        return dist_topn_norm_plain(feats, gs)
    if feats.device.type != "cuda":
        raise ValueError(f"dist_topn_norm: unsupported device {feats.device}")
    dev = feats.device
    N, F, L = feats.shape
    Cu, _, D, _ = gs.means.shape
    ck = cuda_build.check_tensor
    ck(feats, torch.float32, "feats")
    for name in ("means", "var_t", "det"):
        ck(getattr(gs, name), torch.float32, name, dev)
    s = torch.empty((N, Cu, F, gs.topn), dtype=torch.int32, device=dev)
    cw = torch.empty_like(s)
    lib = cuda_build.lib()
    err = lib.sst_dist_topn_norm(
        feats.data_ptr(), gs.means.data_ptr(), gs.var_t.data_ptr(),
        gs.det.data_ptr(), s.data_ptr(), cw.data_ptr(), N, Cu, F, D, L,
        gs.topn, cuda_build.stream(feats))
    cuda_build.check(err, "dist_topn_norm")
    dist_topn_norm.launches += 1
    return s, cw


dist_topn_norm.launches = 0


# -- K3 ----------------------------------------------------------------------

def logadd_plain(x: torch.Tensor, y: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """fast_logmath_add on the 8-bit table: min(x, y) - table[|x - y|]
    (0 past the table's end)."""
    diff = (x - y).abs()
    n = table.shape[0]
    add = torch.where(diff < n, table[diff.clamp(max=n - 1).long()],
                      torch.zeros_like(diff))
    return torch.minimum(x, y) - add


def senone_eval_plain(s: torch.Tensor, cw: torch.Tensor,
                      gs: GraphScorer) -> torch.Tensor:
    """Plain PyTorch version of K3: s/cw int32 [N, Cu, F, topn] ->
    graph-state scores int32 [N, S]."""
    cbp = gs.cb_pos.long()
    s_g = s[:, cbp]                                             # [N, S, F, n]
    cw_g = cw[:, cbp].long()
    cols = torch.arange(gs.S, device=s.device)[None, :]
    ascore = None
    for f in range(s.shape[2]):
        fden = None
        for j in range(s.shape[3]):
            term = gs.mixw[f][cw_g[:, :, f, j], cols].to(torch.int32) \
                + s_g[:, :, f, j]
            if gs.wrap_u8:
                term = term & 0xFF
            fden = term if fden is None else logadd_plain(fden, term, gs.logadd)
        ascore = fden if ascore is None else ascore + fden
    return ascore


def senone_eval(s: torch.Tensor, cw: torch.Tensor, gs: GraphScorer,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: s/cw int32 [N, Cu, F, topn] -> int32 [N, S], written into
    ``out`` when given (a contiguous [N, S] view of the batch buffer)."""
    if s.device.type == "cpu":
        r = senone_eval_plain(s, cw, gs)
        if out is None:
            return r
        out.copy_(r)
        return out
    if s.device.type != "cuda":
        raise ValueError(f"senone_eval: unsupported device {s.device}")
    dev = s.device
    N, Cu, F, topn = s.shape
    D = gs.mixw.shape[1]
    ck = cuda_build.check_tensor
    ck(s, torch.int32, "s")
    ck(cw, torch.int32, "cw", dev)
    ck(gs.mixw, torch.uint8, "mixw", dev)
    ck(gs.cb_pos, torch.int32, "cb_pos", dev)
    ck(gs.logadd, torch.int32, "logadd", dev)
    if out is None:
        out = torch.empty((N, gs.S), dtype=torch.int32, device=dev)
    ck(out, torch.int32, "out", dev)
    if tuple(out.shape) != (N, gs.S):
        raise ValueError(f"senone_eval: out shape {tuple(out.shape)}")
    lib = cuda_build.lib()
    err = lib.sst_senone_eval(
        s.data_ptr(), cw.data_ptr(), gs.mixw.data_ptr(), gs.cb_pos.data_ptr(),
        gs.logadd.data_ptr(), gs.logadd.shape[0], out.data_ptr(), N, Cu, F,
        D, gs.S, topn, int(gs.wrap_u8), cuda_build.stream(s))
    cuda_build.check(err, "senone_eval")
    senone_eval.launches += 1
    return out


senone_eval.launches = 0


def score_frames_graph(gs: GraphScorer, feats: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """feats f32 [N, F, L] -> int32 graph-state scores [N, S] (K2, K3)."""
    s, cw = dist_topn_norm(feats, gs)
    return senone_eval(s, cw, gs, out)
