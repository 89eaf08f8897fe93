"""Frozen copy of ``soundswallower_tpu_torch/ops/senscore_torch.py``
for the benchmark's reference (see ``__init__``).

Senone scoring, graph-restricted and over the full inventory (kernels
K2, K3 and K7; the copy keeps the PTM scorer's plain versions, which
the benchmark's configurations use).

Port of ``soundswallower_tpu/ops/senscore_jax.py``:

* the graph-restricted scorer (GraphScorer, _dist_stage_graph,
  _topn_sen_stage_graph, score_frames_graph): distances and top-N only
  for the codebooks a graph (or a working-set union) uses, mixture
  evaluation only for its S states, scores in column order, not
  0-normalized;
* the full-inventory ptm and semi scorer (ScorerTables, _dist_stage,
  _topn_stage, _sen_eval, score_frames): the same two kernels over every
  codebook and senone, then the per-frame tail, int16 (ptm: 0 = best;
  semi: no subtraction).  It emits senone order: the JAX package's
  codebook-grouped layout (G = n_grp * 128 columns) was a TPU device,
  and ``sencols`` index senones directly (the remap is the identity);
* ``aligner.py`` _gather_cols, the per-row column gather of the mixed
  batch.

Kernels:

* K2 ``dist_topn_norm``: the float32 Mahalanobis fold
  ``d = det - sum_l (x_l - mu_l)^2 * var_l`` in dim order, each step
  ``d - sq * var`` a fused multiply-add (one rounding) as XLA's CPU
  backend contracts the JAX fold, or, with ``dist_mode="mxu"``, the
  expanded distance of _distances_mxu / _dist_stage_graph's mxu branch,
  ``d = ((det - c) - xv) + 2 xmv`` with ``xv = sum_l x_l^2 var_l`` and
  ``xmv = sum_l x_l (mu var)_l`` each a chain of fused multiply-adds
  from 0 in dim order (XLA's CPU dot) and the per-table constants
  ``mu var`` and ``c = sum_l mu_l (mu var)_l`` (XLA's reduce, the same
  chain) made once on the host; then truncation to int32 with an
  INT_MIN clamp, the top N of D densities (lowest index on
  ties, distinct indices even at the clamp), then codebook_norm: ``>>
  SENSCR_SHIFT``, the max over codebooks of each stream's top score,
  negated and clamped to 96.  Over all codebooks it is the function of
  the removed Pallas kernel ``tools/exp_pallas2.py`` dist_topn_fused2.
* K3 ``senone_eval``: per (frame, state) the sum over streams of the
  8-bit log-add over j of ``mixw[f, cw_j, s] + s_j`` (``& 0xFF`` for the
  semi 4-bit quirk).  mixw is read directly from [F, D, S] uint8 and
  the log-add reads the 8-bit table, which equals the JAX package's
  staircase.  The kernel takes a range of columns and a tile of frames
  a block (``senone_eval_layout``), stages the range's weights once and
  the terms of its codebooks once a pass of frames, a term in 16 bits.
* K7 ``frame_best_sub``: the per-frame tail (_sen_eval): the int32
  scores cast to int16 (wrapping), minus (ptm) the int16 cast of the
  frame's minimum int32 score; semi's form is the cast alone.
* K5 ``gather_cols``: ``out[b, t, s] = src[b, t, cols[b, s]]`` from an
  int32 or int16 source, widened to int32, with jnp.take_along_axis's
  index rule (a negative index wraps once, one past the end reads the
  dtype's minimum).

Two TPU devices of the JAX scorer are gone: the bf16 one-hot ``wsel``
matmul (a direct gather here) and the duplicate codebook row at
``Cu % 8 == 0`` (it dodged a slow top_k lowering; a duplicate row cannot
change the cross-codebook max).

The plain versions use no ``torch.topk`` (its tie order is unspecified),
no matmul and no ``torch.sum``; K2's and K3's work through
the frames in blocks, so that their intermediates stay near 256 MB at
the full-inventory shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .logmath import SENSCR_SHIFT
from .utils import to_device

MAX_NEG_ASCR = 96
INT_MIN = -2147483648
PLAIN_BLOCK_BYTES = 1 << 28  # working set of one frame block, plain K2/K3


def _frame_blocks(n: int, bytes_per_frame: int):
    """Slices of at most PLAIN_BLOCK_BYTES // bytes_per_frame frames."""
    step = max(1, PLAIN_BLOCK_BYTES // max(1, bytes_per_frame))
    return [slice(i, min(n, i + step)) for i in range(0, max(n, 1), step)]


@dataclass(eq=False)
class GraphScorer:
    """Device tables of one graph's restricted scorer."""

    means: torch.Tensor      # f32 [Cu, F, D, L] used-codebook rows
    var_t: torch.Tensor      # f32 [Cu, F, D, L]
    det: torch.Tensor        # f32 [Cu, F, D]
    mixw: torch.Tensor       # uint8 [F, D, S] mixture weights per state
    cb_pos: torch.Tensor     # int32 [S] graph state -> used-codebook row
    logadd: torch.Tensor     # int32 [n] 8-bit log-add table
    muv: torch.Tensor        # f32 [Cu, F, D, L] means * var_t (mxu form)
    c: torch.Tensor          # f32 [Cu, F, D] sum_l means * muv (mxu form)
    topn: int = 4
    wrap_u8: bool = False
    # the dense tail (K7): ptm subtracts each frame's best, semi does not
    subtract_best: bool = True

    @property
    def S(self) -> int:
        return self.cb_pos.shape[0]

    @classmethod
    def build(cls, am, senid_flat: np.ndarray, device) -> "GraphScorer":
        """Host selection of GraphScorer.build (senscore_jax.py): the
        used codebooks, each state's codebook row, and the states'
        mixture weights.  ``am`` is the shared AcousticModel."""
        if am.backend == "ms":
            # as the JAX package: ms senone eval (rounded shifts, full
            # logmath_add, aw) does not share this pipeline, and ms
            # models take the dense route (MsScorer)
            raise NotImplementedError(
                "graph-restricted scoring is ptm/semi only; ms models "
                "use the dense scorer (the mixed path)")
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
    muv, c = mxu_constants(means, var_t)
    return GraphScorer(
        means=dev(means, np.float32), var_t=dev(var_t, np.float32),
        det=dev(det, np.float32), mixw=dev(mixw_s, np.uint8),
        cb_pos=dev(cb_pos, np.int32), logadd=dev(logadd_table, np.int32),
        muv=dev(muv, np.float32), c=dev(c, np.float32),
        topn=int(topn), wrap_u8=bool(wrap_u8))


def mxu_constants(means, var_t) -> tuple[np.ndarray, np.ndarray]:
    """The mxu form's per-table constants, on the host, as the JAX
    program computes them: ``muv = means * var_t`` (float32) and ``c =
    sum_l means_l * muv_l``, a chain of float32 fused multiply-adds from
    0 in dim order: XLA's CPU reduce over the L = 13 dims of the
    repository's models (it rewrites an axis of more than 32 values as a
    tree, fe/frontend.py frame_sum_plain)."""
    m = torch.from_numpy(np.array(means, np.float32, order="C"))
    v = torch.from_numpy(np.array(var_t, np.float32, order="C"))
    muv = m * v
    c = torch.zeros(m.shape[:-1], dtype=torch.float32)
    for i in range(m.shape[-1]):
        c = fma_sub_plain(c, -m[..., i], muv[..., i])
    return muv.numpy(), c.numpy()



MS_GROUP_MAX = 128       # senones a K12 group holds at most
MS_GROUP_CODEBOOKS = 8   # codebooks a K12 group spans at most







# -- K2 ----------------------------------------------------------------------

def dist_topn_norm_plain(feats: torch.Tensor, gs: GraphScorer,
                         dist_mode: str = "fold"):
    """Plain PyTorch version of K2: feats f32 [N, F, L] -> (s, cw) int32
    [N, Cu, F, topn]."""
    parts = [_dist_topn_norm_block(feats[b], gs, dist_mode)
             for b in _frame_blocks(feats.shape[0], 64 * gs.det.numel())]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def fma_sub_plain(acc: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """float32 ``acc - a * b`` rounded once, as a fused multiply-add.
    The product of two float32 values is exact in float64, so the only
    error left is the float64 subtraction's rounding, which can change
    the float32 result only where the float64 difference lands exactly
    on a float32 tie (the 29 mantissa bits float32 drops are 1000...0;
    float32-normal results).  There the exact error (TwoSum) decides the
    side."""
    x = acc.double()
    p = a.double() * b.double()
    s = x - p
    r = s.float()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(tie.any()):
        xt, pt, st_, rt = x[tie], p[tie], s[tie], r[tie]
        bb = st_ - xt
        e = (xt - (st_ - bb)) + (-pt - bb)         # x - p == s + e exactly
        rd = rt.double()
        up = torch.nextafter(rt, torch.full_like(rt, float("inf")))
        dn = torch.nextafter(rt, torch.full_like(rt, float("-inf")))
        r = r.clone()
        r[tie] = torch.where((st_ > rd) & (e > 0), up,
                             torch.where((st_ < rd) & (e < 0), dn, rt))
    return r


def _fold_plain(feats: torch.Tensor, gs) -> torch.Tensor:
    """The float32 distance fold: feats [N, F, L] -> d [N, C, F, D],
    ``d = det``, then per dim in order ``d - (x - mu)^2 * var`` as one
    fused multiply-add of the rounded square."""
    N, _, L = feats.shape
    d = gs.det[None].expand((N,) + tuple(gs.det.shape)).clone()
    for i in range(L):                                          # dim order
        diff = feats[:, None, :, None, i] - gs.means[None, :, :, :, i]
        d = fma_sub_plain(d, diff * diff, gs.var_t[None, :, :, :, i])
    return d


def _mxu_plain(feats: torch.Tensor, gs: GraphScorer) -> torch.Tensor:
    """The expanded float32 distance: feats [N, F, L] -> d [N, C, F, D]
    = ((det - c) - xv) + 2 xmv, xv and xmv chains of fused multiply-adds
    from 0 in dim order."""
    N, _, L = feats.shape
    shape = (N,) + tuple(gs.det.shape)
    xx = feats * feats
    xv = torch.zeros(shape, dtype=torch.float32, device=feats.device)
    xmv = torch.zeros_like(xv)
    for i in range(L):                                          # dim order
        xv = fma_sub_plain(xv, -xx[:, None, :, None, i],
                           gs.var_t[None, :, :, :, i])
        xmv = fma_sub_plain(xmv, -feats[:, None, :, None, i],
                            gs.muv[None, :, :, :, i])
    return ((gs.det - gs.c)[None] - xv) + 2.0 * xmv


def int_distances_plain(feats: torch.Tensor, gs: GraphScorer,
                        dist_mode: str = "fold") -> torch.Tensor:
    """K2's distances before the top-N (_dist_stage_graph, _dist_stage):
    feats f32 [N, F, L] -> int32 [N, C, F, D], truncated, clamped at
    INT_MIN."""
    d = _mxu_plain(feats, gs) if dist_mode == "mxu" else _fold_plain(feats,
                                                                     gs)
    return torch.clamp(d, min=float(INT_MIN)).to(torch.int32)


def _dist_topn_norm_block(feats: torch.Tensor, gs: GraphScorer,
                          dist_mode: str):
    di = int_distances_plain(feats, gs, dist_mode)
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
    scores int32 [N, S] in column order."""
    per_frame = 16 * gs.S * (s.shape[2] * s.shape[3] + 4)
    parts = [_senone_eval_block(s[b], cw[b], gs)
             for b in _frame_blocks(s.shape[0], per_frame)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _senone_eval_block(s: torch.Tensor, cw: torch.Tensor,
                       gs: GraphScorer) -> torch.Tensor:
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


def score_frames_graph(gs: GraphScorer, feats: torch.Tensor,
                       out: torch.Tensor | None = None,
                       dist_mode: str = "fold") -> torch.Tensor:
    """feats f32 [N, F, L] -> int32 graph-state scores [N, S] (K2, K3)."""
    s, cw = dist_topn_norm_plain(feats, gs, dist_mode)
    r = senone_eval_plain(s, cw, gs)
    if out is None:
        return r
    out.copy_(r)
    return out


# -- K7 ----------------------------------------------------------------------


# -- K11 ---------------------------------------------------------------------




# -- K12 ---------------------------------------------------------------------




# -- K5 ----------------------------------------------------------------------

def frame_best_sub_plain(x: torch.Tensor, sub: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K7: int32 [N, S] -> int16 [N, S], the
    int16 cast of each score minus (``sub``, ptm) that of its frame's
    minimum."""
    if not sub:
        return x.to(torch.int16)
    best = x.amin(dim=1, keepdim=True)
    return x.to(torch.int16) - best.to(torch.int16)
