"""Senone scoring: graph-restricted, full-inventory and fully continuous
(kernels K2, K3, K5, K7, K11 and K12).

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
* the fully continuous (ms) scorer (_dist_stage_ms, _ms_stage): float
  top-N, ms_senone's senone eval, int16, 0 = best, senone order
  (MsScorer, score_frames_ms);
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
  semi 4-bit quirk).  mixw is gathered directly from [F, D, S] uint8 and
  the log-add reads the 8-bit table, which equals the JAX package's
  staircase.
* K7 ``frame_best_sub``: the per-frame tail (_sen_eval): the int32
  scores cast to int16 (wrapping), minus (ptm) the int16 cast of the
  frame's minimum int32 score; semi's form is the cast alone.
* K11 ``ms_dist_topn``: the ms fold (K2's, one FMA per dim), kept in
  float, and its top N by float with ties to the later density (the
  JAX package's packed order key), the WORST_DIST floor (a distance
  below INT_MIN gives (INT_MIN, 0)), or, with ``topn >= D``, every
  density in index order.
* K12 ``ms_senone_eval``: per (frame, senone) the rounded-up shift of
  each top distance, minus the senone's mixture weight, the full
  logmath_add over the top N with both zero guards, the negated sum over
  streams in int64, the acoustic weight's truncation, the int16 clamp,
  then the frame's best subtracted, clamped -> int16 [N, S].
* K5 ``gather_cols``: ``out[b, t, s] = src[b, t, cols[b, s]]`` from an
  int32 or int16 source, widened to int32, with jnp.take_along_axis's
  index rule (a negative index wraps once, one past the end reads the
  dtype's minimum).

Two TPU devices of the JAX scorer are gone: the bf16 one-hot ``wsel``
matmul (a direct gather here) and the duplicate codebook row at
``Cu % 8 == 0`` (it dodged a slow top_k lowering; a duplicate row cannot
change the cross-codebook max).

The plain versions use no ``torch.topk`` (its tie order is unspecified),
no matmul and no ``torch.sum``; K2's, K3's, K11's and K12's work through
the frames in blocks, so that their intermediates stay near 256 MB at
the full-inventory shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..logmath import SENSCR_SHIFT
from ..utils import cuda_build, to_device

MAX_NEG_ASCR = 96
INT_MIN = -2147483648
WORST_DIST = float(INT_MIN)  # ms_gauden.c's floor, as a float32
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
    return scorer_from_numpy(
        means, np.asarray(gs.var_t, np.float32)[:Cu],
        np.asarray(gs.det, np.float32)[:Cu], mixw_s.astype(np.int64),
        cb_pos, _staircase_table(gs.table_thresh), gs.max_topn, gs.wrap_u8,
        device)


def _staircase_table(thresh) -> np.ndarray:
    """The 8-bit log-add table from the JAX scorer's staircase
    thresholds: table[d] = sum_k [d < thresh_k]."""
    thresh = np.asarray(thresh, np.int64)
    d = np.arange(int(thresh.max()) + 1)
    return (d[:, None] < thresh[None, :]).sum(1)


def dense_scorer(am, device) -> "GraphScorer | MsScorer":
    """The full-inventory scorer (ScorerTables.from_am's tables): every
    codebook, every senone, columns in senone order; for ms models the
    MsScorer."""
    if am.backend == "ms":
        return ms_scorer(am, device)
    gs = scorer_from_numpy(
        am.means, am.var_t, am.det, am.mixw_dense(), am.sen2cb,
        logadd_table(am), am.max_topn, am.mixw_wrap_u8, device)
    gs.subtract_best = am.backend != "semi"
    return gs


def dense_scorer_from_jax_tables(tables, device="cpu") -> GraphScorer:
    """The port's full-inventory ptm or semi scorer holding exactly the
    tables of a JAX ``ScorerTables`` (its arrays read as numpy): the
    grouped mixture weights ``mixw_g [F, G, D, M]`` back in senone order
    through ``sen_remap``, each senone's codebook from ``cb_of``, and the
    log-add table rebuilt from its staircase thresholds."""
    if tables.backend not in ("ptm", "semi"):
        raise ValueError(f"{tables.backend} tables: use "
                         "ms_scorer_from_jax_tables")
    remap = np.asarray(tables.sen_remap, np.int64)
    mixw_g = np.asarray(tables.mixw_g)
    M = mixw_g.shape[3]
    grp, slot = remap // M, remap % M
    mixw_s = mixw_g[:, grp, :, slot]                            # [S, F, D]
    gs = scorer_from_numpy(
        np.asarray(tables.means, np.float32),
        np.asarray(tables.var_t, np.float32),
        np.asarray(tables.det, np.float32),
        np.transpose(mixw_s, (1, 2, 0)).astype(np.int64),
        np.asarray(tables.cb_of)[grp], _staircase_table(tables.table_thresh),
        tables.max_topn, tables.wrap_u8, device)
    gs.subtract_best = tables.backend != "semi"
    return gs


@dataclass(eq=False)
class MsScorer:
    """Device tables of the fully continuous (ms) scorer."""

    means: torch.Tensor      # f32 [C, F, D, L]
    var_t: torch.Tensor      # f32 [C, F, D, L]
    det: torch.Tensor        # f32 [C, F, D]
    mixw: torch.Tensor       # int32 [S, F, D] quantized mixture weights
    sen2cb: torch.Tensor     # int32 [S] senone -> codebook
    logadd: torch.Tensor     # int32 [n] 8-bit log-add table
    zero8: int               # the 8-bit logmath's zero
    aw: int = 1              # acoustic weight (scores truncate by it)
    topn: int = 4

    @property
    def S(self) -> int:
        return self.sen2cb.shape[0]

    @property
    def n_best(self) -> int:
        """Densities kept per (frame, codebook, stream): the top N, or
        all of them when topn >= D (or topn <= 0)."""
        D = self.det.shape[2]
        return min(self.topn, D) if self.topn > 0 else D


def ms_scorer_from_numpy(means, var_t, det, mixw_ms, sen2cb, logadd_table,
                         zero8: int, aw: int, topn: int,
                         device) -> MsScorer:
    def dev(a, dtype):
        return to_device(a, dtype, device)

    if int(aw) < 1:
        raise ValueError(f"aw={aw}: the acoustic weight must be >= 1")
    return MsScorer(
        means=dev(means, np.float32), var_t=dev(var_t, np.float32),
        det=dev(det, np.float32), mixw=dev(mixw_ms, np.int32),
        sen2cb=dev(sen2cb, np.int32), logadd=dev(logadd_table, np.int32),
        zero8=int(zero8), aw=int(aw), topn=int(topn))


def ms_scorer(am, device) -> MsScorer:
    """The ms scorer of an AcousticModel (ScorerTables.from_am's ms
    fields): untransposed [S, F, D] weights, the senmgau map."""
    return ms_scorer_from_numpy(
        am.means, am.var_t, am.det, np.asarray(am.mixw), am.sen2cb,
        logadd_table(am), am.lmath_8b.zero, am.aw,
        am.max_topn, device)


def ms_scorer_from_jax_tables(tables, device="cpu") -> MsScorer:
    """The port's ms scorer holding exactly the ms fields of a JAX
    ``ScorerTables`` (its arrays read as numpy).  The JAX scorer emits
    senone order permuted into its grouped columns (``sen_inv``) and
    ``ungroup`` permutes back (``sen_remap``); the port emits senone
    order, which is the same only if the two permutations cancel, as
    checked here."""
    if tables.backend != "ms":
        raise ValueError(f"{tables.backend} tables: use "
                         "dense_scorer_from_jax_tables")
    inv = np.asarray(tables.sen_inv)[np.asarray(tables.sen_remap)]
    if not np.array_equal(inv, np.arange(tables.n_sen)):
        raise ValueError("sen_inv does not invert sen_remap")
    return ms_scorer_from_numpy(
        np.asarray(tables.means), np.asarray(tables.var_t),
        np.asarray(tables.det), np.asarray(tables.mixw_ms),
        np.asarray(tables.sen2cb), _staircase_table(tables.table_thresh),
        tables.zero8, tables.aw, tables.max_topn, device)


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


def dist_topn_norm(feats: torch.Tensor, gs: GraphScorer,
                   dist_mode: str = "fold"):
    """K2: feats f32 [N, F, L] -> (s, cw) int32 [N, Cu, F, topn]; the
    distance is the fold, or the expanded form under ``dist_mode="mxu"``
    (any other mode is the fold, as in the JAX package)."""
    if feats.device.type == "cpu":
        return dist_topn_norm_plain(feats, gs, dist_mode)
    if feats.device.type != "cuda":
        raise ValueError(f"dist_topn_norm: unsupported device {feats.device}")
    dev = feats.device
    N, F, L = feats.shape
    Cu, _, D, _ = gs.means.shape
    ck = cuda_build.check_tensor
    ck(feats, torch.float32, "feats")
    for name in ("means", "var_t", "det", "muv", "c"):
        ck(getattr(gs, name), torch.float32, name, dev)
    mxu = dist_mode == "mxu"
    s = torch.empty((N, Cu, F, gs.topn), dtype=torch.int32, device=dev)
    cw = torch.empty_like(s)
    lib = cuda_build.lib()
    err = lib.sst_dist_topn_norm(
        feats.data_ptr(), gs.means.data_ptr(), gs.var_t.data_ptr(),
        gs.det.data_ptr(), gs.muv.data_ptr(), gs.c.data_ptr(), s.data_ptr(),
        cw.data_ptr(), N, Cu, F, D, L, gs.topn, int(mxu),
        cuda_build.stream(feats))
    cuda_build.check(err, "dist_topn_norm")
    form = "mxu" if mxu else "fold"
    dist_topn_norm.launches += 1
    dist_topn_norm.forms[form] = dist_topn_norm.forms.get(form, 0) + 1
    return s, cw


dist_topn_norm.launches = 0
dist_topn_norm.forms = {}


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
                       out: torch.Tensor | None = None,
                       dist_mode: str = "fold") -> torch.Tensor:
    """feats f32 [N, F, L] -> int32 graph-state scores [N, S] (K2, K3)."""
    s, cw = dist_topn_norm(feats, gs, dist_mode)
    return senone_eval(s, cw, gs, out)


# -- K7 ----------------------------------------------------------------------

def frame_best_sub_plain(x: torch.Tensor, sub: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K7: int32 [N, S] -> int16 [N, S], the
    int16 cast of each score minus (``sub``, ptm) that of its frame's
    minimum."""
    if not sub:
        return x.to(torch.int16)
    best = x.amin(dim=1, keepdim=True)
    return x.to(torch.int16) - best.to(torch.int16)


def frame_best_sub(x: torch.Tensor, sub: bool = True) -> torch.Tensor:
    """K7: int32 [N, S] mixture scores -> int16 [N, S], 0 = best (ptm);
    with ``sub=False`` (semi) the int16 cast alone."""
    if x.device.type == "cpu":
        return frame_best_sub_plain(x, sub)
    if x.device.type != "cuda":
        raise ValueError(f"frame_best_sub: unsupported device {x.device}")
    cuda_build.check_tensor(x, torch.int32, "x")
    N, S = x.shape
    out = torch.empty((N, S), dtype=torch.int16, device=x.device)
    err = cuda_build.lib().sst_frame_best_sub(
        x.data_ptr(), out.data_ptr(), N, S, int(sub), cuda_build.stream(x))
    cuda_build.check(err, "frame_best_sub")
    frame_best_sub.launches += 1
    return out


frame_best_sub.launches = 0


def score_frames(ds, feats: torch.Tensor,
                 dist_mode: str = "fold") -> torch.Tensor:
    """Full-inventory scores: feats f32 [N, F, L] -> int16 [N, n_sen]
    in senone order: K2, K3, K7 (ptm 0 = best per frame; semi not
    normalized), or, for an MsScorer, K11, K12, which ignore
    ``dist_mode`` (the JAX package's score_frames routes ms before it
    reads the mode)."""
    if isinstance(ds, MsScorer):
        return score_frames_ms(ds, feats)
    s, cw = dist_topn_norm(feats, ds, dist_mode)
    return frame_best_sub(senone_eval(s, cw, ds), ds.subtract_best)


# -- K11 ---------------------------------------------------------------------

def _order_key(d: torch.Tensor) -> torch.Tensor:
    """int64 key that orders float32 values as the JAX program packs
    them: the float's bits mapped to an unsigned order (so -0 < +0)."""
    u = d.view(torch.int32).to(torch.int64)
    ub = u & 0xFFFFFFFF
    return torch.where(u < 0, (~ub) & 0xFFFFFFFF, ub | 0x80000000)


def ms_dist_topn_plain(feats: torch.Tensor, ms: MsScorer):
    """Plain PyTorch version of K11: feats f32 [N, F, L] -> (dval f32,
    cw int32) [N, C, F, n_best]."""
    parts = [_ms_dist_topn_block(feats[b], ms)
             for b in _frame_blocks(feats.shape[0], 40 * ms.det.numel())]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _ms_dist_topn_block(feats: torch.Tensor, ms: MsScorer):
    d = _fold_plain(feats, ms)
    D = d.shape[-1]
    dev = d.device
    lane = torch.arange(D, dtype=torch.int64, device=dev)
    if ms.n_best >= D:
        # compute_dist_all: every density, in index order
        return d, lane.to(torch.int32).expand(d.shape).contiguous()
    # distinct keys, the later density first among equal floats; a
    # distance below WORST_DIST ranks last (-1)
    key = torch.where(d < WORST_DIST, torch.tensor(-1, device=dev),
                      _order_key(d) * D + lane)
    taken = torch.zeros(d.shape, dtype=torch.bool, device=dev)
    below = torch.tensor(-2, dtype=torch.int64, device=dev)
    tops, idxs = [], []
    for _ in range(ms.n_best):
        cand = torch.where(taken, below, key)
        m = cand.amax(dim=-1, keepdim=True)
        idx = torch.where((cand == m) & ~taken, lane, D).amin(dim=-1,
                                                               keepdim=True)
        tops.append(m)
        idxs.append(idx)
        taken = taken | (lane == idx)
    top = torch.cat(tops, -1)
    idx = torch.cat(idxs, -1)
    bad = top < 0
    dval = torch.where(bad, torch.tensor(WORST_DIST, device=dev),
                       torch.gather(d, -1, idx))
    cw = torch.where(bad, 0, idx).to(torch.int32)
    return dval, cw


def ms_dist_topn(feats: torch.Tensor, ms: MsScorer):
    """K11: feats f32 [N, F, L] -> (dval f32, cw int32) [N, C, F,
    n_best]."""
    if feats.device.type == "cpu":
        return ms_dist_topn_plain(feats, ms)
    if feats.device.type != "cuda":
        raise ValueError(f"ms_dist_topn: unsupported device {feats.device}")
    dev = feats.device
    N, F, L = feats.shape
    C, _, D, _ = ms.means.shape
    ck = cuda_build.check_tensor
    ck(feats, torch.float32, "feats")
    for name in ("means", "var_t", "det"):
        ck(getattr(ms, name), torch.float32, name, dev)
    ne = ms.n_best
    dval = torch.empty((N, C, F, ne), dtype=torch.float32, device=dev)
    cw = torch.empty((N, C, F, ne), dtype=torch.int32, device=dev)
    err = cuda_build.lib().sst_ms_dist_topn(
        feats.data_ptr(), ms.means.data_ptr(), ms.var_t.data_ptr(),
        ms.det.data_ptr(), dval.data_ptr(), cw.data_ptr(), N, C, F, D, L,
        ne, cuda_build.stream(feats))
    cuda_build.check(err, "ms_dist_topn")
    ms_dist_topn.launches += 1
    return dval, cw


ms_dist_topn.launches = 0


# -- K12 ---------------------------------------------------------------------

def ms_senone_eval_plain(dval: torch.Tensor, cw: torch.Tensor,
                         ms: MsScorer) -> torch.Tensor:
    """Plain PyTorch version of K12: (dval f32, cw int32) [N, C, F, n]
    -> int16 [N, S] in senone order, 0 = best."""
    per_frame = 48 * ms.S * dval.shape[2] * dval.shape[3]
    parts = [_ms_senone_eval_block(dval[b], cw[b], ms)
             for b in _frame_blocks(dval.shape[0], per_frame)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _ms_senone_eval_block(dval, cw, ms: MsScorer) -> torch.Tensor:
    dev = dval.device
    i64 = torch.int64
    # senone_eval's fden: rounded-up shift of the truncated distance
    fden = torch.where(dval < WORST_DIST,
                       torch.tensor(INT_MIN >> SENSCR_SHIFT, device=dev),
                       (dval.to(i64) + ((1 << SENSCR_SHIFT) - 1))
                       >> SENSCR_SHIFT)
    sc = ms.sen2cb.long()
    S = sc.shape[0]
    F, n = dval.shape[2], dval.shape[3]
    fden_s = fden[:, sc]                                     # [N, S, F, n]
    cw_s = cw[:, sc].long()
    sidx = torch.arange(S, device=dev)[None, :, None, None]
    fidx = torch.arange(F, device=dev)[None, None, :, None]
    fwscr = fden_s - ms.mixw[sidx, fidx, cw_s].to(i64)
    zero = ms.zero8
    tab = ms.logadd.to(i64)
    nt = tab.shape[0]
    fscr = fwscr[..., 0]
    for j in range(1, n):                                    # logmath_add
        x, y = fscr, fwscr[..., j]
        r = torch.maximum(x, y)
        d = r - torch.minimum(x, y)
        res = r + torch.where(d < nt, tab[d.clamp(max=nt - 1)],
                              torch.zeros_like(d))
        res = torch.where(x <= zero, y, res)
        fscr = torch.where(y <= zero, torch.where(x <= zero, res, x), res)
    scr = fscr[:, :, 0]
    for f in range(1, F):                                    # stream order
        scr = scr + fscr[:, :, f]
    scr = -scr
    if ms.aw != 1:
        scr = torch.sign(scr) * (scr.abs() // ms.aw)
    scr = scr.clamp(-32768, 32767)
    best = scr.amin(dim=1, keepdim=True)
    return (scr - best).clamp(-32768, 32767).to(torch.int16)


def ms_senone_eval(dval: torch.Tensor, cw: torch.Tensor,
                   ms: MsScorer) -> torch.Tensor:
    """K12: (dval f32, cw int32) [N, C, F, n] -> int16 [N, S]."""
    if dval.device.type == "cpu":
        return ms_senone_eval_plain(dval, cw, ms)
    if dval.device.type != "cuda":
        raise ValueError(f"ms_senone_eval: unsupported device {dval.device}")
    dev = dval.device
    N, C, F, n = dval.shape
    D = ms.mixw.shape[2]
    ck = cuda_build.check_tensor
    ck(dval, torch.float32, "dval")
    ck(cw, torch.int32, "cw", dev)
    ck(ms.mixw, torch.int32, "mixw", dev)
    ck(ms.sen2cb, torch.int32, "sen2cb", dev)
    ck(ms.logadd, torch.int32, "logadd", dev)
    if tuple(cw.shape) != (N, C, F, n):
        raise ValueError(f"ms_senone_eval: cw shape {tuple(cw.shape)}")
    out = torch.empty((N, ms.S), dtype=torch.int16, device=dev)
    err = cuda_build.lib().sst_ms_senone_eval(
        dval.data_ptr(), cw.data_ptr(), ms.mixw.data_ptr(),
        ms.sen2cb.data_ptr(), ms.logadd.data_ptr(), ms.logadd.shape[0],
        out.data_ptr(), N, C, F, D, ms.S, n, ms.zero8, ms.aw,
        cuda_build.stream(dval))
    cuda_build.check(err, "ms_senone_eval")
    ms_senone_eval.launches += 1
    return out


ms_senone_eval.launches = 0


def score_frames_ms(ms: MsScorer, feats: torch.Tensor) -> torch.Tensor:
    """ms scores: feats f32 [N, F, L] -> int16 [N, S] in senone order,
    0 = best per frame (K11, K12)."""
    dval, cw = ms_dist_topn(feats, ms)
    return ms_senone_eval(dval, cw, ms)


# -- K5 ----------------------------------------------------------------------

def gather_cols_plain(src: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: src int32/int16 [B, T, Sx], cols
    int32 [B, S] -> int32 [B, T, S]."""
    B, T, Sx = src.shape
    idx = cols.long()
    idx = torch.where(idx < 0, idx + Sx, idx)
    ok = ((idx >= 0) & (idx < Sx))[:, None, :]
    g = torch.gather(src, 2, idx.clamp(0, Sx - 1)[:, None, :]
                     .expand(B, T, -1)).to(torch.int32)
    fill = torch.tensor(torch.iinfo(src.dtype).min, dtype=torch.int32,
                        device=src.device)
    return torch.where(ok, g, fill)


def gather_cols(src: torch.Tensor, cols: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: src int32/int16 [B, T, Sx], cols int32 [B, S] -> int32
    [B, T, S], written into ``out`` when given (a contiguous slice of
    the batch buffer)."""
    B, T, Sx = src.shape
    S = cols.shape[1]
    if cols.shape[0] != B:
        raise ValueError(f"gather_cols: {cols.shape[0]} column rows for "
                         f"{B} rows")
    if src.device.type == "cpu":
        r = gather_cols_plain(src, cols)
        if out is None:
            return r
        out.copy_(r)
        return out
    if src.device.type != "cuda":
        raise ValueError(f"gather_cols: unsupported device {src.device}")
    if src.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"gather_cols: source dtype {src.dtype}")
    dev = src.device
    ck = cuda_build.check_tensor
    ck(src, src.dtype, "src")
    ck(cols, torch.int32, "cols", dev)
    if out is None:
        out = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    ck(out, torch.int32, "out", dev)
    if tuple(out.shape) != (B, T, S):
        raise ValueError(f"gather_cols: out shape {tuple(out.shape)}")
    err = cuda_build.lib().sst_gather_cols(
        src.data_ptr(), src.element_size(), cols.data_ptr(), out.data_ptr(),
        B, T, Sx, S, cuda_build.stream(src))
    cuda_build.check(err, "gather_cols")
    gather_cols.launches += 1
    return out


gather_cols.launches = 0
