"""Senone scoring for PTM / semi-continuous Gaussian mixture models.

Two implementations:

* ``ScorerNp`` - exact host reference replicating ``src/ptm_mgau.c`` (and
  the structurally identical semi-continuous path in s2_semi_mgau.c)
  operation-for-operation, including the dynamic-threshold top-N codeword
  search with its 4-dim-checkpoint early termination (eval_cb,
  ptm_mgau.c:150-225), the cross-frame top-N seeding (frame_eval,
  ptm_mgau.c:408-454), quantized normalization (codebook_norm,
  ptm_mgau.c:264-295) and table-based log-add senone evaluation
  (senone_eval, ptm_mgau.c:326-403).  Vectorized over codebooks/features
  with numpy float32 (per-element IEEE ops, so bit-exact vs C), sequential
  over codewords where C is.  Used for bit-parity tests and as the oracle
  for the fast path.

* ``score_frames`` (ops/senscore_torch.py) - the dense path on the card.

A copy of the JAX package's module; the exact ``Decoder`` scores with
it.

Scores follow the C convention: int16, 0 = best in frame, larger = worse
(negated normalized log-likelihoods), SENSCR_SHIFT-quantized.
"""

from __future__ import annotations

import numpy as np

from ..am import AcousticModel
from ..logmath import SENSCR_SHIFT

MAX_NEG_INT32 = -2147483648
MAX_NEG_ASCR = 96
WORST_DIST = MAX_NEG_INT32


def dist_checkpoints(am: AcousticModel, obs: np.ndarray, group: int = 4):
    """All Mahalanobis distances with eval_cb's checkpoint partials.

    obs: [n_feat, L] float32.  Returns (checks, final) where
    checks: list of [cb, f, dens] float32 partial distances at the loop
    conditions of eval_cb, final: [cb, f, dens] float32.

    group=4 gives the PTM checkpoint structure (before dim 0, after the
    L%4 pre-loop, after each 4-dim group except the last,
    ptm_mgau.c:181-202); group=1 the semi-continuous one (before every
    dim, s2_semi_mgau.c:137-147).

    The fold subtracts per-dim terms in dimension order with float32
    rounding at every step, matching COMPUTE_GMM_MAP/REDUCE exactly.
    """
    L = am.means.shape[-1]
    diff = (obs[None, :, None, :] - am.means).astype(np.float32)
    sq = (diff * diff).astype(np.float32)
    compl_ = (sq * am.var_t).astype(np.float32)
    d = am.det.astype(np.float32).copy()
    checks = [d.copy()]
    if group == 1:
        for i in range(L):
            d = (d - compl_[..., i]).astype(np.float32)
            if i < L - 1:
                checks.append(d.copy())
        return checks, d
    pre = L % 4
    for i in range(pre):
        d = (d - compl_[..., i]).astype(np.float32)
    checks.append(d.copy())
    j = pre
    while j < L:
        for k in range(4):
            d = (d - compl_[..., j + k]).astype(np.float32)
        j += 4
        if j < L:
            checks.append(d.copy())
    return checks, d


def int_dist(d: np.ndarray) -> np.ndarray:
    """(int32)d with the C MAX_NEG_INT32 floor (eval_cb, ptm_mgau.c:218-221)."""
    out = np.trunc(d.astype(np.float64)).astype(np.int64)
    out = np.where(d < np.float32(MAX_NEG_INT32), MAX_NEG_INT32, out)
    return out


class MsScorerNp:
    """Exact replication of the fully-continuous multi-stream scorer
    (``src/ms_mgau.c`` + ``src/ms_senone.c``): per-codebook top-N Gaussian
    distances (compute_dist, ms_gauden.c:385-433: fresh float insertion
    lists with per-dim early termination), senone evaluation with
    rounded-shift densities and full log-add table (senone_eval,
    ms_senone.c:315-362), acoustic-weight downscale and int16-clamped
    normalization (ms_cont_mgau_frame_eval, ms_mgau.c:279-368).

    Stateless across frames (ms keeps no top-N history)."""

    def __init__(self, am: AcousticModel):
        self.am = am
        # ms_cont_mgau_frame_eval never clears senone_scores, so senones
        # outside the active list keep stale values across frames
        # (ms_mgau.c:279-368 has no memset); replicated via a persistent
        # buffer.
        self._buf = np.zeros(am.n_sen, np.int16)
        self.frame_idx = 0

    def start_utt(self):
        self.frame_idx = 0

    def frame_eval(self, obs: np.ndarray, frame: int,
                   mgau_active: np.ndarray | None = None,
                   senone_active: np.ndarray | None = None) -> np.ndarray:
        am = self.am
        topn = min(am.max_topn, am.n_density) if am.max_topn > 0 \
            else am.n_density
        n_sen = am.n_sen
        if senone_active is None:
            sens = np.arange(n_sen)
        else:
            sens = np.asarray(senone_active)
        cbs_needed = np.zeros(am.n_mgau, bool)
        cbs_needed[am.sen2cb[sens]] = True

        # compute_dist per active codebook/feature (sequential scan with
        # float threshold; vectorized over (cb, f))
        checks, final = dist_checkpoints(am, obs, group=1)
        n_cb, n_feat, D = final.shape
        N = topn
        top_d = np.full((n_cb, n_feat, N), np.float32(-2.0**62), np.float32)
        top_d[:] = np.float32(WORST_DIST)
        top_id = np.zeros((n_cb, n_feat, N), np.int64)
        if topn >= am.n_density:
            # compute_dist_all (ms_gauden.c:350-383): densities in index
            # order, NOT sorted
            top_id = np.broadcast_to(np.arange(D), final.shape).copy()
            top_d = final.copy()
        else:
            for cw in range(am.n_density):
                worst = top_d[..., N - 1]
                ok = cbs_needed[:, None].copy()
                for c in checks:
                    ok = ok & (c[..., cw] >= worst)
                ok = ok & (final[..., cw] >= worst)
                if not ok.any():
                    continue
                dval = final[..., cw]
                # insert before entries with dist <= dval (ties: new above)
                rank = (top_d > dval[..., None]).sum(axis=-1)
                nd, ni = top_d.copy(), top_id.copy()
                for k in range(N - 1, -1, -1):
                    put = ok & (rank == k)
                    nd[..., k] = np.where(put, dval, nd[..., k])
                    ni[..., k] = np.where(put, cw, ni[..., k])
                    if k + 1 < N:
                        shift = ok & (rank <= k)
                        nd[..., k + 1] = np.where(shift, top_d[..., k],
                                                  nd[..., k + 1])
                        ni[..., k + 1] = np.where(shift, top_id[..., k],
                                                  ni[..., k + 1])
                top_d, top_id = nd, ni

        # senone_eval (ms_senone.c:315-362)
        cbs = am.sen2cb[sens]
        # fden: rounded shift of int32-cast distance
        di = int_dist(top_d)  # [cb, f, N] int64
        fden = np.where(top_d < np.float32(MAX_NEG_INT32),
                        MAX_NEG_INT32 >> SENSCR_SHIFT,
                        (di + ((1 << SENSCR_SHIFT) - 1)) >> SENSCR_SHIFT)
        # senone_eval's logmath_add uses the senone's own 8-bit shifted
        # table (s->lmath, ms_senone.c:212), not the main shift-0 lmath
        lmath = am.lmath_8b
        zero = lmath.zero
        table = lmath.table.astype(np.int64)
        tsize = len(table)
        scr = np.zeros(len(sens), np.int64)
        for f in range(n_feat):
            fscr = None
            for t in range(topn):
                cw_t = top_id[cbs, f, t]
                if am.backend == "ms" and am.n_mgau > 1:
                    mixw_t = am.mixw[sens, f, cw_t].astype(np.int64)
                else:
                    mixw_t = am.mixw[f, cw_t, sens].astype(np.int64)
                fwscr = fden[cbs, f, t] + -mixw_t
                if fscr is None:
                    fscr = fwscr
                else:
                    # logmath_add (logmath.c:229-272)
                    x, y = fscr, fwscr
                    r = np.maximum(x, y)
                    lo = np.minimum(x, y)
                    d = r - lo
                    add = np.where(d < tsize, table[np.minimum(d, tsize - 1)], 0)
                    res = r + add
                    res = np.where(x <= zero, y, res)
                    res = np.where(y <= zero, np.where(x <= zero, res, x), res)
                    fscr = res
            scr -= fscr
        aw = getattr(am, "aw", 1)
        # C integer division truncates toward zero
        scr = (np.sign(scr) * (np.abs(scr) // aw)).astype(np.int64)
        scr = np.clip(scr, -32768, 32767)
        best = scr.min() if len(scr) else 0
        normed = np.clip(scr - best, -32768, 32767)
        self._buf[sens] = normed
        return self._buf.copy()


class ScorerNp:
    """Exact numpy replication of ptm_mgau scoring.

    Stateful across frames (and utterances!) exactly like the C code: the
    top-N history ring (s->hist) is only initialized once at decoder init
    (ptm_mgau_reset_fast_hist, ptm_mgau.c:694-720) and acmod_start_utt only
    resets mgau->frame_idx.
    """

    def __init__(self, am: AcousticModel):
        self.am = am
        self.n_mgau = am.n_mgau
        self.n_feat = am.n_feat
        self.max_topn = am.max_topn
        self.hist_cw = np.zeros((2, self.n_mgau, self.n_feat, self.max_topn), np.int64)
        self.hist_cw[:] = np.arange(self.max_topn)[None, None, None, :]
        self.hist_score = np.full(
            (2, self.n_mgau, self.n_feat, self.max_topn), WORST_DIST, np.int64
        )
        self.frame_idx = 0  # mgau->frame_idx (acmod_advance increments)

    def start_utt(self):
        self.frame_idx = 0

    def frame_eval(self, obs: np.ndarray, frame: int,
                   mgau_active: np.ndarray | None = None,
                   senone_active: np.ndarray | None = None) -> np.ndarray:
        """Score one frame.  obs: [n_feat, L] float32 feature vectors.

        mgau_active: bool [n_mgau] (None = all, compallsen).
        senone_active: evaluated senone ids incl. bridge senones (None =
        all).  Returns int16 [n_sen].
        """
        am = self.am
        if mgau_active is None:
            mgau_active = np.ones(self.n_mgau, bool)
        fi = frame % 2
        li = 1 - fi
        if frame >= self.frame_idx:
            self.hist_cw[fi] = self.hist_cw[li]
            self.hist_score[fi] = self.hist_score[li]
            group = 1 if am.backend == "semi" else 4
            checks, final = dist_checkpoints(am, obs, group)
            self._eval_topn(fi, final)
            if frame % am.ds_ratio == 0:
                self._eval_cb(fi, checks, final, mgau_active)
            self._codebook_norm(fi, mgau_active)
        return self._senone_eval(fi, mgau_active, senone_active)

    def _eval_topn(self, fi, final):
        """eval_topn (ptm_mgau.c:86-135): re-score seeds, stable-sort desc."""
        cws = self.hist_cw[fi]  # [cb, f, N]
        cb_i = np.arange(self.n_mgau)[:, None, None]
        f_i = np.arange(self.n_feat)[None, :, None]
        scores = int_dist(final[cb_i, f_i, cws])
        # insertion_sort_topn == stable descending sort by score
        order = np.argsort(-scores, axis=-1, kind="stable")
        self.hist_score[fi] = np.take_along_axis(scores, order, axis=-1)
        self.hist_cw[fi] = np.take_along_axis(cws, order, axis=-1)

    def _eval_cb(self, fi, checks, final, mgau_active):
        """eval_cb (ptm_mgau.c:150-225): sequential codeword scan with the
        dynamic worst-of-top-N threshold, vectorized over (cb, feat)."""
        am = self.am
        scores = self.hist_score[fi]  # [cb, f, N] int64
        cws = self.hist_cw[fi]
        N = self.max_topn
        act = mgau_active[:, None]  # [cb, 1]
        semi = am.backend == "semi"
        for cw in range(am.n_density):
            thresh = scores[..., N - 1].astype(np.float32)  # (mfcc_t)worst
            ok = act.copy()
            for c in checks:
                ok = ok & (c[..., cw] >= thresh)
            if semi:
                # final check is int (s2_semi_mgau.c:155-156)
                ok = ok & (int_dist(final[..., cw]) >= scores[..., N - 1])
            else:
                ok = ok & (final[..., cw] >= thresh)
            ok = ok & ~(cws == cw).any(axis=-1)
            if not ok.any():
                continue
            di = int_dist(final[..., cw])  # [cb, f]
            # insert di above entries with score <= di; drop worst
            rank = (scores > di[..., None]).sum(axis=-1)  # insertion index
            new_scores = scores.copy()
            new_cws = cws.copy()
            for k in range(N - 1, -1, -1):
                at_k = rank == k
                put = ok & at_k
                new_scores[..., k] = np.where(put, di, new_scores[..., k])
                new_cws[..., k] = np.where(put, cw, new_cws[..., k])
                if k + 1 < N:
                    shift = ok & (rank <= k)
                    new_scores[..., k + 1] = np.where(
                        shift, scores[..., k], new_scores[..., k + 1]
                    )
                    new_cws[..., k + 1] = np.where(
                        shift, cws[..., k], new_cws[..., k + 1]
                    )
            scores[...] = new_scores
            cws[...] = new_cws

    def _codebook_norm(self, fi, mgau_active):
        """ptm_mgau_codebook_norm (ptm_mgau.c:264-295)."""
        scores = self.hist_score[fi]
        act = mgau_active
        shifted = scores >> SENSCR_SHIFT
        for f in range(self.n_feat):
            norm = shifted[act, f, 0].max()
            s = shifted[:, f, :] - norm
            s = -s
            s = np.minimum(s, MAX_NEG_ASCR)
            scores[:, f, :] = np.where(act[:, None], s, scores[:, f, :])

    def _senone_eval(self, fi, mgau_active, senone_active=None):
        """ptm_mgau_senone_eval (ptm_mgau.c:326-403) vectorized over
        senones.  Evaluated senones always have active codebooks (their
        codebooks were activated from the same list), so the stale-topn
        branch at :353-364 is unreachable and not replicated."""
        am = self.am
        n_sen = am.n_sen
        table = am.lmath_8b.table
        cw = self.hist_cw[fi]
        sc = self.hist_score[fi]
        if senone_active is None:
            sens = np.arange(n_sen)
        else:
            sens = np.asarray(senone_active)
        cbs = am.sen2cb[sens]
        ascore = np.zeros(len(sens), np.int64)
        for f in range(self.n_feat):
            fden = None
            for j in range(self.max_topn):
                cw_j = cw[cbs, f, j]
                if am.mixw_cb is not None:
                    packed = am.mixw[f, cw_j, sens // 2].astype(np.int64)
                    # Nibble select differs per backend: ptm keys on the
                    # PACKED-BYTE parity (ptm_mgau.c:377, a faithful C
                    # quirk), semi on the SENONE-INDEX parity
                    # (s2_semi_mgau.c:475-499).  See am.mixw_dense.
                    odd = (sens & 1) if am.backend == "semi" else (packed & 1)
                    dcw = np.where(odd, packed >> 4, packed & 0x0F)
                    mixw_j = am.mixw_cb[dcw].astype(np.int64)
                else:
                    mixw_j = am.mixw[f, cw_j, sens].astype(np.int64)
                term = mixw_j + sc[cbs, f, j]
                if am.mixw_wrap_u8:
                    # semi 4-bit precomputes uint8 w_den = mixw_cb + score
                    # (s2_semi_mgau.c:452-461): sum truncates to uint8
                    term = term & 0xFF
                if fden is None:
                    fden = term
                else:
                    d = np.abs(fden - term)
                    r = np.minimum(fden, term)
                    # fast_logmath_add's table has >= 256 entries and the
                    # difference is < 256 by design (tied_mgau_common.h:91-99)
                    fden = r - table[np.minimum(d, len(table) - 1)].astype(np.int64)
            ascore += fden
        out = np.zeros(n_sen, np.int16)
        out[sens] = ascore
        if am.backend != "semi":
            # ptm subtracts the best evaluated score from every senone
            # (ptm_mgau.c:397-400); the semi-continuous scorer does not
            # (s2_semi_mgau_frame_eval accumulates raw, :826-875)
            best = ascore.min() if len(ascore) else 0
            out = (out.astype(np.int64) - best).astype(np.int16)
        return out
