"""A plain reference for fully continuous acoustic models whose one
stream holds 39 dims (``1s_c_d_dd`` without subvectors), in plain
PyTorch, on the CPU or the card.

From the model files, the raw audio and the transcripts alone it
computes what the port's batch routes produce on such a model: the
plain front end and its features (the benchmark's reference,
``portbench.reference.align.Reference``: its cepstra, the host front
end's wire where it is used, 1s_c_d_dd with CMN as configured), read as
one stream of 39 dims, cepstra, delta and delta-delta in that order;
then, per senone's codebook, the Gaussian distances
``det - sum_l (x_l - mu_l)^2 * var_l`` in float32 over the 39 dims in
order and the top N (ms_mgau.c:279-368, ms_gauden.c's compute_dist);
per senone the log-add over the top N of the quantized mixture weight
and the rounded-up shifted distance, the sum over streams, the acoustic
weight, the int16 clamp and each frame's best subtracted
(ms_senone.c:315-362, ms_mgau.c's best subtraction); then the
reference's plain Viterbi over the stacked graphs (``replay``) and its
word and phone segments.  It imports no JAX, nothing of the JAX package
and no kernel of the port.

Departures from ms_mgau.c and ms_senone.c, each as the port and the
JAX package compute it:

* every senone is scored at every frame (the dense route), where the C
  decoder scores the active senones only; so each frame's best is taken
  over all of them;
* each step of the distance is one fused multiply-add of the rounded
  square, ``d - (diff * diff) * var`` rounded once (XLA's CPU backend
  contracts the JAX fold so); C compiled without contraction rounds the
  product first;
* the top N is ordered by the float's bits (-0.0 below +0.0), ties to
  the later density (the C insertion puts an equal newcomer above the
  incumbent); a distance below INT_MIN as a float ranks below every
  other and comes out as (INT_MIN, density 0); with N at least the
  densities, every density in index order;
* CMN ``current`` normalises each utterance by its own mean (the batch
  form), where the live C decoder updates its estimate as it goes;
* no feature transform is applied.

``precision="bf16"`` is a control: the distance computed in bfloat16
(features, means, variances and constants rounded to it, every step of
the fold rounded to it), which must not match.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import replay
from portbench.reference.align import Reference
from portbench.reference.sst.logmath import SENSCR_SHIFT
from portbench.reference.sst.senscore import fma_sub_plain
from portbench.reference.sst.viterbi import (row_consts_from_numpy,
                                             stack_graphs)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INT_MIN = -2147483648
WORST_DIST = float(INT_MIN)
BLOCK_BYTES = 1 << 28          # a frame block's float64 distances at most


class ContTables:
    """A continuous model's scoring tables on ``device``: means and
    variances [C, F, D, L], det [C, F, D] (float32), the quantized
    weights [S, F, D] and each senone's codebook (int64), the 8-bit
    log-add table, its zero, the acoustic weight and top N."""

    def __init__(self, am, device):
        if am.backend != "ms":
            raise ValueError(f"a {am.backend} model is not continuous")
        dev = torch.device(device)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        self.means = t(am.means, torch.float32)
        self.var = t(am.var_t, torch.float32)
        self.det = t(am.det, torch.float32)
        self.mixw = t(am.mixw, torch.int64)
        self.sen2cb = t(am.sen2cb, torch.int64)
        self.table = t(am.lmath_8b.table, torch.int64)
        self.zero = int(am.lmath_8b.zero)
        self.aw = int(am.aw)
        D = self.det.shape[2]
        self.n = min(int(am.max_topn), D) if am.max_topn > 0 else D


def distances(x: torch.Tensor, tb: ContTables,
              precision: str = "f32") -> torch.Tensor:
    """x f32 [N, F, L] -> d f32 [N, C, F, D]: det, then per dim in order
    d - (x - mu)^2 * var (one rounding, or bfloat16 throughout)."""
    N, _, L = x.shape
    if precision == "bf16":
        bf = torch.bfloat16
        xb, mu, var = x.to(bf), tb.means.to(bf), tb.var.to(bf)
        d = tb.det.to(bf)[None].expand((N,) + tuple(tb.det.shape)).clone()
        for i in range(L):
            diff = xb[:, None, :, None, i] - mu[None, :, :, :, i]
            d = d - diff * diff * var[None, :, :, :, i]
        return d.float()
    if precision != "f32":
        raise ValueError(f"precision {precision!r}")
    d = tb.det[None].expand((N,) + tuple(tb.det.shape)).clone()
    for i in range(L):
        diff = x[:, None, :, None, i] - tb.means[None, :, :, :, i]
        d = fma_sub_plain(d, diff * diff, tb.var[None, :, :, :, i])
    return d


def top_n(d: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """d f32 [..., D] -> (value f32, density int64) [..., n]: the n
    highest by the float's bits, ties to the later density; below
    WORST_DIST last, given as (WORST_DIST, 0); every density in index
    order where n covers them all."""
    D = d.shape[-1]
    lane = torch.arange(D, device=d.device)
    if n >= D:
        return d, lane.expand(d.shape)
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits,
                        bits + 0x80000000)       # unsigned order of floats
    key = torch.where(d < WORST_DIST, torch.full_like(order, -1),
                      order * D + lane)
    key, idx = torch.sort(key, dim=-1, descending=True)
    key, idx = key[..., :n], idx[..., :n]
    low = key < 0
    val = torch.where(low, torch.full_like(d[..., :n], WORST_DIST),
                      torch.gather(d, -1, idx))
    return val, torch.where(low, torch.zeros_like(idx), idx)


def senone_scores(val: torch.Tensor, dens: torch.Tensor,
                  tb: ContTables) -> torch.Tensor:
    """(val f32, dens int64) [N, C, F, n] -> int16 [N, S], 0 = best a
    frame."""
    i64 = torch.int64
    fden = torch.where(val < WORST_DIST,
                       torch.full(val.shape, INT_MIN >> SENSCR_SHIFT,
                                  dtype=i64, device=val.device),
                       (val.to(i64) + ((1 << SENSCR_SHIFT) - 1))
                       >> SENSCR_SHIFT)
    cb = tb.sen2cb
    S = cb.shape[0]
    F = val.shape[2]
    fd, dn = fden[:, cb], dens[:, cb]                    # [N, S, F, n]
    s_ix = torch.arange(S, device=val.device)[None, :, None, None]
    f_ix = torch.arange(F, device=val.device)[None, None, :, None]
    term = fd - tb.mixw[s_ix, f_ix, dn]
    nt = tb.table.shape[0]
    acc = term[..., 0]
    for j in range(1, term.shape[-1]):                   # logmath_add
        x, y = acc, term[..., j]
        hi = torch.maximum(x, y)
        gap = hi - torch.minimum(x, y)
        add = torch.where(gap < nt, tb.table[gap.clamp(max=nt - 1)],
                          torch.zeros_like(gap))
        r = torch.where(x <= tb.zero, y, hi + add)
        acc = torch.where(y <= tb.zero, torch.where(x <= tb.zero, r, x), r)
    total = acc[:, :, 0]
    for f in range(1, F):
        total = total + acc[:, :, f]
    scr = -total
    if tb.aw != 1:
        scr = torch.sign(scr) * (scr.abs() // tb.aw)
    scr = scr.clamp(-32768, 32767)
    return (scr - scr.amin(dim=1, keepdim=True)).clamp(
        -32768, 32767).to(torch.int16)


def score(x: torch.Tensor, tb: ContTables,
          precision: str = "f32") -> torch.Tensor:
    """x f32 [N, F, L] on the tables' device -> int16 [N, S], a block of
    frames at a time."""
    C, F, D, _ = tb.means.shape
    step = max(1, BLOCK_BYTES // (8 * C * F * D))
    parts = []
    for i in range(0, x.shape[0], step):
        val, dens = top_n(distances(x[i:i + step], tb, precision), tb.n)
        parts.append(senone_scores(val, dens, tb))
    if not parts:
        return torch.zeros((0, tb.sen2cb.shape[0]), dtype=torch.int16,
                           device=x.device)
    return torch.cat(parts)


class PlainCont(Reference):
    """The plain reference for a continuous model of one 39-dim stream,
    on the benchmark reference's front end, graphs, Viterbi and
    extraction."""

    def __init__(self, model_dir: str, samprate: int, host_fe: bool,
                 device="cpu"):
        super().__init__(model_dir, samprate, host_fe, device)
        self._setup()

    @classmethod
    def of(cls, ref: Reference) -> "PlainCont":
        """This reference over a loaded ``Reference`` (its model, front
        end and graphs)."""
        self = cls.__new__(cls)
        self.__dict__.update(ref.__dict__)
        self._setup()
        return self

    def _setup(self) -> None:
        am = self.am
        if am.n_feat != 1 or list(am.veclen) != [39]:
            raise ValueError(f"a model of {am.n_feat} stream(s) of "
                             f"{list(am.veclen)} dims: this reference reads "
                             "one stream of 39")
        self.tables = ContTables(am, self.device)

    def scores(self, audios: list, precision: str = "f32") -> list:
        """Each row's int16 scores [T_i, S] on the device."""
        feats, Ts = self.features(audios)
        out = []
        for b, T in enumerate(Ts):
            x = feats[b, :int(T)].reshape(int(T), 1, -1).to(self.device)
            out.append(score(x, self.tables, precision))
        return out

    def align_rows(self, audios: list, texts: list, union_texts=None,
                   precision: str = "f32") -> list:
        """Word and phone segments of each row (None where a row reaches
        no final state): every senone's scores, each row's graph
        states' columns of them, the plain Viterbi over the stacked
        graphs.  ``union_texts`` is not read: a continuous model scores
        every senone whatever the batch."""
        graphs = [self.graph(t) for t in texts]
        scores = self.scores(audios, precision)
        Ts = np.array([s.shape[0] for s in scores])
        st = stack_graphs(graphs, self.am.tmat.astype(np.int32),
                          np.arange(self.am.n_sen))
        sencols = torch.from_numpy(st["sencols"].astype(np.int64))
        B, Tm, S = len(audios), int(Ts.max()), sencols.shape[1]
        sen = torch.zeros((B, Tm, S), dtype=torch.int32, device=self.device)
        for b in range(B):
            c = sencols[b].clamp(min=0).to(self.device)
            sen[b, :int(Ts[b])] = scores[b].index_select(1, c).to(
                torch.int32)
        vit = row_consts_from_numpy(st, self.device)
        path = replay.viterbi_rows(
            sen, torch.from_numpy(Ts.astype(np.int32)).to(self.device),
            vit).cpu().numpy()
        return [self.extract(g, path[b], int(Ts[b]))
                for b, g in enumerate(graphs)]
