"""The benchmark's plain reference aligner.

From the model files and the raw audio and transcripts alone, it works
out again what the port's timed paths produce: graphs
(``sst.align_graph``), cepstra (the plain front end; its spectra on the
CPU, where their log is the C library's), the wire's quantization for
host-front-end cells (``round(cep * scale)`` to int16, half to even, as
``lrintf`` rounds), features (``sst.feat``), senone scores
(``sst.senscore``'s plain K2/K3 over the scorer's codebooks, and K7
over the full inventory), the Viterbi and its backtrace (``sst.viterbi``'s, their frame
loops replayed by ``replay``), and the word and phone segments (the
aligner's Python extraction, copied below).  The noise removal, scoring
and the Viterbi run on ``device`` in plain PyTorch operations; the plain
versions use integer operations and explicitly rounded float64 ones, so
they give the same bits on the CPU and on the card.

Which codebooks a frame is normalized over is part of the result (K2's
top-N scores are clamped after the normalization), so the reference
takes the scorer the route takes: the union of the senones of every
graph the cell's traffic has sent on the mixed route (padded with
senone 0 to a multiple of 256 columns), or the full inventory once
that union passes UNION_MAX_FRAC of it (each frame's best then
subtracted, as K7 does), and a graph's own senones on the
same-transcript route.

``precision="bf16"`` is the benchmark's control: the Gaussian distance
fold computed in bfloat16 (features, means, variances and the
constants rounded to it, every step of the fold rounded to it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import replay
from .sst import senscore
from .sst.align_graph import build_chain_graph
from .sst.am import AcousticModel
from .sst.config import Config
from .sst.dict2pid import Dict2Pid
from .sst.dictionary import Dictionary
from .sst.feat import feat_plain, feats_plain
from .sst.frontend import Frontend, fe_cep_plain, fe_spec_plain
from .sst.logmath import LogMath
from .sst.viterbi import (WORST_SCORE, VitConsts, build_pred_table,
                          pred_count, row_consts_from_numpy, stack_graphs)

UNION_MAX_FRAC = 0.6     # the mixed route's switch to the full inventory


def _fold_bf16(feats: torch.Tensor, gs) -> torch.Tensor:
    """The distance fold of ``senscore._fold_plain`` in bfloat16."""
    bf = torch.bfloat16
    N, _, L = feats.shape
    x, mu, var = feats.to(bf), gs.means.to(bf), gs.var_t.to(bf)
    d = gs.det.to(bf)[None].expand((N,) + tuple(gs.det.shape)).clone()
    for i in range(L):
        diff = x[:, None, :, None, i] - mu[None, :, :, :, i]
        d = d - diff * diff * var[None, :, :, :, i]
    return d.float()


@contextlib.contextmanager
def _precision(precision: str):
    if precision == "f32":
        yield
        return
    if precision != "bf16":
        raise ValueError(f"precision {precision!r}")
    plain = senscore._fold_plain
    senscore._fold_plain = _fold_bf16
    try:
        yield
    finally:
        senscore._fold_plain = plain


def seg_rep(segs) -> list | None:
    """Segments as plain lists: [[word, start, duration, [[ciphone,
    start, duration], ...]], ...]; None for a failed row.  Takes the
    port's WordSeg objects or the reference's tuples alike."""
    if segs is None:
        return None
    out = []
    for s in segs:
        word, start, dur, phones = ((s.word, s.start, s.duration, s.phones)
                                    if hasattr(s, "word") else s)
        out.append([str(word), int(start), int(dur),
                    [[str(p[0]), int(p[1]), int(p[2])] for p in phones]])
    return out


class Reference:
    """The reference for one model directory (written by
    ``portbench.model``) and one front end."""

    def __init__(self, model_dir: str, samprate: int, host_fe: bool,
                 device="cpu"):
        config = Config(hmm=model_dir, samprate=samprate)
        config.expand()
        self.config = config
        self.lmath = LogMath(config.get_float("logbase"), 0, True)
        self.am = AcousticModel.load(config, self.lmath)
        self.dict = Dictionary(self.am.mdef, config["dict"], config["fdict"],
                               config.get_bool("dictcase"))
        self.d2p = Dict2Pid(self.am.mdef, self.dict)
        self.fe = Frontend.from_config(config)
        self.host_fe = host_fe
        self.wire_scale = 256.0 if config["transform"] == "legacy" else 128.0
        self.do_cmn = config["cmn"] in ("batch", "current")
        self.device = torch.device(device)
        self._graphs: dict[str, object] = {}
        mdef = self.am.mdef
        self.ci = [mdef.ciphone_str(i) for i in range(mdef.n_ciphone)]

    # -- graphs ------------------------------------------------------------

    def graph(self, text: str):
        g = self._graphs.get(text)
        if g is None:
            wids = []
            for w in text.split():
                wid = self.dict.wordid(w)
                if wid < 0:
                    raise KeyError(f"Unknown word {w}")
                wids.append(wid)
            g = self._graphs[text] = build_chain_graph(
                wids, self.dict, self.d2p, self.am, self.lmath, self.config)
        return g

    def union_senones(self, texts) -> np.ndarray | None:
        """The senones of the mixed route's union scorer after the
        graphs of ``texts`` were sent, in column order, or None where
        they pass UNION_MAX_FRAC of the inventory (the full inventory
        then)."""
        senset = np.unique(np.concatenate(
            [self.graph(t).senid.ravel() for t in texts]).astype(np.int64))
        return None if len(senset) > UNION_MAX_FRAC * self.am.n_sen \
            else senset

    # -- front end and features --------------------------------------------

    def cepstra(self, buf: np.ndarray, ns: np.ndarray, T: int):
        """``Frontend.mfcc`` of int16 rows [B, N] with ns samples each,
        T frames: the spectra on the CPU (their log is the C library's
        there), the noise removal's recursion on ``device``
        (replay.fe_noise), the cepstra on the CPU."""
        self.fe.check_supported()
        spec = fe_spec_plain(self.fe, torch.from_numpy(buf),
                             torch.from_numpy(ns),
                             torch.zeros(len(ns), dtype=torch.float32), T)
        if self.fe.remove_noise:
            spec = replay.fe_noise(spec.to(self.device)).cpu()
        return fe_cep_plain(self.fe, spec)

    def features(self, audios: list) -> tuple[torch.Tensor, np.ndarray]:
        """Features float32 [B, T, 3, ncep] on the CPU (T the longest
        row's frames) and the frame counts."""
        ns = np.array([len(a) for a in audios], np.int32)
        Ts = np.array([self.fe.n_frames(int(n)) for n in ns])
        T = int(Ts.max())
        buf = np.zeros((len(audios), int(ns.max())), np.int16)
        for i, a in enumerate(audios):
            buf[i, :len(a)] = a
        cep = self.cepstra(buf, ns, T)
        Ts_t = torch.from_numpy(Ts.astype(np.int32))
        if not self.host_fe:
            return feats_plain(cep, Ts_t, self.do_cmn), Ts
        scale = torch.tensor(self.wire_scale, dtype=torch.float32)
        q = torch.round(cep * scale).clamp(-32768, 32767).to(torch.int32)
        planes = torch.stack([(q & 0xFF).to(torch.uint8),
                              ((q >> 8) & 0xFF).to(torch.uint8)])
        return feat_plain(planes, Ts_t, 1.0 / self.wire_scale,
                          self.do_cmn), Ts

    # -- scores ------------------------------------------------------------

    def _scores(self, feats: torch.Tensor, Ts: np.ndarray, scorer,
                dense: bool = False, block: int = 2048) -> list[torch.Tensor]:
        """Each row's scores [T_i, columns] on the device, ``block``
        frames at a time; ``dense``: the full inventory's, each frame's
        best subtracted, int16 (K7)."""
        out = []
        for b, T in enumerate(Ts):
            x = feats[b, :int(T)]
            parts = []
            for t0 in range(0, int(T), block):
                f = x[t0:t0 + block].to(self.device)
                s = senscore.score_frames_graph(
                    scorer, f.reshape(f.shape[0], 3, -1))
                parts.append(senscore.frame_best_sub_plain(s) if dense
                             else s)
            out.append(torch.cat(parts))
        return out

    # -- the routes --------------------------------------------------------

    def align_rows(self, audios: list, texts: list, union_texts,
                   precision: str = "f32") -> list:
        """The mixed route (align_batch_begin/_end on different
        transcripts): segments of each row, with the union scorer of
        ``union_texts`` or, past UNION_MAX_FRAC, the full inventory."""
        with _precision(precision):
            graphs = [self.graph(t) for t in texts]
            feats, Ts = self.features(audios)
            senset = self.union_senones(union_texts)
            dense = senset is None
            if dense:
                # the union passed UNION_MAX_FRAC: the full inventory,
                # columns in senone order
                senset = cols = np.arange(self.am.n_sen)
            else:
                # pad columns score senone 0, whose codebook joins the norm
                cols = np.zeros(max(256, -(-len(senset) // 256) * 256),
                                np.int64)
                cols[:len(senset)] = senset
            scorer = senscore.GraphScorer.build(self.am, cols, self.device)
            remap = np.full(self.am.n_sen, -1, np.int64)
            remap[senset] = np.arange(len(senset))
            scores = self._scores(feats, Ts, scorer, dense)
            st = stack_graphs(graphs, self.am.tmat.astype(np.int32), remap)
            sencols = torch.from_numpy(st["sencols"].astype(np.int64))
            B, Tm, S = len(audios), int(Ts.max()), sencols.shape[1]
            sen = torch.zeros((B, Tm, S), dtype=torch.int32,
                              device=self.device)
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

    def align_long(self, audio: np.ndarray, text: str,
                   precision: str = "f32"):
        """The same-transcript route (align_longform_batch on one row):
        the graph's own scorer, K4's recurrence, the first final node
        at the best score."""
        with _precision(precision):
            g = self.graph(text)
            feats, Ts = self.features([audio])
            scorer = senscore.GraphScorer.build(self.am, g.senid.reshape(-1),
                                                self.device)
            sen = self._scores(feats, Ts, scorer)[0][None]
            pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst,
                                          g.edge_pen, len(g.senid))

            def dev(a, dtype=np.int32):
                return torch.from_numpy(np.array(a, dtype)).to(self.device)

            vit = VitConsts(
                tp=dev(self.am.tmat.astype(np.int32)[g.tmatid]),
                pred_idx=dev(pi), pred_pen=dev(pp), pred_ok=dev(pk, np.uint8),
                pred_n=dev(pred_count(pk)), astart=dev(g.astart),
                aend=dev(g.aend),
                entry=dev(np.where(g.is_entry, g.entry_pen, WORST_SCORE)),
                fin=dev(g.final_nodes))
            path = replay.viterbi_batch(
                sen, torch.from_numpy(Ts.astype(np.int32)).to(self.device),
                vit)
        return self.extract(g, path[0].cpu().numpy(), int(Ts[0]))

    # -- segments ----------------------------------------------------------

    def extract(self, g, path: np.ndarray, T: int) -> list | None:
        """State path -> [(word, start, duration, [(ciphone, start,
        duration)])] (the aligner's Python extraction without scores;
        None where the path does not reach a final state)."""
        p = np.asarray(path[:T]).astype(np.int64)
        if T == 0 or p[T - 1] < 0:
            return None
        ch = np.nonzero(p[1:] != p[:-1])[0]
        E = g.senid.shape[1]
        n_runs = len(ch) + 1
        states = np.empty(n_runs, np.int64)
        states[:-1] = p[ch]
        states[-1] = p[T - 1]
        starts = np.empty(n_runs, np.int64)
        starts[0] = 0
        starts[1:] = ch + 2
        ends = np.empty(n_runs, np.int64)
        ends[:-1] = ch + 2
        ends[-1] = T
        if n_runs > 1 and ends[-1] == starts[-1]:
            states, starts, ends = states[:-1], starts[:-1], ends[:-1]
        nodes = states // E
        pb = np.nonzero(np.concatenate(([True], nodes[1:] != nodes[:-1])))[0]
        p_start = starts[pb]
        p_end = np.concatenate((p_start[1:], ends[-1:]))
        out: list = []
        cur_word = None
        for node, s, e in zip(nodes[pb].tolist(), p_start.tolist(),
                              p_end.tolist()):
            w = int(g.word_of[node])
            ci = self.ci[int(g.cipid[node])]
            if w < 0:
                out.append(["<sil>", s, e - s, [(ci, s, e - s)]])
                cur_word = None
                continue
            if cur_word != w:
                out.append([self.dict.wordstr(int(g.variant_of[node])), s, 0,
                            []])
                cur_word = w
            out[-1][2] += e - s
            out[-1][3].append((ci, s, e - s))
        return out
