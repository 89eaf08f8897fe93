"""TorchAligner: forced alignment on PyTorch.

Port of ``soundswallower_tpu/aligner.py`` (TpuAligner):

* same transcript: host C++ MFCC -> int16 byte-plane wire -> upload ->
  K1 dynamic features -> K2/K3 graph-restricted senone scores -> K4
  Viterbi, final-node select and backtrace -> download -> native
  segment extraction (``native/sst_seg.cpp``);
* different transcripts (_batch_begin_mixed, ReadAlongs' one transcript
  per document): the same front end, then K2/K3 over the working-set
  union of the batch's senones (or the full inventory, K2/K3/K7, once
  the union passes UNION_MAX_FRAC of it), K5's per-row column gather,
  and K6 over a stack of per-row graphs;
* ``align_batch_scored``: always the full-inventory route, with token
  scores, and Python extraction of per-word, per-phone and (with
  ``want_states``) per-state scores;
* the acoustic-model backends TpuAligner loads: ptm and semi (8-bit or
  4-bit clustered sendumps) on every route above (semi's full-inventory
  scores are not 0-normalized: K7's semi form); ms (a senmgau map, or
  the 1:1 fallback) has no graph-restricted scorer, so every batch of an
  ms model takes the multi-graph route on its full-inventory scorer
  (K11, K12), as TpuAligner routes it;
* the device front end, where TpuAligner takes it (``SST_FE=device``, or
  no host FE library): pinned int16 upload -> K8/K9/K10 MFCC -> K1's
  float32 form, on both batch routes; ``align`` then runs the
  single-utterance path (K8-K10, K1, K2/K3, K4's carry form with the
  final select and backtrace);
* ``stream`` (streaming.AlignStream) and ``spectrogram`` on the device
  front end;
* 3- and 5-state HMMs on every route (K4, K6 and K4's carry form in
  their E=5 forms), int32 token stacks and paths where a graph has
  32,767 states or more, and a global-memory Viterbi state for graphs
  whose state does not fit a block's shared memory;
* grammar decode (``set_grammar`` from an FsgModel or JSGF, with the
  filler self-loops and alternate pronunciations of the config):
  ``decode`` and ``decode_batch`` on the same-transcript route (the
  decode graph is one graph for the batch), ``decode_batch_scored`` on
  the scored multi-graph route, and ``decode_search``, ``lattice`` and
  ``nbest``: the full-inventory scores (K2, K3, K7) of one utterance
  fed to the host history search (``search_fsg.FsgSearch``, a copy of
  the JAX package's) and its lattice;
* the host front end's wire as TpuAligner reads it (``SST_WIRE``: the
  int16 byte planes, or exact float32 cepstra and K1's float32 form;
  ``SST_WIRE_SCALE``), ``SST_MIXED=grouped`` (a same-transcript
  dispatch per text), ``remove_dc`` (K8's frame-mean branch) and
  ``dist_mode="mxu"`` (K2's expanded-distance form) on every entry
  point that takes it;
* ``align_longform_batch``: the same-transcript route's scores, then
  the sequence-parallel Viterbi on a ``parallel.SeqRing`` (K4's carry
  form per chunk, K13 ``backtrace_chunk`` on the way back).

Host modules (config, model, dictionary, phone and decode graphs,
grammars, history search, lattice, native FE loader, live CMN) are the
port's own copies of the JAX package's; the native
C++ helpers (``native/``) are shared.  Without ``native/libsst_seg.so``,
segments are extracted in Python, as TpuAligner does.

``device="cuda"`` runs the hand-written kernels (``csrc/``) and raises
if no CUDA device is present; ``device="cpu"`` runs their plain PyTorch
versions.  Nothing falls back from one to the other.

Still to be ported: ``use_mesh`` (ROADMAP.md A13) and ``update_mllr``
(A14).  As in the JAX package, ``align`` and ``decode`` on the device
front end and ``stream`` raise NotImplementedError for ms models (they
need the graph-restricted scorer), and ``stream`` and
``align_longform_batch`` on a 5-state model fail as the JAX package's
do (their carry starts with 3 states).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .am import AcousticModel
from .config import Config
from .dict2pid import Dict2Pid
from .dictionary import Dictionary
from .fe.feat import feat, feat_f32
from .fe.frontend import Frontend
from .fe.native_fe import NativeFrontend
from .logmath import LogMath
from .ops.align_graph import AlignGraph, build_chain_graph
from .ops.align_torch import (WORST_SCORE, RowVitConsts, VitConsts,
                              build_pred_table, row_consts_from_numpy,
                              stack_graphs, viterbi_batch, viterbi_rows,
                              viterbi_single)
from .ops.senscore_torch import (GraphScorer, dense_scorer, gather_cols,
                                 score_frames, score_frames_graph)
from .utils import native_build, resolve_device, to_device


@dataclass
class WordSeg:
    """A word segment (TpuAligner's WordSeg, field for field)."""

    word: str
    start: int
    duration: int
    score: int = 0
    phones: list | None = None  # list of (ciphone, start, duration, score)
    wid: int = -1
    states: list | None = None


def result_json_from_segs(segs, lmath, n_frames: int, frate: int,
                          hyp: str | None = None, start: float = 0.0,
                          align_level: int = 0) -> str:
    """WordSeg list -> the reference's line-JSON result schema
    (decoder_result_json, decoder.c:1502-1593), as TpuAligner writes it."""
    def fmt(b, d, p, t):
        return f'{{"b":{b:.3f},"d":{d:.3f},"p":{p:.3f},"t":"{t}"'

    if hyp is None:
        import re

        hyp = " ".join(re.sub(r"\(\d+\)$", "", s.word) for s in segs
                       if not (s.word.startswith("<")
                               or s.word.startswith("[")))
    out = [fmt(start, n_frames / frate, 1.0, hyp), ',"w":[']
    for i, s in enumerate(segs):
        if i:
            out.append(",")
        out.append(fmt(start + s.start / frate, s.duration / frate,
                       lmath.exp(int(s.score)), s.word))
        if align_level and s.phones:
            out.append(',"w":[')
            for k, (ci, ps, pd, psc) in enumerate(s.phones):
                if k:
                    out.append(",")
                out.append(fmt(start + ps / frate, pd / frate,
                               lmath.exp(int(psc)), ci))
                if align_level >= 2 and s.states:
                    out.append(',"w":[')
                    for m, (senid, ss, sd, ssc) in enumerate(s.states[k]):
                        if m:
                            out.append(",")
                        out.append(fmt(start + ss / frate, sd / frate,
                                       lmath.exp(int(ssc)), str(senid)))
                        out.append("}")
                    out.append("]")
                out.append("}")
            out.append("]")
        out.append("}")
    out.append("]}\n")
    return "".join(out)


@dataclass(eq=False)
class GraphConsts:
    """Per-graph device constants: the Viterbi's and the scorer's."""

    vit: VitConsts
    gs: GraphScorer


@dataclass(eq=False)
class _Stack:
    """A stacked batch of graphs on the device (_stacked_graphs)."""

    vit: RowVitConsts
    sencols: torch.Tensor    # int32 [B, P*3] scorer columns


@dataclass(eq=False)
class _Batch:
    """Handle of a dispatched batch."""

    graphs: list             # [realB] AlignGraph of each row
    Ts: np.ndarray           # [realB] frame counts
    paths: torch.Tensor      # int16 (int32 at S >= 32767) [B, Tmax], host
    fscore: torch.Tensor     # int32 [B], host
    realB: int
    pscore: torch.Tensor | None = None   # int32 [B, Tmax] path scores
    done: torch.cuda.Event | None = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class TorchAligner:
    """Batch forced aligner with TpuAligner's batch API."""

    def __init__(self, config=None, device: str | torch.device = "cuda",
                 **kwargs):
        self.device = resolve_device(device)
        if config is None:
            config = Config(**kwargs)
        self.config = config
        config.expand()
        if config["mllr"]:
            raise _unported("update_mllr / mllr", "A14")
        self.lmath = LogMath(config.get_float("logbase"), 0, True)
        self.am = AcousticModel.load(config, self.lmath)
        self.dict = Dictionary(self.am.mdef, config["dict"], config["fdict"],
                               config.get_bool("dictcase"))
        self.d2p = Dict2Pid(self.am.mdef, self.dict)
        self.fe = Frontend.from_config(config)
        # the host C++ MFCC unless SST_FE=device; without it (or where it
        # refuses the configuration) the device front end, K8-K10
        self.native_fe = None
        if os.environ.get("SST_FE", "host") != "device":
            self.native_fe = NativeFrontend.load(self.fe)
        if self.native_fe is None:
            self.fe.check_supported()
        # host-FE wire (TpuAligner's SST_WIRE, SST_WIRE_SCALE): "i16p"
        # ships round(cep * scale) int16 byte planes (scale 256 for
        # legacy, 128 for dct/htk), anything else exact float32 cepstra
        self.wire = os.environ.get("SST_WIRE", "i16p")
        self.wire_scale = float(os.environ.get(
            "SST_WIRE_SCALE",
            "256" if config["transform"] == "legacy" else "128"))
        self.do_cmn = config["cmn"] in ("batch", "current")
        # serving size-class floors (AlignService.prewarm sets them)
        self.tmax_floor = 0
        self.graph_p_floor = 0
        self.graph_k_floor = 0
        self.graph_w_floor = 0
        self.want_scores = False
        self.want_states = False
        self.dense = dense_scorer(self.am, self.device)
        self._graph_cache: dict[str, AlignGraph] = {}
        self._graph_const_cache: dict[int, GraphConsts] = {}
        self._uni: dict | None = None
        self._stack_cache: dict[tuple, _Stack] = {}
        self._seg_tab_cache: dict[tuple, tuple] = {}
        self._fe_pool = ThreadPoolExecutor(max_workers=1)

    # -- graph -------------------------------------------------------------

    def graph_for_text(self, text: str) -> AlignGraph:
        g = self._graph_cache.get(text)
        if g is None:
            wids = []
            for w in text.split():
                wid = self.dict.wordid(w)
                if wid < 0:
                    raise KeyError(f"Unknown word {w}")
                wids.append(wid)
            g = build_chain_graph(wids, self.dict, self.d2p, self.am,
                                  self.lmath, self.config)
            self._graph_cache[text] = g
        return g

    def _graph_consts(self, g: AlignGraph) -> GraphConsts:
        """Per-graph Viterbi and scorer tables on the device, cached."""
        c = self._graph_const_cache.get(g.serial)
        if c is None:
            pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst,
                                          g.edge_pen, len(g.senid))

            def dev(a, dtype=np.int32):
                return to_device(a, dtype, self.device)

            vit = VitConsts(
                tp=dev(self.am.tmat.astype(np.int32)[g.tmatid]),
                pred_idx=dev(pi), pred_pen=dev(pp),
                pred_ok=dev(pk, np.uint8), astart=dev(g.astart),
                aend=dev(g.aend),
                entry=dev(np.where(g.is_entry, g.entry_pen, WORST_SCORE)),
                fin=dev(g.final_nodes))
            gs = GraphScorer.build(self.am, g.senid.reshape(-1), self.device)
            c = self._graph_const_cache[g.serial] = GraphConsts(vit, gs)
        return c

    # -- single utterance and batch ------------------------------------------

    def align(self, audio: np.ndarray, text: str,
              dist_mode: str = "fold") -> list[WordSeg]:
        """Align one int16 utterance: through the batch path with the
        host FE, else on the single-utterance device path (frame axis
        bucketed to 128), as TpuAligner.align."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            raise TypeError("align expects int16 audio")
        g = self.graph_for_text(text)
        if self.native_fe is not None:
            out = self._batch_end(self._batch_begin(g, [audio], dist_mode))[0]
            if out is None:
                raise RuntimeError("Alignment failed to reach final state")
            return out
        n = len(audio)
        T = self.fe.n_frames(n)
        Tpad = max(128, -(-T // 128) * 128)
        c = self._graph_consts(g)
        sig = self._upload(torch.from_numpy(audio.astype(np.int16)))
        cep = self.fe.mfcc(sig[None], n, Tpad)
        Ts = self._upload(torch.tensor([T], dtype=torch.int32))
        feats = feat_f32(cep, Ts, self.do_cmn)[0]
        sen = score_frames_graph(c.gs, feats, dist_mode=dist_mode)
        path, _ = viterbi_single(sen, T, c.vit)
        return self._extract(g, path.cpu().numpy(), T)

    def stream(self, text: str):
        """Streaming alignment with an explicit, checkpointable state
        (streaming.AlignStream): push int16 chunks, end() -> segments."""
        from .streaming import AlignStream

        return AlignStream(self, text)

    def spectrogram(self, audio: np.ndarray,
                    smooth: bool = False) -> np.ndarray:
        """Mel log-spectra [n_frames, nfilt] float32 on the device front
        end (the JS binding's spectrogram(), js/soundswallower.c:88-112)."""
        return self.fe.spectrogram(audio, smooth, device=self.device)

    def align_batch(self, audios: list[np.ndarray], texts: list[str],
                    dist_mode: str = "fold") -> list[list[WordSeg]]:
        """Batch alignment.  A batch of one transcript is one dispatch of
        the same-transcript path; different transcripts are one
        multi-graph dispatch, and an utterance whose transcript has an
        unknown word stays None.  ``SST_MIXED=grouped`` dispatches
        different transcripts a group per text instead
        (_align_batch_grouped), as TpuAligner does."""
        if len(set(texts)) == 1:
            return self._batch_end(self._batch_begin(
                self.graph_for_text(texts[0]), audios, dist_mode))
        if os.environ.get("SST_MIXED", "") == "grouped":
            return self._align_batch_grouped(audios, texts, dist_mode)
        out: list = [None] * len(audios)
        graphs, idxs = [], []
        for i, t in enumerate(texts):
            try:
                graphs.append(self.graph_for_text(t))
            except KeyError:
                continue
            idxs.append(i)
        if not idxs:
            return out
        h = self._batch_begin_mixed(graphs, [audios[i] for i in idxs],
                                    dist_mode)
        for i, segs in zip(idxs, self._batch_end(h)):
            out[i] = segs
        return out

    def _align_batch_grouped(self, audios, texts, dist_mode: str):
        """TpuAligner._align_batch_grouped: group the rows by text,
        dispatch every group's same-transcript batch, then collect; a
        group whose text has an unknown word stays None."""
        groups: dict[str, list[int]] = {}
        for i, t in enumerate(texts):
            groups.setdefault(t, []).append(i)
        out: list = [None] * len(audios)
        handles = []
        for t, idxs in groups.items():
            try:
                g = self.graph_for_text(t)
            except KeyError:
                continue
            handles.append((idxs, self._batch_begin(
                g, [audios[i] for i in idxs], dist_mode)))
        for idxs, h in handles:
            for i, segs in zip(idxs, self._batch_end(h)):
                out[i] = segs
        return out

    def align_batch_scored(self, audios: list[np.ndarray], texts: list[str],
                           dist_mode: str = "fold") -> list:
        """Batch alignment with per-word and per-phone scores (and
        per-state segments under ``want_states``): always the
        multi-graph dispatch on the full-inventory scorer, whose 0 =
        best per frame gives scores in the units of the reference's
        result JSON (TpuAligner.align_batch_scored).  Unknown words
        raise KeyError."""
        graphs = [self.graph_for_text(t) for t in texts]
        prev = self.want_scores
        self.want_scores = True
        try:
            return self._batch_end(self._batch_begin_mixed(graphs, audios,
                                                           dist_mode))
        finally:
            self.want_scores = prev

    def align_batch_begin(self, audios: list[np.ndarray], texts: list[str],
                          dist_mode: str = "fold"):
        """Dispatch one batch; returns a handle for align_batch_end.
        Unknown words raise KeyError."""
        if len(set(texts)) == 1:
            return self._batch_begin(self.graph_for_text(texts[0]), audios,
                                     dist_mode)
        return self._batch_begin_mixed(
            [self.graph_for_text(t) for t in texts], audios, dist_mode)

    def align_batch_end(self, handle) -> list[list[WordSeg]]:
        """Fetch and extract the results of an align_batch_begin batch."""
        return self._batch_end(handle)

    # -- pipelined batch -------------------------------------------------------

    def _chunk_size(self, B: int) -> int:
        """Rows per upload chunk (TpuAligner._chunk_size's default)."""
        return 256 if B >= 1024 else 128

    def _batch_shape(self, audios) -> tuple[list, np.ndarray, int]:
        """Batch-size bucket and frame-axis rounding as TpuAligner
        (aligner.py:798-805): the padded audio list (pad rows repeat the
        last utterance), frames per row, and Tmax."""
        realB = len(audios)
        B = (max(8, 1 << (realB - 1).bit_length()) if realB <= 64
             else -(-realB // 64) * 64)
        audios = list(audios) + [audios[-1]] * (B - realB)
        Ts = np.array([self.fe.n_frames(len(a)) for a in audios])
        Tmax = max(64, self.tmax_floor, -(-int(Ts.max()) // 64) * 64)
        return audios, Ts, Tmax

    def _chunk_feats(self, audios, Ts_d: torch.Tensor, Tmax: int):
        """Start the host FE of every upload chunk on the worker thread
        now; return an iterator of (first row, wire, K1 features
        [n, Tmax, 3, 13]) per chunk, uploading each as it is reached:
        on the i16p wire the byte planes and K1, on the float32 wire
        (``SST_WIRE=f32``) the cepstra [n, Tmax, ncep] and K1's float32
        form.  Without the host FE: (first row, int16 audio [n, N],
        features) from the device FE."""
        chunk = self._chunk_size(len(audios))
        if self.native_fe is None:
            return self._chunk_feats_device(audios, Ts_d, Tmax, chunk)
        starts = range(0, len(audios), chunk)
        if self.wire != "i16p":
            ns = np.array([len(a) for a in audios], np.int32)
            buf = np.zeros((len(audios), int(ns.max())), np.int16)
            for i, a in enumerate(audios):
                buf[i, :len(a)] = a
            futs = [(i0, self._fe_pool.submit(
                self.native_fe.process_batch, buf[i0:i0 + chunk],
                ns[i0:i0 + chunk], Tmax)) for i0 in starts]

            def chunks_f32():
                for i0, fut in futs:
                    cep = self._upload(torch.from_numpy(fut.result()))
                    yield i0, cep, feat_f32(cep, Ts_d[i0:i0 + cep.shape[0]],
                                            self.do_cmn)
            return chunks_f32()
        futs = [(i0, self._fe_pool.submit(self.native_fe.process_list_i16p,
                                          audios[i0:i0 + chunk], Tmax,
                                          self.wire_scale))
                for i0 in starts]

        def chunks():
            for i0, fut in futs:
                pl = self._upload(torch.from_numpy(fut.result()))
                yield i0, pl, feat(pl, Ts_d[i0:i0 + pl.shape[1]],
                                   1.0 / self.wire_scale, self.do_cmn)
        return chunks()

    def _chunk_feats_device(self, audios, Ts_d: torch.Tensor, Tmax: int,
                            chunk: int):
        """The device-FE route (TpuAligner._feats_chunk_raw): the batch's
        int16 audio zero-padded to its longest row in one (pinned)
        buffer; per chunk an upload, K8/K9/K10 from a fresh state and
        K1's float32 form."""
        ns = np.array([len(a) for a in audios], np.int32)
        buf = torch.zeros((len(audios), int(ns.max())), dtype=torch.int16,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        for i, a in enumerate(audios):
            host[i, :len(a)] = a
        ns_d = self._upload(torch.from_numpy(ns))

        def chunks():
            for i0 in range(0, len(audios), chunk):
                sig = buf[i0:i0 + chunk].to(self.device, non_blocking=True)
                cep = self.fe.mfcc(sig, ns_d[i0:i0 + chunk], Tmax)
                yield i0, sig, feat_f32(cep, Ts_d[i0:i0 + sig.shape[0]],
                                        self.do_cmn)
        return chunks()

    def _batch_begin(self, g: AlignGraph, audios,
                     dist_mode: str = "fold") -> _Batch:
        """Host FE (prefetched on a worker thread, chunk by chunk) ->
        pinned upload -> K1, K2, K3 per chunk into one [B, Tmax, S]
        score buffer -> K4 over the whole batch (with token and path
        scores under ``want_scores``) -> download into pinned host
        buffers, with an event recorded after the copies."""
        if self.am.backend == "ms":
            # no graph-restricted ms scorer: the full-inventory scores
            # and the per-row gather of the multi-graph route
            # (TpuAligner._batch_begin)
            return self._batch_begin_mixed([g] * len(audios), audios,
                                           dist_mode)
        realB = len(audios)
        if realB == 0:
            return self._empty()
        audios, Ts, Tmax = self._batch_shape(audios)
        Ts_d = self._upload(torch.from_numpy(Ts.astype(np.int32)))
        c = self._graph_consts(g)
        sen = self._graph_scores(c.gs, audios, Ts_d, Tmax, dist_mode)
        path, pscore, fscore = viterbi_batch(sen, Ts_d, c.vit,
                                             self.want_scores)
        return self._download([g] * realB, Ts[:realB], realB, path, fscore,
                              pscore)

    def _graph_scores(self, gs: GraphScorer, audios, Ts_d: torch.Tensor,
                      Tmax: int, dist_mode: str) -> torch.Tensor:
        """The same-transcript route's scores: per upload chunk the front
        end and K1, then K2/K3 on the graph's scorer into one [B, Tmax,
        S] int32 buffer."""
        sen = torch.empty((len(audios), Tmax, gs.S), dtype=torch.int32,
                          device=self.device)
        for i0, _, feats in self._chunk_feats(audios, Ts_d, Tmax):
            n = feats.shape[0]
            score_frames_graph(gs, feats.view(n * Tmax, 3, -1),
                               out=sen[i0:i0 + n].view(n * Tmax, -1),
                               dist_mode=dist_mode)
        return sen

    def _batch_begin_mixed(self, graphs: list, audios,
                           dist_mode: str = "fold") -> _Batch:
        """One dispatch for a batch of different transcripts
        (TpuAligner._batch_begin_mixed): the same bucketing and chunked
        front end as _batch_begin; per chunk, K2/K3 over the working-set
        union (_union_scorer), or K2/K3/K7 over the full inventory under
        ``want_scores`` or once the union is dense (K11/K12 for ms),
        then K5 into one
        [B, Tmax, S] buffer in each row's graph-state order; then K6
        over the stacked per-row graphs, with token scores under
        ``want_scores``; pinned downloads with an event after them."""
        realB = len(audios)
        if realB == 0:
            return self._empty()
        audios, Ts, Tmax = self._batch_shape(audios)
        graphs = list(graphs) + [graphs[-1]] * (len(audios) - realB)
        uni = None if self.want_scores else self._union_scorer(graphs)
        if uni is None:
            st = self._stacked_graphs(graphs)
        else:
            st = self._stacked_graphs(graphs, remap=uni["pos"],
                                      remap_ver=uni["ver"])
        Ts_d = self._upload(torch.from_numpy(Ts.astype(np.int32)))
        chunks = self._chunk_feats(audios, Ts_d, Tmax)
        sen = torch.empty((len(audios), Tmax, st.sencols.shape[1]),
                          dtype=torch.int32, device=self.device)
        for i0, _, feats in chunks:
            n = feats.shape[0]
            flat = feats.view(n * Tmax, 3, -1)
            if uni is None:
                src = score_frames(self.dense, flat, dist_mode)     # int16
            else:
                src = score_frames_graph(uni["gs"], flat,
                                         dist_mode=dist_mode)       # int32
            gather_cols(src.view(n, Tmax, -1), st.sencols[i0:i0 + n],
                        out=sen[i0:i0 + n])
        path, pscore, fscore = viterbi_rows(sen, Ts_d, st.vit,
                                            self.want_scores)
        return self._download(graphs[:realB], Ts[:realB], realB, path,
                              fscore, pscore)

    # mixed batches switch from the union scorer to the full inventory
    # once the working set covers this share of the senones
    UNION_MAX_FRAC = 0.6

    def _union_scorer(self, graphs: list) -> dict | None:
        """The working-set union scorer of mixed batches, as
        TpuAligner._union_scorer keeps it: the union of every senone
        the aligner's mixed batches have used grows monotonically, its
        column count Spad buckets to multiples of 256 and never shrinks,
        pad columns score senone 0 (so senone 0's codebook joins the
        union's codebook norm), and once the set passes UNION_MAX_FRAC of
        the inventory ``dense`` turns on for good (None: score the full
        inventory).  Scores therefore depend on the batches seen before.
        An ms model starts dense (it has no graph-restricted scorer).
        """
        u = self._uni
        if u is None:
            u = self._uni = dict(ver=0, senset=np.zeros(0, np.int64),
                                 gs=None, Spad=0,
                                 dense=self.am.backend == "ms",
                                 pos=np.full(self.am.n_sen, -1, np.int32))
        if u["dense"]:
            return None
        need = np.unique(np.concatenate(
            [g.senid.ravel() for g in graphs]).astype(np.int64))
        if u["gs"] is None or np.any(u["pos"][need] < 0):
            senset = np.unique(np.concatenate([u["senset"], need]))
            if len(senset) > self.UNION_MAX_FRAC * self.am.n_sen:
                u["dense"] = True
                return None
            Spad = max(256, -(-len(senset) // 256) * 256, u["Spad"])
            senid_flat = np.zeros(Spad, np.int64)   # pad columns: senone 0
            senid_flat[: len(senset)] = senset
            pos = np.full(self.am.n_sen, -1, np.int32)
            pos[senset] = np.arange(len(senset), dtype=np.int32)
            gs = GraphScorer.build(self.am, senid_flat, self.device)
            u.update(ver=u["ver"] + 1, senset=senset, Spad=Spad, pos=pos,
                     gs=gs)
        return u

    def _stacked_graphs(self, graphs: list, remap: np.ndarray | None = None,
                        remap_ver: int = 0) -> _Stack:
        """stack_graphs on the device, cached by (graph serials, union
        version, size-class floors), 32 entries, first in first out.
        ``remap`` maps senones to scorer columns: the union's positions,
        or the identity of the full inventory's senone order."""
        key = (tuple(g.serial for g in graphs), remap_ver,
               self.graph_p_floor, self.graph_k_floor, self.graph_w_floor)
        st = self._stack_cache.get(key)
        if st is None:
            raw = stack_graphs(graphs, self.am.tmat.astype(np.int32),
                               np.arange(self.am.n_sen) if remap is None
                               else remap,
                               p_floor=self.graph_p_floor,
                               k_floor=self.graph_k_floor,
                               w_floor=self.graph_w_floor)
            st = _Stack(row_consts_from_numpy(raw, self.device),
                        to_device(raw["sencols"], np.int32, self.device))
            if len(self._stack_cache) >= 32:
                self._stack_cache.pop(next(iter(self._stack_cache)))
            self._stack_cache[key] = st
        return st

    def _empty(self) -> _Batch:
        return _Batch([], np.zeros(0, np.int64),
                      torch.zeros((0, 0), dtype=torch.int16),
                      torch.zeros(0, dtype=torch.int32), 0)

    def _download(self, graphs, Ts, realB, path, fscore,
                  pscore=None) -> _Batch:
        """The batch handle; on CUDA the results are copied into pinned
        host buffers, with an event recorded after the copies."""
        done = None
        if self.device.type == "cuda":
            def host(t):
                if t is None:
                    return None
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                return h

            path, fscore, pscore = host(path), host(fscore), host(pscore)
            done = torch.cuda.Event()
            done.record()
        return _Batch(graphs, Ts, path, fscore, realB, pscore, done)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _batch_end(self, handle: _Batch) -> list:
        """Wait for the downloads; native extraction on the unscored
        path when the library loads, Python extraction (and scores,
        states) otherwise."""
        if handle.done is not None:
            handle.done.synchronize()
        if handle.realB == 0:
            return []
        paths = handle.paths.numpy()
        if handle.pscore is None and not self.want_states:
            out = self._extract_batch_native(handle.graphs, paths,
                                             handle.Ts, handle.realB)
            if out is not None:
                return out
        pscores = None if handle.pscore is None else handle.pscore.numpy()
        return [self._extract_safe(g, paths[i], int(handle.Ts[i]),
                                   None if pscores is None else pscores[i])
                for i, g in enumerate(handle.graphs)]

    # -- segment extraction ------------------------------------------------------

    def _seg_lib(self):
        """native/libsst_seg.so, or None where it does not load."""
        if not hasattr(self, "_segl"):
            import ctypes as ct

            lib = native_build.load_native("libsst_seg.so")
            if lib is not None:
                i32p = np.ctypeslib.ndpointer(np.int32)
                i64p = np.ctypeslib.ndpointer(np.int64)
                lib.sst_extract_batch.restype = ct.c_int
                lib.sst_extract_batch.argtypes = [
                    np.ctypeslib.ndpointer(np.int16), ct.c_int, ct.c_int,
                    i64p, ct.c_int, i32p, i32p, i32p, i64p,
                    i32p, i32p, i32p, i32p, i32p, i32p,
                    i32p, i32p, i32p, ct.c_int64, ct.c_int64,
                ]
            self._segl = lib
        return self._segl

    def _seg_tables(self, graphs: list) -> tuple:
        """Node tables of the rows' graphs for sst_extract_batch: each
        distinct graph's word_of/variant_of/cipid once, concatenated,
        and each row's offset into them; cached per graph tuple (64
        entries, first in first out), as TpuAligner does."""
        key = tuple(g.serial for g in graphs)
        tab = self._seg_tab_cache.get(key)
        if tab is None:
            start: dict[int, int] = {}
            uniq = []
            pos = 0
            for g in graphs:
                if g.serial not in start:
                    start[g.serial] = pos
                    pos += len(g.word_of)
                    uniq.append(g)
            offs = np.zeros(len(graphs) + 1, np.int64)
            offs[:len(graphs)] = [start[g.serial] for g in graphs]
            tab = tuple(np.concatenate([getattr(g, name) for g in uniq])
                        .astype(np.int32)
                        for name in ("word_of", "variant_of", "cipid")) \
                + (offs,)
            if len(self._seg_tab_cache) >= 64:
                self._seg_tab_cache.pop(next(iter(self._seg_tab_cache)))
            self._seg_tab_cache[key] = tab
        return tab

    def _extract_batch_native(self, graphs: list, paths: np.ndarray,
                              Ts: np.ndarray, realB: int) -> list:
        """Whole-batch segment extraction with native/sst_seg.cpp (the
        library TpuAligner._extract_batch_native calls, same tables),
        one graph per row; None where the library does not load."""
        lib = self._seg_lib()
        if lib is None:
            return None
        wo, vo, cp, offs = self._seg_tables(graphs)
        paths = np.ascontiguousarray(paths[:realB], np.int16)
        Ts64 = np.ascontiguousarray(Ts[:realB], np.int64)
        cap = int(Ts64.sum()) + realB
        nw = np.empty(realB, np.int32)
        w = [np.empty(cap, np.int32) for _ in range(5)]
        p = [np.empty(cap, np.int32) for _ in range(3)]
        rc = lib.sst_extract_batch(
            paths, realB, paths.shape[1], Ts64, graphs[0].senid.shape[1],
            wo, vo, cp, offs, nw, *w, *p, cap, cap)
        if rc != 0:
            raise RuntimeError(f"sst_extract_batch failed ({rc})")
        w_kind, w_var, w_start, w_dur, w_np = w
        p_ci, p_start, p_dur = p
        ci = self._ci_strs()
        out: list = []
        wi = pi = 0
        for b in range(realB):
            n = int(nw[b])
            if n < 0:
                out.append(None)
                continue
            segs = []
            for _ in range(n):
                k = int(w_np[wi])
                phones = [(ci[p_ci[pi + j]], int(p_start[pi + j]),
                           int(p_dur[pi + j]), 0) for j in range(k)]
                word = "<sil>" if w_kind[wi] else self.dict.wordstr(
                    int(w_var[wi]))
                segs.append(WordSeg(word, int(w_start[wi]), int(w_dur[wi]),
                                    phones=phones))
                wi += 1
                pi += k
            out.append(segs)
        return out

    def _ci_strs(self) -> list[str]:
        if not hasattr(self, "_ci_str_list"):
            m = self.am.mdef
            self._ci_str_list = [m.ciphone_str(i)
                                 for i in range(m.n_ciphone)]
        return self._ci_str_list

    def _extract(self, g: AlignGraph, path: np.ndarray, T: int,
                 pscore: np.ndarray | None = None) -> list[WordSeg]:
        """Decoded state path -> word/phone segments (TpuAligner._extract).

        state_align_search_finish's boundary rule
        (state_align_search.c:236-255): a state's segment starts at the
        frame after its backpointer changes, so interior boundaries
        shift by +1.  With ``pscore`` (the cumulative path score per
        frame) a phone's score is the difference across its segment and
        a word's the sum of its phones (ps_alignment.c:316-352); with
        ``want_states`` each phone also carries its HMM-state segments
        (senone id, start, duration, score)."""
        if path[T - 1] < 0:
            raise RuntimeError("Alignment failed to reach final state")
        p = np.asarray(path[:T])
        ch = np.nonzero(p[1:] != p[:-1])[0]     # change between ch, ch+1
        E = g.senid.shape[1]
        # state runs [starts, ends); only the last can be empty
        n_runs = len(ch) + 1
        states = np.empty(n_runs, np.int64)
        states[:-1] = p[ch]
        states[-1] = int(p[T - 1])
        starts = np.empty(n_runs, np.int64)
        starts[0] = 0
        starts[1:] = ch + 2
        ends = np.empty(n_runs, np.int64)
        ends[:-1] = ch + 2
        ends[-1] = T
        if n_runs > 1 and ends[-1] == starts[-1]:
            states, starts, ends = states[:-1], starts[:-1], ends[:-1]
        nodes = states // E
        # consecutive runs of one node make a phone segment
        pb = np.nonzero(np.concatenate(([True], nodes[1:] != nodes[:-1])))[0]
        p_node = nodes[pb].tolist()
        p_start = starts[pb]
        p_end = np.concatenate((p_start[1:], ends[-1:]))

        def span_scores(lo, hi):
            if pscore is None:
                return [0] * len(lo)
            ps = np.asarray(pscore)
            top = ps[hi - 1].astype(np.int64)
            bot = np.where(lo > 0, ps[np.maximum(lo, 1) - 1],
                           0).astype(np.int64)
            return (top - bot).tolist()

        p_sc = span_scores(p_start, p_end)
        p_dur = (p_end - p_start).tolist()
        p_start = p_start.tolist()
        st_per_phone = None
        if self.want_states:
            senids = np.asarray(g.senid)[nodes, states % E].tolist()
            r_sc = span_scores(starts, ends)
            pb2 = pb.tolist() + [len(nodes)]
            r_starts = starts.tolist()
            r_durs = (ends - starts).tolist()
            st_per_phone = [
                [(senids[j], r_starts[j], r_durs[j], r_sc[j])
                 for j in range(pb2[i], pb2[i + 1])]
                for i in range(len(pb))]
        ci_strs = self._ci_strs()
        cur_word = None
        cur = None
        out: list[WordSeg] = []
        for i, (node, start, dur, sc) in enumerate(
                zip(p_node, p_start, p_dur, p_sc)):
            w = int(g.word_of[node])
            ci = ci_strs[int(g.cipid[node])]
            sts = None if st_per_phone is None else [st_per_phone[i]]
            if w < 0:
                out.append(WordSeg("<sil>", start, dur, score=sc,
                                   phones=[(ci, start, dur, sc)],
                                   states=sts))
                cur_word = None
                continue
            if cur_word != w:
                cur = WordSeg(self.dict.wordstr(int(g.variant_of[node])),
                              start, 0, phones=[],
                              states=None if st_per_phone is None else [])
                out.append(cur)
                cur_word = w
            cur.duration += dur
            cur.score += sc
            cur.phones.append((ci, start, dur, sc))
            if st_per_phone is not None:
                cur.states.append(st_per_phone[i])
        return out

    def _extract_safe(self, g: AlignGraph, path: np.ndarray, T: int,
                      pscore: np.ndarray | None = None):
        """_extract, with an unreachable final state failing only that
        row (None)."""
        try:
            return self._extract(g, path, T, pscore)
        except RuntimeError:
            return None

    # -- grammar decoding ----------------------------------------------------

    def set_grammar(self, fsg=None, jsgf_file: str | None = None,
                    jsgf_string: str | None = None) -> AlignGraph:
        """Compile a grammar (FsgModel or JSGF) into a static decode graph
        (ops/decode_graph.py), with silence self-loops and alternate
        pronunciations added per config like fsg_search_init
        (fsg_search.c:84-170), as TpuAligner.set_grammar."""
        from .jsgf import Jsgf
        from .ops.decode_graph import build_fsg_graph

        if jsgf_file is not None or jsgf_string is not None:
            j = Jsgf.parse_file(jsgf_file) if jsgf_file \
                else Jsgf.parse_string(jsgf_string)
            rule = j.get_rule(self.config["toprule"]) \
                if self.config["toprule"] else j.default_rule()
            fsg = j.build_fsg(rule, self.lmath, self.config.get_float("lw"))
        if fsg is None:
            raise ValueError("need fsg, jsgf_file, or jsgf_string")
        if self.config.get_bool("fsgusefiller") and not fsg.has_sil:
            fsg.add_silence("<sil>", -1, self.config.get_float("silprob"))
            for wid in range(self.dict.filler_start,
                             self.dict.filler_end + 1):
                if wid in (self.dict.startwid, self.dict.finishwid,
                           self.dict.silwid):
                    continue
                fsg.add_silence(self.dict.wordstr(wid), -1,
                                self.config.get_float("fillprob"))
        if self.config.get_bool("fsgusealtpron") and not fsg.has_alt:
            for word in list(fsg.vocab):
                wid = self.dict.wordid(word)
                if wid < 0:
                    continue
                alt = self.dict.nextalt(wid)
                while alt >= 0:
                    fsg.add_alt(word, self.dict.wordstr(alt))
                    alt = self.dict.nextalt(alt)
        self._decode_graph = build_fsg_graph(
            fsg, self.dict, self.d2p, self.am, self.lmath, self.config)
        self._decode_fsg = fsg
        return self._decode_graph

    def _grammar(self) -> AlignGraph:
        g = getattr(self, "_decode_graph", None)
        if g is None:
            raise RuntimeError("call set_grammar() first")
        return g

    def _hyp(self, segs: list) -> str:
        return " ".join(self.dict.wordstr(self.dict.basewid_of(s.wid))
                        for s in segs if not self.dict.filler_word(s.wid))

    def decode(self, audio: np.ndarray,
               dist_mode: str = "fold") -> tuple[str, list[WordSeg]]:
        """Grammar decode of one int16 utterance against the set_grammar()
        graph: dense global Viterbi, no beams.  With the host FE through
        decode_batch, else on the single-utterance device path (K8-K10,
        K1, K2/K3, K4's carry form).  Returns (hyp text, segs)."""
        g = self._grammar()
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            raise TypeError("decode expects int16 audio")
        if self.native_fe is not None:
            res = self.decode_batch([audio], dist_mode)[0]
            if res is None:
                raise RuntimeError("Decode failed to reach final state")
            return res
        n = len(audio)
        T = self.fe.n_frames(n)
        Tpad = max(128, -(-T // 128) * 128)
        c = self._graph_consts(g)
        sig = self._upload(torch.from_numpy(audio.astype(np.int16)))
        cep = self.fe.mfcc(sig[None], n, Tpad)
        Ts = self._upload(torch.tensor([T], dtype=torch.int32))
        feats = feat_f32(cep, Ts, self.do_cmn)[0]
        path, _ = viterbi_single(
            score_frames_graph(c.gs, feats, dist_mode=dist_mode), T, c.vit)
        segs = self._extract_decode(g, path.cpu().numpy(), T)
        return self._hyp(segs), segs

    def decode_batch(self, audios: list[np.ndarray],
                     dist_mode: str = "fold") -> list:
        """Grammar decode of a batch against the set_grammar() graph on
        the same-transcript route (K1, K2/K3, K4).  Returns (hyp, segs)
        per utterance, None where the final state is not reached."""
        g = self._grammar()
        return self._decode_end(g, self._batch_begin(g, audios, dist_mode))

    def decode_batch_scored(self, audios: list[np.ndarray],
                            dist_mode: str = "fold") -> list:
        """decode_batch with per-segment scores: the multi-graph route
        on the full-inventory scorer (K2, K3, K7, K5, K6 with token
        scores), as align_batch_scored.  Returns (hyp, segs) or None per
        utterance."""
        g = self._grammar()
        prev = self.want_scores
        self.want_scores = True
        try:
            handle = self._batch_begin_mixed([g] * len(audios), audios,
                                             dist_mode)
        finally:
            self.want_scores = prev
        return self._decode_end(g, handle)

    def _decode_end(self, g: AlignGraph, handle: _Batch) -> list:
        if handle.done is not None:
            handle.done.synchronize()
        paths = handle.paths.numpy()
        pscores = None if handle.pscore is None else handle.pscore.numpy()
        out: list = []
        for i in range(handle.realB):
            try:
                segs = self._extract_decode(
                    g, paths[i], int(handle.Ts[i]),
                    None if pscores is None else pscores[i])
            except RuntimeError:
                out.append(None)
                continue
            out.append((self._hyp(segs), segs))
        return out

    def _extract_decode(self, g: AlignGraph, path, T: int,
                        pscore=None) -> list[WordSeg]:
        """Decode-path extraction (TpuAligner._extract_decode): a graph
        traversal can re-enter the same node (self-loop grammars), so a
        within-node HMM-state decrease marks a re-entry boundary; words
        group by runs of the same graph transition (word_of), a new
        traversal starting wherever the phone position does not
        advance."""
        if path[T - 1] < 0:
            raise RuntimeError("Decode failed to reach final state")
        p = np.asarray(path[:T])
        E = g.senid.shape[1]
        node = p // E
        state = p % E
        change = (node[1:] != node[:-1]) | (state[1:] < state[:-1])
        ch = np.nonzero(change)[0]
        bounds = [0] + (ch + 2).tolist() + [T]
        nodes_seq = node[ch].tolist() + [int(node[T - 1])]

        def seg_score(s, e):  # frames [s, e)
            if pscore is None:
                return 0
            hi = int(pscore[min(e, T) - 1])
            lo = int(pscore[s - 1]) if s > 0 else 0
            return hi - lo

        ci_strs = self._ci_strs()
        segs: list[WordSeg] = []
        cur_ti = None
        last_pos = -1
        for i, nd in enumerate(nodes_seq):
            start = bounds[i]
            dur = bounds[i + 1] - bounds[i]
            if dur <= 0:
                continue
            ti = int(g.word_of[nd])
            pos = int(g.pos_of[nd])
            wid = int(g.variant_of[nd])
            ci = ci_strs[int(g.cipid[nd])]
            if ti != cur_ti or pos <= last_pos:
                seg = WordSeg(self.dict.wordstr(wid), start, 0, phones=[])
                seg.wid = wid
                segs.append(seg)
                cur_ti = ti
            seg = segs[-1]
            sc = seg_score(start, start + dur)
            seg.phones.append((ci, start, dur, sc))
            seg.duration = start + dur - seg.start
            seg.score += sc
            last_pos = pos
        return segs

    # -- lattice / nbest (scores on the card, history search on the host) ----

    def _dense_scores_utt(self, audio: np.ndarray,
                          dist_mode: str = "fold") -> np.ndarray:
        """Full-inventory int16 senone scores [T, n_sen] of one utterance
        in senone order (the acmod_score contract the host search reads),
        the frame axis bucketed to 64: the host FE's float32 cepstra or
        the device FE, K1's float32 form, K2, K3 and K7."""
        audio = np.asarray(audio)
        n = len(audio)
        T = self.fe.n_frames(n)
        Tpad = max(64, -(-T // 64) * 64)
        if self.native_fe is not None:
            cep = self.native_fe.process_batch(audio[None], np.array([n]),
                                               Tpad)
            cep = self._upload(torch.from_numpy(
                np.ascontiguousarray(cep, np.float32)))
        else:
            sig = self._upload(torch.from_numpy(audio.astype(np.int16)))
            cep = self.fe.mfcc(sig[None], n, Tpad)
        Ts = self._upload(torch.tensor([T], dtype=torch.int32))
        feats = feat_f32(cep, Ts, self.do_cmn)[0]
        return score_frames(self.dense, feats, dist_mode).cpu().numpy()[:T]

    def decode_search(self, audio: np.ndarray, dist_mode: str = "fold"):
        """Grammar decode with the full history table: the card's dense
        scores fed to the reference's beam search and history dedup on
        the host (search_fsg.FsgSearch), as TpuAligner.decode_search.
        Returns the finished FsgSearch (hyp(), seg_iter(); the input of
        Lattice.from_fsg_search)."""
        from .search_fsg import FsgSearch

        fsg = getattr(self, "_decode_fsg", None)
        if fsg is None:
            raise RuntimeError("call set_grammar() first")
        sen = self._dense_scores_utt(audio, dist_mode)
        search = FsgSearch(fsg, self.config, self.am, self.dict, self.d2p,
                           self.lmath)
        search.start()
        for t in range(len(sen)):
            search.step(sen[t], t)
        search.finish()
        return search

    def lattice(self, audio: np.ndarray, dist_mode: str = "fold"):
        """Word DAG of one utterance against the set_grammar() grammar
        (decoder_lattice / fsg_search_lattice, fsg_search.c:1344-1524),
        built from decode_search's history."""
        from .lattice import Lattice

        return Lattice.from_fsg_search(self.decode_search(audio, dist_mode),
                                       self.config)

    def nbest(self, audio: np.ndarray, sf: int = 0, ef: int = -1,
              dist_mode: str = "fold"):
        """A* N-best iterator yielding (hyp, score) best-first
        (decoder_nbest semantics) over the lattice."""
        from .lattice import AstarSearch

        dag = self.lattice(audio, dist_mode)
        dag.bestpath(self.config.get_float("ascale"))
        astar = AstarSearch(dag, sf, ef)
        while True:
            p = astar.next()
            if p is None:
                return
            yield astar.hyp(p), p.score

    # -- long form (sequence parallel) ----------------------------------------

    def align_longform_batch(self, audios: list[np.ndarray], texts: list[str],
                             ring=None,
                             dist_mode: str = "fold") -> list[list[WordSeg]]:
        """Sequence-parallel alignment of long audio (TpuAligner's
        align_longform_batch): the rows scored as the same-transcript
        route scores them (the same wire, the same graph scorer and
        ``dist_mode``), the frame axis rounded up to 64 per rank of
        ``ring`` (a parallel.SeqRing; one local rank on the aligner's
        device when None), then the ring-carried Viterbi and chunk
        backtrace (parallel/seqpipe.py) and segment extraction per row.
        Segments equal align_batch's on the same audio."""
        from .parallel.seqpipe import align_longform, seq_ring

        if len(set(texts)) != 1:
            raise ValueError("align_longform_batch needs one shared "
                             "transcript (one graph) per call")
        if ring is None:
            ring = seq_ring(1, self.device)
        g = self.graph_for_text(texts[0])
        Ts = np.array([self.fe.n_frames(len(a)) for a in audios])
        gran = 64 * ring.nseq
        Tmax = max(gran, -(-int(Ts.max()) // gran) * gran)
        Ts_d = self._upload(torch.from_numpy(Ts.astype(np.int32)))
        sen = self._graph_scores(self._graph_consts(g).gs, audios, Ts_d,
                                 Tmax, dist_mode)
        P, E = g.senid.shape
        pi, pp, pk = build_pred_table(g.edge_src, g.edge_dst, g.edge_pen, P)
        paths, _ = align_longform(
            ring, sen, np.arange(P * E).reshape(P, E),
            self.am.tmat.astype(np.int32)[g.tmatid], pi, pp, pk, g.astart,
            g.aend, Ts.astype(np.int32),
            np.where(g.is_entry, g.entry_pen, WORST_SCORE), g.final_nodes)
        paths = paths.cpu().numpy()
        return [self._extract_safe(g, paths[i], int(Ts[i]))
                for i in range(len(audios))]

    # -- not ported yet ----------------------------------------------------

    def use_mesh(self, *a, **k):
        raise _unported("use_mesh", "A13")

    def update_mllr(self, *a, **k):
        raise _unported("update_mllr", "A14")
