"""TorchAligner: same-transcript batch forced alignment on PyTorch.

Port of the batch path of ``soundswallower_tpu/aligner.py`` (TpuAligner):
host C++ MFCC -> int16 byte-plane wire -> upload -> K1 dynamic features
-> K2/K3 graph-restricted senone scores -> K4 Viterbi, final-node select
and backtrace -> download -> native segment extraction
(``native/sst_seg.cpp``).  Host modules (config, model, dictionary,
phone graph, native FE, segment extraction library) are the JAX
package's own, loaded through ``_shared``.

``device="cuda"`` runs the hand-written kernels (``csrc/``) and raises
if no CUDA device is present; ``device="cpu"`` runs their plain PyTorch
versions.  Nothing falls back from one to the other.

Batches of different transcripts run one group per transcript
(TpuAligner's ``SST_MIXED=grouped`` dispatch); the single-dispatch mixed
path is still to be ported (ROADMAP.md B6), as are ``want_scores``, the
ms backend, 5-state models, ``decode*``, ``stream``,
``align_longform_batch``, ``use_mesh`` and ``update_mllr``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ._shared import load
from .fe.feat import feat
from .fe.frontend import Frontend
from .ops.align_torch import (WORST_SCORE, VitConsts, build_pred_table,
                              viterbi_batch)
from .ops.senscore_torch import GraphScorer, score_frames_graph
from .utils import to_device

Config = load("config").Config
LogMath = load("logmath").LogMath
AcousticModel = load("am").AcousticModel
Dictionary = load("dictionary").Dictionary
Dict2Pid = load("dict2pid").Dict2Pid
_align_graph = load("ops.align_graph")
AlignGraph = _align_graph.AlignGraph
build_chain_graph = _align_graph.build_chain_graph
NativeFrontend = load("fe.native_fe").NativeFrontend


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
class _Batch:
    """Handle of a dispatched same-transcript batch."""

    g: AlignGraph
    Ts: np.ndarray           # [realB] frame counts
    paths: torch.Tensor      # int16 [B, Tmax], host (pinned on CUDA)
    fscore: torch.Tensor     # int32 [B], host
    realB: int
    done: torch.cuda.Event | None = None


@dataclass(eq=False)
class _Grouped:
    """Handle of a mixed-transcript batch: one _Batch per transcript."""

    n: int
    parts: list              # (row indices, _Batch)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


class TorchAligner:
    """Batch forced aligner with TpuAligner's batch API."""

    def __init__(self, config=None, device: str | torch.device = "cuda",
                 **kwargs):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device is "
                                   "available")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        if config is None:
            config = Config(**kwargs)
        self.config = config
        config.expand()
        if config["mllr"]:
            raise _unported("update_mllr / mllr", "A14")
        self.lmath = LogMath(config.get_float("logbase"), 0, True)
        self.am = AcousticModel.load(config, self.lmath)
        if self.am.mdef.n_emit_state != 3:
            raise _unported("5-state HMMs", "B4")
        if self.am.backend != "ptm" or self.am.mixw_cb is not None:
            raise _unported(f"the {self.am.backend} backend and 4-bit "
                            "sendumps on the card", "B7/B8")
        self.dict = Dictionary(self.am.mdef, config["dict"], config["fdict"],
                               config.get_bool("dictcase"))
        self.d2p = Dict2Pid(self.am.mdef, self.dict)
        self.fe = Frontend.from_config(config)
        self.native_fe = NativeFrontend.load(self.fe)
        if self.native_fe is None:
            raise RuntimeError(
                "the host C++ front end (native/libsst_fe.so) did not load; "
                "the device front end is not ported (ROADMAP.md B10)")
        # i16p wire scale (aligner.py: 256 for legacy, 128 for dct/htk)
        self.wire_scale = 256.0 if config["transform"] == "legacy" else 128.0
        self.do_cmn = config["cmn"] in ("batch", "current")
        # serving size-class floors (AlignService.prewarm sets them)
        self.tmax_floor = 0
        self.graph_p_floor = 0
        self.graph_k_floor = 0
        self.graph_w_floor = 0
        self.want_scores = False
        self._graph_cache: dict[str, AlignGraph] = {}
        self._graph_const_cache: dict[int, GraphConsts] = {}
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

    @staticmethod
    def _fold_only(dist_mode: str) -> None:
        if dist_mode != "fold":
            raise _unported(f"dist_mode={dist_mode!r}", "B2")

    def align(self, audio: np.ndarray, text: str,
              dist_mode: str = "fold") -> list[WordSeg]:
        """Align one int16 utterance (through the batch path, as
        TpuAligner does with its native FE)."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            raise TypeError("align expects int16 audio")
        self._fold_only(dist_mode)
        out = self._batch_end(self._batch_begin(self.graph_for_text(text),
                                                [audio]))[0]
        if out is None:
            raise RuntimeError("Alignment failed to reach final state")
        return out

    def align_batch(self, audios: list[np.ndarray], texts: list[str],
                    dist_mode: str = "fold") -> list[list[WordSeg]]:
        """Batch alignment.  A batch of one transcript is one dispatch;
        mixed transcripts run one group per transcript, and an
        utterance whose transcript has an unknown word stays None."""
        self._fold_only(dist_mode)
        if len(set(texts)) == 1:
            return self._batch_end(self._batch_begin(
                self.graph_for_text(texts[0]), audios))
        return self._batch_end(self._begin_grouped(audios, texts, True))

    def align_batch_begin(self, audios: list[np.ndarray], texts: list[str],
                          dist_mode: str = "fold"):
        """Dispatch one batch; returns a handle for align_batch_end.
        Unknown words raise KeyError."""
        self._fold_only(dist_mode)
        if len(set(texts)) == 1:
            return self._batch_begin(self.graph_for_text(texts[0]), audios)
        return self._begin_grouped(audios, texts, False)

    def align_batch_end(self, handle) -> list[list[WordSeg]]:
        """Fetch and extract the results of an align_batch_begin batch."""
        return self._batch_end(handle)

    def _begin_grouped(self, audios, texts, skip_unknown: bool) -> _Grouped:
        """One same-transcript batch per distinct transcript, all
        dispatched before any is collected (TpuAligner's grouped mixed
        dispatch, aligner.py:580-599)."""
        groups: dict[str, list[int]] = {}
        for i, t in enumerate(texts):
            groups.setdefault(t, []).append(i)
        parts = []
        for t, idxs in groups.items():
            try:
                g = self.graph_for_text(t)
            except KeyError:
                if skip_unknown:
                    continue
                raise
            parts.append((idxs, self._batch_begin(
                g, [audios[i] for i in idxs])))
        return _Grouped(len(audios), parts)

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
        now; return an iterator of (first row, planes, K1 features
        [n, Tmax, 3, 13]) per chunk, uploading each as it is reached."""
        chunk = self._chunk_size(len(audios))
        futs = [(i0, self._fe_pool.submit(self.native_fe.process_list_i16p,
                                          audios[i0:i0 + chunk], Tmax,
                                          self.wire_scale))
                for i0 in range(0, len(audios), chunk)]

        def chunks():
            for i0, fut in futs:
                pl = self._upload(torch.from_numpy(fut.result()))
                yield i0, pl, feat(pl, Ts_d[i0:i0 + pl.shape[1]],
                                   1.0 / self.wire_scale, self.do_cmn)
        return chunks()

    def _batch_begin(self, g: AlignGraph, audios) -> _Batch:
        """Host FE (prefetched on a worker thread, chunk by chunk) ->
        pinned upload -> K1, K2, K3 per chunk into one [B, Tmax, S]
        score buffer -> K4 over the whole batch -> download into pinned
        host buffers, with an event recorded after the copies."""
        if self.want_scores:
            raise _unported("want_scores=True", "A7")
        realB = len(audios)
        if realB == 0:
            return _Batch(g, np.zeros(0, np.int64),
                          torch.zeros((0, 0), dtype=torch.int16),
                          torch.zeros(0, dtype=torch.int32), 0)
        audios, Ts, Tmax = self._batch_shape(audios)
        Ts_d = self._upload(torch.from_numpy(Ts.astype(np.int32)))
        chunks = self._chunk_feats(audios, Ts_d, Tmax)
        c = self._graph_consts(g)
        cuda = self.device.type == "cuda"
        sen = torch.empty((len(audios), Tmax, c.gs.S), dtype=torch.int32,
                          device=self.device)
        for i0, _, feats in chunks:
            n = feats.shape[0]
            score_frames_graph(c.gs, feats.view(n * Tmax, 3, -1),
                               out=sen[i0:i0 + n].view(n * Tmax, -1))
        path, fscore = viterbi_batch(sen, Ts_d, c.vit)
        done = None
        if cuda:
            path_h = torch.empty(path.shape, dtype=path.dtype,
                                 pin_memory=True)
            fs_h = torch.empty(fscore.shape, dtype=fscore.dtype,
                               pin_memory=True)
            path_h.copy_(path, non_blocking=True)
            fs_h.copy_(fscore, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            path, fscore = path_h, fs_h
        return _Batch(g, Ts[:realB], path, fscore, realB, done)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _batch_end(self, handle) -> list:
        if isinstance(handle, _Grouped):
            out: list = [None] * handle.n
            for idxs, h in handle.parts:
                for i, segs in zip(idxs, self._batch_end(h)):
                    out[i] = segs
            return out
        if handle.done is not None:
            handle.done.synchronize()
        if handle.realB == 0:
            return []
        return self._extract_batch_native(handle.g, handle.paths.numpy(),
                                          handle.Ts, handle.realB)

    # -- segment extraction ------------------------------------------------------

    def _seg_lib(self):
        if not hasattr(self, "_segl"):
            import ctypes as ct

            lib = load("utils.native_build").load_native("libsst_seg.so")
            if lib is None:
                raise RuntimeError("native/libsst_seg.so did not build")
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

    def _extract_batch_native(self, g: AlignGraph, paths: np.ndarray,
                              Ts: np.ndarray, realB: int) -> list:
        """Whole-batch segment extraction with native/sst_seg.cpp (the
        library TpuAligner._extract_batch_native calls, same tables)."""
        lib = self._seg_lib()
        wo = g.word_of.astype(np.int32)
        vo = g.variant_of.astype(np.int32)
        cp = g.cipid.astype(np.int32)
        offs = np.zeros(realB + 1, np.int64)
        paths = np.ascontiguousarray(paths[:realB], np.int16)
        Ts64 = np.ascontiguousarray(Ts[:realB], np.int64)
        cap = int(Ts64.sum()) + realB
        nw = np.empty(realB, np.int32)
        w = [np.empty(cap, np.int32) for _ in range(5)]
        p = [np.empty(cap, np.int32) for _ in range(3)]
        rc = lib.sst_extract_batch(
            paths, realB, paths.shape[1], Ts64, g.senid.shape[1], wo, vo, cp,
            offs, nw, *w, *p, cap, cap)
        if rc != 0:
            raise RuntimeError(f"sst_extract_batch failed ({rc})")
        w_kind, w_var, w_start, w_dur, w_np = w
        p_ci, p_start, p_dur = p
        ci = [self.am.mdef.ciphone_str(i)
              for i in range(self.am.mdef.n_ciphone)]
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

    # -- not ported yet ----------------------------------------------------------

    def decode(self, *a, **k):
        raise _unported("decode", "A8")

    decode_batch = decode_batch_scored = decode_search = decode

    def stream(self, *a, **k):
        raise _unported("stream", "A11")

    def align_longform_batch(self, *a, **k):
        raise _unported("align_longform_batch", "A12")

    def use_mesh(self, *a, **k):
        raise _unported("use_mesh", "A13")

    def update_mllr(self, *a, **k):
        raise _unported("update_mllr", "A14")

    def align_batch_scored(self, *a, **k):
        raise _unported("align_batch_scored / want_scores", "A7")
