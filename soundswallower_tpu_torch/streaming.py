"""Streaming forced alignment with a checkpointable state.

Port of ``soundswallower_tpu/streaming.py`` (AlignStream).  Every
``push(chunk)`` consumes int16 samples and advances

* the front end: the pre-emphasis prior, the unconsumed raw tail and the
  noise-removal carry (``Frontend.mfcc_chunk``: K8, K9, K10), in
  2048-sample and 32-frame buckets;
* live CMN (``fe/cmn_live.py``);
* the dynamic-feature window (the last 2*FEAT_DCEP_WIN+2 cepstra, numpy);
* the scores (K2/K3 ``score_frames_graph``, 32-frame buckets) and the
  Viterbi carry (K4's carry form ``viterbi_chunk``, 128-frame chunks,
  the last one partial at ``end()``);

and appends each chunk's int16 backpointer tokens on the host.
``state()`` returns all of it as plain numpy under the JAX package's keys,
dtypes and shapes: a checkpoint taken by either package restores in the
other (``AlignStream.restore``) and continues bit for bit.  ``result()``
walks the tokens on the host (partial results while streaming, final
after ``end()``).
"""

from __future__ import annotations

import numpy as np
import torch

from .fe.cmn_live import CmnLive
from .ops.align_torch import vit_carry0, viterbi_chunk
from .ops.senscore_torch import score_frames_graph

FEAT_DCEP_WIN = 2       # soundswallower_tpu/fe/feat.py (a module importing jax)
_W = FEAT_DCEP_WIN + 1  # 1s_c_d_dd window (3)


class AlignStream:
    """Streaming aligner for one utterance; create with
    ``TorchAligner.stream(text)``."""

    CHUNK = 128  # frames per Viterbi launch

    def __init__(self, aligner, text: str, _restore: dict | None = None):
        self.al = aligner
        self.text = text
        g = aligner.graph_for_text(text)
        self.g = g
        self._S = len(g.senid) * g.senid.shape[1]
        self._c = aligner._graph_consts(g)
        self._dev = aligner.device
        fe = aligner.fe
        self.shift, self.size = fe.frame_shift, fe.frame_size
        if _restore is None:
            self._prior = np.float32(0.0)
            self._raw = np.zeros(0, np.int16)
            self._noise = fe.noise_init(device=self._dev)
            self._cmn = CmnLive(fe.num_cepstra, aligner.config["cmninit"])
            self._cepq: list[np.ndarray] = []
            self._cep_base = 0
            self._pend = np.zeros((0, 0), np.int16)
            self._head_done = False
            self._nfeat = 0          # feature frames fully computed
            # the JAX package's stream starts from vit_carry0's default
            # 3-state carry (soundswallower_tpu/streaming.py:67-70): on a
            # 5-state model its first Viterbi chunk raises TypeError, and
            # so does this one (viterbi_chunk's carry check)
            self._carry = vit_carry0(self._c.vit, n_emit=3)
            self._toks: list[np.ndarray] = []
            self._t = 0              # frames consumed by Viterbi
            self._ended = False
        else:
            self._load(_restore)

    # -- feeding -------------------------------------------------------------

    def push(self, chunk: np.ndarray) -> int:
        """Feed int16 samples; returns the new feature frames."""
        if self._ended:
            raise RuntimeError("stream already ended")
        chunk = np.asarray(chunk)
        if chunk.dtype != np.int16:
            raise TypeError("push expects int16 samples")
        self._raw = np.concatenate([self._raw, chunk])
        n = len(self._raw)
        nfr = 1 + (n - self.size) // self.shift if n >= self.size else 0
        if nfr > 0:
            self._fe_frames(nfr, tail=False)
        return self._advance()

    def _fe_frames(self, count: int, tail: bool):
        """The device FE on `count` frames of the raw buffer, then drop
        the consumed samples (constant memory)."""
        fe = self.al.fe
        seg = self._raw if tail else \
            self._raw[: (count - 1) * self.shift + self.size]
        Tpad = max(32, -(-count // 32) * 32)
        n = len(seg)
        Npad = max(2048, -(-n // 2048) * 2048)
        segp = np.zeros(Npad, np.float32)
        segp[:n] = seg
        cep, self._noise = fe.mfcc_chunk(
            torch.from_numpy(segp).to(self._dev), n, Tpad,
            float(self._prior), self._noise, count)
        cep = cep[:count].cpu().numpy()
        consumed = count * self.shift
        if consumed > 0 and len(self._raw) >= consumed:
            self._prior = np.float32(self._raw[consumed - 1])
            self._raw = self._raw[consumed:]
        norm = self._cmn.process(cep)
        if not self._head_done and len(norm) > 0:
            for _ in range(_W):
                self._cepq.append(norm[0].copy())
            self._head_done = True
        for row in norm:
            self._cepq.append(row)

    def _advance(self) -> int:
        """Dynamic features of the frames whose window is complete, their
        scores, and Viterbi over every full chunk.  Row k of the cep
        queue holds cep frame (base + k); frame i's window is rows
        (i - base) .. (i - base + 2W)."""
        base = self._cep_base
        navail = base + len(self._cepq) - 2 * _W
        nnew = navail - self._nfeat
        if nnew <= 0:
            return 0
        q = np.stack(self._cepq)
        lo = self._nfeat - base                   # first window start row
        c = q[lo + _W: lo + _W + nnew]
        d = (q[lo + _W + 2: lo + _W + 2 + nnew]
             - q[lo + _W - 2: lo + _W - 2 + nnew]).astype(np.float32)
        d1 = (q[lo + _W + 3: lo + _W + 3 + nnew]
              - q[lo + _W - 1: lo + _W - 1 + nnew]).astype(np.float32)
        d2 = (q[lo + _W + 1: lo + _W + 1 + nnew]
              - q[lo + _W - 3: lo + _W - 3 + nnew]).astype(np.float32)
        feats = np.stack([c, d, (d1 - d2).astype(np.float32)], axis=1)
        self._nfeat = navail
        drop = navail - base
        if drop > 0:
            self._cepq = self._cepq[drop:]
            self._cep_base = navail
        # scores in 32-frame buckets, in graph-state order
        Tb = -(-nnew // 32) * 32
        fpad = np.zeros((Tb,) + feats.shape[1:], np.float32)
        fpad[:nnew] = feats
        senscr = score_frames_graph(
            self._c.gs, torch.from_numpy(fpad).to(self._dev))
        senscr = senscr.cpu().numpy().astype(np.int16)[:nnew]
        self._pend = np.concatenate([self._pend, senscr]) \
            if len(self._pend) else senscr
        # Viterbi only on full chunks; the rest waits for end()
        while len(self._pend) >= self.CHUNK:
            self._dispatch(self._pend[:self.CHUNK], self.CHUNK)
            self._pend = self._pend[self.CHUNK:]
        return nnew

    def _dispatch(self, sen: np.ndarray, nvalid: int):
        pad = np.zeros((self.CHUNK, sen.shape[1]), np.int32)
        pad[:len(sen)] = sen
        self._carry, tok = viterbi_chunk(
            torch.from_numpy(pad).to(self._dev), self._carry, self._t,
            self._t + nvalid, self._c.vit)
        self._toks.append(tok[:nvalid].cpu().numpy())
        self._t += nvalid

    def end(self) -> list:
        """Flush the FE tail, the final feature replication and the last
        Viterbi frames; returns the final word segments."""
        if not self._ended:
            if len(self._raw) > 0:
                self._fe_frames(1, tail=True)
            if self._cepq:
                last = self._cepq[-1]
                for _ in range(_W):
                    self._cepq.append(last.copy())
            self._advance()
            if len(self._pend):
                self._dispatch(self._pend, len(self._pend))
                self._pend = np.zeros((0, 0), np.int16)
            self._cmn.update()  # fold the pending sum (acmod_end_utt)
            self._ended = True
        return self.result()

    # -- results -------------------------------------------------------------

    def result(self) -> list:
        """Backtrace over everything fed so far (partial while
        streaming; final after end())."""
        if self._t == 0:
            return []
        out_score = self._carry[2].cpu().numpy()
        out_hist = self._carry[3].cpu().numpy()
        fin = self.g.final_nodes
        best = int(fin[np.argmax(out_score[fin])])
        final_state = int(out_hist[best])
        if final_state < 0:
            raise RuntimeError("Alignment failed to reach final state")
        toks = np.concatenate(self._toks)
        T = self._t
        path = np.empty(T, np.int32)
        # state_align_search_finish's walk: the token at frame t-1
        # points to the state covering frame t-1
        cur = final_state
        for t in range(T - 1, -1, -1):
            path[t] = cur
            if t >= 1:
                cur = int(toks[t - 1, cur])
        return self.al._extract(self.g, path, T)

    # -- checkpoint / resume -------------------------------------------------

    def state(self) -> dict:
        """The whole stream state as plain numpy (the checkpoint), under
        the JAX package's keys and dtypes."""
        return dict(
            text=self.text,
            prior=np.float32(self._prior),
            raw=self._raw.copy(),
            noise=tuple(x.cpu().numpy() for x in self._noise),
            cmn_mean=self._cmn.mean.copy(), cmn_sum=self._cmn.sum.copy(),
            cmn_nframe=self._cmn.nframe,
            cepq=np.stack(self._cepq) if self._cepq else
                 np.zeros((0, self.al.fe.num_cepstra), np.float32),
            cep_base=self._cep_base,
            pend=self._pend.copy(),
            head_done=self._head_done, nfeat=self._nfeat,
            carry=tuple(x.cpu().numpy() for x in self._carry),
            toks=(np.concatenate(self._toks) if self._toks else
                  np.zeros((0, self._S), np.int16)),
            t=self._t, ended=self._ended,
        )

    @classmethod
    def restore(cls, aligner, state: dict) -> "AlignStream":
        return cls(aligner, state["text"], _restore=state)

    def _load(self, s: dict):
        fe = self.al.fe
        self._prior = np.float32(s["prior"])
        self._raw = np.asarray(s["raw"], np.int16)
        self._noise = tuple(torch.from_numpy(np.array(x)).to(self._dev)
                            for x in s["noise"])
        self._cmn = CmnLive(fe.num_cepstra)
        self._cmn.mean = np.asarray(s["cmn_mean"], np.float32).copy()
        self._cmn.sum = np.asarray(s["cmn_sum"], np.float32).copy()
        self._cmn.nframe = int(s["cmn_nframe"])
        self._cepq = [r for r in np.asarray(s["cepq"])]
        self._cep_base = int(s["cep_base"])
        self._pend = np.asarray(s["pend"], np.int16)
        self._head_done = bool(s["head_done"])
        self._nfeat = int(s["nfeat"])
        self._carry = tuple(torch.from_numpy(np.array(x, np.int32))
                            .to(self._dev) for x in s["carry"])
        self._toks = [np.asarray(s["toks"], np.int16)] if len(s["toks"]) \
            else []
        self._t = int(s["t"])
        self._ended = bool(s["ended"])
