"""Live (streaming) cepstral mean normalization.

Exact port of ``src/cmn_live.c``: running float32 sum, subtract the prior
mean per frame, exponential decay of the window once ``nframe`` exceeds
CMN_WIN_HWM (cmn_live:107-135, cmn_live_update:81-105), and the
comma-separated serialization used to carry CMN state across utterances
(cmn_update_repr/cmn_set_repr, cmn.c:82-140).  This is the reference's
long-audio streaming state (SURVEY.md section 5).
"""

from __future__ import annotations

import numpy as np

CMN_WIN = 500
CMN_WIN_HWM = 800


class CmnLive:
    def __init__(self, veclen: int = 13, init_repr: str | None = None):
        self.veclen = veclen
        self.mean = np.zeros(veclen, np.float32)
        self.sum = np.zeros(veclen, np.float32)
        self.nframe = 0
        if init_repr:
            self.set_repr(init_repr)

    def set(self, vec: np.ndarray) -> None:
        """cmn_live_set (cmn_live.c:47-58)."""
        self.mean = np.asarray(vec, np.float32).copy()
        self.sum = (self.mean * np.float32(CMN_WIN)).astype(np.float32)
        self.nframe = CMN_WIN

    def process(self, cep: np.ndarray) -> np.ndarray:
        """cmn_live (cmn_live.c:107-135): normalize frames in place order.

        cep: [n, veclen] float32; returns normalized copy."""
        out = cep.astype(np.float32).copy()
        for i in range(len(out)):
            if out[i, 0] < 0:  # skip zero energy frames
                continue
            self.sum = (self.sum + out[i]).astype(np.float32)
            out[i] = (out[i] - self.mean).astype(np.float32)
            self.nframe += 1
        if self.nframe > CMN_WIN_HWM:
            self._shiftwin()
        return out

    def _shiftwin(self):
        """cmn_live_shiftwin (cmn_live.c:60-77)."""
        self.mean = (self.sum / np.float32(self.nframe)).astype(np.float32)
        if self.nframe >= CMN_WIN_HWM:
            sf = np.float32(CMN_WIN) * (np.float32(1.0) / np.float32(self.nframe))
            self.sum = (self.sum * sf).astype(np.float32)
            self.nframe = CMN_WIN

    def update(self):
        """cmn_live_update (cmn_live.c:81-105): fold the sum into the mean
        at utterance end."""
        if self.nframe <= 0:
            return
        self.mean = (self.sum / np.float32(self.nframe)).astype(np.float32)
        if self.nframe > CMN_WIN_HWM:
            sf = np.float32(CMN_WIN) * (np.float32(1.0) / np.float32(self.nframe))
            self.sum = (self.sum * sf).astype(np.float32)
            self.nframe = CMN_WIN

    # -- serialization (cmn.c:82-140) --------------------------------------

    def repr(self) -> str:
        return ",".join("%g" % float(x) for x in self.mean)

    def set_repr(self, s: str) -> None:
        vals = [float(x) for x in s.split(",") if x != ""]
        self.mean = np.zeros(self.veclen, np.float32)
        self.mean[: len(vals)] = np.asarray(vals[: self.veclen], np.float32)
        self.sum = (self.mean * np.float32(CMN_WIN)).astype(np.float32)
        self.nframe = CMN_WIN
