"""Speech endpointer: ring-buffer-of-frames state machine over a VAD.

Exact port of ``src/ps_endpointer.c``: enter speech when the window's
speech count exceeds ratio*window frames, leave when it drops below
(1-ratio)*window; frames are queued and returned one per process() call
while in speech, preserving the reference's timestamps
(endpointer_process :283-322, endpointer_end_stream :234-281).
"""

from __future__ import annotations

import numpy as np

from .vad import Vad, LOOSE

DEFAULT_WINDOW = 0.3
DEFAULT_RATIO = 0.9


class Endpointer:
    def __init__(self, window: float = 0.0, ratio: float = 0.0,
                 vad_mode: int = LOOSE, sample_rate: int = 16000,
                 frame_length: float = 0.03):
        self.vad = Vad(vad_mode, sample_rate, frame_length)
        if window == 0.0:
            window = DEFAULT_WINDOW
        if ratio == 0.0:
            ratio = DEFAULT_RATIO
        self.frame_length = self.vad.frame_length
        self.maxlen = int(window / self.frame_length + 0.5)
        self.start_frames = int(ratio * self.maxlen)
        self.end_frames = int((1.0 - ratio) * self.maxlen + 0.5)
        if not (0 < self.start_frames < self.maxlen):
            raise ValueError(f"Ratio {ratio} makes start-pointing impossible")
        if not (0 < self.end_frames < self.maxlen):
            raise ValueError(f"Ratio {ratio} makes end-pointing impossible")
        self.frame_size = self.vad.frame_size
        self._buf = np.zeros((self.maxlen, self.frame_size), np.int16)
        self._is_speech = np.zeros(self.maxlen, np.int8)
        self._pos = 0
        self._n = 0
        self.in_speech = False
        self.qstart_time = 0.0
        self.timestamp = 0.0
        self.speech_start = 0.0
        self.speech_end = 0.0

    # -- queue helpers (ps_endpointer.c:129-200) ---------------------------

    def _push(self, is_speech: bool, frame: np.ndarray):
        i = (self._pos + self._n) % self.maxlen
        self._buf[i] = frame
        self._is_speech[i] = is_speech
        if self._n == self.maxlen:
            self.qstart_time += self.frame_length
            self._pos = (self._pos + 1) % self.maxlen
        else:
            self._n += 1

    def _pop(self):
        if self._n == 0:
            return None
        self.qstart_time += self.frame_length
        pcm = self._buf[self._pos].copy()
        self._pos = (self._pos + 1) % self.maxlen
        self._n -= 1
        return pcm

    def _speech_count(self) -> int:
        if self._n == 0:
            return 0
        idx = (self._pos + np.arange(self._n)) % self.maxlen
        return int(self._is_speech[idx].sum())

    # -- public API --------------------------------------------------------

    def process(self, frame: np.ndarray):
        """Process one frame; returns int16 audio (one frame) while in
        speech, else None (endpointer_process, ps_endpointer.c:283-322)."""
        frame = np.asarray(frame)
        if frame.dtype != np.int16:
            frame = np.frombuffer(frame.tobytes(), dtype=np.int16)
        is_speech = self.vad.classify(frame)
        self._push(is_speech, frame)
        self.timestamp += self.frame_length
        speech_count = self._speech_count()
        if self.in_speech:
            if speech_count < self.end_frames:
                pcm = self._pop()
                self.speech_end = self.qstart_time
                self.in_speech = False
                return pcm
        else:
            if speech_count > self.start_frames:
                self.speech_start = self.qstart_time
                self.speech_end = 0.0
                self.in_speech = True
        if self.in_speech:
            return self._pop()
        return None

    def end_stream(self, frame: np.ndarray):
        """Drain at end of stream (endpointer_end_stream,
        ps_endpointer.c:234-281): returns remaining speech audio or None."""
        frame = np.asarray(frame, dtype=np.int16)
        if len(frame) > self.frame_size:
            raise ValueError(
                f"Final frame must be {self.frame_size} samples or less")
        if not self.in_speech:
            return None
        # linearize queued frames + final partial frame
        idx = (self._pos + np.arange(self._n)) % self.maxlen
        out = np.concatenate([self._buf[idx].reshape(-1), frame])
        self.speech_end = self.qstart_time + self._n * self.frame_length \
            + len(frame) / self.vad.sample_rate
        self._n = 0
        self._pos = 0
        self.in_speech = False
        return out
