"""Voice activity detection.

API-compatible with the reference ``ps_vad.c`` wrapper (modes, frame
sizing with the closest-supported-rate trick, ps_vad.c:50-115), backed by
the bit-exact fixed-point GMM classifier in webrtc_vad.py (the same
algorithm as the reference's vendored src/common_audio/vad/*; golden
parity tests in tests/test_vad.py).
"""

from __future__ import annotations

import numpy as np

from .webrtc_vad import VadCore, valid_rate_and_frame_length, VALID_RATES

# vad_mode_t (vad.h)
LOOSE = 0
MEDIUM_LOOSE = 1
MEDIUM_STRICT = 2
STRICT = 3

DEFAULT_SAMPLE_RATE = 16000
DEFAULT_FRAME_LENGTH = 0.03


class Vad:
    """Framewise speech/non-speech classifier (GMM, 6 sub-bands)."""

    def __init__(self, mode: int = LOOSE,
                 sample_rate: int = DEFAULT_SAMPLE_RATE,
                 frame_length: float = DEFAULT_FRAME_LENGTH):
        if not sample_rate:
            sample_rate = DEFAULT_SAMPLE_RATE
        if not frame_length:
            frame_length = DEFAULT_FRAME_LENGTH
        # vad_set_input_params (ps_vad.c:93-128): pick the supported rate
        # with the smallest relative offset (within 50%); the frame size
        # is taken at the CLOSEST rate, and frames of the original audio
        # are fed at that size.
        closest = 0
        best_diff = 0.5
        for rate in VALID_RATES:
            diff = abs(1.0 - rate / sample_rate)
            if diff < best_diff:
                closest = rate
                best_diff = diff
        if closest == 0:
            raise ValueError(f"No suitable sampling rate for {sample_rate}")
        frame_size = int(closest * frame_length)
        if not valid_rate_and_frame_length(closest, frame_size):
            raise ValueError(f"Unsupported frame length {frame_length}")
        self.sample_rate = sample_rate
        self._closest_rate = closest
        self.frame_size = frame_size
        self._core = VadCore(mode)
        self.mode = mode

    @property
    def frame_length(self) -> float:
        return self.frame_size / self.sample_rate

    def classify(self, frame: np.ndarray) -> bool:
        """Classify one frame of int16 samples as speech (True) or not."""
        frame = np.asarray(frame)
        if frame.dtype != np.int16:
            raise ValueError("VAD requires int16 audio")
        if len(frame) != self.frame_size:
            raise ValueError(
                f"Frame has {len(frame)} samples, expected {self.frame_size}")
        return bool(self._core.process(self._closest_rate, frame))
