"""MT19937 RNG matching the reference's genrand (src/genrand.c).

The reference uses the standard Mersenne twister (init_genrand seeding,
genrand_int32 tempering, genrand_int31 = int32 >> 1) solely to add
1/2-bit dither to incoming audio (fe_sigproc.c:336,364: one draw per
sample in stream order, +1 iff rand31() % 4 == 0).  Seeding semantics:
fe_init_dither (fe_interface.c:345-349) passes the ``seed`` config value
straight through, so a negative seed is taken modulo 2**32 like C's
``s & 0xffffffffUL``.

Implemented as a block-vectorized numpy twister: the 624-word state
update and tempering run as whole-array ops, so drawing a rand per audio
sample costs microseconds per utterance instead of a Python loop.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class GenRand:
    def __init__(self, seed: int = 5489):
        self.seed(seed)

    def seed(self, s: int) -> None:
        """init_genrand (genrand.c:103-117)."""
        mt = np.empty(_N, np.uint32)
        mt[0] = s & 0xFFFFFFFF
        x = np.uint64(mt[0])
        # the recurrence is sequential; 624 steps in a Python loop is fine
        for i in range(1, _N):
            x = (np.uint64(1812433253) * (x ^ (x >> np.uint64(30)))
                 + np.uint64(i)) & np.uint64(0xFFFFFFFF)
            mt[i] = x
        self._mt = mt
        self._idx = _N

    def _twist(self) -> None:
        mt = self._mt
        y = (mt & _UPPER) | (np.roll(mt, -1) & _LOWER)
        mag = np.where(y & np.uint32(1), _MATRIX_A, np.uint32(0))
        self._mt = np.roll(mt, -_M) ^ (y >> np.uint32(1)) ^ mag
        self._idx = 0

    def int32_block(self, n: int) -> np.ndarray:
        """Next n draws of genrand_int32 as uint32 [n]."""
        out = np.empty(n, np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= _N:
                self._twist()
            take = min(n - filled, _N - self._idx)
            y = self._mt[self._idx:self._idx + take].copy()
            # tempering (genrand.c:146-151)
            y ^= y >> np.uint32(11)
            y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
            y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
            y ^= y >> np.uint32(18)
            out[filled:filled + take] = y
            self._idx += take
            filled += take
        return out

    def int31_block(self, n: int) -> np.ndarray:
        """genrand_int31: int32 >> 1, int64 [n]."""
        return (self.int32_block(n) >> np.uint32(1)).astype(np.int64)

    def dither_int16(self, audio: np.ndarray) -> np.ndarray:
        """Per-sample 1/2-bit dither (fe_read_frame_int16,
        fe_sigproc.c:330-338): sample += 1 iff rand31 % 4 == 0.
        Matches C int16 wraparound."""
        r = self.int31_block(len(audio))
        add = (r % 4 == 0).astype(np.int16)
        return (audio.astype(np.int16) + add).astype(np.int16)

    def dither_float32(self, audio: np.ndarray,
                       scale: float = 1.0) -> np.ndarray:
        """float32 path (fe_read_frame_float32, fe_sigproc.c:357-366):
        sample*scale + FLOAT32_DITHER (=1.0f) iff rand31 % 4 == 0."""
        r = self.int31_block(len(audio))
        add = (r % 4 == 0).astype(np.float32)
        return (audio.astype(np.float32) * np.float32(scale)
                + add).astype(np.float32)
