"""Frozen copy of ``soundswallower_tpu_torch/logmath.py``
for the benchmark's reference (see ``__init__``).

Integer log-domain arithmetic ("logmath").

The whole decoder works in a quantized integer log domain: probabilities are
represented as ``int(log_base(p)) >> shift`` for a base very close to 1
(default 1.0001), so that log-probs are large negative integers and log-add
can be done with a small lookup table.

This is a bit-exact reimplementation of the reference C module
(``src/logmath.c:61-161`` builds the quantized log-add table;
``src/logmath.c:229-272`` implements table-based log-add).  Bit-exactness
matters because every acoustic score, transition probability, and beam in the
decoder is quantized through these functions, and our goal is exact
word/phone/state boundary parity with the C decoder.

Table construction note: the C code generates ``byx = base^{-i}`` by repeated
*division* (``byx /= base``), whose float64 rounding differs from ``pow``;
we replicate the sequential division loop exactly (vectorization would change
the rounding and break parity at a handful of table entries).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

MAX_NEG_INT32 = -2147483648

# From include/soundswallower/hmm.h:69
SENSCR_SHIFT = 10


def _c_int_cast(x: float) -> int:
    """C's (int) cast: truncation toward zero."""
    return int(x)


@lru_cache(maxsize=8)
def _build_table(base: float, shift: int) -> tuple[np.ndarray, int]:
    """Build the quantized log-add table (reference: src/logmath.c:88-161).

    Returns (table, width).  table[d] = round-to-shift of
    log_base(1 + base^-d'), stored so that fast_logmath_add/logmath_add can
    index by the (quantized) score difference.
    """
    log_of_base = math.log(base)
    inv_log_of_base = 1.0 / log_of_base

    # Width determination (logmath.c:90-97).  uint32 arithmetic.
    maxyx = (int(math.log(2.0) / log_of_base + 0.5) & 0xFFFFFFFF) >> shift
    if maxyx < 256:
        width = 1
    elif maxyx < 65536:
        width = 2
    else:
        width = 4

    # Size determination (logmath.c:101-119): iterate byx /= base until the
    # quantized log-add value k reaches 0.
    byx = 1.0
    i = 0
    half = 0.5 * (1 << shift)
    while True:
        lobyx = math.log(1.0 + byx) * inv_log_of_base
        k = _c_int_cast(lobyx + half) >> shift
        if k <= 0:
            break
        byx /= base
        i += 1
    i >>= shift
    if i < 255:
        i = 255
    table_size = i + 1

    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[width]
    table = np.zeros(table_size, dtype=dtype)

    # Fill (logmath.c:124-161): first value written into each bucket wins.
    byx = 1.0
    i = 0
    written = np.zeros(table_size, dtype=bool)
    while True:
        lobyx = math.log(1.0 + byx) * inv_log_of_base
        k = _c_int_cast(lobyx + half) >> shift
        idx = i >> shift
        if idx >= table_size:
            # C would overrun; can't happen given size computation above.
            break
        if not written[idx] and table[idx] == 0:
            table[idx] = k
            written[idx] = True
        if k <= 0:
            break
        byx /= base
        i += 1

    return table, width


class LogMath:
    """Quantized integer log-domain math (reference: src/logmath.c)."""

    def __init__(self, base: float = 1.0001, shift: int = 0, use_table: bool = True):
        if base <= 1.0:
            raise ValueError("Base must be greater than 1.0")
        self.base = base
        self.log_of_base = math.log(base)
        self.log10_of_base = math.log10(base)
        self.inv_log_of_base = 1.0 / self.log_of_base
        self.inv_log10_of_base = 1.0 / self.log10_of_base
        self.shift = shift
        # logmath.c:84 - "Shift this sufficiently that overflows can be avoided"
        self.zero = MAX_NEG_INT32 >> (shift + 2)
        if use_table:
            self.table, self.width = _build_table(base, shift)
            self.table_size = len(self.table)
        else:
            self.table = None
            self.width = 0
            self.table_size = 0

    # -- scalar ops (bit-exact vs C) --------------------------------------

    def log(self, p: float) -> int:
        """logmath_log (src/logmath.c:283-289)."""
        if p <= 0:
            return self.zero
        return _c_int_cast(math.log(p) * self.inv_log_of_base) >> self.shift

    def exp(self, logb_p: int) -> float:
        """logmath_exp (src/logmath.c:292-295)."""
        return math.pow(self.base, float(logb_p << self.shift))

    def ln_to_log(self, log_p: float) -> int:
        """logmath_ln_to_log (src/logmath.c:298-301)."""
        return _c_int_cast(log_p * self.inv_log_of_base) >> self.shift

    def log_to_ln(self, logb_p: int) -> float:
        return float(logb_p << self.shift) * self.log_of_base

    def log10_to_log(self, log_p: float) -> int:
        return _c_int_cast(log_p * self.inv_log10_of_base) >> self.shift

    def log_to_log10(self, logb_p: int) -> float:
        return float(logb_p << self.shift) * self.log10_of_base

    def add(self, x: int, y: int) -> int:
        """logmath_add (src/logmath.c:229-272)."""
        if x <= self.zero:
            return y
        if y <= self.zero:
            return x
        if self.table is None:
            return self.add_exact(x, y)
        if x > y:
            d, r = x - y, x
        else:
            d, r = y - x, y
        if d < 0:
            return r
        if d >= self.table_size:
            return r
        return r + int(self.table[d])

    def add_exact(self, p: int, q: int) -> int:
        return self.log(self.exp(p) + self.exp(q))

    def fast_add(self, mlx: int, mly: int) -> int:
        """fast_logmath_add on *negated* log probs (tied_mgau_common.h:100-116).

        Requires an 8-bit table (width==1) and 0 <= |mlx-mly| < 256.
        """
        if mlx > mly:
            d, r = mlx - mly, mly
        else:
            d, r = mly - mlx, mlx
        return r - int(self.table[d])

    # -- vectorized helpers ------------------------------------------------

    def log_v(self, p: np.ndarray) -> np.ndarray:
        """Vectorized logmath_log over a float array -> int32 array."""
        p = np.asarray(p, dtype=np.float64)
        out = np.full(p.shape, self.zero, dtype=np.int64)
        pos = p > 0
        vals = np.log(p[pos]) * self.inv_log_of_base
        # C (int) cast truncates toward zero; then arithmetic >> shift.
        out[pos] = np.trunc(vals).astype(np.int64) >> self.shift
        return out.astype(np.int32)

    def fast_add_v(self, mlx: np.ndarray, mly: np.ndarray) -> np.ndarray:
        """Vectorized fast_logmath_add over negated-log int arrays."""
        d = np.abs(mlx - mly)
        r = np.minimum(mlx, mly)
        return r - self.table[d].astype(mlx.dtype)
