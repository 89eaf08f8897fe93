"""The work the cells' kernels do, counted from the cells' inputs.

Operations and bytes come from each row's real frames, its graph's
real states, phones and predecessor slots, and the codebooks and
senones its scorer uses: never from the port's padded tensors, tiles or
launch shapes, so a count stays the same whatever implements the
kernel.  The arithmetic is ``chip_smoke.py``'s (``fold_ops``,
``k3_ops``, ``vit_ops``, ``bound``), rewritten to count
real shapes.  A kernel's least time is the larger of its bytes (inputs
read once, outputs written once) over the HBM rate and its operations
over their peak.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes/s; float32 outside the
# tensor cores; int32 (half the float32 rate: 64 lanes an SM)
HBM_BPS = 3.35e12
F32_OPS = 67e12
I32_OPS = 33.5e12


@dataclass
class Work:
    """One kernel's work: operations (of ``rate``'s type) and bytes."""

    ops: float = 0.0
    nbytes: float = 0.0
    rate: float = F32_OPS

    def __iadd__(self, other: "Work") -> "Work":
        self.ops += other.ops
        self.nbytes += other.nbytes
        return self

    @property
    def least_s(self) -> float:
        return max(self.nbytes / HBM_BPS, self.ops / self.rate)

    @property
    def peak_s(self) -> float:
        """The operations alone at their peak (the step's share of the
        chip's peak, mfu, sums these)."""
        return self.ops / self.rate


@dataclass
class Row:
    """One row as the kernels see it: frames, and its graph's states,
    phones, predecessor slots and distinct senones."""

    frames: int
    states: int
    phones: int
    preds: int
    senones: int
    emit: int = 3


def fold(frames: int, codebooks: int, streams: int, density: int,
         dims: int, topn: int) -> Work:
    """K2, the Gaussian distance fold and top-N: 4 float32
    operations per density and dim (a subtraction, a square, a fused
    multiply-add); the features in, the top-N scores and indices out,
    the codebooks' means, variances and constants in."""
    ops = 4.0 * frames * codebooks * streams * density * dims
    nbytes = (4.0 * frames * streams * dims
              + 8.0 * frames * codebooks * streams * topn
              + 4.0 * codebooks * streams * density * (2 * dims + 1))
    return Work(ops, nbytes, F32_OPS)


def senone_eval(frame_senones: int, streams: int, topn: int) -> Work:
    """K3 over ``frame_senones`` (frame, senone) pairs: per stream the
    first term's add, then per later term the add, the min, |diff|
    (two) and the table's subtraction, and the sum over streams."""
    return Work(float(frame_senones) * streams * (5 * topn - 3), 0.0,
                I32_OPS)


def _tables(r: Row) -> float:
    """A graph's tables the Viterbi reads: per phone its transition
    rows, window and entry, per predecessor slot its index and
    penalty."""
    return 4.0 * r.phones * (r.emit * (r.emit + 1) + 3) + 8.0 * r.preds


def viterbi_rows(rows: list[Row]) -> Work:
    """K6: about 10 int32 operations per frame and state (the HMM
    update's adds and maxes, the predecessor max, the token); each
    row's scores read once, its path written once, its tables."""
    ops = 10.0 * sum(r.frames * r.states for r in rows)
    nbytes = sum(4.0 * r.frames * r.states + 2.0 * r.frames + _tables(r)
                 for r in rows)
    return Work(ops, nbytes, I32_OPS)


def viterbi_chunk(r: Row) -> Work:
    """K4's carry form over a whole row: the same operations as K6;
    the scores read once and the token stack (int16, int32 from 32,767
    states) written once, for the reverse pass."""
    tok = 2.0 if r.states < 32767 else 4.0
    return Work(10.0 * r.frames * r.states,
                (4.0 + tok) * r.frames * r.states + _tables(r), I32_OPS)
