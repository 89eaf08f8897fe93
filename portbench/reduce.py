"""From the window's record, spans and trace to the metrics' readers.

A traffic kind's ``work`` counts (``counts``) what the window's kernels
had to do, from the cell's inputs: each row's frames (the front end's
frame count of its audio), its graph's phones, states, predecessor
slots and senones (``graph_row``, built again by the reference from its
transcript), and the codebooks its scorer uses (``codebooks``).
``Context`` is what a reader of ``metrics/`` is handed.
"""

from __future__ import annotations

import numpy as np

from .counts import Row


def graph_row(ref, text: str, frames: int) -> Row:
    g = ref.graph(text)
    P, E = g.senid.shape
    return Row(frames=frames, states=P * E, phones=P,
               preds=len(g.edge_src), senones=len(np.unique(g.senid)),
               emit=E)


def codebooks(ref, senones) -> int:
    return len(np.unique(np.asarray(ref.am.sen2cb)[np.asarray(senones)]))


def dims(ref) -> tuple[int, int, int, int]:
    """Streams, densities, dims a stream and top-N of the model."""
    C, F, D, L = np.asarray(ref.am.means).shape
    return F, D, L, int(ref.am.max_topn)


class Context:
    """What a metric's reader reads: the window's ``record``, the
    benchmark's ``spans``, the device's view of the traced window
    (``device``, None untraced), the window's ``work`` by kernel, and
    ``setup_s``."""

    def __init__(self, record, spans, setup_s: float, device=None,
                 work=None):
        self.record, self.spans, self.setup_s = record, spans, setup_s
        self.device, self.work = device, work or {}

    def kernel_s(self, *names: str) -> float:
        if self.device is None:
            return 0.0
        return sum(self.device["by_name"].get(n, 0.0) for n in names)

    def roofline(self, key: str, *names: str):
        """100 x the least time of ``work[key]`` over the device time of
        the kernels ``names``; None where either is missing."""
        t = self.kernel_s(*names)
        w = self.work.get(key)
        if w is None or t <= 0:
            return None
        return 100.0 * w.least_s / t
