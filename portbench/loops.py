"""What the traffic kinds' loops share: the window's record, and a
seeded reservoir for what the check keeps."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn by ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        """Offer the stream's next item."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.n))
            if j < self.k:
                self.items[j] = item


class Record:
    """What a window did: per batch or chapter its audio seconds, rows,
    failed rows and host-clock latency; the window's length."""

    def __init__(self):
        self.done: list[dict] = []
        self.t0 = self.t1 = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def attempted(self) -> int:
        return sum(d["rows"] for d in self.done)

    @property
    def failed(self) -> int:
        return sum(d["failed"] for d in self.done)

    @property
    def audio_s(self) -> float:
        """Audio whose alignment completed (failed rows left out)."""
        return sum(d["audio_s"] for d in self.done)
