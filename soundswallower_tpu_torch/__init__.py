"""soundswallower_tpu_torch: the forced aligner of ``soundswallower_tpu``
(batches, single utterances, streams, the device front end) ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

Importing the package builds nothing and imports no JAX.  The public
class is :class:`TorchAligner` (``aligner.py``); ``device="cpu"`` runs
the plain PyTorch version of every kernel, ``device="cuda"`` the
kernels, which compile from ``csrc/`` at first use.
"""

from __future__ import annotations

__version__ = "0.1.0"

__all__ = ["TorchAligner"]


def __getattr__(name):
    if name == "TorchAligner":
        from .aligner import TorchAligner
        return TorchAligner
    raise AttributeError(name)
