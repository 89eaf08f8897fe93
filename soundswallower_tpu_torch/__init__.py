"""soundswallower_tpu_torch: the finite-state-grammar recognizer and
forced aligner of ``soundswallower_tpu`` ported to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

Public API mirrors the reference Python binding
(py/_soundswallower.pyx: Config, Decoder, FsgModel, Vad, Endpointer,
Alignment, AlignmentEntry; py/soundswallower/__init__.py helpers), as the
JAX package's does, with :class:`TorchAligner` (``aligner.py``) in the
place of its ``TpuAligner``.  ``device="cpu"`` runs the plain PyTorch
version of every kernel, ``device="cuda"`` (the default of every entry
point) the kernels, which compile from ``csrc/`` at first use.

Importing the package builds nothing and imports neither torch nor JAX;
the heavy modules load on first use.
"""

from __future__ import annotations

import collections
import os

from .config import Config
from .logmath import LogMath

__version__ = "0.1.0"

Arg = collections.namedtuple("Arg", ["name", "default", "doc", "type", "required"])
Seg = collections.namedtuple("Seg", ["text", "start", "duration", "ascore", "lscore"])
Hyp = collections.namedtuple("Hyp", ["text", "score", "prob"])


def __getattr__(name):
    if name == "Decoder":
        from .decoder import Decoder
        return Decoder
    if name == "FsgModel":
        from .fsg import FsgModel
        return FsgModel
    if name == "TorchAligner":
        from .aligner import TorchAligner
        return TorchAligner
    if name == "Vad":
        from .vad import Vad
        return Vad
    if name == "Endpointer":
        from .endpointer import Endpointer
        return Endpointer
    raise AttributeError(name)


__all__ = [
    "Arg",
    "Config",
    "Decoder",
    "Endpointer",
    "FsgModel",
    "Hyp",
    "LogMath",
    "Seg",
    "TorchAligner",
    "Vad",
    "get_audio_data",
    "get_model_path",
]


def get_audio_data(input_file: str):
    """Single-channel WAV or raw audio loader
    (py/soundswallower/__init__.py:43-64)."""
    import wave

    try:
        with wave.open(input_file) as wavfile:
            if wavfile.getnchannels() != 1:
                raise ValueError("Only supporting single-channel WAV")
            data = wavfile.readframes(wavfile.getnframes())
            return data, wavfile.getframerate()
    except wave.Error:
        with open(input_file, "rb") as rawfile:
            return rawfile.read(), None


def get_model_path(subpath: str | None = None) -> str:
    """Locate models (py/soundswallower/__init__.py:27): checks
    $SOUNDSWALLOWER_MODEL_DIR, then a package-local ``model/`` dir."""
    for root in (
        os.environ.get("SOUNDSWALLOWER_MODEL_DIR"),
        os.path.join(os.path.dirname(__file__), "model"),
    ):
        if root and os.path.isdir(root):
            return os.path.join(root, subpath) if subpath else root
    raise RuntimeError("No model directory found")
