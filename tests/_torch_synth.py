"""Helpers shared by the port's parity tests (tests/test_torch_*.py):
the synthetic models and the golden audio of tools/."""

import os
import sys

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

from make_synth_model import VARIANTS, make_synth_model  # noqa: E402
from make_torch_synth_golden import (SAMPRATE, TEXT, austen_audio,  # noqa: E402,F401
                                     load_golden, segs_rep)


def model_dir(tmp_path_factory, width: str = "small") -> str:
    return make_synth_model(str(tmp_path_factory.mktemp(f"synth-{width}")),
                            seed=0, width=width)


def variant_dir(tmp_path_factory, variant: str, width: str = "small") -> str:
    """A synthetic model of one VARIANTS entry (ptm4b, semi, ms, ...)."""
    backend, bits = VARIANTS[variant]
    d = tmp_path_factory.mktemp(f"synth-{width}-{variant}")
    return make_synth_model(str(d), 0, width, backend, bits)
