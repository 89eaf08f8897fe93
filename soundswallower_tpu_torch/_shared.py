"""Loader for the host modules shared with the JAX package.

The JAX package's host code (config, model readers, dictionaries, the
phone-graph builder, the native C++ front end, the HTTP service) uses
no JAX itself, but ``soundswallower_tpu/__init__.py`` imports jax (and
turns on x64), and the port must run where jax is not installed and
never load it where it is.  So this module registers a package
``soundswallower_tpu_torch.ref`` whose ``__path__`` is the JAX
package's directory: its submodules import unchanged through it, and
the JAX package's ``__init__`` never runs.  Nothing is copied.

In a process that also imports ``soundswallower_tpu`` (the parity
tests), the two packages hold distinct module objects: classes differ
across them (``isinstance`` fails) and module-level caches are not
shared.  Build each side from the same files and compare arrays.
"""

from __future__ import annotations

import importlib
import os
import sys
import types

REF = __name__.rsplit(".", 1)[0] + ".ref"
# the JAX package sits beside this one (in the repository and when
# both are installed)
REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "soundswallower_tpu")


def _register() -> types.ModuleType:
    pkg = sys.modules.get(REF)
    if pkg is None:
        if not os.path.isfile(os.path.join(REF_DIR, "config.py")):
            raise ImportError(f"shared host modules not found in {REF_DIR}")
        pkg = types.ModuleType(REF, "JAX package host modules, shared")
        pkg.__path__ = [REF_DIR]
        pkg.__package__ = REF
        sys.modules[REF] = pkg
    return pkg


def load(name: str) -> types.ModuleType:
    """Import a shared module by its path inside the JAX package,
    e.g. ``load("ops.align_graph")``."""
    _register()
    return importlib.import_module(f"{REF}.{name}")


_register()
