"""Build-on-demand loader for the native (C++) helper libraries.

The .so binaries are not vendored in git: each is rebuilt from its
source via the checked-in Makefile whenever the binary is missing or
older than the .cpp, so a stale binary can never silently diverge from
the source it claims to implement.  ``load_native`` returns None when
the library cannot be produced (no toolchain, unsupported platform);
every caller has a fallback (the device front end, Python extraction).

The libraries are the repository's shared C++ helpers (``native/``,
beside this package), not part of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess


def native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native")


def load_native(soname: str) -> ctypes.CDLL | None:
    """Load native/<soname>, (re)building it from source if needed."""
    d = native_dir()
    so = os.path.join(d, soname)
    # libsst_fe.so -> sst_fe.cpp; ISA variants (libsst_fe_avx512.so)
    # build from the same source
    base = soname[3:-3]
    for suffix in ("_avx512",):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    src = os.path.join(d, base + ".cpp")
    try:
        stale = not os.path.exists(so) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(so))
        if stale and os.path.exists(src):
            subprocess.run(["make", "-C", d, soname], check=True,
                           capture_output=True, timeout=300)
        return ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        return None
