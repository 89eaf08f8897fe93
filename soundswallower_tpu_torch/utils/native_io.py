"""ctypes bindings for the native audio I/O library (native/sst_io.cpp).

Provides fast WAV/raw loading and padded float32 batch packing for the
batch pipeline (a copy of the JAX package's module; the library is the
repository's shared C++ helper).  Falls back to pure-Python implementations when the shared
library has not been built (``make -C native``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from .native_build import load_native
    lib = load_native("libsst_io.so")
    if lib is None:
        return None
    lib.sst_audio_read.restype = ctypes.c_void_p
    lib.sst_audio_read.argtypes = [ctypes.c_char_p]
    lib.sst_audio_n_samples.restype = ctypes.c_int64
    lib.sst_audio_n_samples.argtypes = [ctypes.c_void_p]
    lib.sst_audio_sample_rate.restype = ctypes.c_int32
    lib.sst_audio_sample_rate.argtypes = [ctypes.c_void_p]
    lib.sst_audio_samples.restype = ctypes.POINTER(ctypes.c_int16)
    lib.sst_audio_samples.argtypes = [ctypes.c_void_p]
    lib.sst_audio_free.argtypes = [ctypes.c_void_p]
    lib.sst_pack_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return lib


def read_audio(path: str):
    """Load WAV (mono PCM16) or raw int16; returns (samples, rate_or_None)."""
    lib = _lib()
    if lib is None:
        from .. import get_audio_data

        data, rate = get_audio_data(path)
        return np.frombuffer(data, np.int16), rate
    h = lib.sst_audio_read(path.encode())
    if not h:
        raise IOError(f"Cannot read {path}")
    try:
        n = lib.sst_audio_n_samples(h)
        rate = lib.sst_audio_sample_rate(h)
        ptr = lib.sst_audio_samples(h)
        samples = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return samples, (rate if rate > 0 else None)
    finally:
        lib.sst_audio_free(h)


def pack_batch(utts: list[np.ndarray], max_len: int | None = None) -> np.ndarray:
    """Pack int16 utterances into a padded float32 [B, max_len] batch with
    fe-compatible sample-value scaling."""
    if max_len is None:
        max_len = max(len(u) for u in utts)
    lib = _lib()
    B = len(utts)
    if lib is None:
        out = np.zeros((B, max_len), np.float32)
        for i, u in enumerate(utts):
            n = min(len(u), max_len)
            out[i, :n] = u[:n].astype(np.float32)
        return out
    out = np.zeros((B, max_len), np.float32)
    arrs = [np.ascontiguousarray(u, dtype=np.int16) for u in utts]
    ptrs = (ctypes.POINTER(ctypes.c_int16) * B)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for a in arrs])
    lens = (ctypes.c_int64 * B)(*[len(a) for a in arrs])
    lib.sst_pack_batch_f32(ptrs, lens, B, max_len,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
