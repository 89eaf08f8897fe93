"""Build-on-first-use loader for the CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface (``csrc/sst_kernels.h``), loaded with ``ctypes``.
The library is rebuilt whenever a source or header is newer than it,
the same rule as ``soundswallower_tpu/utils/native_build.py``, so a
stale binary never runs in place of the source it claims to be.

``-fmad=false``: the kernels reproduce the JAX package's float32
results bit for bit, and FMA contraction would change the rounding of
the distance fold (``native/Makefile`` builds the host FE with
``-ffp-contract=off`` for the same reason).  No ``--use_fast_math``.

Nothing here runs at import: ``lib()`` builds on its first call, which
only a wrapper handed a CUDA tensor makes.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SONAME = "libsst_cuda.so"
NVCC_FLAGS = ["-O3", "-std=c++17", "-arch=sm_90a", "-fmad=false",
              "-Xcompiler", "-fPIC"]
LINK_FLAGS = ["-arch=sm_90a", "-shared"]

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()
# seconds the last build took (0.0 when the library was up to date)
build_seconds = 0.0
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C signatures of the launchers (csrc/sst_kernels.h); every launcher
# returns the cudaError_t of its launch
_SIGS = {
    "sst_feat": [_P] * 4 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
    "sst_feat_layout": [_I] * 7 + [_P],
    "sst_dist_topn_norm": [_P] * 8 + [_I] * 7 + [_P],
    "sst_dist_topn_tile": [_I, _I],
    "sst_senone_eval": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    "sst_senone_eval_layout": [_I] * 5 + [_P],
    "sst_viterbi_batch": [_P] * 13 + [_I] * 6 + [_P, _I] + [_P] * 6,
    "sst_viterbi_smem_bytes": [_I, _I],
    "sst_viterbi_state_bytes": [_I, _I],
    "sst_gather_cols": [_P, _I, _P, _P, _I, _I, _I, _I, _P],
    "sst_gather_cols_layout": [_I, _P],
    "sst_viterbi_rows": [_P] * 10 + [_I] * 5 + [_P, _I] + [_P] * 5
    + [_I, _P],
    "sst_viterbi_rows_cluster": [_I] * 5 + [_P],
    "sst_frame_best_sub": [_P, _P, _I, _I, _I, _P],
    "sst_feat_f32": [_P] * 4 + [_I] * 7 + [_P],
    "sst_viterbi_chunk": [_P, _I, _I] + [_P] * 15 + [_I] * 5
    + [_P, _I, _P, _I, _P, _P, _P, _I, _P],
    "sst_viterbi_chunk_cluster": [_I] * 5 + [_P],
    "sst_fe_spec": [_P, _I] + [_P] * 10 + [_I] * 8 + [_D, _I, _P],
    "sst_fe_spec_frames": [_I] * 5,
    "sst_fe_noise": [_P] * 8 + [_I] * 4 + [_P],
    "sst_fe_noise_tile": [_I],
    "sst_fe_cep": [_P] * 5 + [_I] * 4 + [_F, _F, _P],
    "sst_ms_dist_topn": [_P] * 6 + [_I] * 6 + [_P],
    "sst_ms_dist_topn_at": [_P] * 6 + [_I] * 8 + [_P],
    "sst_ms_dist_topn_layout": [_I] * 6 + [_P],
    "sst_ms_senone_eval": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _P,
                           _P] + [_I] * 8 + [_P],
    "sst_ms_senone_eval_tile": [_I] * 6,
    "sst_backtrace_chunk": [_P, _I] + [_P] * 5 + [_I] * 5 + [_P],
    "sst_backtrace_segment_len": [_I] * 4,
    "sst_yin_cmnd": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "sst_yin_layout": [_I] * 4 + [_P],
}
# launchers return the cudaError_t of their launch; these return sizes
_RESTYPES = {"sst_viterbi_state_bytes": ctypes.c_int64}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale(so: str) -> bool:
    if not os.path.exists(so):
        return True
    t = os.path.getmtime(so)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.h"))
    return any(os.path.getmtime(p) > t for p in deps)


def build() -> str:
    """Compile csrc/*.cu into _build/libsst_cuda.so if stale, one nvcc
    per source in parallel, then link; returns the library's path.  The
    compilers' output stays in ``build_log``."""
    global build_seconds, build_log
    so = os.path.join(BUILD_DIR, SONAME)
    if not _stale(so):
        build_seconds = 0.0
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for obj, src in zip(objs, sources())]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
        failed = [p.args[-1] for p in procs if p.returncode != 0]
        if not failed:
            tmp = f"{so}.{tag}"
            r = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                               capture_output=True, text=True, timeout=300)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed = ["link"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            dll = ctypes.CDLL(build())
            for name, argtypes in _SIGS.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            dll.sst_error_string.argtypes = [_I]
            dll.sst_error_string.restype = ctypes.c_char_p
            _LIB = dll
    return _LIB


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = _LIB.sst_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_tensor(t, dtype, name: str, device=None) -> None:
    """What a launcher takes: the dtype, contiguous, on the device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def stream(t) -> int:
    """Handle of PyTorch's current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
