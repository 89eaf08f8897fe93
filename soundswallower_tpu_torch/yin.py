"""YIN pitch estimator (reference: src/yin.c, include/soundswallower/yin.h).

Two paths:

* **Exact fixed-point path** (`Yin`): bit-identical to the reference's
  block-floating-point Q15 cumulative-mean-normalized-difference (CMND)
  implementation (yin.c:69-130) and its smoothed circular-window state
  machine (yin_write yin.c:198, yin_read yin.c:223).  The inner
  accumulation's dynamic shifting is sequential, so this lives in native
  C++ (native/sst_yin.cpp) bound via ctypes, with a pure-Python fallback
  when the shared library is not built.  A copy of the JAX package's
  host path.

* **Batched path on the card** (`cmnd_batch`, `pitch_batch`): float32
  CMND over a whole ``[..., frame_size]`` frame tensor and the
  threshold-then-argmin period pick, in one call of kernel K14
  (``csrc/yin.cu``: the differences, then the scan and pick) for CUDA
  tensors; ``yin_layout`` says which layout its launcher takes and
  ``yin_cmnd_at`` forces one; ``yin_cmnd_plain`` is the same
  function in plain PyTorch, which only the CPU route and the tests
  run.  Both keep the float32 order of the JAX program as XLA's CPU
  backend compiles it (``soundswallower_tpu/yin.py`` cmnd_batch,
  pitch_batch), read from its compiled HLO:

  - d(t) = sum_j (x[j] - x[t+j])^2, the square rounded on its own (no
    FMA), summed as XLA's tree: at most 32 values are a sequential sum
    from 0; more are cut into windows of 32 (the padding split with its
    smaller half in front), each window summed in order, and the window
    sums summed the same way, level after level;
  - the cumulative sum as XLA's blocked scan: at most 16 values are a
    running sum; more are padded at the back to blocks of 16, each block
    takes a running sum, the block totals are scanned the same way and
    the total of the blocks before is added to each lane;
  - d'(t) = (d(t) * t) / cum(t) with cum <= 0 replaced by 1, d'(0) = 1,
    then x 32768;
  - the period: the first lag with d' < threshold (in float32), else the
    first minimum (a NaN counts as the minimum); int64, as the JAX
    program's with x64.

  Lags t + j past the frame's end read its last sample, as the JAX
  gather clamps them (frame_size // 2 < ``ndiff`` <= frame_size).

The estimator is standalone in the reference (not in the decode path);
it is exposed here for API completeness and as a batched voicing
feature extractor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .utils import cuda_build, resolve_device

_LIB = None
_LIB_TRIED = False

TREE_WINDOW = 32     # the window of XLA's tree reduction on the CPU
SCAN_BLOCK = 16      # the block of XLA's blocked scan on the CPU


def _lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    from .utils.native_build import load_native
    lib = load_native("libsst_yin.so")
    if lib is None:
        return None
    lib.sst_yin_init.restype = ctypes.c_void_p
    lib.sst_yin_init.argtypes = [ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int]
    lib.sst_yin_free.argtypes = [ctypes.c_void_p]
    lib.sst_yin_start.argtypes = [ctypes.c_void_p]
    lib.sst_yin_end.argtypes = [ctypes.c_void_p]
    lib.sst_yin_write.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int16)]
    lib.sst_yin_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint16),
                                 ctypes.POINTER(ctypes.c_uint16)]
    lib.sst_yin_read.restype = ctypes.c_int
    lib.sst_yin_cmn_diff.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.c_int]
    _LIB = lib
    return lib


def cmn_diff_exact(signal: np.ndarray, ndiff: int) -> np.ndarray:
    """Bit-exact Q15 CMND of one frame (yin.c:69-130).

    signal: int16 [>= 2*ndiff].  Returns int32 [ndiff]."""
    signal = np.ascontiguousarray(signal, dtype=np.int16)
    lib = _lib()
    if lib is not None:
        out = np.empty(ndiff, np.int32)
        lib.sst_yin_cmn_diff(
            signal.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ndiff)
        return out
    return _cmn_diff_py(signal, ndiff)


def _cmn_diff_py(signal: np.ndarray, ndiff: int) -> np.ndarray:
    """Pure-Python fallback, same block-floating-point semantics."""
    out = np.empty(ndiff, np.int32)
    out[0] = 32768
    cum = 0
    cshift = 0
    tscale = 0
    while tscale < 32 and not (ndiff & (1 << (31 - tscale))):
        tscale += 1
    tscale -= 1
    sig = signal.astype(np.int64)
    for t in range(1, ndiff):
        dd = 0
        dshift = 0
        lim = 1 << tscale
        for j in range(ndiff):
            diff = int(sig[j]) - int(sig[t + j])
            if dd > lim:
                dd >>= 1
                dshift += 1
            dd += (diff * diff) >> dshift
        if dshift > cshift:
            cum += dd << (dshift - cshift)
        else:
            cum += dd >> (cshift - dshift)
        while cum > lim:
            cum >>= 1
            cshift += 1
        if cum == 0:
            cum = 1
        norm = ((t << tscale) & 0xFFFFFFFF) // cum
        shift = tscale - 15 + cshift - dshift
        prod = dd * norm
        v = (prod >> shift) if shift >= 0 else (prod << -shift)
        out[t] = np.int32(v & 0xFFFFFFFF) if v <= 0x7FFFFFFF else np.int32(
            (v & 0xFFFFFFFF) - (1 << 32) if (v & 0x80000000) else v & 0x7FFFFFFF)
    return out


class Yin:
    """Moving-window pitch estimator, reference-equivalent API
    (yin_init/start/write/read/end, yin.h:63-106).

    frame_size: analysis frame length in samples (lags searched up to
    frame_size/2); search_threshold/search_range in [0,1) (quantized to
    Q15 like yin_init, yin.c:136-139); smooth_window: half-width of the
    period smoothing window."""

    def __init__(self, frame_size: int, search_threshold: float = 0.1,
                 search_range: float = 0.2, smooth_window: int = 2):
        self.frame_size = frame_size
        self.search_threshold = int(search_threshold * 32768)
        self.search_range = int(search_range * 32768)
        self.wsize = smooth_window * 2 + 1
        lib = _lib()
        if lib is not None:
            self._h = lib.sst_yin_init(frame_size,
                                       ctypes.c_float(search_threshold),
                                       ctypes.c_float(search_range),
                                       smooth_window)
            self._lib = lib
        else:
            self._h = None
            self._lib = None
            self._diff = np.zeros((self.wsize, frame_size // 2), np.int32)
            self._period = np.zeros(self.wsize, np.uint16)
            self._wstart = self._wcur = self._nfr = 0
            self._endut = False

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.sst_yin_free(self._h)
            self._h = None

    def start(self):
        if self._h is not None:
            self._lib.sst_yin_start(self._h)
        else:
            self._wstart = self._nfr = 0
            self._endut = False

    def end(self):
        if self._h is not None:
            self._lib.sst_yin_end(self._h)
        else:
            self._endut = True

    def write(self, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, dtype=np.int16)
        if len(frame) < self.frame_size:
            raise ValueError("frame shorter than frame_size")
        if self._h is not None:
            self._lib.sst_yin_write(
                self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            return
        # fallback mirror of yin_write (yin.c:198-221)
        self._wstart += 1
        outptr = self._wstart - 1
        if self._wstart == self.wsize:
            self._wstart = 0
        difflen = self.frame_size // 2
        self._diff[outptr] = _cmn_diff_py(frame, difflen)
        self._period[outptr] = _thresholded_search_py(
            self._diff[outptr], self.search_threshold, 0, difflen)
        self._nfr += 1

    def read(self):
        """Returns (period_samples, bestdiff_q15) or None if no frame is
        available yet (yin_read, yin.c:223-326)."""
        if self._h is not None:
            period = ctypes.c_uint16()
            bdiff = ctypes.c_uint16()
            if self._lib.sst_yin_read(self._h, ctypes.byref(period),
                                      ctypes.byref(bdiff)):
                return int(period.value), int(bdiff.value)
            return None
        return self._read_py()

    def _read_py(self):
        half = (self.wsize - 1) // 2
        if half == 0:
            if self._endut:
                return None
            p = int(self._period[0])
            return p, int(self._diff[0][p])
        if not self._endut and self._nfr < half + 1:
            return None
        if self._endut:
            if self._wcur == self._wstart:
                return None
            wstart = (self._wcur + self.wsize - half) % self.wsize
            wlen = self._wstart - wstart
            if wlen < 0:
                wlen += self.wsize
        elif self._nfr < self.wsize:
            wstart, wlen = 0, self._nfr
        else:
            wstart, wlen = self._wstart, self.wsize
        best = int(self._period[self._wcur])
        best_diff = int(self._diff[self._wcur][best])
        for i in range(wlen):
            j = (wstart + i) % self.wsize
            d = int(self._diff[j][self._period[j]])
            if d < best_diff:
                best_diff = d
                best = int(self._period[j])
        if best == int(self._period[self._wcur]):
            self._wcur = (self._wcur + 1) % self.wsize
            return best, best_diff
        width = best * self.search_range // 32768
        if width == 0:
            width = 1
        lo = max(0, best - width)
        hi = min(self.frame_size // 2, best + width)
        best = _thresholded_search_py(self._diff[self._wcur],
                                      self.search_threshold, lo, hi)
        best_diff = int(self._diff[self._wcur][best])
        self._wcur = (self._wcur + 1) % self.wsize
        return min(best, 32768), min(best_diff, 32768)


def _thresholded_search_py(dw, threshold, start, end):
    best, argmin = 1 << 62, 0
    for i in range(start, end):
        d = int(dw[i])
        if d < threshold:
            return i
        if d < best:
            best, argmin = d, i
    return argmin


# ---------------------------------------------------------------------------
# Batched float path: kernel K14 and its plain version
# ---------------------------------------------------------------------------

def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def tree_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of XLA's tree
    reduction on the CPU (windows of 32, padding split with its smaller
    half in front, level after level)."""
    while x.shape[-1] > TREE_WINDOW:
        n = x.shape[-1]
        w = -(-n // TREE_WINDOW)
        lo = (w * TREE_WINDOW - n) // 2
        x = torch.nn.functional.pad(x, (lo, w * TREE_WINDOW - n - lo))
        x = _seq_sum(x.reshape(*x.shape[:-1], w, TREE_WINDOW))
    return _seq_sum(x)


def blocked_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum over the last axis in the order
    of XLA's blocked scan on the CPU (blocks of 16, recursively)."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        out = []
        for k in range(n):
            acc = acc + x[..., k]
            out.append(acc)
        return torch.stack(out, -1)
    m = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * SCAN_BLOCK - n))
    within = blocked_cumsum_plain(xp.reshape(*x.shape[:-1], m, SCAN_BLOCK))
    incl = blocked_cumsum_plain(within[..., -1])          # [..., m]
    cum = torch.cat([within[..., :1, :],
                     within[..., 1:, :] + incl[..., :-1, None]], -2)
    return cum.reshape(*x.shape[:-1], m * SCAN_BLOCK)[..., :n]


def _pick(cmnd: torch.Tensor, thr: float):
    """(period int64, best float32): the first lag under ``thr`` (a
    float32 threshold), else the first minimum, a NaN first."""
    under = cmnd < torch.tensor(thr, dtype=torch.float32)
    first = torch.argmax(under.to(torch.uint8), -1)
    nan = torch.isnan(cmnd)
    amin = torch.where(nan.any(-1), torch.argmax(nan.to(torch.uint8), -1),
                       torch.argmin(torch.where(nan, 0.0, cmnd), -1))
    period = torch.where(under.any(-1), first, amin)
    best = torch.gather(cmnd, -1, period[:, None])[:, 0]
    return period, best


def yin_cmnd_plain(frames: torch.Tensor, ndiff: int, thr: float):
    """Plain PyTorch version of K14: frames [N, F] (int16 or float32) ->
    (cmnd float32 [N, ndiff], period int64 [N], best float32 [N]); the
    float32 orders of the module docstring."""
    x = frames.to(torch.float32)
    N, F = x.shape
    idx = torch.clamp(torch.arange(ndiff, device=x.device)[:, None]
                      + torch.arange(ndiff, device=x.device)[None, :],
                      max=F - 1)
    # the lag matrix [rows, ndiff, ndiff], a few rows at a time
    rows = max(1, (1 << 24) // max(1, ndiff * ndiff))
    d = []
    for r in range(0, N, rows):
        xr = x[r:r + rows]
        diff = xr[:, None, :ndiff] - xr[:, idx]
        d.append(tree_sum_plain(diff * diff))
    d = torch.cat(d) if d else torch.zeros((0, ndiff), device=x.device)
    cum = blocked_cumsum_plain(d)
    cum = torch.where(cum <= 0, torch.ones_like(cum), cum)
    t = torch.arange(ndiff, dtype=torch.float32, device=x.device)
    dp = (d * t) / cum
    dp[:, 0] = 1.0
    cmnd = dp * torch.tensor(32768.0, dtype=torch.float32)
    return (cmnd,) + _pick(cmnd, thr)


def yin_layout(N: int, ndiff: int, R: int = 0, tpf: int = 0) -> dict:
    """K14's layout on the current CUDA device for N frames of ndiff
    lags: R lags a thread, threads a block (tpf), lag tiles a frame,
    blocks of the first launch, launches; R and tpf force one where not
    0.  RuntimeError for a layout the launcher cannot run."""
    lay = (ctypes.c_int32 * 5)()
    cuda_build.check(cuda_build.lib().sst_yin_layout(
        N, ndiff, R, tpf, ctypes.addressof(lay)), "yin_layout")
    return dict(R=lay[0], tpf=lay[1], tiles=lay[2], blocks=lay[3],
                launches=lay[4])


def yin_cmnd_at(frames: torch.Tensor, ndiff: int, thr: float, R: int = 0,
                tpf: int = 0):
    """K14 on a CUDA tensor in a forced layout (``yin_layout``'s
    parameters; 0 for the launcher's choice)."""
    if ndiff > frames.shape[-1]:
        raise ValueError(f"ndiff {ndiff} > frame_size {frames.shape[-1]}")
    if frames.device.type != "cuda":
        raise ValueError(f"yin_cmnd: unsupported device {frames.device}")
    if frames.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"yin_cmnd: dtype {frames.dtype}, expected int16 "
                        "or float32")
    cuda_build.check_tensor(frames, frames.dtype, "frames")
    N, F = frames.shape
    dev = frames.device
    cmnd = torch.empty((N, ndiff), dtype=torch.float32, device=dev)
    period = torch.empty(N, dtype=torch.int64, device=dev)
    best = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0 or ndiff == 0:
        return cmnd, period, best
    lib = cuda_build.lib()
    err = lib.sst_yin_cmnd(frames.data_ptr(), int(frames.dtype == torch.int16),
                           cmnd.data_ptr(), period.data_ptr(), best.data_ptr(),
                           N, F, ndiff, float(thr), R, tpf,
                           cuda_build.stream(frames))
    cuda_build.check(err, "yin_cmnd")
    yin_cmnd.launches += 1
    return cmnd, period, best


def yin_cmnd(frames: torch.Tensor, ndiff: int, thr: float):
    """K14: frames [N, F] int16 or float32 -> (cmnd float32 [N, ndiff],
    period int64 [N], best float32 [N]).  ``thr`` is the float32
    threshold on the x32768 scale."""
    if ndiff > frames.shape[-1]:
        # the JAX program's x[..., :ndiff] has F values: it cannot
        # broadcast against the [ndiff, ndiff] lag matrix either
        raise ValueError(f"ndiff {ndiff} > frame_size {frames.shape[-1]}")
    if frames.device.type == "cpu":
        return yin_cmnd_plain(frames, ndiff, thr)
    return yin_cmnd_at(frames, ndiff, thr)


yin_cmnd.launches = 0


def _frames(frames, device) -> torch.Tensor:
    """frames (numpy or tensor, any integer or float dtype) as a tensor
    on ``device``: int16 and float32 as they are, any other dtype
    converted to float32 as the JAX program's ``astype`` converts it."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(frames) if not isinstance(
        frames, torch.Tensor) else frames).to(device)
    if x.dtype not in (torch.int16, torch.float32):
        x = x.to(torch.float32)
    return x


def _run(frames, ndiff, thr, device):
    x = _frames(frames, device)
    lead, F = x.shape[:-1], x.shape[-1]
    if ndiff is None:
        ndiff = F // 2
    cmnd, period, best = yin_cmnd(x.reshape(-1, F).contiguous(), ndiff, thr)
    return (cmnd.reshape(*lead, ndiff), period.reshape(lead),
            best.reshape(lead))


def cmnd_batch(frames, ndiff: int | None = None, device="cuda"):
    """Float CMND over a frame tensor ``[..., frame_size]`` -> float32
    [..., ndiff] on ``device`` (the card unless the caller asks for the
    CPU).

    d(t) = sum_j (x[j] - x[t+j])^2; d'(0)=1, d'(t) = d(t) * t / cumsum(d).
    Output scaled to Q15 range (x32768) so thresholds match the exact
    path."""
    return _run(frames, ndiff, 0.0, device)[0]


def pitch_batch(frames, search_threshold: float = 0.1, device="cuda"):
    """Batched period estimate: for each frame, the first lag whose CMND
    falls under threshold, else the argmin (thresholded_search semantics,
    yin.c:174-196).  Returns (period int64 [...], bestdiff_q15 float32
    [...]) on ``device``."""
    thr = float(np.float32(search_threshold * 32768.0))
    return _run(frames, None, thr, device)[1:]
