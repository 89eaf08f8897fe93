"""Frozen copy of ``soundswallower_tpu_torch/fe/frontend.py``
for the benchmark's reference (see ``__init__``).

The MFCC front end: tables (numpy) and the device MFCC (kernels K8-K10).

Port of ``soundswallower_tpu/fe/frontend.py`` (Frontend), a module that
imports jax.  The tables (Hamming window, FFT twiddles and bit-reversal
permutation, mel filters, DCT basis, lifter) are built from numpy alone
with the same float32/float64 arithmetic (tests/test_torch_shared.py
compares them); the host C++ MFCC (``native/sst_fe.cpp``, through
``fe/native_fe.py``) reads them.

The device MFCC works on a batch of signals [B, N] (float32 sample
values or int16), with per-row sample counts, pre-emphasis priors and
noise-removal carries, so one launch serves a batch and a stream:

* K8 ``fe_spec``: float64 pre-emphasis with the cross-chunk prior,
  framing (samples at and after ``n_samps`` are zero), with
  ``remove_dc`` the frame mean subtracted (``frame_sum_plain``'s order),
  the Hamming window, the reference's in-place radix-2 real FFT in C
  butterfly order (``fe_fft_real``), the power spectrum and the mel
  fold, a sequential float64 fold in coefficient order -> mfspec [B, T,
  nfilt] float64;
* K9 ``fe_noise``: the noise-removal recurrence (``fe_remove_noise``)
  over frames with its carry, frozen on frames >= ``n_frames``;
* K10 ``fe_cep``: ``log(x + 1e-4)``, then the DCT with float32
  rounding after every float64 add (``dct``/``htk`` or ``legacy``), then
  the lifter -> cep [B, T, ncep] float32 (or the float64 log spectra).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version, in float64, for CPU tensors.  The plain versions follow
the JAX program stage by stage.  Where its CPU backend fuses a float64
multiply and add into one FMA (XLA's CPU compiler allows FMA
contraction), the plain version and the kernel do the same with an
exactly rounded FMA (``fma_plain``, ``__fma_rn``); every other multiply
and add rounds separately.  On the CPU the plain version takes ``log``
from the C library (``math.log``), as XLA's CPU backend does: PyTorch's
vectorized float64 ``log`` differs from it in the last bit of about 2 in
10,000 values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .utils import resolve_device
from .warp import Warp

LOG_FLOOR = 1e-4                 # fe_sigproc.c:609
# fe_noise.c's constants, as the JAX program holds them (Python doubles)
LAMBDA_POWER = 0.7
LAMBDA_A = 0.995
LAMBDA_B = 0.5
LAMBDA_T = 0.85
MU_T = 0.2
MAX_GAIN = 20.0
SMOOTH_WINDOW = 4
# the constants XLA's algebraic simplifier folds into the JAX program's
# noise step (division by a constant becomes a product with its
# reciprocal; constant factors of a product chain are multiplied out)
INV_MAX_GAIN = 1.0 / MAX_GAIN
LT_LT = LAMBDA_T * LAMBDA_T
LT_MU = LAMBDA_T * MU_T
SQRT_HALF = np.float32(0.707106781186548)   # fe.h:367


def _mel(x_f32, warp=None) -> np.float32:
    """fe_mel (fe_sigproc.c:70-76): warp, then mel scale."""
    if warp is not None:
        x_f32 = warp.unwarped_to_warped(np.float32(x_f32))
    return np.float32(2595.0 * math.log10(1.0 + float(x_f32) / 700.0))


def _melinv(x_f32, warp=None) -> np.float32:
    """fe_melinv (fe_sigproc.c:78-83): inverse mel scale, then unwarp."""
    f = np.float32(700.0 * (math.pow(10.0, float(x_f32) / 2595.0) - 1.0))
    if warp is not None:
        f = warp.warped_to_unwarped(f)
    return f


def build_melfilters(sampling_rate, fft_size, num_filters, lower_filt_freq,
                     upper_filt_freq, doublewide=False, round_filters=True,
                     unit_area=True, warp=None):
    """fe_build_melfilters (fe_sigproc.c:85-199) in float32: returns
    (spec_start [nfilt] int32, widths [nfilt] int32, coefficient
    arrays)."""
    f32 = np.float32
    melmin = _mel(f32(lower_filt_freq), warp)
    melmax = _mel(f32(upper_filt_freq), warp)
    melbw = f32((melmax - melmin) / f32(num_filters + 1))
    if doublewide:
        melmin = f32(melmin - melbw)
        melmax = f32(melmax + melbw)
    fftfreq = f32(f32(sampling_rate) / f32(fft_size))
    spec_start = np.full(num_filters, -1, dtype=np.int32)
    widths = np.zeros(num_filters, dtype=np.int32)
    coeffs = []
    for i in range(num_filters):
        freqs = []
        for j in range(3):
            k = i + j * 2 if doublewide else i + j
            f = _melinv(f32(f32(k) * melbw + melmin), warp)
            if round_filters:
                # ((int)(freqs[j] / fftfreq + 0.5)) * fftfreq, +0.5 in double
                f = f32(int(float(f32(f / fftfreq)) + 0.5) * fftfreq)
            freqs.append(f32(f))
        start, width = -1, 0
        for j in range(fft_size // 2 + 1):
            hz = f32(f32(j) * fftfreq)
            if hz < freqs[0]:
                continue
            if hz > freqs[2] or j == fft_size // 2:
                width = j - start
                break
            if start == -1:
                start = j
        spec_start[i] = start
        widths[i] = width
        cf = np.zeros(width, dtype=np.float32)
        for j in range(width):
            hz = f32(f32(start + j) * fftfreq)
            lo = f32((hz - freqs[0]) / f32(freqs[1] - freqs[0]))
            hi = f32((freqs[2] - hz) / f32(freqs[2] - freqs[1]))
            if unit_area:
                scale = f32(f32(2.0) / f32(freqs[2] - freqs[0]))
                lo = f32(lo * scale)
                hi = f32(hi * scale)
            cf[j] = lo if lo < hi else hi
        coeffs.append(cf)
    return spec_start, widths, coeffs


def bitrev_perm(n: int) -> np.ndarray:
    """fe_fft_real's bit-reversal permutation (fe_sigproc.c:472-485)."""
    perm = np.arange(n)
    j = 0
    for i in range(n - 1):
        if i < j:
            perm[i], perm[j] = perm[j], perm[i]
        k = n // 2
        while k <= j:
            j -= k
            k //= 2
        j += k
    return perm


def _fft_stages(n: int) -> list[dict]:
    """Index arrays of fe_fft_real's stages k = 1 .. log2(n)-1 (the JAX
    package's _fft_stage_indices): per block of 2^(k+1), the sum and
    difference at i_a/i_b, the negation at i_c, and the butterflies
    (i1, i2, i3, i4) with twiddle index tw."""
    m = int(round(math.log2(n)))
    stages = []
    for k in range(1, m):
        n4, n2, n1 = k - 1, k, k + 1
        blocks = np.arange(0, n, 1 << n1)
        st = dict(i_a=blocks, i_b=blocks + (1 << n2),
                  i_c=blocks + (1 << n2) + (1 << n4))
        js = np.arange(1, 1 << n4)
        if len(js):
            jj, bb = np.meshgrid(js, blocks)
            st.update(i1=(bb + jj).ravel(), i2=(bb + (1 << n2) - jj).ravel(),
                      i3=(bb + (1 << n2) + jj).ravel(),
                      i4=(bb + (1 << n2) + (1 << n2) - jj).ravel(),
                      tw=(jj << (m - n1)).ravel())
        stages.append(st)
    return stages


# -- exactly rounded float64 FMA ------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = a * 134217729.0                      # 2^27 + 1 (Veltkamp)
    hi = t - (t - a)
    return hi, a - hi


def fma_plain(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float64 ``a * b + c`` rounded once (IEEE fma), from float64 ops:
    the exact product (Dekker), the exact sum with c (TwoSum), the two
    error terms added with rounding to odd, then one rounding to nearest
    (Boldo and Melquiond, "Emulation of FMA and correctly rounded sums:
    proved algorithms using rounding to odd", IEEE TC 2008).  Finite,
    non-overflowing operands."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, w = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    step = torch.nextafter(v, torch.where(w > 0, math.inf, -math.inf))
    v = torch.where((w != 0) & even, step, v)              # round to odd
    return th + v


def log_plain(x: torch.Tensor) -> torch.Tensor:
    """float64 natural log, the C library's on the CPU (see the module
    docstring), torch.log elsewhere."""
    if x.device.type != "cpu":
        return torch.log(x)
    flat = x.detach().reshape(-1).numpy()
    out = np.fromiter(map(math.log, flat.tolist()), np.float64, len(flat))
    return torch.from_numpy(out).view(x.shape)


@dataclass(eq=False)
class Frontend:
    """Front-end parameters, tables (fe_init, fe_interface.c:263-266 and
    fe_sigproc.c) and the device MFCC."""

    sampling_rate: int = 16000
    frame_rate: int = 100
    window_length: float = 0.025625
    fft_size: int = 0  # 0 = next power of two >= frame_size
    num_cepstra: int = 13
    num_filters: int = 40
    lower_filt_freq: float = 133.33334
    upper_filt_freq: float = 6855.4976
    pre_emphasis_alpha: float = 0.97
    lifter_val: int = 0
    transform: str = "legacy"
    warp_type: str = "inverse_linear"
    warp_params: str | None = None
    remove_noise: bool = False
    remove_dc: bool = False
    round_filters: bool = True
    unit_area: bool = True
    doublewide: bool = False

    def __post_init__(self):
        self.frame_shift = int(self.sampling_rate / self.frame_rate + 0.5)
        self.frame_size = int(self.window_length * self.sampling_rate + 0.5)
        if self.fft_size == 0:
            n = 1
            while n < self.frame_size:
                n <<= 1
            self.fft_size = n
        if self.frame_size > self.fft_size:
            raise ValueError("frame size exceeds the FFT size")
        if self.fft_size & (self.fft_size - 1) or self.fft_size < 4:
            raise ValueError(f"FFT size {self.fft_size} is not a power of two")
        # Hamming window (fe_create_hamming): first half, mirrored
        half = np.zeros(self.frame_size // 2, dtype=np.float64)
        for i in range(self.frame_size // 2):
            half[i] = 0.54 - 0.46 * math.cos(
                2 * math.pi * i / (float(self.frame_size) - 1.0))
        win = np.ones(self.frame_size, dtype=np.float64)
        win[: self.frame_size // 2] = half
        win[self.frame_size - 1: self.frame_size - 1 - self.frame_size // 2:
            -1] = half
        self._window = win
        # twiddles (fe_create_twiddle)
        ang = 2 * np.pi * np.arange(self.fft_size // 4) / self.fft_size
        self._ccc = np.cos(ang)
        self._sss = np.sin(ang)
        self._perm = bitrev_perm(self.fft_size)
        self._stages = _fft_stages(self.fft_size)
        warp = Warp(self.warp_type, self.warp_params, self.sampling_rate)
        spec_start, widths, coeffs = build_melfilters(
            self.sampling_rate, self.fft_size, self.num_filters,
            self.lower_filt_freq, self.upper_filt_freq, self.doublewide,
            self.round_filters, self.unit_area, warp)
        self._spec_start = spec_start
        self._widths = widths
        self._maxw = int(widths.max())
        cmat = np.zeros((self.num_filters, self._maxw), dtype=np.float32)
        for i, cf in enumerate(coeffs):
            cmat[i, : len(cf)] = cf
        self._coeff_mat = cmat
        # DCT basis (fe_compute_melcosine), float32
        step = math.pi / self.num_filters
        mc = np.zeros((self.num_cepstra, self.num_filters), dtype=np.float32)
        for i in range(self.num_cepstra):
            for j in range(self.num_filters):
                mc[i, j] = np.float32(math.cos(step * i * (j + 0.5)))
        self._mel_cosine = mc
        self._sqrt_inv_n = np.float32(math.sqrt(1.0 / self.num_filters))
        self._sqrt_inv_2n = np.float32(math.sqrt(2.0 / self.num_filters))
        self._lifter = None
        if self.lifter_val:
            self._lifter = np.array(
                [1 + self.lifter_val / 2 * math.sin(i * math.pi / self.lifter_val)
                 for i in range(self.num_cepstra)], dtype=np.float32)
        self._dev_cache: dict = {}

    def n_frames(self, n_samps: int) -> int:
        """Output frames for a full utterance of n_samps samples
        (output_frame_count, fe_interface.c:379-391, plus fe_end's
        tail frame)."""
        if n_samps < self.frame_size:
            return 1 if n_samps > 0 else 0
        nfull = 1 + (n_samps - self.frame_size) // self.frame_shift
        tail = n_samps - nfull * self.frame_shift
        return nfull + (1 if tail > 0 else 0)

    @classmethod
    def from_config(cls, config) -> "Frontend":
        return cls(
            sampling_rate=config.get_int("samprate"),
            frame_rate=config.get_int("frate"),
            window_length=config.get_float("wlen"),
            fft_size=config.get_int("nfft"),
            num_cepstra=config.get_int("ncep"),
            num_filters=config.get_int("nfilt"),
            lower_filt_freq=config.get_float("lowerf"),
            upper_filt_freq=config.get_float("upperf"),
            pre_emphasis_alpha=config.get_float("alpha"),
            lifter_val=config.get_int("lifter"),
            transform=config["transform"],
            remove_noise=config.get_bool("remove_noise"),
            remove_dc=config.get_bool("remove_dc"),
        )

    # -- device tables -------------------------------------------------------

    def tables(self, device) -> dict:
        """The tables the kernels and plain versions read, on ``device``
        (cached per device)."""
        device = torch.device(device)
        t = self._dev_cache.get(device)
        if t is None:
            def dev(a, dtype):
                return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

            t = dict(window=dev(self._window, np.float64),
                     ccc=dev(self._ccc, np.float64),
                     sss=dev(self._sss, np.float64),
                     perm=dev(self._perm, np.int32),
                     spec_start=dev(self._spec_start, np.int32),
                     widths=dev(self._widths, np.int32),
                     coeff=dev(self._coeff_mat, np.float32),
                     mel_cosine=dev(self._mel_cosine, np.float32),
                     lifter=None if self._lifter is None
                     else dev(self._lifter, np.float32))
            self._dev_cache[device] = t
        return t

    def check_supported(self) -> None:
        if self.transform not in ("dct", "htk", "legacy"):
            raise ValueError(f"unknown transform {self.transform!r}")

    # -- the device MFCC -------------------------------------------------------

    def noise_init(self, B: int | None = None, device="cuda"):
        """Fresh noise-removal state (fe_reset_noisestats): (power,
        noise, floor, peak) float64 [nfilt] and undef bool [], or [B,
        nfilt] and [B] for a batch of B rows, on ``device`` (the card
        unless the caller asks for the CPU)."""
        device = resolve_device(device)
        shape = (self.num_filters,) if B is None else (B, self.num_filters)
        z = torch.zeros(shape, dtype=torch.float64, device=device)
        undef = torch.ones(() if B is None else (B,), dtype=torch.bool,
                           device=device)
        return (z, z.clone(), z.clone(), z.clone(), undef)

    def _rows(self, signal, n_samps, prior, noise_state, n_frames):
        """Batch form of the arguments: signal [B, N], n_samps/prior/
        n_frames [B] tensors on the signal's device, noise state [B,
        ...]; and whether the call was for a single row."""
        single = signal.dim() == 1
        sig = signal[None] if single else signal
        B, dev = sig.shape[0], sig.device

        def vec(x, dtype):
            x = torch.as_tensor(x, dtype=dtype, device=dev)
            return x.expand(B).contiguous() if x.dim() == 0 else x

        ns = vec(n_samps, torch.int32)
        pr = vec(0.0 if prior is None else prior, torch.float32)
        nf = None if n_frames is None else vec(n_frames, torch.int32)
        if noise_state is None:
            noise_state = self.noise_init(B, dev)
        elif single:
            noise_state = tuple(torch.as_tensor(x, device=dev)[None]
                                for x in noise_state)
        return single, sig.contiguous(), ns, pr, noise_state, nf

    def mfspec(self, signal, n_samps, max_frames: int, prior=None,
               noise_state=None, n_frames=None):
        """K8 then, with noise removal, K9: mel spectra [B, T, nfilt]
        float64 and the new noise state (None without noise removal)."""
        self.check_supported()
        single, sig, ns, pr, noise, nf = self._rows(signal, n_samps, prior,
                                                    noise_state, n_frames)
        spec = fe_spec_plain(self, sig, ns, pr, max_frames)
        if self.remove_noise:
            spec, noise = fe_noise_plain(self, spec, noise, nf)
        if single:
            spec = spec[0]
            noise = tuple(x[0] for x in noise)
        return spec, noise

    def mfcc_chunk(self, signal, n_samps, max_frames: int, prior,
                   noise_state, n_frames=None):
        """Chunk MFCC with explicit streaming state: ``prior`` is the
        sample preceding the chunk (float32) and ``noise_state`` the
        noise-removal carry; ``n_frames`` bounds the frames that advance
        the carry (needed whenever the state feeds a next chunk).
        signal [N] or [B, N] (float32 sample values or int16); returns
        (cep [T, ncep] or [B, T, ncep] float32, new noise state)."""
        spec, noise = self.mfspec(signal, n_samps, max_frames, prior,
                                  noise_state, n_frames)
        return fe_cep_plain(self, spec), noise

    def mfcc(self, signal, n_samps, max_frames: int):
        """Full-utterance MFCC from a fresh state (prior 0): [T, ncep]
        or [B, T, ncep] float32.  Frames past n_frames(n_samps) are the
        JAX program's padding values."""
        return self.mfcc_chunk(signal, n_samps, max_frames, None, None)[0]

    def logspec_chunk(self, signal, n_samps, max_frames: int):
        """Mel log-spectra [T, nfilt] or [B, T, nfilt] float64 from a
        fresh state (the powspec_t values the C pipeline carries)."""
        spec, _ = self.mfspec(signal, n_samps, max_frames)
        return fe_cep_plain(self, spec, logspec=True)

    def _smooth_logspec(self, ls: np.ndarray) -> np.ndarray:
        """SMOOTH_LOG_SPEC (fe_mel_cep, fe_sigproc.c:624-637): DCT-II to
        num_cepstra coefficients, DCT-III back, in numpy with the C
        accumulation dtypes (the JAX package's host helper)."""
        T = len(ls)
        nfilt, ncep = self.num_filters, self.num_cepstra
        mc = np.asarray(self._mel_cosine, np.float32)
        cep = np.zeros((T, ncep), np.float32)
        acc = ls[:, 0].astype(np.float32)
        for j in range(1, nfilt):
            acc = (acc.astype(np.float64) + ls[:, j]).astype(np.float32)
        cep[:, 0] = acc * np.float32(self._sqrt_inv_n)
        for i in range(1, ncep):
            acc = np.zeros(T, np.float32)
            for j in range(nfilt):
                term = ls[:, j] * np.float64(mc[i, j])
                acc = (acc.astype(np.float64) + term).astype(np.float32)
            cep[:, i] = acc * np.float32(self._sqrt_inv_2n)
        out = np.zeros((T, nfilt), np.float32)
        for i in range(nfilt):
            acc = (cep[:, 0] * SQRT_HALF).astype(np.float64)
            for j in range(1, ncep):
                acc = acc + (cep[:, j] * mc[j, i]).astype(np.float64)
            out[:, i] = (acc * np.float64(np.float32(self._sqrt_inv_2n))) \
                .astype(np.float32)
        return out

    def spectrogram(self, audio: np.ndarray, smooth: bool = False,
                    device="cuda") -> np.ndarray:
        """int16 samples (or float32 sample values in int16 range) ->
        [n_frames, nfilt] float32 mel log-spectra, the JS binding's
        spectrogram() (js/soundswallower.c:88-112): RAW_LOG_SPEC, or
        SMOOTH_LOG_SPEC when ``smooth``.  Runs on ``device``, the card
        unless the caller asks for the CPU."""
        device = resolve_device(device)
        audio = np.asarray(audio)
        n = len(audio)
        nfr = self.n_frames(n)
        if nfr == 0:
            return np.zeros((0, self.num_filters), np.float32)
        sig = torch.from_numpy(audio.astype(np.float32)).to(device)
        ls = self.logspec_chunk(sig, n, nfr).cpu().numpy()[:nfr]
        if smooth:
            return self._smooth_logspec(ls)
        return ls.astype(np.float32)

    def process_int16(self, audio: np.ndarray, device="cuda") -> np.ndarray:
        """int16 samples -> [n_frames, ncep] float32 numpy, on ``device``
        (the card unless the caller asks for the CPU)."""
        device = resolve_device(device)
        n = len(audio)
        nfr = self.n_frames(n)
        if nfr == 0:
            return np.zeros((0, self.num_cepstra), dtype=np.float32)
        sig = torch.from_numpy(np.asarray(audio).astype(np.float32)).to(device)
        return self.mfcc(sig, n, nfr).cpu().numpy()[:nfr]


# -- K8 ----------------------------------------------------------------------------

def fft_real_plain(fe: Frontend, x: torch.Tensor) -> torch.Tensor:
    """fe_fft_real (fe_sigproc.c:461-557) over [..., nfft] float64, stage
    by stage with the C code's per-element arithmetic (the JAX package's
    _fft_real)."""
    tb = fe.tables(x.device)
    ccc, sss = tb["ccc"], tb["sss"]
    x = x[..., tb["perm"].long()]
    e, o = x[..., 0::2], x[..., 1::2]
    x = torch.stack([e + o, e - o], dim=-1).reshape(x.shape)
    for st in fe._stages:
        i_a, i_b, i_c = (torch.from_numpy(st[k]).to(x.device)
                         for k in ("i_a", "i_b", "i_c"))
        xa, xb = x[..., i_a], x[..., i_b]
        x[..., i_a] = xa + xb
        x[..., i_b] = xa - xb
        x[..., i_c] = -x[..., i_c]
        if "i1" in st:
            i1, i2, i3, i4, tw = (torch.from_numpy(st[k]).to(x.device)
                                  for k in ("i1", "i2", "i3", "i4", "tw"))
            cc, ss = ccc[tw], sss[tw]
            x1, x2, x3, x4 = x[..., i1], x[..., i2], x[..., i3], x[..., i4]
            t1 = fma_plain(x3, cc, x4 * ss)
            t2 = fma_plain(x3, ss, -(x4 * cc))
            x[..., i4] = x2 - t2
            x[..., i3] = -x2 - t2
            x[..., i2] = x1 - t1
            x[..., i1] = x1 + t1
    return x


SUM_WINDOW = 32   # XLA's CPU tree reduction: windows of this many values


def frame_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """float64 sum over the last axis in the order XLA's CPU backend
    reduces it (its tree-reduction rewrite, read from the compiled
    remove_dc program): an axis of at most SUM_WINDOW values is added in
    order from 0; a longer one is zero-padded to whole windows, half the
    padding (rounded down) in front, each window added in order from 0,
    and the window sums reduced the same way."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(n):
            acc = acc + x[..., k]
        return acc
    nwin = -(-n // SUM_WINDOW)
    pad = nwin * SUM_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    win = xp.reshape(x.shape[:-1] + (nwin, SUM_WINDOW))
    acc = torch.zeros(win.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(SUM_WINDOW):
        acc = acc + win[..., k]
    return frame_sum_plain(acc)


def fe_spec_plain(fe: Frontend, sig: torch.Tensor, n_samps: torch.Tensor,
                  prior: torch.Tensor, T: int) -> torch.Tensor:
    """Plain PyTorch version of K8: sig [B, N] float32 or int16,
    n_samps int32 [B], prior float32 [B] -> mfspec [B, T, nfilt]
    float64."""
    tb = fe.tables(sig.device)
    B, N = sig.shape
    shift, size, nfft = fe.frame_shift, fe.frame_size, fe.fft_size
    f64 = torch.float64
    sig = sig.to(torch.float32)
    alpha = float(np.float32(fe.pre_emphasis_alpha))
    prev = torch.cat([prior.to(torch.float32)[:, None], sig[:, :-1]], dim=1)
    valid = torch.arange(N, device=sig.device)[None] < n_samps[:, None]
    sig = torch.where(valid, sig, 0.0).to(f64)
    prev = torch.where(valid, prev, 0.0).to(f64)
    pre = fma_plain(-prev, alpha, sig)
    idx = (torch.arange(T, device=sig.device)[:, None] * shift
           + torch.arange(size, device=sig.device)[None])
    ok = (idx[None] < N) & (idx[None] < n_samps[:, None, None])
    frames = torch.where(ok, pre[:, idx.clamp(max=N - 1)], 0.0)
    if fe.remove_dc:
        # frames - sum / size: the division a product with 1 / size, the
        # product fused into the subtraction, as XLA's CPU backend has it
        frames = fma_plain(-frame_sum_plain(frames)[..., None], 1.0 / size,
                           frames)
    frames = frames * tb["window"]
    x = torch.zeros((B, T, nfft), dtype=f64, device=sig.device)
    x[..., :size] = frames
    x = fft_real_plain(fe, x)
    j = torch.arange(1, nfft // 2 + 1, device=sig.device)
    spec = torch.cat([(x[..., 0] * x[..., 0])[..., None],
                      fma_plain(x[..., j], x[..., j],
                                x[..., nfft - j] * x[..., nfft - j])], dim=-1)
    # mel fold: sequential float64 fold in coefficient order
    offs = torch.arange(fe._maxw, device=sig.device)
    widx = (tb["spec_start"].long()[:, None] + offs[None]).clamp(max=nfft // 2)
    wins = spec[..., widx]                                 # [B, T, nfilt, maxw]
    cm = tb["coeff"].to(f64)
    acc = torch.zeros(wins.shape[:-1], dtype=f64, device=sig.device)
    for k in range(fe._maxw):
        take = offs[k] < tb["widths"]
        acc = torch.where(take, fma_plain(wins[..., k], cm[:, k], acc), acc)
    return acc


# -- K9 ----------------------------------------------------------------------------



# -- K10 ---------------------------------------------------------------------------

def fe_cep_plain(fe: Frontend, mfspec: torch.Tensor,
                 logspec: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K10: mfspec [..., nfilt] float64 ->
    cep [..., ncep] float32 (or, with ``logspec``, the float64 log
    spectra)."""
    ls = log_plain(mfspec + LOG_FLOOR)
    if logspec:
        return ls
    tb = fe.tables(mfspec.device)
    mc = tb["mel_cosine"].to(torch.float64)
    nfilt, f32, f64 = fe.num_filters, torch.float32, torch.float64
    legacy = fe.transform == "legacy"
    # legacy: XLA folds the factor 2 into the basis (ls * (2 mc), exact)
    # and divides by a constant as a product with its reciprocal
    acc = (ls[..., 0] * 0.5 if legacy else ls[..., 0]).to(f32)
    for j in range(1, nfilt):
        acc = (acc.to(f64) + ls[..., j]).to(f32)
    if legacy:
        out = [(acc.to(f64) * (1.0 / nfilt)).to(f32)]
    else:
        scale = fe._sqrt_inv_2n if fe.transform == "htk" else fe._sqrt_inv_n
        out = [acc * torch.tensor(scale, dtype=f32)]
    for i in range(1, fe.num_cepstra):
        acc = torch.zeros(ls.shape[:-1], dtype=f32, device=ls.device)
        for j in range(nfilt):
            m = mc[i, j] * 2.0 if legacy and j else mc[i, j]
            acc = fma_plain(ls[..., j], m, acc.to(f64)).to(f32)
        if legacy:
            out.append((acc.to(f64) * (1.0 / (2.0 * nfilt))).to(f32))
        else:
            out.append(acc * torch.tensor(fe._sqrt_inv_2n, dtype=f32))
    cep = torch.stack(out, dim=-1)
    if tb["lifter"] is not None:
        cep = cep * tb["lifter"]
    return cep


