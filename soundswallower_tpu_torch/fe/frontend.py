"""Front-end tables for the host C++ MFCC (numpy only).

The aligner computes MFCC on the host with ``native/sst_fe.cpp``
(through the shared ``fe/native_fe.py``), which takes its tables from a
front-end object: Hamming window, FFT twiddles and bit-reversal
permutation, mel filters, DCT basis, lifter.  The JAX package builds
them in ``soundswallower_tpu/fe/frontend.py``, a module that imports
jax; this module builds the same arrays with the same float32/float64
arithmetic from numpy alone (tests/test_torch_shared.py compares them).
The device MFCC itself is not ported yet (ROADMAP.md B10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .._shared import load


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


@dataclass(eq=False)
class Frontend:
    """The front-end parameters and tables ``NativeFrontend`` reads
    (fe_init, fe_interface.c:263-266 and fe_sigproc.c)."""

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
        warp = load("fe.warp").Warp(self.warp_type, self.warp_params,
                                    self.sampling_rate)
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
