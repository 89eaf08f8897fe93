"""Bit-exact fixed-point GMM voice-activity detector.

Reimplements the algorithm of the WebRTC VAD vendored by the reference
(src/common_audio/vad/{vad_core,vad_filterbank,vad_gmm,vad_sp}.c and the
signal_processing helpers it uses), in integer Python.  Parity-tested
frame-by-frame against golden dumps from the reference library
(tests/golden/vad, produced by tools/oracle/vad_oracle.c) at 8/16/32/48
kHz, all four aggressiveness modes and 10/20/30 ms frames.

The classifier is a 6-band spectral VAD: a cascade of split (QMF-style
all-pass pair) filters decomposes an 8 kHz signal into 6 sub-bands whose
log energies feed per-band 2-Gaussian speech/noise models; a combined
local + global likelihood-ratio test makes the decision and the models
adapt online.  All arithmetic is int16/int32 with C wrapping semantics:
every value stored to an int16 slot passes through _w16(), every int32
slot through _w32(), and divisions truncate toward zero (_div).
"""

from __future__ import annotations

import numpy as np

NUM_CHANNELS = 6
NUM_GAUSSIANS = 2
TABLE_SIZE = NUM_CHANNELS * NUM_GAUSSIANS
MIN_ENERGY = 10

# spectrum weights for the global log-likelihood sum
_SPECTRUM_WEIGHT = (6, 8, 10, 12, 14, 16)
_NOISE_UPDATE = 655       # Q15
_SPEECH_UPDATE = 6554     # Q15
_BACK_ETA = 154           # Q8
_MIN_DIFF = (544, 544, 576, 576, 576, 576)          # Q5
_MAX_SPEECH = (11392, 11392, 11520, 11520, 11520, 11520)  # Q7
_MIN_MEAN = (640, 768)
_MAX_NOISE = (9216, 9088, 8960, 8832, 8704, 8576)   # Q7
_NOISE_WEIGHTS = (34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103)
_SPEECH_WEIGHTS = (48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81)
_NOISE_MEANS = (6738, 4892, 7065, 6715, 6771, 3369,
                7646, 3863, 7820, 7266, 5020, 4362)
_SPEECH_MEANS = (8306, 10085, 10078, 11823, 11843, 6309,
                 9473, 9571, 10879, 7581, 8180, 7483)
_NOISE_STDS = (378, 1064, 493, 582, 688, 593, 474, 697, 475, 688, 421, 455)
_SPEECH_STDS = (555, 505, 567, 524, 585, 1231, 509, 828, 492, 1540, 1079, 850)
_MAX_SPEECH_FRAMES = 6
_MIN_STD = 384

# per-mode {over_hang_max_1, over_hang_max_2, individual, total} x 3 frame
# lengths (10/20/30 ms)
_MODE_PARAMS = {
    0: ((8, 4, 3), (14, 7, 5), (24, 21, 24), (57, 48, 57)),
    1: ((8, 4, 3), (14, 7, 5), (37, 32, 37), (100, 80, 100)),
    2: ((6, 3, 2), (9, 5, 3), (82, 78, 82), (285, 260, 285)),
    3: ((6, 3, 2), (9, 5, 3), (94, 94, 94), (1100, 1050, 1100)),
}

# split-filter all-pass coefficients (upper 0.64, lower 0.17)
_ALLPASS_Q15 = (20972, 5571)
_ALLPASS_Q13 = (5243, 1392)
_SMOOTH_DOWN = 6553   # 0.2 Q15
_SMOOTH_UP = 32439    # 0.99 Q15
_HP_ZERO = (6631, -13262, 6631)   # Q14
_HP_POLE = (16384, -7756, 5620)   # Q14
_LOG_CONST = 24660        # 160*log10(2) Q9
_LOG_INT_PART = 14336     # 14 in Q10
_ENERGY_OFFSET = (368, 368, 272, 176, 176, 176)
_COMP_VAR = 22005
_LOG2_EXP = 5909          # log2(e) Q12

# by-2 resampler all-pass coefficients (lower row used by decimators)
_RS_ALLPASS = ((821, 6110, 12382), (3050, 9368, 15063))
_COEF_48_32 = ((778, -2050, 1087, 23285, 12903, -3783, 441, 222),
               (222, 441, -3783, 12903, 23285, 1087, -2050, 778))


def _w16(x: int) -> int:
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def _w32(x: int) -> int:
    return ((int(x) + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _sat16(x: int) -> int:
    return 0x7FFF if x > 0x7FFF else (-0x8000 if x < -0x8000 else int(x))


def _div(num: int, den: int) -> int:
    """C integer division (truncate toward zero); den==0 -> INT32_MAX."""
    if den == 0:
        return 0x7FFFFFFF
    q = abs(num) // abs(den)
    return -q if (num < 0) != (den < 0) else q


def _norm_w32(a: int) -> int:
    if a == 0:
        return 0
    v = a if a > 0 else ~a & 0xFFFFFFFF
    return 31 - v.bit_length()


def _norm_u32(a: int) -> int:
    if a == 0:
        return 0
    return 32 - a.bit_length()


def _energy(vec) -> tuple[int, int]:
    """(energy, scale): sum of (x*x >> scale) with wrapping int32 sum,
    scale chosen so one squared max sample times len fits 32 bits."""
    n = len(vec)
    nbits = int(n).bit_length()
    smax = -1
    for v in vec:
        sabs = v if v > 0 else _w16(-v)
        if sabs > smax:
            smax = sabs
    if smax == 0:
        scale = 0
    else:
        t = _norm_w32(_w32(smax * smax))
        scale = 0 if t > nbits else nbits - t
    en = 0
    for v in vec:
        en = _w32(en + ((v * v) >> scale))
    return en, scale


class VadCore:
    """State + per-frame decision of the fixed-point GMM VAD."""

    def __init__(self, mode: int = 0):
        self.noise_means = list(_NOISE_MEANS)
        self.speech_means = list(_SPEECH_MEANS)
        self.noise_stds = list(_NOISE_STDS)
        self.speech_stds = list(_SPEECH_STDS)
        self.frame_counter = 0
        self.over_hang = 0
        self.num_of_speech = 0
        self.low_value_vector = [10000] * (16 * NUM_CHANNELS)
        self.index_vector = [0] * (16 * NUM_CHANNELS)
        self.mean_value = [1600] * NUM_CHANNELS
        self.upper_state = [0] * 5
        self.lower_state = [0] * 5
        self.hp_filter_state = [0] * 4
        self.downsampling_states = [0, 0, 0, 0]  # [0:2]=16->8, [2:4]=32->16
        # 48->8 kHz resampler states
        self.s48_24 = [0] * 8
        self.s24_24 = [0] * 16
        self.s24_16 = [0] * 8
        self.s16_8 = [0] * 8
        self.vad = 1
        self.set_mode(mode)

    def set_mode(self, mode: int):
        if mode not in _MODE_PARAMS:
            raise ValueError(f"Invalid VAD mode {mode}")
        (self.over_hang_max_1, self.over_hang_max_2,
         self.individual, self.total) = _MODE_PARAMS[mode]
        self.mode = mode

    # -- filterbank ----------------------------------------------------

    def _allpass(self, data, coef, state_idx, states):
        """Decimating all-pass over every 2nd input sample; state in
        Q(-1), output Q(-1)."""
        out = []
        state32 = _w32(states[state_idx] * (1 << 16))
        for x in data[::2]:
            tmp16 = _w16((state32 + coef * x) >> 16)
            out.append(tmp16)
            state32 = _w32(_w32(x * (1 << 14)) - coef * tmp16)
            state32 = _w32(state32 * 2)
        states[state_idx] = _w16(state32 >> 16)
        return out

    def _split(self, data, band):
        """One QMF split+decimate stage -> (high band, low band)."""
        hp = self._allpass(data, _ALLPASS_Q15[0], band, self.upper_state)
        lp = self._allpass(data[1:], _ALLPASS_Q15[1], band, self.lower_state)
        h2, l2 = [], []
        for a, b in zip(hp, lp):
            h2.append(_w16(a - b))
            l2.append(_w16(b + a))
        return h2, l2

    def _highpass(self, data):
        st = self.hp_filter_state
        out = []
        for x in data:
            tmp32 = _HP_ZERO[0] * x + _HP_ZERO[1] * st[0] + _HP_ZERO[2] * st[1]
            st[1] = st[0]
            st[0] = x
            tmp32 -= _HP_POLE[1] * st[2] + _HP_POLE[2] * st[3]
            st[3] = st[2]
            st[2] = _w16(_w32(tmp32) >> 14)
            out.append(st[2])
        return out

    def _log_energy(self, data, offset, total_energy):
        """10*log10(energy) in Q4 (+offset); returns (log_e, total_e)."""
        en, tot_rshifts = _energy(data)
        energy = en & 0xFFFFFFFF  # uint32 view
        if energy == 0:
            return offset, total_energy
        norm = 17 - _norm_u32(energy)
        tot_rshifts += norm
        energy = energy << -norm if norm < 0 else energy >> norm
        log2_energy = _LOG_INT_PART + ((energy & 0x00003FFF) >> 4)
        log_e = _w16(((_LOG_CONST * log2_energy) >> 19)
                     + ((tot_rshifts * _LOG_CONST) >> 9))
        if log_e < 0:
            log_e = 0
        log_e = _w16(log_e + offset)
        if total_energy <= MIN_ENERGY:
            if tot_rshifts >= 0:
                total_energy = _w16(total_energy + MIN_ENERGY + 1)
            else:
                total_energy = _w16(total_energy + (energy >> -tot_rshifts))
        return log_e, total_energy

    def calculate_features(self, frame):
        """8 kHz int16 frame (80/160/240 samples) -> (features[6],
        total_power), band edges 80-250-500-1000-2000-3000-4000 Hz."""
        feats = [0] * NUM_CHANNELS
        total = 0
        hp_4k, lp_2k = self._split(frame, 0)          # split at 2 kHz
        hp_3k4, lp_2k3 = self._split(hp_4k, 1)        # 2-4 kHz at 3 kHz
        feats[5], total = self._log_energy(hp_3k4, _ENERGY_OFFSET[5], total)
        feats[4], total = self._log_energy(lp_2k3, _ENERGY_OFFSET[4], total)
        hp_1k2, lp_1k = self._split(lp_2k, 2)         # 0-2 kHz at 1 kHz
        feats[3], total = self._log_energy(hp_1k2, _ENERGY_OFFSET[3], total)
        hp_500_1k, lp_500 = self._split(lp_1k, 3)     # 0-1 kHz at 500 Hz
        feats[2], total = self._log_energy(hp_500_1k, _ENERGY_OFFSET[2], total)
        hp_250_500, lp_250 = self._split(lp_500, 4)   # 0-500 Hz at 250 Hz
        feats[1], total = self._log_energy(hp_250_500, _ENERGY_OFFSET[1], total)
        band_80_250 = self._highpass(lp_250)          # remove 0-80 Hz
        feats[0], total = self._log_energy(band_80_250, _ENERGY_OFFSET[0], total)
        return feats, total

    # -- Gaussian model ------------------------------------------------

    @staticmethod
    def _gaussian(x, mean, std):
        """P(x) of N(mean, std) in Q20 and delta=(x-m)/s^2 in Q11."""
        inv_std = _w16(_div(131072 + (std >> 1), std))      # Q10
        t = inv_std >> 2
        inv_std2 = _w16((t * t) >> 2)                       # Q14
        xm = _w16(x << 3)                                   # Q4 -> Q7
        xm = _w16(xm - mean)                                # Q7
        delta = _w16((inv_std2 * xm) >> 10)                 # Q11
        expo = _w32(delta * xm) >> 9                        # Q10
        exp_value = 0
        if expo < _COMP_VAR:
            t = _w16(-((_LOG2_EXP * expo) >> 12))
            exp_value = 0x0400 | (t & 0x03FF)
            t = _w16(t ^ 0xFFFF)
            t >>= 10
            t = _w16(t + 1)
            exp_value >>= t
        return _w32(inv_std * exp_value), delta

    def _find_minimum(self, value, channel):
        """Track the 16 smallest feature values of the last 100 frames;
        return the smoothed median of the 5 smallest (Q4)."""
        offset = channel << 4
        age = self.index_vector
        small = self.low_value_vector
        for i in range(16):
            if age[offset + i] != 100:
                age[offset + i] += 1
            else:
                for j in range(i, 15):
                    small[offset + j] = small[offset + j + 1]
                    age[offset + j] = age[offset + j + 1]
                age[offset + 15] = 101
                small[offset + 15] = 10000
        # binary insertion position among the 16 smallest
        position = -1
        if value < small[offset + 7]:
            lo, hi = 0, 8
        elif value < small[offset + 15]:
            lo, hi = 8, 16
        else:
            lo = hi = -1
        if lo >= 0:
            position = hi - 1
            for i in range(lo, hi):
                if value < small[offset + i]:
                    position = i
                    break
        if position > -1:
            for i in range(15, position, -1):
                small[offset + i] = small[offset + i - 1]
                age[offset + i] = age[offset + i - 1]
            small[offset + position] = value
            age[offset + position] = 1
        if self.frame_counter > 2:
            current_median = small[offset + 2]
        elif self.frame_counter > 0:
            current_median = small[offset]
        else:
            current_median = 1600
        alpha = 0
        if self.frame_counter > 0:
            alpha = (_SMOOTH_DOWN if current_median < self.mean_value[channel]
                     else _SMOOTH_UP)
        tmp32 = _w32((alpha + 1) * self.mean_value[channel])
        tmp32 = _w32(tmp32 + (0x7FFF - alpha) * current_median + 16384)
        self.mean_value[channel] = _w16(tmp32 >> 15)
        return self.mean_value[channel]

    @staticmethod
    def _weighted_average(data, base, offset, weights):
        """Offset both gaussians of a channel and return the weighted sum
        (mutates data like the reference's WeightedAverage)."""
        avg = 0
        for k in range(NUM_GAUSSIANS):
            i = base + k * NUM_CHANNELS
            data[i] = _w16(data[i] + offset)
            avg = _w32(avg + data[i] * weights[i])
        return avg

    def gmm_decide(self, features, total_power, frame_length):
        """Local+global LRT over the 6 bands, then model adaptation.
        Returns the raw vadflag (0 noise, >=1 speech)."""
        fl_idx = 0 if frame_length == 80 else (1 if frame_length == 160 else 2)
        overhead1 = self.over_hang_max_1[fl_idx]
        overhead2 = self.over_hang_max_2[fl_idx]
        individual_test = self.individual[fl_idx]
        total_test = self.total[fl_idx]
        vadflag = 0
        if total_power > MIN_ENERGY:
            delta_n = [0] * TABLE_SIZE
            delta_s = [0] * TABLE_SIZE
            ngprvec = [0] * TABLE_SIZE
            sgprvec = [0] * TABLE_SIZE
            sum_llr = 0
            noise_prob = [0, 0]
            speech_prob = [0, 0]
            for ch in range(NUM_CHANNELS):
                h0_test = 0
                h1_test = 0
                for k in range(NUM_GAUSSIANS):
                    g = ch + k * NUM_CHANNELS
                    p, delta_n[g] = self._gaussian(
                        features[ch], self.noise_means[g], self.noise_stds[g])
                    noise_prob[k] = _w32(_NOISE_WEIGHTS[g] * p)
                    h0_test = _w32(h0_test + noise_prob[k])
                    p, delta_s[g] = self._gaussian(
                        features[ch], self.speech_means[g], self.speech_stds[g])
                    speech_prob[k] = _w32(_SPEECH_WEIGHTS[g] * p)
                    h1_test = _w32(h1_test + speech_prob[k])
                # log2 LR ~ difference of normalization shifts
                shifts_h0 = 31 if h0_test == 0 else _norm_w32(h0_test)
                shifts_h1 = 31 if h1_test == 0 else _norm_w32(h1_test)
                llr = shifts_h0 - shifts_h1
                sum_llr += llr * _SPECTRUM_WEIGHT[ch]
                if llr * 4 > individual_test:
                    vadflag = 1
                h0 = _w16(h0_test >> 12)
                if h0 > 0:
                    t = _w32((noise_prob[0] & 0xFFFFF000) << 2)
                    ngprvec[ch] = _w16(_div(t, h0))
                    ngprvec[ch + NUM_CHANNELS] = 16384 - ngprvec[ch]
                else:
                    ngprvec[ch] = 16384
                h1 = _w16(h1_test >> 12)
                if h1 > 0:
                    t = _w32((speech_prob[0] & 0xFFFFF000) << 2)
                    sgprvec[ch] = _w16(_div(t, h1))
                    sgprvec[ch + NUM_CHANNELS] = 16384 - sgprvec[ch]
            if sum_llr >= total_test:
                vadflag |= 1

            # adapt the models
            maxspe = 12800
            for ch in range(NUM_CHANNELS):
                feature_minimum = self._find_minimum(features[ch], ch)
                noise_global = self._weighted_average(
                    self.noise_means, ch, 0, _NOISE_WEIGHTS)
                ngm_q8 = _w16(noise_global >> 6)
                for k in range(NUM_GAUSSIANS):
                    g = ch + k * NUM_CHANNELS
                    nmk = self.noise_means[g]
                    smk = self.speech_means[g]
                    nsk = self.noise_stds[g]
                    ssk = self.speech_stds[g]
                    nmk2 = nmk
                    if not vadflag:
                        delt = _w16((ngprvec[g] * delta_n[g]) >> 11)
                        nmk2 = _w16(nmk + _w16((delt * _NOISE_UPDATE) >> 22))
                    # long-term correction toward the tracked minimum
                    ndelt = _w16((feature_minimum << 4) - ngm_q8)
                    nmk3 = _w16(nmk2 + _w16((ndelt * _BACK_ETA) >> 9))
                    lo = _w16((k + 5) << 7)
                    hi = _w16((72 + k - ch) << 7)
                    nmk3 = lo if nmk3 < lo else (hi if nmk3 > hi else nmk3)
                    self.noise_means[g] = nmk3
                    if vadflag:
                        delt = _w16((sgprvec[g] * delta_s[g]) >> 11)
                        t16 = _w16((delt * _SPEECH_UPDATE) >> 21)
                        smk2 = _w16(smk + ((t16 + 1) >> 1))
                        maxmu = maxspe + 640
                        if smk2 < _MIN_MEAN[k]:
                            smk2 = _MIN_MEAN[k]
                        if smk2 > maxmu:
                            smk2 = maxmu
                        self.speech_means[g] = smk2
                        # speech std update
                        t16 = (smk + 4) >> 3
                        t16 = _w16(features[ch] - t16)
                        t32 = _w32(delta_s[g] * t16) >> 3
                        t32 = _w32(t32 - 4096)
                        t16 = sgprvec[g] >> 2
                        t32 = _w32(t16 * t32)
                        t32 = t32 >> 4
                        den = _w16(ssk * 10)  # int16_t parameter truncation
                        if t32 > 0:
                            t16 = _w16(_div(t32, den))
                        else:
                            t16 = _w16(-_div(-t32, den))
                        t16 = _w16(t16 + 128)
                        ssk = _w16(ssk + (t16 >> 8))
                        if ssk < _MIN_STD:
                            ssk = _MIN_STD
                        self.speech_stds[g] = ssk
                    else:
                        # noise std update
                        t16 = _w16(features[ch] - (nmk >> 3))
                        t32 = _w32(delta_n[g] * t16) >> 3
                        t32 = _w32(t32 - 4096)
                        t16 = (ngprvec[g] + 2) >> 2
                        t32 = _w32(t16 * t32)
                        t32 = t32 >> 14
                        if t32 > 0:
                            t16 = _w16(_div(t32, nsk))
                        else:
                            t16 = _w16(-_div(-t32, nsk))
                        t16 = _w16(t16 + 32)
                        nsk = _w16(nsk + (t16 >> 6))
                        if nsk < _MIN_STD:
                            nsk = _MIN_STD
                        self.noise_stds[g] = nsk
                # keep the models separated
                noise_global = self._weighted_average(
                    self.noise_means, ch, 0, _NOISE_WEIGHTS)
                speech_global = self._weighted_average(
                    self.speech_means, ch, 0, _SPEECH_WEIGHTS)
                diff = _w16(_w16(speech_global >> 9) - _w16(noise_global >> 9))
                if diff < _MIN_DIFF[ch]:
                    t16 = _w16(_MIN_DIFF[ch] - diff)
                    up = _w16((13 * t16) >> 2)    # ~0.8 to speech
                    down = _w16((3 * t16) >> 2)   # ~0.2 to noise
                    speech_global = self._weighted_average(
                        self.speech_means, ch, up, _SPEECH_WEIGHTS)
                    noise_global = self._weighted_average(
                        self.noise_means, ch, _w16(-down), _NOISE_WEIGHTS)
                maxspe = _MAX_SPEECH[ch]
                t16 = _w16(speech_global >> 7)
                if t16 > maxspe:
                    t16 = _w16(t16 - maxspe)
                    for k in range(NUM_GAUSSIANS):
                        g = ch + k * NUM_CHANNELS
                        self.speech_means[g] = _w16(self.speech_means[g] - t16)
                t16 = _w16(noise_global >> 7)
                if t16 > _MAX_NOISE[ch]:
                    t16 = _w16(t16 - _MAX_NOISE[ch])
                    for k in range(NUM_GAUSSIANS):
                        g = ch + k * NUM_CHANNELS
                        self.noise_means[g] = _w16(self.noise_means[g] - t16)
            self.frame_counter += 1

        # hangover smoothing
        if not vadflag:
            if self.over_hang > 0:
                vadflag = 2 + self.over_hang
                self.over_hang -= 1
            self.num_of_speech = 0
        else:
            self.num_of_speech += 1
            if self.num_of_speech > _MAX_SPEECH_FRAMES:
                self.num_of_speech = _MAX_SPEECH_FRAMES
                self.over_hang = overhead2
            else:
                self.over_hang = overhead1
        return vadflag

    # -- rate conversion -----------------------------------------------

    def _down_by_2(self, signal, state_base):
        """Decimate by 2 with a 2-branch all-pass pair (Q13 coeffs);
        int32 filter state, int16 in/out."""
        st = self.downsampling_states
        s1 = st[state_base]
        s2 = st[state_base + 1]
        out = []
        for n in range(len(signal) >> 1):
            x0 = signal[2 * n]
            x1 = signal[2 * n + 1]
            t1 = _w16((s1 >> 1) + ((_ALLPASS_Q13[0] * x0) >> 14))
            s1 = _w32(x0 - ((_ALLPASS_Q13[0] * t1) >> 12))
            t2 = _w16((s2 >> 1) + ((_ALLPASS_Q13[1] * x1) >> 14))
            s2 = _w32(x1 - ((_ALLPASS_Q13[1] * t2) >> 12))
            out.append(_w16(t1 + t2))
        st[state_base] = s1
        st[state_base + 1] = s2
        return out

    @staticmethod
    def _allpass3(x, st, base, coefs):
        """Three cascaded first-order all-pass sections on int32 samples
        (the building block of the by-2 resamplers): section 1 rounds the
        Q14 scale-down, sections 2-3 truncate toward zero.  Returns the
        section-3 output (also left in st[base+3])."""
        diff = _w32(x - st[base + 1])
        diff = _w32(diff + (1 << 13)) >> 14
        t1 = _w32(st[base] + diff * coefs[0])
        st[base] = x
        diff = _w32(t1 - st[base + 2])
        diff = diff >> 14
        if diff < 0:
            diff += 1
        t0 = _w32(st[base + 1] + diff * coefs[1])
        st[base + 1] = t1
        diff = _w32(t0 - st[base + 3])
        diff = diff >> 14
        if diff < 0:
            diff += 1
        st[base + 3] = _w32(st[base + 2] + diff * coefs[2])
        st[base + 2] = t0
        return st[base + 3]

    def _down_shortint(self, frame):
        """48->24: int16 input -> int32 (Q15 + 16384 offset) output."""
        st = self.s48_24
        half = len(frame) >> 1
        out = [0] * half
        for i in range(half):  # lower branch: even samples
            x = _w32((frame[2 * i] << 15) + (1 << 14))
            out[i] = self._allpass3(x, st, 0, _RS_ALLPASS[1]) >> 1
        for i in range(half):  # upper branch: odd samples
            x = _w32((frame[2 * i + 1] << 15) + (1 << 14))
            out[i] = _w32(out[i] + (self._allpass3(x, st, 4, _RS_ALLPASS[0]) >> 1))
        return out

    def _lp_by2_int(self, data):
        """24->24 kHz low-pass (phase-split all-pass average), int32
        Q15+offset in/out of half length... operates in-place semantics
        of the reference LPBy2IntToInt."""
        st = self.s24_24
        half = len(data) >> 1
        even = [0] * half
        odd = [0] * half
        # lower all-pass: odd input -> even output, one sample of
        # polyphase delay carried in st[12] (shared with the 4th branch,
        # which rewrites it after this loop reads it -- same order as the
        # reference)
        tmp0 = st[12]
        for i in range(half):
            even[i] = self._allpass3(tmp0, st, 0, _RS_ALLPASS[1]) >> 1
            tmp0 = data[2 * i + 1]
        # upper all-pass: even input -> even output; average the branches
        for i in range(half):
            up = self._allpass3(data[2 * i], st, 4, _RS_ALLPASS[0]) >> 1
            even[i] = _w32(even[i] + up) >> 15
        # lower all-pass: even input -> odd output
        for i in range(half):
            odd[i] = self._allpass3(data[2 * i], st, 8, _RS_ALLPASS[1]) >> 1
        # upper all-pass: odd input -> odd output
        for i in range(half):
            up = self._allpass3(data[2 * i + 1], st, 12, _RS_ALLPASS[0]) >> 1
            odd[i] = _w32(odd[i] + up) >> 15
        out = [0] * (2 * half)
        out[0::2] = even
        out[1::2] = odd
        return out

    @staticmethod
    def _resample_3to2(data, state):
        """48->32 kHz fractional resampler on int32 samples; `state`
        provides the 8 history samples (updated by caller)."""
        buf = state + data
        K = len(data) // 3
        out = []
        for m in range(K):
            b = buf[3 * m:3 * m + 9]
            for row in range(2):
                tmp = 1 << 14
                for j in range(8):
                    tmp = _w32(tmp + _COEF_48_32[row][j] * b[row + j])
                out.append(tmp)
        return out

    def _down_intshort(self, data, state):
        """16->8: int32 (Q15+offset) input -> saturated int16 output."""
        half = len(data) >> 1
        low = [self._allpass3(data[2 * i], state, 0, _RS_ALLPASS[1]) >> 1
               for i in range(half)]
        high = [self._allpass3(data[2 * i + 1], state, 4, _RS_ALLPASS[0]) >> 1
                for i in range(half)]
        return [_sat16(_w32(lo + hi) >> 15) for lo, hi in zip(low, high)]

    def _resample_48_to_8(self, frame480):
        """One 10 ms block: 480 samples at 48 kHz -> 80 at 8 kHz."""
        s24 = self._down_shortint(frame480)           # 240 @24k, int32
        s24lp = self._lp_by2_int(s24)                 # 240 @24k low-passed
        hist = list(self.s24_16)
        self.s24_16 = list(s24lp[-8:])
        s16 = self._resample_3to2(s24lp, hist)        # 160 @16k
        return self._down_intshort(s16, self.s16_8)   # 80 @8k int16

    # -- public per-frame entry -----------------------------------------

    def process(self, rate: int, frame) -> int:
        """Classify one int16 frame at 8/16/32/48 kHz; returns 0/1."""
        frame = [int(v) for v in frame]
        if rate == 48000:
            # Quirk preserved from the reference's CalcVad48khz: the
            # input pointer is never advanced, so every 10 ms block
            # resamples the same first 480 samples of the frame.
            nb = []
            for _ in range(len(frame) // 480):
                nb.extend(self._resample_48_to_8(frame[:480]))
        elif rate == 32000:
            wb = self._down_by_2(frame, 2)
            nb = self._down_by_2(wb, 0)
        elif rate == 16000:
            nb = self._down_by_2(frame, 0)
        elif rate == 8000:
            nb = frame
        else:
            raise ValueError(f"Unsupported rate {rate}")
        feats, total = self.calculate_features(nb)
        self.vad = self.gmm_decide(feats, total, len(nb))
        return 1 if self.vad > 0 else 0


VALID_RATES = (8000, 16000, 32000, 48000)


def valid_rate_and_frame_length(rate: int, frame_length: int) -> bool:
    """WebRtcVad_ValidRateAndFrameLength: 10/20/30 ms at a valid rate."""
    if rate not in VALID_RATES:
        return False
    return frame_length in tuple(rate // 1000 * ms for ms in (10, 20, 30))
