"""The port's device front end (plain PyTorch, float64, on the CPU)
against the JAX package's Frontend and the C reference's MFCC: cepstra,
float64 log spectra, the chunked form with its carried state, and the
spectrogram.  Every comparison is exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_synth import austen_audio

from soundswallower_tpu.fe.frontend import Frontend as JaxFrontend
from soundswallower_tpu_torch.fe import frontend as fm
from soundswallower_tpu_torch.fe.frontend import Frontend

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the synthetic model's (and the en-us model's) front end at 8 kHz
SYNTH = dict(sampling_rate=8000, num_filters=20, lower_filt_freq=130,
             upper_filt_freq=3700, transform="dct", lifter_val=22,
             remove_noise=True)


def _pair(**kw):
    return Frontend(**kw), JaxFrontend(**kw)


def _seeded(n, seed, scale=3000.0):
    rng = np.random.RandomState(seed)
    return np.clip(np.round(rng.randn(n) * scale), -32768, 32767) \
        .astype(np.int16)


def test_mfcc_austen_equals_reference_and_c_golden():
    port, ref = _pair(**SYNTH)
    audio = np.fromfile(os.path.join(GOLDEN, "austen.raw"), np.int16)
    gold = np.fromfile(os.path.join(GOLDEN, "austen-en", "mfcc.f32"),
                       np.float32).reshape(-1, 13)
    got = port.process_int16(audio, device="cpu")
    assert got.shape == gold.shape
    assert np.array_equal(got, gold)
    assert np.array_equal(got, ref.process_int16(audio))


@pytest.mark.parametrize("transform", ["legacy", "dct"])
@pytest.mark.parametrize("noise", [False, True])
def test_16k_nfft512_mfcc_and_logspec(transform, noise):
    """16 kHz, nfft 512, 40 filters: cepstra and the float64 log spectra
    of seeded audio, over every padded frame the JAX program returns."""
    port, ref = _pair(sampling_rate=16000, fft_size=512, num_filters=40,
                      transform=transform, remove_noise=noise,
                      lifter_val=22 if transform == "dct" else 0)
    a = _seeded(16000 + 333, 11)
    x = a.astype(np.float32)
    n, T = len(a), port.n_frames(len(a)) + 5
    got = port.mfcc(torch.from_numpy(x), n, T).numpy()
    assert np.array_equal(got, np.asarray(ref.mfcc(jnp.asarray(x), n, T)))
    ls = port.logspec_chunk(torch.from_numpy(x), n, T).numpy()
    assert ls.dtype == np.float64
    assert np.array_equal(ls, np.asarray(ref.logspec_chunk(jnp.asarray(x),
                                                           n, T)))


def test_batch_rows_equal_single_rows():
    """One [B, N] launch with per-row lengths (int16 input, the batch
    route's form) equals each row on its own."""
    port, ref = _pair(**SYNTH)
    rows = [austen_audio(i)[:6000 - 700 * i] for i in range(3)]
    N = max(len(r) for r in rows)
    buf = np.zeros((3, N), np.int16)
    for i, r in enumerate(rows):
        buf[i, :len(r)] = r
    ns = torch.tensor([len(r) for r in rows], dtype=torch.int32)
    T = port.n_frames(N)
    cep = port.mfcc(torch.from_numpy(buf), ns, T).numpy()
    for i, r in enumerate(rows):
        want = np.asarray(ref.mfcc(jnp.asarray(buf[i].astype(np.float32)),
                                   len(r), T))
        assert np.array_equal(cep[i], want)


def _feed(fe, audio, split, mod):
    """The stream's front-end loop (AlignStream._fe_frames): push
    `split` samples at a time, run every complete frame, carry the prior
    and the noise state; returns the cepstra of each call and the state
    after each call."""
    shift, size = fe.frame_shift, fe.frame_size
    raw = np.zeros(0, np.int16)
    prior = np.float32(0.0)
    noise = fe.noise_init(device="cpu") if mod == "port" else fe.noise_init()
    ceps, states = [], []
    for i0 in range(0, len(audio), split):
        raw = np.concatenate([raw, audio[i0:i0 + split]])
        count = 1 + (len(raw) - size) // shift if len(raw) >= size else 0
        if count <= 0:
            continue
        seg = raw[: (count - 1) * shift + size]
        Tpad = max(32, -(-count // 32) * 32)
        segp = np.zeros(max(2048, -(-len(seg) // 2048) * 2048), np.float32)
        segp[:len(seg)] = seg
        if mod == "port":
            cep, noise = fe.mfcc_chunk(torch.from_numpy(segp), len(seg), Tpad,
                                       float(prior), noise, count)
            cep = cep.numpy()
            st = [x.numpy() for x in noise]
        else:
            cep, noise = fe.mfcc_chunk(jnp.asarray(segp), len(seg), Tpad,
                                       jnp.float32(prior), noise,
                                       jnp.int32(count))
            st = [np.asarray(x) for x in noise]
        ceps.append(np.asarray(cep)[:count])
        prior = np.float32(raw[count * shift - 1])
        raw = raw[count * shift:]
        states.append((prior, st))
    return ceps, states


@pytest.mark.parametrize("split", [1, 777, 1600])
def test_mfcc_chunk_carry_equals_reference(split):
    """Chunked MFCC with the prior and the noise carry handed from call
    to call: cepstra and carried state after every call."""
    port, ref = _pair(**SYNTH)
    audio = austen_audio(1)[:4000 if split == 1 else 12000]
    pc, ps = _feed(port, audio, split, "port")
    rc, rs = _feed(ref, audio, split, "ref")
    assert len(pc) == len(rc) > 0
    for a, b in zip(pc, rc):
        assert np.array_equal(a, b)
    for (pa, sa), (pb, sb) in zip(ps, rs):
        assert pa == pb
        for x, y in zip(sa, sb):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)


@pytest.mark.parametrize("smooth", [False, True])
def test_spectrogram_equals_reference(smooth):
    port, ref = _pair(**SYNTH)
    a = austen_audio(4)
    assert np.array_equal(port.spectrogram(a, smooth, device="cpu"),
                          ref.spectrogram(a, smooth))


def test_fma_plain_is_exactly_rounded():
    """fma_plain against exact rational arithmetic on random doubles."""
    from fractions import Fraction

    rng = np.random.RandomState(5)
    a = rng.randn(2000) * np.exp2(rng.randint(-30, 30, 2000))
    b = rng.randn(2000) * np.exp2(rng.randint(-30, 30, 2000))
    c = -a * b * (1 + rng.randn(2000) * 1e-9)           # heavy cancellation
    got = fm.fma_plain(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        assert r == float(Fraction(x) * Fraction(y) + Fraction(z))


def test_remove_dc_raises():
    """The host C++ MFCC still refuses remove_dc (its frame mean sums in
    another order than the JAX program), as the JAX package's loader
    does, so such a configuration takes the device front end, which now
    runs it (tests/test_torch_remove_dc.py)."""
    from soundswallower_tpu.fe.native_fe import NativeFrontend as JaxNative
    from soundswallower_tpu_torch.fe.native_fe import NativeFrontend

    fe, jfe = _pair(remove_dc=True)
    assert NativeFrontend.load(fe) is None
    assert JaxNative.load(jfe) is None
    fe.check_supported()
