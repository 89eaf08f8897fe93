"""remove_dc (the frame mean subtracted before the window) on the
device front end against the JAX package, bit-equal on the CPU: the
frame sum in the order of XLA's tree reduction, the float64 log spectra
at several sample rates, and TorchAligner(remove_dc=True) against
TpuAligner(remove_dc=True) through spectrogram, align and align_batch
(the host C++ MFCC refuses remove_dc in both packages, so both take the
device front end)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, TEXT, austen_audio, model_dir, segs_rep

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.fe.frontend import Frontend as JaxFrontend
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.fe import frontend as fm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = model_dir(tmp_path_factory, "small")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu",
                        remove_dc=True)
    ref = TpuAligner(hmm=d, samprate=SAMPRATE, remove_dc=True)
    assert port.native_fe is None and ref.native_fe is None
    assert port.fe.remove_dc and ref.fe.remove_dc
    return port, ref


def _offset(a: np.ndarray, dc: int = 3000) -> np.ndarray:
    """The audio with a DC offset, so that the mean matters."""
    return np.clip(a.astype(np.int32) + dc, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("n", [7, 32, 205, 410, 1230])
def test_frame_sum_is_xlas_tree(n):
    """frame_sum_plain against the reduction jnp.sum compiles to inside
    a jitted float64 program whose axis is a frame (XLA's tree rewrite
    above 32 values), on values whose sum depends on the order."""
    rng = np.random.RandomState(n)
    x = (rng.randn(64, n) * np.exp(rng.randn(64, n) * 6)).astype(np.float64)
    f = jax.jit(lambda v: jnp.sum(v * 1.0, axis=-1))
    want = np.asarray(f(jnp.asarray(x)))
    assert np.array_equal(fm.frame_sum_plain(torch.from_numpy(x)).numpy(),
                          want)


@pytest.mark.parametrize("rate", [8000, 16000, 48000])
def test_remove_dc_log_spectra_equal_jax(rate):
    """Frontend(remove_dc=True).logspec_chunk, float64 log spectra, bit
    for bit (205, 410 and 1,230 samples a frame: one, and two levels of
    the tree)."""
    kw = dict(sampling_rate=rate, remove_dc=True)
    fe, jfe = fm.Frontend(**kw), JaxFrontend(**kw)
    a = _offset(austen_audio(0))[:3 * rate]
    n = len(a)
    T = fe.n_frames(n)
    want = np.asarray(jfe.logspec_chunk(jnp.asarray(a.astype(np.float32)),
                                        n, T))
    got = fe.logspec_chunk(torch.from_numpy(a.astype(np.float32)), n,
                           T).numpy()
    assert np.array_equal(got, want)
    plain = fm.Frontend(sampling_rate=rate).logspec_chunk(
        torch.from_numpy(a.astype(np.float32)), n, T).numpy()
    assert not np.array_equal(plain, want)      # remove_dc changed them


def test_remove_dc_aligner_equals_reference(pair):
    port, ref = pair
    a = _offset(austen_audio(1))
    got = port.spectrogram(a)
    assert got.dtype == np.float32 and np.array_equal(got, ref.spectrogram(a))
    assert np.array_equal(port.spectrogram(a, smooth=True),
                          ref.spectrogram(a, smooth=True))
    assert segs_rep(port.align(a, TEXT)) == segs_rep(ref.align(a, TEXT))
    audios = [_offset(austen_audio(i), 1000 * i) for i in range(4)]
    want = [segs_rep(s) for s in ref.align_batch(audios, [TEXT] * 4)]
    assert [segs_rep(s) for s in port.align_batch(audios, [TEXT] * 4)] \
        == want
