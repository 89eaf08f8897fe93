"""K9's plain version (the port's two-phase ``fe_noise_plain``: the
recurrence over the frames yielding gains, then the smoothing across
filters over all frames) against the JAX package's
``Frontend._remove_noise_scan`` on the CPU, bit for bit: the plain and
the masked scan, from a fresh and from a carried state, at 20 and 40
filters, over frame counts that are not a multiple of K9's tile."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from soundswallower_tpu.fe.frontend import Frontend as JaxFrontend
from soundswallower_tpu_torch.fe import frontend as fm
from soundswallower_tpu_torch.fe.frontend import Frontend

torch.set_num_threads(1)


def _mfspec(rng, T, nf):
    """Mel energies over several decades, with silent (zero) frames and
    a loud burst, as a front end's mel spectra span."""
    x = np.exp(rng.randn(T, nf) * 2.5 + 9.0)
    x[rng.rand(T) < 0.05] = 0.0
    x[T // 3: T // 3 + 3] *= 1e4
    return x


def _jax_scan(ref, mfspec, init, valid):
    """The JAX scan compiled as its jitted program compiles it."""
    if valid is None:
        return jax.jit(ref._remove_noise_scan)(jnp.asarray(mfspec), init)
    return jax.jit(ref._remove_noise_scan)(jnp.asarray(mfspec), init,
                                           jnp.asarray(valid))


@pytest.mark.parametrize("nf", [20, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_two_phase_plain_equals_jax_scan(nf, masked):
    """Three calls on each row, the carry handed from one to the next
    (the first from a fresh state), T of 1, 45 and 70 frames (32 is the
    tile); the masked scan stops each row's carry at its own count.  The
    carry after a row's first frame is compared before later frames can
    round its floor's last bit away."""
    fe = Frontend(sampling_rate=16000 if nf == 40 else 8000, num_filters=nf,
                  remove_noise=True, fft_size=512 if nf == 40 else 256,
                  lower_filt_freq=130, upper_filt_freq=3700)
    ref = JaxFrontend(sampling_rate=fe.sampling_rate, num_filters=nf,
                      remove_noise=True, fft_size=fe.fft_size,
                      lower_filt_freq=130, upper_filt_freq=3700)
    rng = np.random.RandomState(nf + masked)
    B = 3
    port = fe.noise_init(B, "cpu")
    refs = [ref.noise_init() for _ in range(B)]
    for T in (1, 45, 70):
        spec = np.stack([_mfspec(rng, T, nf) for _ in range(B)])
        n = np.array([T, T // 2, 0], np.int32) if masked else None
        out, port = fm.fe_noise_plain(
            fe, torch.from_numpy(spec), port,
            None if n is None else torch.from_numpy(n))
        for b in range(B):
            valid = None if n is None else np.arange(T) < n[b]
            want, refs[b] = _jax_scan(ref, spec[b], refs[b], valid)
            assert out.dtype == torch.float64
            assert np.array_equal(out[b].numpy(), np.asarray(want))
            for got, exp in zip(port, refs[b]):
                exp = np.asarray(exp)
                assert np.array_equal(got[b].numpy(), exp), (T, b)


def test_two_phase_plain_smooths_every_frame_alike():
    """The smoothing phase over all frames at once equals the scan's
    per-frame smoothing: a frame's output depends only on its own gains,
    so the output of frames [0, T) equals that of the same frames run one
    call per frame with the carry handed on."""
    fe = Frontend(sampling_rate=8000, num_filters=20, remove_noise=True,
                  lower_filt_freq=130, upper_filt_freq=3700)
    rng = np.random.RandomState(7)
    spec = torch.from_numpy(np.stack([_mfspec(rng, 37, 20)
                                      for _ in range(2)]))
    whole, carry_w = fm.fe_noise_plain(fe, spec, fe.noise_init(2, "cpu"),
                                       None)
    carry = fe.noise_init(2, "cpu")
    parts = []
    for t in range(spec.shape[1]):
        o, carry = fm.fe_noise_plain(fe, spec[:, t:t + 1], carry, None)
        parts.append(o)
    assert torch.equal(whole, torch.cat(parts, dim=1))
    for a, b in zip(carry_w, carry):
        assert torch.equal(a, b)
