"""YIN (B11) against the JAX package on the CPU, bit-equal: the port's
plain ``cmnd_batch``/``pitch_batch`` (K14's plain version) and its exact
``Yin``.

Frame sizes 32-4096 cover XLA's plain reduce (ndiff <= 32), one and two
levels of its tree of 32-windows, and its blocked scan of 16 with and
without recursion; frames come from tests/golden/austen.raw.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_synth import austen_audio
from make_torch_synth_golden import REPO

from soundswallower_tpu import yin as jyin
from soundswallower_tpu_torch import yin

torch.set_num_threads(1)

AUSTEN = np.fromfile(os.path.join(REPO, "tests", "golden", "austen.raw"),
                     np.int16)


def _frames(F: int, n: int = 10) -> np.ndarray:
    step = max(160, (len(AUSTEN) - F) // n)
    return np.stack([AUSTEN[p:p + F]
                     for p in range(0, len(AUSTEN) - F, step)])[:n]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _check(frames, got_cmnd, got_pitch, ndiff=None):
    """Port results against the JAX functions on the same frames: CMND
    float32 bits, int64 period, best float32 bits."""
    want = np.asarray(jyin.cmnd_batch(jnp.asarray(frames), ndiff))
    assert got_cmnd.dtype == torch.float32
    assert got_cmnd.shape == want.shape
    assert (_bits(got_cmnd.numpy()) == _bits(want)).all()
    if got_pitch is not None:
        period, best = (np.asarray(v) for v in
                        jyin.pitch_batch(jnp.asarray(frames)))
        assert got_pitch[0].dtype == torch.int64 and period.dtype == np.int64
        assert (got_pitch[0].numpy() == period).all()
        assert got_pitch[1].dtype == torch.float32
        assert (_bits(got_pitch[1].numpy()) == _bits(best)).all()


@pytest.mark.parametrize("F", [32, 64, 200, 400, 1024, 4096])
def test_plain_equals_reference(F):
    """[B, F] and [F] frames, int16: CMND, period and best equal the JAX
    functions' bit for bit."""
    fr = _frames(F, 8 if F < 4096 else 4)
    _check(fr, yin.cmnd_batch(fr, device="cpu"),
           yin.pitch_batch(fr, device="cpu"))
    one = fr[1]
    got = yin.pitch_batch(one, device="cpu")
    assert got[0].shape == () and got[1].shape == ()
    _check(one, yin.cmnd_batch(one, device="cpu"), got)


@pytest.mark.parametrize("ndiff", [70, 100, 150])
def test_lags_past_the_frame_clamp(ndiff):
    """frame_size // 2 < ndiff <= frame_size: lags past the frame read
    its last sample, as the JAX gather clamps them; past frame_size both
    packages refuse the call."""
    fr = _frames(100, 6)
    if ndiff > 100:
        with pytest.raises(ValueError):
            yin.cmnd_batch(fr, ndiff, device="cpu")
        with pytest.raises(TypeError):
            jyin.cmnd_batch(jnp.asarray(fr), ndiff)
        return
    _check(fr, yin.cmnd_batch(fr, ndiff, device="cpu"), None, ndiff)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
def test_other_dtypes(dtype):
    """Any integer or float dtype converts to float32 as the JAX
    program's astype does; torch tensors are taken as well."""
    fr = (_frames(200, 4).astype(np.float64) * 1.37).astype(dtype)
    _check(fr, yin.cmnd_batch(fr, device="cpu"),
           yin.pitch_batch(torch.from_numpy(fr), device="cpu"))


def test_orders_are_xla_s():
    """The tree sum and the blocked scan differ from a plain sequential
    sum and from torch.cumsum on these frames, so the equality above
    holds the orders, not only the values."""
    fr = torch.from_numpy(_frames(400, 8)).float()
    nd = 200
    idx = torch.clamp(torch.arange(nd)[:, None] + torch.arange(nd)[None, :],
                      max=399)
    sq = (fr[:, None, :nd] - fr[:, idx]) ** 2
    d = yin.tree_sum_plain(sq)
    assert not torch.equal(d, yin._seq_sum(sq))
    assert not torch.equal(yin.blocked_cumsum_plain(d), torch.cumsum(d, -1))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fr = _frames(200, 2)
    for call in (lambda: yin.pitch_batch(fr), lambda: yin.cmnd_batch(fr)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _run_yin(mod, frames, smooth):
    pe = mod.Yin(400, 0.1, 0.2, smooth)
    pe.start()
    out = []
    for fr in frames:
        pe.write(fr)
        r = pe.read()
        if r is not None:
            out.append(r)
    pe.end()
    while True:
        r = pe.read()
        if r is None:
            break
        out.append(r)
    return out


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("smooth", [2, 0])
def test_exact_yin_equals_reference(monkeypatch, native, smooth):
    """The exact Yin (native library, and its Python fallback) against
    the JAX package's, on dithered austen frames; cmn_diff_exact too."""
    a = austen_audio(1)
    n = 40 if native else 12
    frames = [a[p:p + 400] for p in range(0, 160 * n, 160)]
    if not native:
        for mod in (yin, jyin):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    elif yin._lib() is None:
        pytest.skip("native yin library not built")
    got = _run_yin(yin, frames, smooth)
    assert got and got == _run_yin(jyin, frames, smooth)
    d = yin.cmn_diff_exact(frames[3], 200)
    assert d.dtype == np.int32
    assert (d == jyin.cmn_diff_exact(frames[3], 200)).all()
    if native:
        assert (d == yin._cmn_diff_py(frames[3], 200)).all()
