"""K1's decomposition on the card (csrc/feat.cu), rendered in numpy and
held bit for bit (uint32 view) against the JAX package.

The fold takes ``rows`` rows a block and passes of ``pass``
frames: a pass is staged (dequantized), frames with c0 < 0 (or NaN) set
to -0.0, the valid frames counted, and each dimension's chain adds the
pass in frame order in groups of 16 padded with -0.0; the mean is the sum
over the count.  The output launch takes tiles of ``tile`` frames and 3
frames each side (row 0 before the start, row min(n, T) - 1 from there
on), subtracts the mean and forms the dynamic features; a row of one
pass is written whole by its fold block (one launch).  The rendering
asserts what the kernels rely on: every frame of a row folded once, in
order, and every read inside the row.
"""

import types

import jax
import numpy as np
import pytest
import torch

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.fe.feat import feats_full_utt
from soundswallower_tpu_torch.fe.feat import feat_plain, feats_plain

torch.set_num_threads(1)

WIN = 3
F32 = np.float32


def dequant(planes: np.ndarray, inv_scale: float) -> np.ndarray:
    """The kernel's Planes load: (int8(hi) * 256 + lo) * inv_scale."""
    v = planes[1].view(np.int8).astype(np.int32) * 256 + planes[0]
    return (v.astype(F32) * F32(inv_scale)).astype(F32)


def fold_rendering(cep: np.ndarray, n: np.ndarray, rows: int,
                   pass_frames: int) -> np.ndarray:
    """feat_fold_kernel: the means [B, ncep], block by block."""
    B, T, ncep = cep.shape
    mean = np.empty((B, ncep), F32)
    for b0 in range(0, B, rows):
        rs = list(range(b0, min(b0 + rows, B)))
        nf = [min(max(int(n[b]), 0), T) for b in rs]
        npass = -(-max(nf) // pass_frames) if max(nf) > 0 else 0
        s = {b: np.zeros(ncep, F32) for b in rs}
        cnt = {b: 0 for b in rs}
        folded = {b: [] for b in rs}
        for p in range(npass):
            for b, f in zip(rs, nf):
                t0 = p * pass_frames
                k = min(pass_frames, f - t0)
                if k <= 0:
                    continue
                assert t0 + k <= T            # inside the row
                buf = cep[b, t0:t0 + k].copy()
                valid = buf[:, 0] >= 0
                buf[~valid] = F32(-0.0)
                cnt[b] += int(valid.sum())
                pad = -(-k // 16) * 16 - k
                buf = np.concatenate([buf, np.full((pad, ncep), -0.0, F32)])
                for row in buf:
                    s[b] = (s[b] + row).astype(F32)
                folded[b].extend(range(t0, t0 + k))
        for b, f in zip(rs, nf):
            assert folded[b] == list(range(f))  # every frame once, in order
            with np.errstate(invalid="ignore", divide="ignore"):
                mean[b] = (s[b] / F32(cnt[b])).astype(F32)
    return mean


def output_rendering(cep: np.ndarray, n: np.ndarray, mean, tile: int):
    """feat_out_kernel: the features [B, T, 3, ncep], tile by tile."""
    B, T, ncep = cep.shape
    out = np.full((B, T, 3, ncep), np.nan, F32)
    for b in range(B):
        last = min(max(int(n[b]) - 1, 0), T - 1)
        for t0 in range(0, T, tile):
            nt = min(tile, T - t0)
            r = np.minimum(np.maximum(t0 + np.arange(nt + 2 * WIN) - WIN, 0),
                           last)
            assert r.min() >= 0 and r.max() < T
            xs = cep[b, r]
            if mean is not None:
                xs = (xs - mean[b]).astype(F32)
            c = [xs[k:k + nt] for k in range(2 * WIN + 1)]
            out[b, t0:t0 + nt, 0] = c[3]
            out[b, t0:t0 + nt, 1] = (c[5] - c[1]).astype(F32)
            out[b, t0:t0 + nt, 2] = ((c[6] - c[2]).astype(F32)
                                     - (c[4] - c[0]).astype(F32))
    return out


def rendering(cep, n, do_cmn: bool, rows=1, pass_frames=1024, tile=64):
    """tile 0: the one-launch form of a row of one pass, whose fold
    block writes the whole row (one tile of T frames)."""
    mean = fold_rendering(cep, n, rows, pass_frames) if do_cmn else None
    return output_rendering(cep, n, mean, tile or cep.shape[1])


def _cep(seed: int, B: int, T: int, scale: float = 128.0):
    """Cepstra [B, T, 13] on the wire's grid, c0 < 0 on a third of the
    frames; row 1 (where B > 1) has c0 < 0 on every frame."""
    rng = np.random.RandomState(seed)
    cep = rng.normal(0.0, 6.0, (B, T, 13))
    cep[:, :, 0] = np.where(rng.random_sample((B, T)) < 0.33,
                            -rng.random_sample((B, T)) * 5,
                            5 + rng.random_sample((B, T)) * 20)
    if B > 1:
        cep[1, :, 0] = -1.0 - rng.random_sample(T)
    return np.clip(np.round(cep * scale), -32768, 32767).astype(np.int16)


def _planes(v: np.ndarray) -> np.ndarray:
    u = v.view(np.uint16)
    return np.stack([(u & 0xFF).astype(np.uint8),
                     (u >> 8).astype(np.uint8)])


def _jax_planes(planes, Ts, cmn: str, scale: float) -> np.ndarray:
    fake = types.SimpleNamespace(config={"cmn": cmn}, wire_scale=scale)
    return np.asarray(TpuAligner._feats_chunk_planes(fake, planes, Ts,
                                                     planes.shape[2]))


def _jax_f32(cep, Ts, cmn: str) -> np.ndarray:
    fn = jax.vmap(lambda c, n: feats_full_utt(c, n, cmn))
    return np.asarray(fn(cep, Ts))


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == F32
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


# frame counts of the rows (T is 70 unless stated): full, all-negative c0,
# mid-row on a 32-frame tile edge, one frame, none, past T
COUNTS = [70, 55, 64, 1, 0, 90]


@pytest.mark.parametrize("layout", [(1, 32, 32), (2, 64, 16), (1, 1024, 64),
                                    (2, 96, 128), (1, 96, 0), (2, 1024, 0)])
@pytest.mark.parametrize("cmn", ["batch", "live"])
def test_planes_rendering_equals_jax(layout, cmn):
    """The byte-plane form in every layout (rows a fold block, frames a
    pass, frames a tile; T = 70 is no multiple of any tile) against the
    JAX package's _feats_chunk_planes, CMN on and off."""
    rows, pass_frames, tile = layout
    scale = 128.0
    planes = _planes(_cep(3, len(COUNTS), 70, scale))
    Ts = np.array(COUNTS, np.int32)
    want = _jax_planes(planes, Ts, cmn, scale)
    got = rendering(dequant(planes, 1.0 / scale), Ts, cmn != "live", rows,
                    pass_frames, tile)
    _same(got, want)
    # the plain version, which the wrapper runs on the CPU, agrees
    plain = feat_plain(torch.from_numpy(planes), torch.from_numpy(Ts),
                       1.0 / scale, cmn != "live").numpy()
    _same(plain, want)


@pytest.mark.parametrize("layout", [(1, 32, 64), (2, 64, 32)])
def test_f32_rendering_equals_jax(layout):
    """The float32 form (the device front end's cepstra, not on the
    wire's grid) against feats_full_utt row by row."""
    rows, pass_frames, tile = layout
    rng = np.random.RandomState(5)
    cep = (_cep(5, len(COUNTS), 70).astype(F32) / 100
           + rng.normal(0, 1e-3, (len(COUNTS), 70, 13))).astype(F32)
    Ts = np.array(COUNTS, np.int32)
    want = _jax_f32(cep, Ts, "batch")
    _same(rendering(cep, Ts, True, rows, pass_frames, tile), want)
    _same(feats_plain(torch.from_numpy(cep), torch.from_numpy(Ts),
                      True).numpy(), want)


@pytest.mark.parametrize("pass_frames,rows", [(1024, 1), (256, 2), (96, 1)])
def test_long_row_in_passes(pass_frames, rows):
    """Rows of a few thousand frames folded in several passes (the long
    form's rows are thousands of frames): the chains carry across the
    passes, a short row ends inside an early pass."""
    T = 2600
    scale = 256.0
    planes = _planes(_cep(7, 3, T, scale))
    Ts = np.array([T, 2500, 700], np.int32)
    want = _jax_planes(planes, Ts, "batch", scale)
    got = rendering(dequant(planes, 1.0 / scale), Ts, True, rows,
                    pass_frames, 64)
    _same(got, want)


def test_frame_count_past_t_reads_as_t():
    """A frame count past T: the JAX program's gathers clamp, so the row
    reads as one of T frames; the plain version (and the kernel) clamp
    the last frame to T - 1 instead of indexing past the row."""
    scale = 128.0
    planes = _planes(_cep(9, 2, 40, scale))
    want = _jax_planes(planes, np.array([40, 12], np.int32), "batch", scale)
    for n0 in (41, 1000):
        Ts = np.array([n0, 12], np.int32)
        _same(_jax_planes(planes, Ts, "batch", scale), want)
        got = feat_plain(torch.from_numpy(planes), torch.from_numpy(Ts),
                         1.0 / scale, True).numpy()
        _same(got, want)
        _same(rendering(dequant(planes, 1.0 / scale), Ts, True), want)


def test_fold_masks_to_negative_zero():
    """Adding -0.0 leaves every float32 sum as it was (+0.0, -0.0,
    subnormals, infinities, NaN), so the masked frames drop out of the
    chain exactly as the reference's where() skips them."""
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 3.5, np.inf, -np.inf, np.nan],
                    F32)
    got = (vals + F32(-0.0)).astype(F32)
    assert (got.view(np.uint32) == vals.view(np.uint32)).all()
