"""K14's decomposition on the card (csrc/yin.cu), rendered in numpy and
held bit for bit (uint32 view) against the JAX package's
``cmnd_batch``/``pitch_batch``.

The first launch cuts a frame's lags into tiles of tpf * R: a block of
tpf threads stages the frame (sample F - 1 repeated past the frame, the
JAX gather's clamp; shifted so every window of 32 starts on a 16-byte
boundary) and each thread carries R adjacent lags through XLA's tree of
windows of 32 in lockstep, whole windows from 16-byte loads, the windows
cut by the padding one sample at a time.  Where a block holds a whole
frame it then finishes the frame, else a second launch of
256 threads a frame does: it scans d in XLA's blocked order, forms the
CMND and picks the period, each thread over the lags k, k + threads,
..., then xor-shuffles in warps of 32, then thread 0 over the warps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from soundswallower_tpu import yin as jyin

F32 = np.float32
WINDOW = 32
SCAN = 16
MAX_TREE = 4
INT_MAX = 2 ** 31 - 1
FINISH_THREADS = 256

AUSTEN = np.fromfile(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "golden", "austen.raw"), np.int16)


def make_tree(ndiff: int):
    levels, n, lo = 0, [ndiff], [0]
    while n[levels] > WINDOW and levels < MAX_TREE:
        w = -(-n[levels] // WINDOW)
        lo[levels] = (w * WINDOW - n[levels]) // 2
        lo.append(0)
        n.append(w)
        levels += 1
    return levels, n, lo


def layout(ndiff: int, R: int, tpf: int):
    """The launcher's arithmetic for a forced (R, tpf): lag tiles a
    frame, staged samples, the staged frame's stride."""
    need = -(-ndiff // R)
    tiles = -(-need // tpf)
    stage = (2 * ndiff + 12 + 3) // 4 * 4
    return tiles, stage, stage + 4


def diff_rendering(frames: np.ndarray, ndiff: int, R: int,
                   tpf: int) -> np.ndarray:
    """yin_diff_kernel: d [N, ndiff] float32."""
    N, F = frames.shape
    levels, n, lo = make_tree(ndiff)
    tiles, stage, sstride = layout(ndiff, R, tpf)
    off = lo[0] & 3
    NB = (WINDOW + R - 1 + 3) // 4
    x = frames.astype(F32)
    # a block's staged frame: x[min(i, F - 1)] at off + i
    sm = np.full((N, sstride), np.nan, F32)
    sm[:, off:off + stage] = x[:, np.minimum(np.arange(stage), F - 1)]
    # every thread's R lags, tiles side by side: [threads, R]
    t0 = (np.arange(tiles * tpf) * R)
    t0 = t0[t0 < ndiff]
    lags = t0[:, None] + np.arange(R)[None, :]
    acc = [np.zeros((N,) + lags.shape, F32) for _ in range(MAX_TREE)]
    nw = n[1] if levels else 1
    for W in range(nw):
        a = W * WINDOW - lo[0]
        ja, jb = max(a, 0), min(a + WINDOW, ndiff)
        if (ja, jb) == (a, a + WINDOW):
            # 16-byte loads of x[a ..] and x[a + t0 ..]
            assert (off + a) % 4 == 0 and (off + a + t0).max() % 4 == 0
            assert off + a + t0.max() + 4 * NB <= off + stage
        w = np.zeros((N,) + lags.shape, F32)
        for j in range(ja, jb):
            idx = off + lags + j
            assert idx.max() < off + stage
            with np.errstate(invalid="ignore"):
                df = (sm[:, off + j][:, None, None] - sm[:, idx]).astype(F32)
            w = (w + (df * df).astype(F32)).astype(F32)
        i = W
        for lv in range(1, levels + 1):
            acc[lv - 1] = (acc[lv - 1] + w).astype(F32)
            if lv == levels:
                break
            p = i + lo[lv]
            if p % WINDOW != WINDOW - 1 and i != n[lv] - 1:
                break
            w, acc[lv - 1] = acc[lv - 1], np.zeros_like(w)
            i = p // WINDOW
    val = acc[levels - 1] if levels else w
    d = np.full((N, ndiff), np.nan, F32)
    keep = lags < ndiff
    d[:, lags[keep]] = val[:, keep]
    assert np.bincount(lags[keep], minlength=ndiff).tolist() == [1] * ndiff
    return d


def blocked_scan(a: np.ndarray) -> np.ndarray:
    """blocked_scan on a copy of a [N, n]: running sums in blocks of 16,
    the totals scanned the same way level by level, added back down."""
    arr = [a.astype(F32).copy()]
    while arr[-1].shape[1] > SCAN:
        m = arr[-1].shape[1]
        mb = -(-m // SCAN)
        tot = np.zeros((a.shape[0], mb), F32)
        for b in range(mb):
            acc = np.zeros(a.shape[0], F32)
            for k in range(b * SCAN, min(m, (b + 1) * SCAN)):
                acc = (acc + arr[-1][:, k]).astype(F32)
                arr[-1][:, k] = acc
            tot[:, b] = acc
        arr.append(tot)
    acc = np.zeros(a.shape[0], F32)
    for k in range(arr[-1].shape[1]):
        acc = (acc + arr[-1][:, k]).astype(F32)
        arr[-1][:, k] = acc
    for lv in range(len(arr) - 2, -1, -1):
        for i in range(SCAN, arr[lv].shape[1]):
            arr[lv][:, i] = (arr[lv][:, i]
                             + arr[lv + 1][:, i // SCAN - 1]).astype(F32)
    return arr[0]


def _merge(a, b):
    under, nan, imin, vmin = a
    if b[2] != INT_MAX and (b[3] < vmin or (b[3] == vmin and b[2] < imin)):
        imin, vmin = b[2], b[3]
    return (min(under, b[0]), min(nan, b[1]), imin, vmin)


def finish_rendering(d: np.ndarray, thr: float,
                     threads: int = FINISH_THREADS):
    """finish_frame on a block of ``threads``: (cmnd, period int64, best)
    from d."""
    N, nd = d.shape
    cum = blocked_scan(d)
    c = np.where(cum <= 0, F32(1.0), cum).astype(F32)
    t = np.arange(nd, dtype=F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = ((d * t).astype(F32) / c).astype(F32)
    v[:, 0] = 1.0
    v = (v * F32(32768.0)).astype(F32)
    thr = F32(thr)
    period = np.empty(N, np.int64)
    best = np.empty(N, F32)
    for r in range(N):
        picks = []
        for th in range(threads):
            pk = (INT_MAX, INT_MAX, INT_MAX, F32(np.inf))
            for k in range(th, nd, threads):
                x = v[r, k]
                if x < thr and k < pk[0]:
                    pk = (k,) + pk[1:]
                if x != x:
                    pk = (pk[0], min(pk[1], k), pk[2], pk[3])
                elif x < pk[3] or (x == pk[3] and k < pk[2]):
                    pk = (pk[0], pk[1], k, x)
            picks.append(pk)
        for o in (16, 8, 4, 2, 1):
            picks = [_merge(picks[i], picks[i ^ o]) for i in range(len(picks))]
        pk = picks[0]
        for w in range(1, threads // 32):
            pk = _merge(pk, picks[32 * w])
        under, nan, imin, _ = pk
        p = (under if under != INT_MAX else nan if nan != INT_MAX
             else imin if imin != INT_MAX else 0)
        period[r] = p
        best[r] = v[r, p]
    return v, period, best


def jax_reference(frames, ndiff: int, thr: float):
    """The JAX cmnd_batch and pitch_batch's pick on it."""
    d = jyin.cmnd_batch(jnp.asarray(frames), ndiff)
    under = d < thr
    period = jnp.where(jnp.any(under, -1), jnp.argmax(under, -1),
                       jnp.argmin(d, -1))
    best = jnp.take_along_axis(d, period[..., None], -1)[..., 0]
    return np.asarray(d), np.asarray(period), np.asarray(best)


def _frames(F: int, n: int) -> np.ndarray:
    step = max(160, (len(AUSTEN) - F) // n)
    return np.stack([AUSTEN[p:p + F]
                     for p in range(0, len(AUSTEN) - F, step)])[:n]


def _check(frames, ndiff, thr, R, tpf):
    want = jax_reference(frames, ndiff, thr)
    tiles = layout(ndiff, R, tpf)[0]
    # one launch (the diff block finishes its frame) where a block holds
    # a whole frame, else the finish kernel's 256 threads
    threads = tpf if tiles == 1 else FINISH_THREADS
    got = finish_rendering(diff_rendering(frames, ndiff, R, tpf), thr,
                           threads)
    assert (got[0].view(np.uint32) == want[0].view(np.uint32)).all()
    assert (got[1] == want[1]).all()
    assert (got[2].view(np.uint32) == want[2].view(np.uint32)).all()


THR = float(np.float32(0.1 * 32768.0))


@pytest.mark.parametrize("F,n,lay", [
    (200, 4, (4, 64)), (200, 3, (8, 64)),
    (400, 3, (4, 128)), (400, 3, (8, 128)),
    (1024, 2, (4, 64)), (1024, 2, (8, 128)),
    (4096, 2, (4, 128)), (4096, 1, (8, 64))])
def test_austen_frames_in_every_layout(F, n, lay):
    """pitch_batch's shape (ndiff = F / 2) at the frame sizes the card
    runs, a frame a block (one launch) and split into lag tiles (the
    second launch), R = 4 and 8, blocks of 64 and 128 threads."""
    _check(_frames(F, n), F // 2, THR, *lay)


@pytest.mark.parametrize("F,ndiff", [(400, 150), (400, 201), (100, 70),
                                     (100, 100), (64, 32), (32, 13),
                                     (1024, 517)])
@pytest.mark.parametrize("lay", [(4, 64), (8, 128)])
def test_ndiff_off_the_grid(F, ndiff, lay):
    """ndiff no multiple of R or of 32, past F / 2 (lags past the frame
    read its last sample), a single window (ndiff <= 32), and a tree
    whose windows are cut at both ends."""
    _check(_frames(F, 3), ndiff, THR, *lay)


def test_ties_nan_and_lag_one():
    """A constant frame (every CMND past lag 0 is 0: under the threshold
    at lag 1, and with a threshold of 0 a tie of minima that the first
    wins), a float frame with an infinity (NaN lags: the first NaN is
    the period) and a frame constant over its first ndiff + 1 samples
    only (under the threshold at lag 1, not after)."""
    F = 200
    fr = _frames(F, 4).astype(F32)
    fr[0] = 123.0
    fr[1, 57] = np.inf
    # d(1) = 0 (cum(1) = 0 reads as 1): the CMND is 0 at lag 1
    fr[2, :F // 2 + 1] = -77.0
    for thr in (THR, 0.0):
        for lay in ((4, 64), (8, 128)):
            _check(fr, F // 2, thr, *lay)
    d, period, _ = jax_reference(fr, F // 2, 0.0)
    assert period[0] == 1 and (d[0, 1:] == 0).all()    # a tie, the first
    assert period[1] == 1 and np.isnan(d[1, 1])         # the first NaN
    _, period, _ = jax_reference(fr, F // 2, THR)
    assert period[2] == 1
