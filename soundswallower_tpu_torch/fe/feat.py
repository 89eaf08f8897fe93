"""Dynamic features from wire-quantized cepstra (kernel K1).

Port of ``soundswallower_tpu/fe/feat.py`` (feats_full_utt, cmn_batch,
compute_feat_1s_c_d_dd) fused with the byte-plane dequant of
``soundswallower_tpu/aligner.py`` (_feats_chunk_planes): uint8 planes
[2, B, T, ncep] of round(cep * scale) and the frame counts [B] in,
float32 features [B, T, 3, ncep] out.

* dequant ``(int8(hi) << 8 | lo) * (1 / scale)``, exact for the
  power-of-two scales the aligner uses;
* batch CMN (``cmn`` in {batch, current}): a float32 sum over frames
  t < n with c0 >= 0, taken in frame order, then ``mean = s / count``
  (0/0 = NaN), subtracted from every row;
* rows >= n replaced by row n-1, WIN=3 rows replicated at each edge,
  Δ = c[t+2]-c[t-2], ΔΔ = (c[t+3]-c[t-1])-(c[t+1]-c[t-3]).

``feat_f32`` is the same kernel's form for float32 cepstra [B, T, ncep]
(the device front end's output, ``_feats_chunk_raw`` of the JAX
aligner): no dequant, the same CMN and Δ/ΔΔ.

``feat`` and ``feat_f32`` launch ``csrc/feat.cu`` for CUDA tensors and
run ``feat_plain``/``feats_plain`` for CPU tensors.  The plain version keeps the float32
order with an explicit frame loop: ``torch.sum`` would not (it
accumulates float32 in another order and precision).  The kernel folds
the CMN sums in passes of frames staged in shared memory; a row of one
pass is then written by the same block (one launch), a longer row by a
second launch in tiles of frames;
``feat_layout`` says which layout the launcher takes, and
``feat_at``/``feat_f32_at`` force one.  A frame count past T reads as
T, as the JAX program's clamped gather does.

The exact Decoder's host path is numpy, copied from the JAX package's
module: ``cmn_batch_np``, ``feats_full_utt_np`` (batch CMN in frame
order, edge replication, 1s_c_d_dd) and ``FeatPipeline`` (the feature-type
registry, LDA and subvector projection, full-utterance and live).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_build

FEAT_DCEP_WIN = 2
WIN = FEAT_DCEP_WIN + 1  # feat window size for 1s_c_d_dd


def _dequant(planes: torch.Tensor, inv_scale: float) -> torch.Tensor:
    lo = planes[0].to(torch.int32)
    hi = planes[1].view(torch.int8).to(torch.int32)
    v = hi * 256 + lo
    return v.to(torch.float32) * torch.tensor(inv_scale, dtype=torch.float32)


def feat_plain(planes: torch.Tensor, n_frames: torch.Tensor,
               inv_scale: float, do_cmn: bool) -> torch.Tensor:
    """Plain PyTorch version of K1 (same signature as ``feat``)."""
    return feats_plain(_dequant(planes, inv_scale), n_frames, do_cmn)


def feats_plain(cep: torch.Tensor, n_frames: torch.Tensor,
                do_cmn: bool) -> torch.Tensor:
    """float32 cepstra [B, T, ncep] -> features [B, T, 3, ncep]
    (feats_full_utt per row; rows >= n_frames are padding)."""
    B, T, ncep = cep.shape
    n = n_frames.to(torch.int64)
    if do_cmn:
        valid = (torch.arange(T, device=cep.device)[None, :] < n[:, None]) \
            & (cep[:, :, 0] >= 0)
        s = torch.zeros((B, ncep), dtype=torch.float32, device=cep.device)
        cnt = torch.zeros(B, dtype=torch.int32, device=cep.device)
        for t in range(T):                              # frame order
            v = valid[:, t]
            s = torch.where(v[:, None], s + cep[:, t], s)
            cnt = cnt + v.to(torch.int32)
        mean = s / cnt.to(torch.float32)[:, None]
        cep = cep - mean[:, None, :]
    last = torch.clamp(n - 1, min=0, max=T - 1)

    def rows(k: int) -> torch.Tensor:
        t = torch.arange(T, device=cep.device)[None, :] + k
        idx = torch.minimum(torch.clamp(t, min=0), last[:, None])
        return torch.gather(cep, 1, idx[:, :, None].expand(B, T, ncep))

    c = [rows(k) for k in range(-WIN, WIN + 1)]
    d = c[5] - c[1]
    dd = (c[6] - c[2]) - (c[4] - c[0])
    return torch.stack([c[3], d, dd], dim=2)


def feat_layout(B: int, T: int, ncep: int, do_cmn: bool,
                rows: int = 0, pass_frames: int = 0,
                tile: int = 0) -> dict:
    """K1's layout on the current CUDA device for B rows of T frames:
    rows a fold block, frames a fold pass, frames an output tile (0: the
    one-launch form, where each fold block writes its rows) and
    launches; ``rows``, ``pass_frames`` and ``tile`` force one where not
    0 (a forced tile takes the two-launch form).  RuntimeError for a
    layout the launcher cannot run."""
    import ctypes

    lay = (ctypes.c_int32 * 4)()
    cuda_build.check(cuda_build.lib().sst_feat_layout(
        B, T, ncep, int(bool(do_cmn)), rows, pass_frames, tile,
        ctypes.addressof(lay)), "feat_layout")
    return dict(rows=lay[0], pass_frames=lay[1], tile=lay[2],
                launches=lay[3])


def _launch(wrapper, x, n_frames, B: int, T: int, ncep: int, do_cmn: bool,
            args: tuple, layout: tuple) -> torch.Tensor:
    """One call of the launcher of ``wrapper`` (feat: sst_feat,
    feat_f32: sst_feat_f32) on x, counted on the wrapper and on its
    ``shapes`` by B and T."""
    cuda_build.check_tensor(n_frames, torch.int32, "n_frames", x.device)
    if n_frames.shape != (B,):
        raise ValueError(f"n_frames shape {tuple(n_frames.shape)} != ({B},)")
    out = torch.empty((B, T, 3, ncep), dtype=torch.float32, device=x.device)
    mean = torch.empty((B, ncep) if do_cmn else (0,), dtype=torch.float32,
                       device=x.device)
    fn = getattr(cuda_build.lib(), "sst_" + wrapper.__name__)
    err = fn(x.data_ptr(), n_frames.data_ptr(), mean.data_ptr(),
             out.data_ptr(), B, T, ncep, *args, int(bool(do_cmn)), *layout,
             cuda_build.stream(x))
    cuda_build.check(err, wrapper.__name__)
    wrapper.launches += 1
    shape = f"B={B}, T={T}"
    wrapper.shapes[shape] = wrapper.shapes.get(shape, 0) + 1
    return out


def feat_at(planes: torch.Tensor, n_frames: torch.Tensor, inv_scale: float,
            do_cmn: bool, rows: int = 0, pass_frames: int = 0,
            tile: int = 0) -> torch.Tensor:
    """K1 on CUDA tensors in a forced layout (``feat_layout``'s
    parameters; 0 for the launcher's choice)."""
    if planes.device.type != "cuda":
        raise ValueError(f"feat: unsupported device {planes.device}")
    _, B, T, ncep = planes.shape
    cuda_build.check_tensor(planes, torch.uint8, "planes")
    return _launch(feat, planes, n_frames, B, T, ncep, do_cmn,
                   (float(inv_scale),), (rows, pass_frames, tile))


def feat(planes: torch.Tensor, n_frames: torch.Tensor, inv_scale: float,
         do_cmn: bool) -> torch.Tensor:
    """K1: planes uint8 [2, B, T, ncep], n_frames int32 [B] -> features
    float32 [B, T, 3, ncep]."""
    if planes.device.type == "cpu":
        return feat_plain(planes, n_frames, inv_scale, do_cmn)
    return feat_at(planes, n_frames, inv_scale, do_cmn)


feat.launches = 0
feat.shapes = {}


def feat_f32_at(cep: torch.Tensor, n_frames: torch.Tensor, do_cmn: bool,
                rows: int = 0, pass_frames: int = 0,
                tile: int = 0) -> torch.Tensor:
    """K1's float32 form on CUDA tensors in a forced layout."""
    if cep.device.type != "cuda":
        raise ValueError(f"feat_f32: unsupported device {cep.device}")
    B, T, ncep = cep.shape
    cuda_build.check_tensor(cep, torch.float32, "cep")
    return _launch(feat_f32, cep, n_frames, B, T, ncep, do_cmn, (),
                   (rows, pass_frames, tile))


def feat_f32(cep: torch.Tensor, n_frames: torch.Tensor,
             do_cmn: bool) -> torch.Tensor:
    """K1's float32 form: cepstra float32 [B, T, ncep], n_frames int32
    [B] -> features float32 [B, T, 3, ncep]."""
    if cep.device.type == "cpu":
        return feats_plain(cep, n_frames, do_cmn)
    return feat_f32_at(cep, n_frames, do_cmn)


feat_f32.launches = 0
feat_f32.shapes = {}


# -- the exact host path (numpy) ------------------------------------------------

def cmn_batch_np(cep: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batch CMN, exact float32 (cmn(), src/cmn.c:159-225)."""
    s = np.zeros(cep.shape[1], np.float32)
    n = 0
    for f in range(len(cep)):
        if cep[f, 0] < 0:
            continue
        s = (s + cep[f]).astype(np.float32)
        n += 1
    mean = (s / np.float32(n)).astype(np.float32)
    return (cep - mean[None, :]).astype(np.float32), mean


def feats_full_utt_np(cep: np.ndarray, cmn_mode: str = "batch") -> np.ndarray:
    """Exact host path: [T, ncep] float32 -> [T, 3, ncep] float32.

    Mirrors feat_s2mfc2feat_block_utt (feat.c:977-1007): CMN, then edge
    replication by WIN frames, then 1s_c_d_dd dynamic features.
    """
    if cmn_mode in ("batch", "current"):
        cep, _ = cmn_batch_np(cep)
    T, ncep = cep.shape
    padded = np.concatenate(
        [np.tile(cep[0], (WIN, 1)), cep, np.tile(cep[-1], (WIN, 1))], axis=0
    ).astype(np.float32)
    c = padded[WIN : WIN + T]
    d = (padded[WIN + 2 : WIN + T + 2] - padded[WIN - 2 : WIN + T - 2]).astype(np.float32)
    d1 = (padded[WIN + 3 : WIN + T + 3] - padded[WIN - 1 : WIN + T - 1]).astype(np.float32)
    d2 = (padded[WIN + 1 : WIN + T + 1] - padded[WIN - 3 : WIN + T - 3]).astype(np.float32)
    dd = (d1 - d2).astype(np.float32)
    return np.stack([c, d, dd], axis=1)


# ---------------------------------------------------------------------------
# Full feature-type registry (feat_init_s3file, feat.c:732-927) + LDA
# (lda.c:125-144) + subvector projection (feat.c:181-368).
#
# The shipped models use 1s_c_d_dd (K1 above on the batch routes); the
# pipeline below is the exact Decoder's host path for every reference
# feature type.  All arithmetic is float32 in the C operation order (each
# subtraction cast).
# ---------------------------------------------------------------------------

def parse_subvecs(spec: str) -> list[list[int]]:
    """parse_subvecs (feat.c:181-277): '/'-separated subvectors, each a
    comma list of dims or a-b ranges; duplicates within a subvector are
    errors."""
    out = []
    for sv in spec.split("/"):
        dims: list[int] = []
        if not sv:
            raise ValueError(f"'{spec}': 0-length subvector")
        for part in sv.split(","):
            if "-" in part[1:]:  # allow leading '-'? C sscanf reads ints
                a_s, b_s = part.split("-", 1)
                a, b = int(a_s), int(b_s)
            else:
                a = b = int(part)
            if a < 0 or a > b:
                raise ValueError(f"'{spec}': bad subrange spec {part}")
            for n in range(a, b + 1):
                if n in dims:
                    raise ValueError(f"'{spec}': duplicate dimension {n}")
                dims.append(n)
        out.append(dims)
    return out


def _f32(x):
    return np.asarray(x, np.float32)


class FeatPipeline:
    """Feature-type registry + LDA + subvector projection (exact host
    path).  Mirrors feat_init_s3file (feat.c:732-927): ``feat_type``
    selects stream shapes, window size, and the cep->feat function;
    ``lda``/``ldadim`` apply a linear transform (single-stream only,
    lda.c:84-144); ``svspec`` projects dimensions into subvector streams
    (feat.c:289-368)."""

    def __init__(self, feat_type: str = "1s_c_d_dd", cepsize: int = 13,
                 lda: np.ndarray | None = None, ldadim: int = 0,
                 svspec: str | None = None):
        t = feat_type
        self.name = t
        self.cepsize = cepsize
        if t == "s2_4x":
            if cepsize != 13:
                raise ValueError("s2_4x features require cepsize == 13")
            self.n_stream, self.stream_len = 4, [12, 24, 3, 12]
            self.window_size = 4
            self._compute = self._s2_4x
        elif t in ("s3_1x39", "1s_12c_12d_3p_12dd"):
            if cepsize != 13:
                raise ValueError("s3_1x39 features require cepsize == 13")
            self.n_stream, self.stream_len = 1, [39]
            self.window_size = 3
            self._compute = self._s3_1x39
        elif t.startswith("1s_c_d_dd"):
            self.n_stream, self.stream_len = 1, [cepsize * 3]
            self.window_size = FEAT_DCEP_WIN + 1
            self._compute = self._1s_c_d_dd
        elif t.startswith("1s_c_d_ld_dd"):
            self.n_stream, self.stream_len = 1, [cepsize * 4]
            self.window_size = FEAT_DCEP_WIN * 2
            self._compute = self._1s_c_d_ld_dd
        elif t.startswith("cep_dcep") or t.startswith("1s_c_d"):
            self.n_stream, self.stream_len = 1, [cepsize * 2]
            self.window_size = 2
            self._compute = self._cep_dcep
        elif t.startswith("cep") or t.startswith("1s_c"):
            self.n_stream, self.stream_len = 1, [cepsize]
            self.window_size = 0
            self._compute = self._copy
        elif t.startswith("1s_3c") or t.startswith("1s_4c"):
            self.window_size = 3 if t.startswith("1s_3c") else 4
            self.n_stream = 1
            self.stream_len = [cepsize * (2 * self.window_size + 1)]
            self._compute = self._copy
        else:
            # generic "%d,%d,...[:win]" comma list of stream widths
            self.window_size = 0
            if ":" in t:
                t, win_s = t.split(":", 1)
                self.window_size = int(win_s)
            widths = [int(w) for w in t.split(",")]
            if any(w <= 0 for w in widths):
                raise ValueError("Bad feature type argument")
            self.n_stream = len(widths)
            if sum(widths) != cepsize:
                raise ValueError("Bad feature type argument")
            self._in_widths = widths
            self.stream_len = [w * (2 * self.window_size + 1)
                               for w in widths]
            self._compute = self._copy_streams
        self.out_dim = sum(self.stream_len)

        self.lda = None
        if lda is not None:
            if self.n_stream != 1:
                raise ValueError("LDA incompatible with multi-stream features")
            lda = np.asarray(lda, np.float32)
            if lda.ndim == 3:
                lda = lda[0]
            if lda.shape[1] != self.stream_len[0]:
                raise ValueError(
                    f"LDA matrix dimension {lda.shape[1]} doesn't match "
                    f"feature stream size {self.stream_len[0]}")
            self.lda = lda
            m = lda.shape[0]
            self.out_dim = m if (ldadim <= 0 or ldadim > m) else ldadim

        self.subvecs = None
        self.sv_len = None
        if svspec:
            if self.n_stream != 1:
                raise ValueError(
                    "Subvector specifications require single-stream features")
            self.subvecs = parse_subvecs(svspec)
            n_dim = sum(len(s) for s in self.subvecs)
            if n_dim > self.out_dim:
                raise ValueError(
                    f"Total dimensionality of subvector specification "
                    f"{n_dim} > feature dimensionality {self.out_dim}")
            self.sv_len = [len(s) for s in self.subvecs]

    # -- output shape as the scorer consumes it -----------------------------

    @property
    def shape(self) -> tuple[int, int]:
        """(n_feat, max stream length) of the final per-frame output."""
        if self.subvecs is not None:
            return len(self.subvecs), max(self.sv_len)
        return self.n_stream, max(self.stream_len)

    # -- per-type compute functions (padded [T+2w, ncep] -> streams) --------

    def _win(self, p, off):
        w = self.window_size
        T = p.shape[0] - 2 * w
        return p[w + off: w + off + T]

    def _s2_4x(self, p):
        c = self._win(p, 0)
        d_s = _f32(self._win(p, 2)[:, 1:] - self._win(p, -2)[:, 1:])
        d_l = _f32(self._win(p, 4)[:, 1:] - self._win(p, -4)[:, 1:])
        d1 = _f32(self._win(p, 3) - self._win(p, -1))
        d2 = _f32(self._win(p, 1) - self._win(p, -3))
        dd = _f32(d1 - d2)
        pow3 = np.stack([c[:, 0],
                         _f32(self._win(p, 2)[:, 0] - self._win(p, -2)[:, 0]),
                         dd[:, 0]], axis=1)
        return [c[:, 1:], np.concatenate([d_s, d_l], 1), pow3, dd[:, 1:]]

    def _s3_1x39(self, p):
        c = self._win(p, 0)
        d = _f32(self._win(p, 2) - self._win(p, -2))
        d1 = _f32(self._win(p, 3) - self._win(p, -1))
        d2 = _f32(self._win(p, 1) - self._win(p, -3))
        dd = _f32(d1 - d2)
        pow3 = np.stack([c[:, 0], d[:, 0], dd[:, 0]], axis=1)
        return [np.concatenate([c[:, 1:], d[:, 1:], pow3, dd[:, 1:]], 1)]

    def _1s_c_d_dd(self, p):
        w = FEAT_DCEP_WIN
        c = self._win(p, 0)
        d = _f32(self._win(p, w) - self._win(p, -w))
        d1 = _f32(self._win(p, w + 1) - self._win(p, -w + 1))
        d2 = _f32(self._win(p, w - 1) - self._win(p, -w - 1))
        dd = _f32(d1 - d2)
        return [np.concatenate([c, d, dd], 1)]

    def _1s_c_d_ld_dd(self, p):
        w = FEAT_DCEP_WIN
        c = self._win(p, 0)
        d = _f32(self._win(p, w) - self._win(p, -w))
        ld = _f32(self._win(p, 2 * w) - self._win(p, -2 * w))
        d1 = _f32(self._win(p, w + 1) - self._win(p, -w + 1))
        d2 = _f32(self._win(p, w - 1) - self._win(p, -w - 1))
        dd = _f32(d1 - d2)
        return [np.concatenate([c, d, ld, dd], 1)]

    def _cep_dcep(self, p):
        c = self._win(p, 0)
        d = _f32(self._win(p, 2) - self._win(p, -2))
        return [np.concatenate([c, d], 1)]

    def _copy(self, p):
        w = self.window_size
        return [np.concatenate([self._win(p, i) for i in range(-w, w + 1)],
                               1)]

    def _copy_streams(self, p):
        w = self.window_size
        outs = []
        pos = 0
        for width in self._in_widths:
            cols = [self._win(p, i)[:, pos:pos + width]
                    for i in range(-w, w + 1)]
            outs.append(np.concatenate(cols, 1))
            pos += width
        return outs

    # -- full-utterance pipeline --------------------------------------------

    def _project(self, streams: list[np.ndarray]) -> np.ndarray:
        """LDA + subvector projection + pad to [T, n_feat, max_len]."""
        T = streams[0].shape[0]
        if self.lda is not None:
            # feat_lda_transform (lda.c:125-144): tmp[j] = sum_k x[k]*A[j,k]
            # in ascending-k float32 accumulation; only out_dim rows kept
            x = streams[0]
            out = np.zeros((T, self.out_dim), np.float32)
            for k in range(x.shape[1]):
                out += x[:, k:k + 1] * self.lda[None, :self.out_dim, k]
                out = out.astype(np.float32)
            streams = [out]
        if self.subvecs is not None:
            flat = streams[0]
            streams = [flat[:, dims] for dims in self.subvecs]
        n_feat = len(streams)
        maxlen = max(s.shape[1] for s in streams)
        out = np.zeros((T, n_feat, maxlen), np.float32)
        for i, s in enumerate(streams):
            out[:, i, :s.shape[1]] = s
        return out

    def compute_full(self, cep: np.ndarray,
                     cmn_mode: str = "batch") -> np.ndarray:
        """[T, ncep] float32 -> [T, n_feat, max_len] float32 (zero-padded
        ragged streams).  CMN, then edge replication by window_size
        (feat_s2mfc2feat_block_utt, feat.c:977-1007), per-type dynamic
        features, LDA, subvector projection."""
        cep = np.asarray(cep, np.float32)
        if cmn_mode in ("batch", "current"):
            cep, _ = cmn_batch_np(cep)
        w = self.window_size
        if w:
            p = np.concatenate([np.tile(cep[0], (w, 1)), cep,
                                np.tile(cep[-1], (w, 1))]).astype(np.float32)
        else:
            p = cep
        return self._project(self._compute(p))

    def compute_window(self, win: np.ndarray) -> np.ndarray:
        """One frame from its [2*window_size+1, ncep] context window
        (already CMN'd) -> [n_feat, max_len] (the live/chunked path)."""
        assert win.shape[0] == 2 * self.window_size + 1
        return self._project(self._compute(np.asarray(win, np.float32)))[0]
