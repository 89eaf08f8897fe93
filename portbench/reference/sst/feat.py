"""Frozen copy of ``soundswallower_tpu_torch/fe/feat.py``
for the benchmark's reference (see ``__init__``).

Dynamic features from wire-quantized cepstra (kernel K1).

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

import torch


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


# ---------------------------------------------------------------------------
# Full feature-type registry (feat_init_s3file, feat.c:732-927) + LDA
# (lda.c:125-144) + subvector projection (feat.c:181-368).
#
# The shipped models use 1s_c_d_dd (K1 above on the batch routes); the
# pipeline below is the exact Decoder's host path for every reference
# feature type.  All arithmetic is float32 in the C operation order (each
# subtraction cast).
# ---------------------------------------------------------------------------


