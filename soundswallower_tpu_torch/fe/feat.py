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
accumulates float32 in another order and precision).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

WIN = 3


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
    last = torch.clamp(n - 1, min=0)

    def rows(k: int) -> torch.Tensor:
        t = torch.arange(T, device=cep.device)[None, :] + k
        idx = torch.minimum(torch.clamp(t, min=0), last[:, None])
        return torch.gather(cep, 1, idx[:, :, None].expand(B, T, ncep))

    c = [rows(k) for k in range(-WIN, WIN + 1)]
    d = c[5] - c[1]
    dd = (c[6] - c[2]) - (c[4] - c[0])
    return torch.stack([c[3], d, dd], dim=2)


def feat(planes: torch.Tensor, n_frames: torch.Tensor, inv_scale: float,
         do_cmn: bool) -> torch.Tensor:
    """K1: planes uint8 [2, B, T, ncep], n_frames int32 [B] -> features
    float32 [B, T, 3, ncep]."""
    if planes.device.type == "cpu":
        return feat_plain(planes, n_frames, inv_scale, do_cmn)
    if planes.device.type != "cuda":
        raise ValueError(f"feat: unsupported device {planes.device}")
    _, B, T, ncep = planes.shape
    cuda_build.check_tensor(planes, torch.uint8, "planes")
    cuda_build.check_tensor(n_frames, torch.int32, "n_frames", planes.device)
    if n_frames.shape != (B,):
        raise ValueError(f"feat: n_frames shape {tuple(n_frames.shape)} != ({B},)")
    out = torch.empty((B, T, 3, ncep), dtype=torch.float32,
                      device=planes.device)
    lib = cuda_build.lib()
    err = lib.sst_feat(planes.data_ptr(), n_frames.data_ptr(), out.data_ptr(),
                       B, T, ncep, float(inv_scale), int(bool(do_cmn)),
                       cuda_build.stream(planes))
    cuda_build.check(err, "feat")
    feat.launches += 1
    return out


feat.launches = 0


def feat_f32(cep: torch.Tensor, n_frames: torch.Tensor,
             do_cmn: bool) -> torch.Tensor:
    """K1's float32 form: cepstra float32 [B, T, ncep], n_frames int32
    [B] -> features float32 [B, T, 3, ncep]."""
    if cep.device.type == "cpu":
        return feats_plain(cep, n_frames, do_cmn)
    if cep.device.type != "cuda":
        raise ValueError(f"feat_f32: unsupported device {cep.device}")
    B, T, ncep = cep.shape
    cuda_build.check_tensor(cep, torch.float32, "cep")
    cuda_build.check_tensor(n_frames, torch.int32, "n_frames", cep.device)
    if n_frames.shape != (B,):
        raise ValueError(f"feat_f32: n_frames shape {tuple(n_frames.shape)} "
                         f"!= ({B},)")
    out = torch.empty((B, T, 3, ncep), dtype=torch.float32, device=cep.device)
    lib = cuda_build.lib()
    err = lib.sst_feat_f32(cep.data_ptr(), n_frames.data_ptr(), out.data_ptr(),
                           B, T, ncep, int(bool(do_cmn)), cuda_build.stream(cep))
    cuda_build.check(err, "feat_f32")
    feat_f32.launches += 1
    return out


feat_f32.launches = 0
