"""Frozen copy of ``soundswallower_tpu_torch/am.py``
for the benchmark's reference (see ``__init__``).

Acoustic model bundle: mdef + tmat + Gaussian codebooks + mixture weights.

Loads and precomputes everything the senone scorer needs:

* Gaussian precompute (``gauden_dist_precompute``, ms_gauden.c:218-255):
  variance flooring, ``det`` = sum of int log determinant terms accumulated
  in float32, variances replaced by ``ln_to_log(1/(2*var))`` stored as
  float32 (all integer-valued, so float32 is exact).
* Transition matrix quantization (``tmat_init_s3file``, tmat.c:125-230):
  row normalize, floor nonzero entries, renormalize, then
  ``-logmath_log(p) >> SENSCR_SHIFT`` clamped to uint8 255.
* Mixture weights from sendump (raw negated quantized uint8) or from the
  float mixw file (``read_mixw``, ptm_mgau.c:611-692).
* Backend selection following acmod_load_am (acmod.c:101-119):
  PTM (n_mgau == n_ciphone) -> semi-continuous (n_mgau == 1) -> ms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .config import Config
from .logmath import SENSCR_SHIFT, LogMath
from .mdef import BinMdef, read_mdef
from . import s3file as s3


def _vector_sum_norm(vec: np.ndarray) -> float:
    """vector_sum_norm (vector.c:87-103): float64 sum in index order, then
    multiply each element by the float64 reciprocal, rounding to float32."""
    s = np.float64(0.0)
    for x in vec:
        s = s + np.float64(x)
    if s != 0.0:
        f = np.float64(1.0) / s
        for i in range(len(vec)):
            vec[i] = np.float32(np.float64(vec[i]) * f)
    return float(s)


def quantize_tmat(tp: np.ndarray, tpfloor: float, lmath: LogMath) -> np.ndarray:
    """Float transition matrices -> negated quantized uint8 (tmat.c:172-207)."""
    n_tmat, n_src, n_dst = tp.shape
    out = np.zeros((n_tmat, n_src, n_dst), dtype=np.uint8)
    for t in range(n_tmat):
        for j in range(n_src):
            row = tp[t, j].astype(np.float32).copy()
            _vector_sum_norm(row)
            # vector_nz_floor: floor only nonzero entries (f32 < f64 compare)
            nz = row != 0.0
            row[nz & (row.astype(np.float64) < tpfloor)] = np.float32(tpfloor)
            _vector_sum_norm(row)
            for k in range(n_dst):
                ltp = -lmath.log(float(row[k])) >> SENSCR_SHIFT
                if ltp > 255:
                    ltp = 255
                out[t, j, k] = ltp
    return out


def precompute_gauden(means: np.ndarray, variances: np.ndarray,
                      varfloor: float, lmath: LogMath):
    """gauden_dist_precompute (ms_gauden.c:218-255), vectorized.

    Returns (det[cb, f, d] float32, var_t[cb, f, d, L] float32).  All values
    are integer-valued log-domain quantities; float32 holds them exactly.
    """
    varf = variances.astype(np.float32).copy()
    varf[varf < np.float32(varfloor)] = np.float32(varfloor)
    var = varf.astype(np.float64)
    # det term per dim: logmath_log(1.0 / sqrt(var * 2.0 * M_PI))
    dterm = np.log(1.0 / np.sqrt(var * 2.0 * math.pi)) * lmath.inv_log_of_base
    dterm = np.trunc(dterm).astype(np.int64) >> lmath.shift
    # accumulate in float32 in dim order (values are ints; f32 exact here)
    det = np.zeros(var.shape[:3], dtype=np.float32)
    for i in range(var.shape[3]):
        det = (det + dterm[..., i].astype(np.float32)).astype(np.float32)
    # "variance" becomes the quadratic-term scale in log_base units:
    # logmath_ln_to_log(1/(2*var)) == (int)((1/(2*var)) * inv_log_of_base)
    # (ms_gauden.c:247-249; note ln_to_log converts units, it does NOT log)
    var_t = np.trunc((1.0 / (var * 2.0)) * lmath.inv_log_of_base)
    var_t = (var_t.astype(np.int64) >> lmath.shift).astype(np.float32)
    return det, var_t


@dataclass(eq=False)
class AcousticModel:
    mdef: BinMdef
    tmat: np.ndarray          # uint8 [n_tmat, n_src, n_dst] negated quantized
    means: np.ndarray         # float32 [cb, feat, dens, L]
    var_t: np.ndarray         # float32 [cb, feat, dens, L] (precomputed)
    det: np.ndarray           # float32 [cb, feat, dens]
    mixw: np.ndarray          # uint8 [feat, dens, n_sen] negated quantized
    mixw_cb: np.ndarray | None
    sen2cb: np.ndarray        # uint8/int16 [n_sen]
    lmath: LogMath
    lmath_8b: LogMath
    backend: str              # 'ptm' | 'semi' | 'ms'
    max_topn: int = 4
    ds_ratio: int = 1
    aw: int = 1
    n_feat: int = 3
    n_density: int = 128
    veclen: list = field(default_factory=lambda: [13, 13, 13])

    @classmethod
    def load(cls, config: Config, lmath: LogMath | None = None) -> "AcousticModel":
        if lmath is None:
            lmath = LogMath(config.get_float("logbase"), 0, True)
        mdef = read_mdef(config["mdef"])
        tp_raw = s3.read_tmat_params(config["tmat"])
        if tp_raw.shape[1] != mdef.n_emit_state:
            raise ValueError("tmat topology does not match mdef")
        tmat = quantize_tmat(tp_raw, config.get_float("tmatfloor"), lmath)

        means, n_mgau, n_feat, n_density, veclen = s3.read_gauden_params(config["mean"])
        variances, vm, vf, vd, vveclen = s3.read_gauden_params(config["var"])
        if (vm, vf, vd) != (n_mgau, n_feat, n_density) or vveclen != veclen:
            raise ValueError("means/variances dimension mismatch")
        det, var_t = precompute_gauden(means, variances, config.get_float("varfloor"), lmath)

        # 8-bit logadd table for fast_logmath_add (ptm_mgau.c:735-743)
        lmath_8b = LogMath(lmath.base, SENSCR_SHIFT, True)
        if lmath_8b.width != 1:
            raise ValueError("Log base too small for 8-bit add table")

        # senmgau forces the general multi-stream backend
        # (acmod_load_am, acmod.c:101-107)
        if config["senmgau"]:
            sen2cb = s3.read_senmgau(config["senmgau"]).astype(np.int32)
            if len(sen2cb) != mdef.n_sen:
                raise ValueError("senmgau size != n_sen")
            pdf = s3.read_mixw_float(config["mixw"])
            mixw = quantize_mixw_ms(pdf, config.get_float("mixwfloor"), lmath)
            return cls(
                mdef=mdef, tmat=tmat, means=means, var_t=var_t, det=det,
                mixw=mixw, mixw_cb=None, sen2cb=sen2cb, lmath=lmath,
                lmath_8b=lmath_8b, backend="ms",
                max_topn=config.get_int("topn"),
                ds_ratio=config.get_int("ds"), aw=config.get_int("aw"),
                n_feat=n_feat, n_density=n_density, veclen=veclen,
            )

        # Backend selection (acmod_load_am, acmod.c:101-119).  The 1:1
        # no-senmgau fallback (".cont.", ms_senone.c:225-241): a model
        # whose codebook count is neither 1 nor n_ciphone maps each
        # senone to its own codebook and runs the ms backend.
        if n_mgau not in (1, mdef.n_ciphone):
            if n_mgau != mdef.n_sen:
                raise ValueError(
                    f"no senmgau and n_mgau {n_mgau} matches neither 1, "
                    f"n_ciphone {mdef.n_ciphone}, nor n_sen {mdef.n_sen}")
            if not config["mixw"]:
                raise ValueError("ms backend needs a mixw file")
            pdf = s3.read_mixw_float(config["mixw"])
            mixw = quantize_mixw_ms(pdf, config.get_float("mixwfloor"),
                                    lmath)
            return cls(
                mdef=mdef, tmat=tmat, means=means, var_t=var_t, det=det,
                mixw=mixw, mixw_cb=None,
                sen2cb=np.arange(mdef.n_sen, dtype=np.int32),
                lmath=lmath, lmath_8b=lmath_8b, backend="ms",
                max_topn=config.get_int("topn"),
                ds_ratio=config.get_int("ds"), aw=config.get_int("aw"),
                n_feat=n_feat, n_density=n_density, veclen=veclen,
            )

        mixw_cb = None
        if config["sendump"]:
            mixw, mixw_cb = s3.read_sendump(
                config["sendump"], n_feat, n_density, mdef.n_sen
            )
        elif config["mixw"]:
            pdf = s3.read_mixw_float(config["mixw"])
            mixw = quantize_mixw(pdf, config.get_float("mixwfloor"), lmath_8b)
            # transpose [sen, feat, comp] -> [feat, comp, sen]
        else:
            raise ValueError("Neither sendump nor mixw available")

        if n_mgau == mdef.n_ciphone:
            backend = "ptm"
            sen2cb = mdef.sen2cimap.astype(np.int32)
        else:
            backend = "semi"
            sen2cb = np.zeros(mdef.n_sen, dtype=np.int32)

        return cls(
            mdef=mdef, tmat=tmat, means=means, var_t=var_t, det=det,
            mixw=mixw, mixw_cb=mixw_cb, sen2cb=sen2cb, lmath=lmath,
            lmath_8b=lmath_8b, backend=backend,
            max_topn=config.get_int("topn"), ds_ratio=config.get_int("ds"),
            aw=config.get_int("aw"),
            n_feat=n_feat, n_density=n_density, veclen=veclen,
        )

    @property
    def n_sen(self) -> int:
        return self.mdef.n_sen

    @property
    def n_mgau(self) -> int:
        return self.means.shape[0]

    @property
    def mixw_wrap_u8(self) -> bool:
        """Whether mixture terms wrap modulo 256 during senone eval: the
        semi-continuous 4-bit path precomputes ``uint8 w_den[][16] =
        mixw_cb[j] + score`` (s2_semi_mgau.c:452-461), so mixw + codeword
        score truncates to uint8 before the log-add.  No other backend
        does this (the 8-bit path uses int32, :221; ptm uses int,
        ptm_mgau.c:374-381)."""
        return self.backend == "semi" and self.mixw_cb is not None

    def mixw_dense(self, sens: np.ndarray | None = None) -> np.ndarray:
        """Decoded uint8 mixture weights [n_feat, n_density, len(sens)].

        8-bit sendumps / float mixw are stored dense already.  4-bit
        clustered sendumps pack two senones per byte and decode through
        the 16-entry cluster codebook — with a convention that differs
        PER BACKEND in the reference:

        * ptm selects the nibble by PACKED-BYTE parity
          (``dcw = (dcw & 1) ? dcw >> 4 : dcw & 0x0f``, ptm_mgau.c:377)
          — a faithful quirk of the C code, replicated for parity;
        * the semi-continuous scorer selects by SENONE-INDEX parity
          (``if (n & 1) cw = pid_cw[n/2] >> 4``, s2_semi_mgau.c:475-499).
        """
        if sens is None:
            sens = np.arange(self.n_sen)
        sens = np.asarray(sens, np.int64)
        if self.backend == "ms":
            # ms stores the untransposed [sen, feat, comp] layout
            # (quantize_mixw_ms / ms_senone.c:104-200)
            return np.transpose(self.mixw[sens], (1, 2, 0))
        if self.mixw_cb is None:
            return self.mixw[:, :, sens]
        packed = self.mixw[:, :, sens // 2].astype(np.int64)
        if self.backend == "semi":
            odd = (sens[None, None, :] & 1) != 0
        else:
            odd = (packed & 1) != 0
        dcw = np.where(odd, packed >> 4, packed & 0x0F)
        return self.mixw_cb[dcw]


def quantize_mixw(pdf: np.ndarray, mixw_floor: float, lmath_8b: LogMath) -> np.ndarray:
    """read_mixw quantization (ptm_mgau.c:658-684): normalize, floor,
    renormalize, -log quantize to uint8 clamped at MAX_NEG_MIXW."""
    MAX_NEG_MIXW = 159
    n_sen, n_feat, n_comp = pdf.shape
    out = np.zeros((n_feat, n_comp, n_sen), dtype=np.uint8)
    for i in range(n_sen):
        for f in range(n_feat):
            row = pdf[i, f].astype(np.float32).copy()
            _vector_sum_norm(row)
            row[row.astype(np.float64) < mixw_floor] = np.float32(mixw_floor)
            _vector_sum_norm(row)
            for c in range(n_comp):
                qscr = -lmath_8b.log(float(row[c]))
                if qscr > MAX_NEG_MIXW or qscr < 0:
                    qscr = MAX_NEG_MIXW
                out[f, c, i] = qscr
    return out


def quantize_mixw_ms(pdf: np.ndarray, mixw_floor: float,
                     lmath: LogMath) -> np.ndarray:
    """senone_mixw_read quantization (ms_senone.c:104-200): normalize,
    floor, renormalize, then rounded SENSCR_SHIFT truncation of the
    full-precision negated log, clamped at 255.  Returns the untransposed
    [n_sen, n_feat, n_cw] uint8 layout used when n_gauden > 1."""
    n_sen, n_feat, n_comp = pdf.shape
    out = np.zeros((n_sen, n_feat, n_comp), dtype=np.uint8)
    for i in range(n_sen):
        for f in range(n_feat):
            row = pdf[i, f].astype(np.float32).copy()
            _vector_sum_norm(row)
            row[row.astype(np.float64) < mixw_floor] = np.float32(mixw_floor)
            _vector_sum_norm(row)
            for c in range(n_comp):
                p = -lmath.log(float(row[c]))
                p += (1 << (SENSCR_SHIFT - 1)) - 1
                out[i, f, c] = (p >> SENSCR_SHIFT) \
                    if p < (255 << SENSCR_SHIFT) else 255
    return out
