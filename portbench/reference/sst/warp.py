"""Frozen copy of ``soundswallower_tpu_torch/fe/warp.py``
for the benchmark's reference (see ``__init__``).

VTLN frequency-warping functions for mel filterbank construction.

Reimplements the reference's pluggable warp module set (``src/fe_warp.c``
dispatch; ``fe_warp_inverse_linear.c``, ``fe_warp_affine.c``,
``fe_warp_piecewise_linear.c``) with exact float32 arithmetic.  A warp
is applied inside ``fe_mel``/``fe_melinv`` (fe_sigproc.c:70-83):
linear frequency -> warped frequency before the mel transform, and
mel-inverted frequency -> unwarped before placing filters on the grid.

All three reference implementations are neutral (identity) when no
parameter string is supplied (set_parameters with NULL, e.g.
fe_warp_affine.c:93-97), so the default config (warp_type
"inverse_linear", warp_params None) gives the identity used by the
stock models.
"""

from __future__ import annotations

import numpy as np

WARP_TYPES = ("inverse_linear", "affine", "piecewise_linear")


def _f32(x) -> np.float32:
    return np.float32(x)


class Warp:
    """Parsed warp function.

    type semantics (doc strings from the reference):
      inverse_linear :  w' = x / a            (fe_warp_inverse_linear.c)
      affine         :  w' = a * x + b        (fe_warp_affine.c)
      piecewise_linear: w' = a * x, x < F; line through (F, aF), (N, N)
                        above (fe_warp_piecewise_linear.c:141-159)
    """

    def __init__(self, warp_type: str = "inverse_linear",
                 warp_params: str | None = None,
                 sampling_rate: float = 16000.0):
        if warp_type not in WARP_TYPES:
            # fe_warp_set unknown id -> FE_START_ERROR (fe_warp.c:75-90)
            raise ValueError(f"Unknown warp type {warp_type!r}")
        self.warp_type = warp_type
        self.nyquist = _f32(_f32(sampling_rate) / np.float32(2.0))
        self.neutral = warp_params is None
        # atof -> double -> (float) cast per token, missing params are 0
        toks = (warp_params or "").split()
        n_param = 1 if warp_type == "inverse_linear" else 2
        params = [np.float32(0.0)] * n_param
        for i, t in enumerate(toks[:n_param]):
            params[i] = _f32(float(t))
        self.params = params
        if not self.neutral and params[0] == 0:
            # zero slope -> warping not applied (e.g. affine.c:130-134)
            self.neutral = True
        self.final_piece = [np.float32(0.0), np.float32(0.0)]
        if warp_type == "piecewise_linear" and not self.neutral:
            a, F = params
            if float(F) < sampling_rate:
                if F == 0:
                    # reference uses sampling_rate (not Nyquist) * 0.85
                    # (fe_warp_piecewise_linear.c:148-150)
                    F = _f32(_f32(sampling_rate) * np.float32(0.85))
                    self.params[1] = F
                N = self.nyquist
                self.final_piece[0] = _f32(
                    _f32(N - _f32(a * F)) / _f32(N - F))
                self.final_piece[1] = _f32(
                    _f32(_f32(N * F) * _f32(a - np.float32(1.0)))
                    / _f32(N - F))

    def unwarped_to_warped(self, linear: np.float32) -> np.float32:
        if self.neutral:
            return _f32(linear)
        a = self.params[0]
        if self.warp_type == "inverse_linear":
            # nonlinear = a / linear [sic: doc]; code is linear / a
            # (fe_warp_inverse_linear.c:152-160)
            return _f32(_f32(linear) / a)
        if self.warp_type == "affine":
            return _f32(_f32(_f32(linear) * a) + self.params[1])
        # piecewise_linear (fe_warp_piecewise_linear.c:184-198)
        if float(linear) < float(self.params[1]):
            return _f32(_f32(linear) * a)
        return _f32(_f32(self.final_piece[0] * _f32(linear))
                    + self.final_piece[1])

    def warped_to_unwarped(self, nonlinear: np.float32) -> np.float32:
        if self.neutral:
            return _f32(nonlinear)
        a = self.params[0]
        if self.warp_type == "inverse_linear":
            return _f32(_f32(nonlinear) * a)
        if self.warp_type == "affine":
            return _f32(_f32(_f32(nonlinear) - self.params[1]) / a)
        # piecewise_linear (fe_warp_piecewise_linear.c:161-182)
        if float(nonlinear) < float(_f32(a * self.params[1])):
            return _f32(_f32(nonlinear) / a)
        return _f32(_f32(_f32(nonlinear) - self.final_piece[1])
                    / self.final_piece[0])
