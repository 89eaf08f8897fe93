"""MLLR adaptation: transform file reading + mean/variance transform.

Reimplements ``src/ps_mllr.c`` (mllr_read, :47-130: text file of per-
stream per-class rotation A, bias b, variance scale h) and
``gauden_mllr_transform`` (ms_gauden.c:460-539: reload raw means/vars,
mean' = A.mean + b in float64 rounded to float32, var' = var * h, then
re-run the distance precompute).
"""

from __future__ import annotations

import numpy as np

from . import s3file as s3
from .am import AcousticModel, precompute_gauden


class Mllr:
    def __init__(self, path: str):
        with open(path) as fh:
            toks = fh.read().split()
        it = iter(toks)

        def rd():
            return next(it)

        self.n_class = int(rd())
        self.n_feat = int(rd())
        self.veclen = []
        self.A = []  # [feat][class][l][m] float32
        self.b = []  # [feat][class][l]
        self.h = []  # [feat][class][l]
        for f in range(self.n_feat):
            n = int(rd())
            self.veclen.append(n)
            A = np.zeros((self.n_class, n, n), np.float32)
            b = np.zeros((self.n_class, n), np.float32)
            h = np.zeros((self.n_class, n), np.float32)
            for m in range(self.n_class):
                for j in range(n):
                    for k in range(n):
                        A[m, j, k] = np.float32(rd())
                for j in range(n):
                    b[m, j] = np.float32(rd())
                for j in range(n):
                    h[m, j] = np.float32(rd())
            self.A.append(A)
            self.b.append(b)
            self.h.append(h)


def apply_mllr(am: AcousticModel, mllr: Mllr, config) -> None:
    """gauden_mllr_transform: reload raw parameters, apply the class-0
    transform, re-precompute, and refresh the model arrays in place."""
    means, n_mgau, n_feat, n_density, veclen = s3.read_gauden_params(
        config["mean"])
    variances, _, _, _, _ = s3.read_gauden_params(config["var"])
    if n_feat != mllr.n_feat:
        raise ValueError("MLLR feature stream count mismatch")
    for f in range(n_feat):
        L = veclen[f]
        if mllr.veclen[f] != L:
            raise ValueError("MLLR stream length mismatch")
        A = mllr.A[f][0].astype(np.float64)   # [L, L]
        b = mllr.b[f][0].astype(np.float64)
        h = mllr.h[f][0].astype(np.float32)
        mu = means[:, f, :, :L].astype(np.float64)       # [cb, D, L]
        mu_t = np.einsum("lm,cdm->cdl", A, mu) + b[None, None, :]
        means[:, f, :, :L] = mu_t.astype(np.float32)
        variances[:, f, :, :L] = (variances[:, f, :, :L] * h[None, None, :])
    det, var_t = precompute_gauden(means, variances,
                                   config.get_float("varfloor"), am.lmath)
    am.means = means
    am.var_t = var_t
    am.det = det
