"""The port's VTLN warps in the mel filterbank (fe/warp.py through
fe/frontend.py build_melfilters) against the C reference's filter dumps
(tests/golden/warp/melfb_*.txt): each filter's first bin, width and
float32 coefficients, exactly, as tests/test_fe.py holds the JAX
package's."""

import os

import numpy as np
import pytest

from soundswallower_tpu_torch.fe.frontend import Frontend, build_melfilters
from soundswallower_tpu_torch.fe.warp import Warp

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
WARPS = [("affine", "1.2 150"), ("piecewise", "0.9"), ("inverse", "0.95")]
WARP_TYPE = {"affine": "affine", "piecewise": "piecewise_linear",
             "inverse": "inverse_linear"}


def _golden(name: str):
    """[(filter, start, width, coefficients float32)] of one dump."""
    out = []
    for line in open(os.path.join(GOLDEN, "warp", f"melfb_{name}.txt")):
        head, vals = line.split(":")
        i, start, width = (int(x) for x in head.split())
        out.append((i, start, width,
                    np.array([np.float32(v) for v in vals.split()],
                             np.float32)))
    return out


@pytest.mark.parametrize("name,params", WARPS)
def test_warped_melfilters_match_reference(name, params):
    """build_melfilters with each warp at the default front end (16 kHz,
    512-point FFT, 40 filters) equals the C dump filter for filter."""
    w = Warp(WARP_TYPE[name], params, 16000)
    spec_start, widths, coeffs = build_melfilters(
        16000, 512, 40, 133.33334, 6855.4976, warp=w)
    gold = _golden(name)
    assert len(gold) == 40
    for i, start, width, cf in gold:
        assert spec_start[i] == start, f"filter {i} start"
        assert widths[i] == width, f"filter {i} width"
        assert np.array_equal(coeffs[i], cf), f"filter {i} coeffs"


@pytest.mark.parametrize("name,params", WARPS)
def test_frontend_tables_carry_the_warp(name, params):
    """A Frontend built with a warp holds the dump's filters in the
    tables its kernels read (start, width, zero-padded coefficient
    rows)."""
    fe = Frontend(sampling_rate=16000, warp_type=WARP_TYPE[name],
                  warp_params=params)
    for i, start, width, cf in _golden(name):
        assert fe._spec_start[i] == start and fe._widths[i] == width
        assert np.array_equal(fe._coeff_mat[i, :width], cf)
        assert not fe._coeff_mat[i, width:].any()
