"""The port's plain path at the published en-us width against the JAX-made
golden of the acoustic-model backends
(tests/golden/torch-synth/backends.json and .npz,
tools/make_torch_backends_golden.py): every variant's full-inventory
int16 scores, and the rows of the sets the CPU affords (ptm4b and
semi4b same-transcript, semi4b on its union, ms same-transcript).  The
card runs every set (chip_smoke.py, tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from _torch_synth import segs_rep, variant_dir
from make_torch_backends_golden import (dense_feats, load_backends_golden,
                                        run_set)

from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.ops import senscore_torch as st

torch.set_num_threads(1)

# variant -> the golden's sets run here, in the golden's order
CPU_SETS = {"ptm4b": ("same",), "semi": (), "semi4b": ("same", "union"),
            "ms": ("same",)}


@pytest.fixture(scope="module")
def golden():
    return load_backends_golden()


@pytest.mark.parametrize("variant", sorted(CPU_SETS))
def test_backend_matches_golden(tmp_path_factory, golden, variant):
    al = TorchAligner(hmm=variant_dir(tmp_path_factory, variant, "en-us"),
                      samprate=golden["samprate"], device="cpu")
    got = st.score_frames(al.dense, torch.from_numpy(dense_feats())).numpy()
    want = golden[f"{variant}_dense"]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for name in CPU_SETS[variant]:
        rows = [segs_rep(r) for r in run_set(al, variant, name,
                                              golden["texts"])]
        assert rows == golden[variant][name], name
