"""The port's package boundary: no JAX, shared host modules, FE tables.

The PyTorch port (soundswallower_tpu_torch) must import and run where
jax is absent; its host modules come from the JAX package's own files
through the shared loader; its numpy front-end tables equal the JAX
package's.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from soundswallower_tpu.fe.frontend import Frontend as JaxFrontend
from soundswallower_tpu_torch import _shared
from soundswallower_tpu_torch.fe.frontend import Frontend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "soundswallower_tpu_torch")


def test_port_imports_without_jax(tmp_path):
    """Importing the port, and running its mixed and scored paths (where
    stack_graphs is the port's own: the shared one imports align_jax at
    call time), a stream, a spectrogram, and the device front end's batch
    and single-utterance paths, leaves jax and the JAX package
    unloaded."""
    code = f"""
import os
import sys
sys.path.insert(0, {os.path.join(REPO, "tools")!r})
import torch
torch.set_num_threads(1)
import soundswallower_tpu_torch.aligner
import soundswallower_tpu_torch.serve
from make_synth_model import make_synth_model
from make_torch_synth_golden import SAMPRATE, TEXT, austen_audio
d = make_synth_model({str(tmp_path)!r}, seed=0, width="small")
al = soundswallower_tpu_torch.aligner.TorchAligner(
    hmm=d, samprate=SAMPRATE, device="cpu")
audios = [austen_audio(i) for i in range(3)]
texts = [TEXT, "young man", "he was not"]
assert all(s is not None for s in al.align_batch(audios, texts))
assert al._uni["gs"] is not None
assert all(s is not None for s in al.align_batch_scored(audios, texts))
st = al.stream(TEXT)
for i in range(0, len(audios[0]), 1600):
    st.push(audios[0][i:i + 1600])
assert st.end() and st.state()["ended"]
assert al.spectrogram(audios[0], smooth=True).shape[1] == al.fe.num_filters
os.environ["SST_FE"] = "device"
dal = soundswallower_tpu_torch.aligner.TorchAligner(
    hmm=d, samprate=SAMPRATE, device="cpu")
assert dal.native_fe is None
assert all(s is not None for s in dal.align_batch(audios, texts))
assert dal.align(audios[0], TEXT)
assert 'jax' not in sys.modules, 'jax was imported'
assert 'soundswallower_tpu' not in sys.modules
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import|from) jax")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "make_synth_model.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f"{f}:{i + 1}" for f in files
                 for i, line in enumerate(open(f, encoding="utf-8"))
                 if pat.match(line)]
    assert not offenders, offenders


def test_shared_modules_are_the_reference_files():
    """Loaded, not copied: each shared module's file is the JAX
    package's, under the port's own module name."""
    for name in ("config", "logmath", "s3file", "mdef", "dictionary",
                 "dict2pid", "am", "fe.warp", "fe.native_fe", "fe.cmn_live",
                 "utils.native_build", "ops.align_graph", "serve"):
        mod = _shared.load(name)
        assert mod.__name__ == f"soundswallower_tpu_torch.ref.{name}"
        want = os.path.join(REPO, "soundswallower_tpu",
                            *name.split(".")) + ".py"
        assert os.path.samefile(mod.__file__, want)


FE_TABLES = ("_window", "_ccc", "_sss", "_perm", "_spec_start", "_widths",
             "_coeff_mat", "_mel_cosine", "_lifter", "_maxw", "_sqrt_inv_n",
             "_sqrt_inv_2n", "frame_shift", "frame_size", "fft_size")


@pytest.mark.parametrize("rate", [8000, 16000])
def test_fe_tables_equal_reference(rate):
    # the en-us front end (tests/test_fe.py:_fe_8k_band)
    kw = dict(sampling_rate=rate, num_filters=20, lower_filt_freq=130,
              upper_filt_freq=3700, transform="dct", lifter_val=22,
              remove_noise=True)
    port, ref = Frontend(**kw), JaxFrontend(**kw)
    for name in FE_TABLES:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a == b).all(), name
    for n in (0, 1, 160, 409, 410, 23920, 44580):
        assert port.n_frames(n) == ref.n_frames(n)
