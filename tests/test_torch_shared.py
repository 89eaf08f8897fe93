"""The port's package boundary: no JAX, its own host modules, FE tables.

The PyTorch port (soundswallower_tpu_torch) must import and run where
jax is absent and read nothing of the JAX package: its host modules are
its own copies, which build the JAX package's phone graphs; its numpy
front-end tables equal the JAX package's; its entry points run on the
card unless the caller asks for the CPU.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, model_dir

from soundswallower_tpu.aligner import TpuAligner
from soundswallower_tpu.fe.frontend import Frontend as JaxFrontend
from soundswallower_tpu_torch.aligner import TorchAligner
from soundswallower_tpu_torch.fe.frontend import Frontend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "soundswallower_tpu_torch")


def test_port_imports_without_jax(tmp_path):
    """Importing the port, and running its mixed and scored paths, a
    stream, a spectrogram, the device front end's batch and
    single-utterance paths, and grammar decode (set_grammar, decode on
    both front ends, decode_batch, nbest over the history search and
    lattice), YIN (pitch_batch, the exact Yin), the exact Decoder (an
    alignment, a live decode), MLLR on the aligner and the Decoder, the
    CLI on both paths, Vad and Endpointer, and the dry run (dryrun.py:
    align_batch and the long form on a ring), leaves jax unloaded and
    reads
    no module of the JAX package: none is in sys.modules, by name or by
    file."""
    code = f"""
import os
import sys
sys.path.insert(0, {os.path.join(REPO, "tools")!r})
import torch
torch.set_num_threads(1)
import soundswallower_tpu_torch.aligner
import soundswallower_tpu_torch.serve
import soundswallower_tpu_torch.streaming
for m in ("fsg", "jsgf", "ops.decode_graph", "hmm", "lextree", "search_fsg",
          "lattice"):
    __import__("soundswallower_tpu_torch." + m)
from make_synth_model import make_synth_model
from make_torch_decode_golden import GRAMMAR
from make_torch_synth_golden import SAMPRATE, TEXT, austen_audio
d = make_synth_model({str(tmp_path)!r}, seed=0, width="small")
al = soundswallower_tpu_torch.aligner.TorchAligner(
    hmm=d, samprate=SAMPRATE, device="cpu")
al.fe.process_int16(austen_audio(0), device="cpu")
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
al.set_grammar(jsgf_string=GRAMMAR)
assert all(r is not None for r in al.decode_batch(audios))
assert al.decode(audios[0])[1]
assert next(al.nbest(audios[0]))[0]
os.environ["SST_FE"] = "device"
dal = soundswallower_tpu_torch.aligner.TorchAligner(
    hmm=d, samprate=SAMPRATE, device="cpu")
assert dal.native_fe is None
assert all(s is not None for s in dal.align_batch(audios, texts))
assert dal.align(audios[0], TEXT)
dal.set_grammar(jsgf_string=GRAMMAR)
assert dal.decode(audios[0])[1]
import contextlib
import io
import numpy as np
import soundswallower_tpu_torch as pkg
from soundswallower_tpu_torch import cli, endpointer, mllr, vad, yin
from make_mllr import make_mllr
fr = np.stack([audios[0][p:p + 400] for p in range(0, 4000, 160)])
period, best = yin.pitch_batch(fr, device="cpu")
assert period.dtype == torch.int64 and period.shape == (len(fr),)
pe = yin.Yin(400)
pe.start()
got = []
for f in fr:
    pe.write(f)
    got.append(pe.read())
pe.end()
assert got[-1] is not None
wide = dict(beam=1e-200, pbeam=1e-200, wbeam=1e-200)
dec = pkg.Decoder(hmm=d, samprate=SAMPRATE, device="cpu", **wide)
dec.set_align_text("he was not")
dec.start_utt()
for i in range(0, 9600, 1600):
    dec.process_raw(audios[0][i:i + 1600], full_utt=False)
dec.end_utt()
assert dec.hyp.text == "he was not" and dec.result_json(align_level=2)
tr = make_mllr(os.path.join({str(tmp_path)!r}, "mllr"), 3, 13)
assert mllr.Mllr(tr)
al.update_mllr(tr)
assert all(s is not None for s in al.align_batch(audios, texts))
dec.update_mllr(tr)
raw = os.path.join({str(tmp_path)!r}, "a.raw")
audios[0][:9600].tofile(raw)
os.environ["SOUNDSWALLOWER_MODEL_DIR"] = os.path.dirname(d)
for exact in ([], ["--exact"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([*exact, "-t", "he was not", "--model", d, "-s",
                  "beam=1e-200", "-s", "pbeam=1e-200", "-s", "wbeam=1e-200",
                  raw], device="cpu")
    assert '"t":"he was not"' in buf.getvalue(), buf.getvalue()
v = vad.Vad(0, SAMPRATE)
assert v.classify(audios[0][:v.frame_size]) in (True, False)
ep = endpointer.Endpointer(sample_rate=SAMPRATE)
ep.process(audios[0][:ep.frame_size])
from soundswallower_tpu_torch import dryrun
assert dryrun.dryrun_multichip(2, d, audios[0][:9600], "he was not",
                               device="cpu", samprate=SAMPRATE)
assert 'jax' not in sys.modules, 'jax was imported'
ref_dir = os.path.join({REPO!r}, "soundswallower_tpu") + os.sep
bad = [n for n, m in list(sys.modules.items())
       if n == "soundswallower_tpu" or n.startswith("soundswallower_tpu.")
       or n.startswith("soundswallower_tpu_torch.ref")
       or os.path.abspath(getattr(m, "__file__", None) or "").startswith(ref_dir)]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_no_jax_import_in_port():
    pat = re.compile(r"^\s*(import|from) (jax|soundswallower_tpu)\b(?!_torch)")
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "make_synth_model.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f"{f}:{i + 1}" for f in files
                 for i, line in enumerate(open(f, encoding="utf-8"))
                 if pat.match(line)]
    assert not offenders, offenders


HOST_MODULES = ("config", "logmath", "s3file", "mdef", "dictionary",
                "dict2pid", "am", "fe.warp", "fe.native_fe", "fe.cmn_live",
                "utils.native_build", "ops.align_graph", "serve")
# the exact Decoder's stack, MLLR, YIN, VAD, endpointer, CLI, audio I/O
API_MODULES = ("genrand", "ops.senscore", "align", "search_align", "decoder",
               "mllr", "yin", "webrtc_vad", "vad", "endpointer", "cli",
               "utils.native_io")
# the grammar and history-search copies (grammar decode, lattice, nbest)
GRAMMAR_MODULES = ("fsg", "jsgf", "ops.decode_graph", "hmm", "lextree",
                   "search_fsg", "lattice")


def test_port_modules_are_files_of_the_port():
    """Every module of the port, the host modules it once loaded from
    the JAX package included, is a file under soundswallower_tpu_torch/
    of its own name, and no shared loader is left."""
    import importlib

    names = ["aligner", "streaming", "fe.feat", "fe.frontend",
             "ops.align_torch", "ops.senscore_torch", "utils",
             "utils.cuda_build", "parallel", "parallel.seqpipe", "dryrun",
             *HOST_MODULES,
             *GRAMMAR_MODULES, *API_MODULES]
    for name in names:
        mod = importlib.import_module(f"soundswallower_tpu_torch.{name}")
        f = os.path.abspath(mod.__file__)
        assert os.path.commonpath([f, PKG]) == PKG, (name, f)
        assert os.path.splitext(os.path.relpath(f, PKG))[0].replace(
            os.sep, ".").removesuffix(".__init__") == name, (name, f)
    assert not os.path.exists(os.path.join(PKG, "_shared.py"))
    assert not any(n.startswith("soundswallower_tpu_torch.ref")
                   for n in sys.modules)


TEXTS10 = ["he was not an ill disposed young man", "young man", "he was not",
           "an ill man", "he", "was was", "disposed young man he was",
           "man an ill", "not an ill disposed", "young young man"]


def test_align_graphs_equal_across_packages(tmp_path_factory):
    """The port's own config, model, dictionary, dict2pid and graph
    builder give the JAX package's AlignGraph arrays for 10 transcripts."""
    d = model_dir(tmp_path_factory, "small")
    port = TorchAligner(hmm=d, samprate=SAMPRATE, device="cpu")
    ref = TpuAligner(hmm=d, samprate=SAMPRATE)
    fields = ("ssid", "tmatid", "senid", "edge_src", "edge_dst", "edge_pen",
              "entry_pen", "is_entry", "astart", "aend", "word_of",
              "variant_of", "pos_of", "cipid", "final_nodes")
    for text in TEXTS10:
        g, w = port.graph_for_text(text), ref.graph_for_text(text)
        for f in fields:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (text, f)
        assert list(g.wids) == list(w.wids)


@pytest.mark.parametrize("entry", ["spectrogram", "process_int16",
                                   "noise_init"])
def test_frontend_entry_points_default_to_the_card(entry):
    """Frontend's entry points run on the card unless asked for the
    CPU: without a card, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fe = Frontend(sampling_rate=SAMPRATE)
    audio = np.zeros(1600, np.int16)
    call = {"spectrogram": lambda: fe.spectrogram(audio),
            "process_int16": lambda: fe.process_int16(audio),
            "noise_init": lambda: fe.noise_init(2)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    cpu = {"spectrogram": lambda: fe.spectrogram(audio, device="cpu"),
           "process_int16": lambda: fe.process_int16(audio, device="cpu"),
           "noise_init": lambda: fe.noise_init(2, device="cpu")[0]}[entry]
    assert cpu() is not None


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
