"""The port's public surface against the JAX package on the CPU: VAD,
endpointer, audio I/O, the CLI and the package's exports.

``Vad`` on the in-repo WebRTC goldens (tests/golden/vad/synth*, the C
reference's decisions) and against the JAX ``Vad``; ``Endpointer``
against the JAX one on synth8000.raw; ``utils.native_io`` on a WAV and
a raw file, native and with the Python fallback; the CLI's fast path and
``--exact`` against the JAX CLI's output lines on the small synthetic
model (wide beams for the exact path, whose default beams prune the
small model's search); ``__init__``'s names.
"""

import os
import wave

import numpy as np
import pytest
import torch

from _torch_synth import SAMPRATE, austen_audio, model_dir
from make_torch_api_golden import cli_results
from make_torch_synth_golden import REPO

import soundswallower_tpu as jpkg
import soundswallower_tpu_torch as pkg
from soundswallower_tpu import cli as jcli
from soundswallower_tpu.endpointer import Endpointer as JaxEndpointer
from soundswallower_tpu.utils import native_io as jio
from soundswallower_tpu.vad import Vad as JaxVad
from soundswallower_tpu_torch import cli
from soundswallower_tpu_torch.endpointer import Endpointer
from soundswallower_tpu_torch.utils import native_io
from soundswallower_tpu_torch.vad import Vad
from soundswallower_tpu_torch.webrtc_vad import VadCore

torch.set_num_threads(1)

VADG = os.path.join(REPO, "tests", "golden", "vad")
VAD_CASES = [(rate, mode) for rate in (8000, 32000, 48000) for mode in (0, 3)]
WIDE = ("-s", "beam=1e-200", "-s", "pbeam=1e-200", "-s", "wbeam=1e-200")


def _synth(rate: int) -> np.ndarray:
    return np.fromfile(os.path.join(VADG, f"synth{rate}.raw"), np.int16)


@pytest.mark.parametrize("rate,mode", VAD_CASES)
def test_vad_equals_golden_and_reference(rate, mode):
    """Per-frame decisions of 30 ms frames: VadCore against the C
    reference's dump, Vad.classify against the JAX Vad's."""
    raw = _synth(rate)
    n = rate * 30 // 1000
    gold = np.fromfile(os.path.join(VADG, f"synth{rate}-r{rate}-m{mode}-f30",
                                    "decisions.u8"), np.uint8)
    core = VadCore(mode)
    got = np.array([core.process(rate, raw[i * n:(i + 1) * n])
                    for i in range(len(gold))], np.uint8)
    assert np.array_equal(got, gold) and gold.any() and not gold.all()
    port, ref = Vad(mode, rate), JaxVad(mode, rate)
    assert port.frame_size == ref.frame_size == n
    frames = [raw[i:i + n] for i in range(0, len(raw) - n + 1, n)]
    assert [port.classify(f) for f in frames] == \
        [ref.classify(f) for f in frames]


@pytest.mark.parametrize("rate,frame_length", [(44100, 0.03), (11025, 0.0),
                                               (16000, 0.0301), (2000, 0.03)])
def test_vad_sizing_equals_reference(rate, frame_length):
    """ps_vad.c's closest-supported-rate sizing, and its refusals."""
    try:
        want = JaxVad(0, rate, frame_length)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            Vad(0, rate, frame_length)
        return
    got = Vad(0, rate, frame_length)
    assert (got.frame_size, got.frame_length) == \
        (want.frame_size, want.frame_length)


def _endpoint(ep, raw):
    n = ep.frame_size
    out = []
    full = len(raw) // n
    for i in range(full):
        pcm = ep.process(raw[i * n:(i + 1) * n])
        out.append((None if pcm is None else pcm.tolist(), ep.in_speech,
                    ep.speech_start, ep.speech_end))
    pcm = ep.end_stream(raw[full * n:])
    out.append((None if pcm is None else pcm.tolist(), ep.in_speech,
                ep.speech_start, ep.speech_end))
    return out


@pytest.mark.parametrize("window,ratio,mode", [(0.3, 0.9, 0), (0.5, 0.6, 3)])
def test_endpointer_equals_reference(window, ratio, mode):
    """Every frame's returned audio, in_speech and timestamps, and the
    end of the stream, on synth8000.raw."""
    raw = _synth(8000)
    got = _endpoint(Endpointer(window, ratio, mode, 8000), raw)
    want = _endpoint(JaxEndpointer(window, ratio, mode, 8000), raw)
    assert got == want
    assert any(p is not None for p, *_ in got)


@pytest.mark.parametrize("native", [True, False])
def test_native_io_equals_reference(tmp_path, monkeypatch, native):
    """read_audio on a WAV and a raw file, pack_batch, with the shared
    library and with the Python fallback."""
    a = austen_audio(0)[:5000]
    wav, raw = str(tmp_path / "a.wav"), str(tmp_path / "a.raw")
    with wave.open(wav, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(SAMPRATE)
        fh.writeframes(a.tobytes())
    a.tofile(raw)
    if not native:
        for mod in (native_io, jio):
            monkeypatch.setattr(mod, "_lib", lambda: None)
    elif native_io._lib() is None:
        pytest.skip("native io library not built")
    for path, rate in ((wav, SAMPRATE), (raw, None)):
        s, r = native_io.read_audio(path)
        w, q = jio.read_audio(path)
        assert r == q == rate and np.array_equal(s, w) and np.array_equal(s, a)
    utts = [a[:100], a[:3000], a]
    for n in (None, 2000):
        got, want = native_io.pack_batch(utts, n), jio.pack_batch(utts, n)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    return model_dir(tmp_path_factory, "small")


def test_cli_equals_reference(small_dir, tmp_path):
    """The CLI on two raw files, the fast path (TorchAligner) and
    --exact (Decoder), with --phone-align: the port's output lines equal
    the JAX CLI's."""
    got = cli_results(lambda argv: cli.main(argv, device="cpu"), small_dir,
                      str(tmp_path), WIDE)
    want = cli_results(jcli.main, small_dir, str(tmp_path), WIDE)
    assert got == want
    assert len(got["fast"]) == len(got["exact"]) == 2


def test_cli_writes_config_and_defaults_to_the_card(small_dir, tmp_path,
                                                    capsys, monkeypatch):
    """--write-config's JSON equals the JAX CLI's; without a card the
    command line's default device raises, on both paths."""
    monkeypatch.setenv("SOUNDSWALLOWER_MODEL_DIR", os.path.dirname(small_dir))
    out = []
    for main in (cli.main, jcli.main):
        main(["--model", small_dir, "--write-config", "-"])
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and small_dir in out[0]
    if torch.cuda.is_available():
        return
    f = str(tmp_path / "a.raw")
    austen_audio(0).tofile(f)
    for exact in ([], ["--exact"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([*exact, "-t", "he", "--model", small_dir, f])


def test_exports_equal_reference(tmp_path, monkeypatch):
    """__all__ with TorchAligner in the place of TpuAligner; every name
    resolves to the port's own class; the named tuples, get_audio_data
    and get_model_path behave as the JAX package's."""
    assert set(pkg.__all__) == \
        set(jpkg.__all__) - {"TpuAligner"} | {"TorchAligner"}
    for name in pkg.__all__:
        obj = getattr(pkg, name)
        mod = getattr(obj, "__module__", "") or ""
        assert mod.startswith("soundswallower_tpu_torch"), (name, mod)
    from soundswallower_tpu_torch.decoder import Decoder
    assert pkg.Decoder is Decoder
    for name in ("Arg", "Seg", "Hyp"):
        assert getattr(pkg, name)._fields == getattr(jpkg, name)._fields
    with pytest.raises(AttributeError):
        pkg.TpuAligner
    f = str(tmp_path / "a.raw")
    austen_audio(0)[:800].tofile(f)
    assert pkg.get_audio_data(f) == jpkg.get_audio_data(f)
    monkeypatch.setenv("SOUNDSWALLOWER_MODEL_DIR", str(tmp_path))
    assert pkg.get_model_path("en-us") == jpkg.get_model_path("en-us") == \
        os.path.join(str(tmp_path), "en-us")
