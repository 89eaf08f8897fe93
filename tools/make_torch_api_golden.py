"""Golden results of the JAX package's public API on the synthetic
en-us-width model: YIN, the exact Decoder, the CLI and MLLR.

Writes ``tests/golden/torch-synth/api.json``: what the JAX package
(CPU) gives on ``make_synth_model(width="en-us", seed=0)`` at 8 kHz:

* ``pitch``: ``pitch_batch`` and ``cmnd_batch`` on the frames of
  ``tests/golden/austen.raw`` (``API_FRAMES`` samples, shift
  ``FRAME_SHIFT``): the periods, the best values' float32 bits and the
  sha256 of the CMND's float32 bytes;
* ``decoder``: the exact ``Decoder`` (``decoder_results``): the
  transcript through ``set_align_text`` on ``austen_audio(0)`` (its
  hypothesis, segments and ``result_json`` at align levels 0-2), the
  decode grammar ``GRAMMAR`` through ``set_jsgf_string`` on
  ``austen_audio(1)`` (hypothesis, segments, the first ``N_BEST`` of
  ``nbest``), and a live decode of ``austen_audio(2)`` in 1,600-sample
  pieces (hypothesis, ``result_json``, ``get_cmn``);
* ``cli``: the CLI on two raw files (``cli_results``), the fast path
  and ``--exact``, both with ``--phone-align``: its output lines;
* ``mllr``: an aligner after ``update_mllr`` with the transform of
  ``tools/make_mllr.py`` (``mllr_results``): ``align_batch`` and
  ``align_batch_scored`` on the 8 austen rows of one transcript.

The scenario functions take the package's classes as arguments, so the
PyTorch port runs the same calls: on the CPU in
``tests/test_torch_decoder.py``/``test_torch_api.py``/``test_torch_mllr.py``
against the JAX package directly, on the GPU in ``chip_smoke.py``
against this file.  The helpers import neither JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_api_golden.py``
(about 2 minutes on one CPU core).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import os
import sys
import tempfile

import numpy as np

from make_mllr import make_mllr
from make_torch_decode_golden import GRAMMAR, N_BEST
from make_torch_mixed_golden import scored_rep
from make_torch_synth_golden import (N_UTT, REPO, SAMPRATE, TEXT,
                                     austen_audio, segs_rep)

GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth", "api.json")
API_FRAMES = (400, 200)      # YIN frame sizes (samples)
FRAME_SHIFT = 160
LIVE_PIECE = 1600            # samples per process_raw call of the live decode
CLI_ROWS = (0, 3)            # austen_audio rows the CLI reads, as raw files


def austen_frames(frame_size: int) -> np.ndarray:
    """int16 [N, frame_size]: the frames of austen.raw, FRAME_SHIFT
    apart."""
    a = np.fromfile(os.path.join(REPO, "tests", "golden", "austen.raw"),
                    np.int16)
    return np.stack([a[p:p + frame_size] for p in
                     range(0, len(a) - frame_size + 1, FRAME_SHIFT)])


def pitch_rep(cmnd, period, best) -> dict:
    """YIN results (numpy) as JSON: periods, best float32 bits, the
    CMND's sha256."""
    cmnd = np.ascontiguousarray(np.asarray(cmnd, np.float32))
    return dict(period=[int(p) for p in np.asarray(period)],
                period_dtype=str(np.asarray(period).dtype),
                best_bits=[int(b) for b in
                           np.asarray(best, np.float32).view(np.int32)],
                cmnd_sha256=hashlib.sha256(cmnd.tobytes()).hexdigest())


def _hyp(hyp) -> list:
    return [hyp.text, hyp.score, hyp.prob]


def _segs(segs) -> list:
    return [[s.text, s.start, s.duration, s.ascore, s.lscore] for s in segs]


def _decode(dec, audio) -> None:
    dec.start_utt()
    dec.process_raw(audio)
    dec.end_utt()


def decoder_results(Decoder, model_dir: str, audio=austen_audio,
                    text: str = TEXT, **kw) -> dict:
    """The exact Decoder's scenario (the module docstring's ``decoder``)
    on ``audio(i)`` and ``text``; ``kw`` are the Decoder's extra
    arguments (the port's ``device``, beams)."""
    dec = Decoder(hmm=model_dir, samprate=SAMPRATE, **kw)
    dec.set_align_text(text)
    _decode(dec, audio(0))
    out = dict(align=dict(hyp=_hyp(dec.hyp), seg=_segs(dec.seg),
                          json=[dec.result_json(align_level=lv)
                                for lv in (0, 1, 2)]))
    dec.set_jsgf_string(GRAMMAR)
    _decode(dec, audio(1))
    out["grammar"] = dict(
        hyp=_hyp(dec.hyp), seg=_segs(dec.seg),
        nbest=[[h, int(s)] for h, s in itertools.islice(dec.nbest(),
                                                         N_BEST)])
    dec.set_align_text(text)
    a = audio(2)
    dec.start_utt()
    for i in range(0, len(a), LIVE_PIECE):
        dec.process_raw(a[i:i + LIVE_PIECE], full_utt=False)
    dec.end_utt()
    out["live"] = dict(hyp=_hyp(dec.hyp), json=dec.result_json(),
                       cmn=dec.get_cmn())
    return out


def cli_results(main, model_dir: str, tmp: str, extra=()) -> dict:
    """The CLI's output lines on the CLI_ROWS raw files, on the fast path
    and with ``--exact`` (``--phone-align``): ``main(argv)`` is the CLI's
    entry, the model found through SOUNDSWALLOWER_MODEL_DIR; ``extra``
    are more arguments (``-s key=value``)."""
    files = []
    for i in CLI_ROWS:
        f = os.path.join(tmp, f"austen{i}.raw")
        austen_audio(i).tofile(f)
        files.append(f)
    root, name = os.path.split(os.path.abspath(model_dir))
    prev = os.environ.get("SOUNDSWALLOWER_MODEL_DIR")
    os.environ["SOUNDSWALLOWER_MODEL_DIR"] = root
    out = {}
    try:
        for mode in ("fast", "exact"):
            argv = ["-t", TEXT, "--phone-align", "--model", name,
                    "-s", f"samprate={SAMPRATE}", *extra, *files]
            if mode == "exact":
                argv.insert(0, "--exact")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv)
            out[mode] = buf.getvalue().splitlines()
    finally:
        if prev is None:
            os.environ.pop("SOUNDSWALLOWER_MODEL_DIR", None)
        else:
            os.environ["SOUNDSWALLOWER_MODEL_DIR"] = prev
    return out


def mllr_results(Aligner, model_dir: str, mllr_path: str, **kw) -> dict:
    """An aligner's same-transcript batch after ``update_mllr``: segments
    of ``align_batch`` and ``align_batch_scored`` (scores included) on
    the 8 austen rows."""
    al = Aligner(hmm=model_dir, samprate=SAMPRATE, **kw)
    al.update_mllr(mllr_path)
    audios = [austen_audio(i) for i in range(N_UTT)]
    return dict(same=[segs_rep(s) for s in
                      al.align_batch(audios, [TEXT] * N_UTT)],
                scored=[scored_rep(s) for s in
                        al.align_batch_scored(audios, [TEXT] * N_UTT)])


def mllr_file(tmp: str) -> str:
    """tools/make_mllr.py's transform for the synthetic model's 3
    streams of 13, written under ``tmp``."""
    with contextlib.redirect_stdout(io.StringIO()):
        return make_mllr(os.path.join(tmp, "mllr"), 3, 13)


def load_api_golden() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def main() -> None:
    sys.path.insert(0, REPO)
    from make_synth_model import make_synth_model

    import jax.numpy as jnp

    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.cli import main as cli_main
    from soundswallower_tpu.decoder import Decoder
    from soundswallower_tpu.yin import cmnd_batch, pitch_batch

    out = {"model": {"width": "en-us", "seed": 0}, "samprate": SAMPRATE,
           "text": TEXT, "pitch": {}}
    for F in API_FRAMES:
        fr = jnp.asarray(austen_frames(F))
        out["pitch"][str(F)] = pitch_rep(cmnd_batch(fr), *pitch_batch(fr))
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "en-us-synth")
        make_synth_model(d, seed=0, width="en-us")
        out["decoder"] = decoder_results(Decoder, d)
        out["cli"] = cli_results(cli_main, d, tmp)
        out["mllr"] = mllr_results(TpuAligner, d, mllr_file(tmp))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
