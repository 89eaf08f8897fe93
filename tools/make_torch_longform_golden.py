"""Golden results of the JAX aligner for the long form and for the
configurations the port once ignored, on the synthetic en-us-width model.

Writes ``tests/golden/torch-synth/longform.json``: what
``soundswallower_tpu.aligner.TpuAligner`` (JAX, CPU) gives on
``make_synth_model(width="en-us", seed=0)``:

* ``longform``: ``align_longform_batch`` on an 8-device ('seq',) mesh of
  virtual CPU devices, on ``LONG_B`` rows ``longform_audio(i)`` (AUSTEN
  tiled ``LONG_K`` times, past 60 s, rows of different lengths) against
  their one transcript ``longform_text()``;
* ``mxu``: ``align_batch`` and ``align_batch_scored`` with
  ``dist_mode="mxu"`` on the 8 utterances ``austen_audio(i)`` and TEXT;
* ``wire_f32``: under ``SST_WIRE=f32``, ``align_batch`` on the 8
  against TEXT and against ``MIXED`` (8 different transcripts, a fresh
  union), and ``align_batch_scored`` against TEXT;
* ``remove_dc``: ``TpuAligner(remove_dc=True)`` (the device front end):
  ``align_batch`` on the 8 ``dc_audio(i)``, ``align`` on
  ``dc_audio(0)`` and the sha256 of ``spectrogram(dc_audio(0))``'s
  float32 bytes.

The PyTorch port is held to them on the GPU (chip_smoke.py).  The
helpers import neither JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_longform_golden.py``
(about two minutes on 8 CPU cores).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

from make_torch_mixed_golden import scored_rep
from make_torch_synth_golden import (N_UTT, REPO, SAMPRATE, TEXT,
                                     austen_audio, segs_rep)

GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth",
                      "longform.json")
LONG_K = 21        # AUSTEN repeats of a long-form row: ~62.8 s at 8 kHz
LONG_B = 4
N_SEQ = 8
MIXED = [TEXT, "young man", "he was not", "an ill man", "was not young",
         "ill disposed man", "he was an ill man", "not young"]


def longform_text(k: int = LONG_K) -> str:
    return " ".join([TEXT] * k)


def longform_audio(i: int, k: int = LONG_K) -> np.ndarray:
    """Row i of the long form: austen_audio(i) (its own dither and
    length) tiled k times."""
    return np.tile(austen_audio(i), k)


def dc_audio(i: int) -> np.ndarray:
    """austen_audio(i) with a DC offset of 500 * (i + 1), so that the
    frame mean of remove_dc matters."""
    a = austen_audio(i).astype(np.int32) + 500 * (i + 1)
    return np.clip(a, -32768, 32767).astype(np.int16)


def spec_sha(spec: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(spec, np.float32)
                          .tobytes()).hexdigest()


def load_longform_golden() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def main() -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count"
                               f"={N_SEQ}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", N_SEQ)
    sys.path.insert(0, REPO)
    from make_synth_model import make_synth_model

    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.parallel.seqpipe import seq_mesh

    audios = [austen_audio(i) for i in range(N_UTT)]
    out: dict = {"model": {"width": "en-us", "seed": 0},
                 "samprate": SAMPRATE, "text": TEXT, "long_k": LONG_K,
                 "long_b": LONG_B, "nseq": N_SEQ, "mixed_texts": MIXED}
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, seed=0, width="en-us")
        al = TpuAligner(hmm=d, samprate=SAMPRATE)
        rows = [longform_audio(i) for i in range(LONG_B)]
        out["longform"] = [segs_rep(s) for s in al.align_longform_batch(
            rows, [longform_text()] * LONG_B, mesh=seq_mesh(N_SEQ))]
        out["mxu"] = dict(
            same=[segs_rep(s) for s in al.align_batch(
                audios, [TEXT] * N_UTT, "mxu")],
            scored=[scored_rep(s) for s in al.align_batch_scored(
                audios, [TEXT] * N_UTT, "mxu")])
        os.environ["SST_WIRE"] = "f32"
        al = TpuAligner(hmm=d, samprate=SAMPRATE)
        out["wire_f32"] = dict(
            same=[segs_rep(s) for s in al.align_batch(
                audios, [TEXT] * N_UTT)],
            mixed=[segs_rep(s) for s in al.align_batch(audios, MIXED)],
            scored=[scored_rep(s) for s in al.align_batch_scored(
                audios, [TEXT] * N_UTT)])
        del os.environ["SST_WIRE"]
        al = TpuAligner(hmm=d, samprate=SAMPRATE, remove_dc=True)
        assert al.native_fe is None
        dc = [dc_audio(i) for i in range(N_UTT)]
        out["remove_dc"] = dict(
            same=[segs_rep(s) for s in al.align_batch(dc, [TEXT] * N_UTT)],
            align=segs_rep(al.align(dc[0], TEXT)),
            spectrogram_sha256=spec_sha(al.spectrogram(dc[0])))
    with open(GOLDEN, "w") as fh:   # one section per line
        fh.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                    for k, v in out.items()) + "\n}\n")


if __name__ == "__main__":
    main()
