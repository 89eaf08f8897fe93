"""Golden segments of the JAX aligner on the synthetic en-us-width model.

Writes ``tests/golden/torch-synth/segs.json``: the word and phone
segments that ``soundswallower_tpu.aligner.TpuAligner`` (JAX, CPU)
gives for 8 seeded, dithered copies of ``tests/golden/austen.raw``
against their transcript, on ``make_synth_model(width="en-us", seed=0)``.
The PyTorch port is held to these segments on the CPU
(tests/test_torch_aligner.py) and on the GPU (chip_smoke.py).

The audio helpers import neither JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_synth_golden.py``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth", "segs.json")
TEXT = "he was not an ill disposed young man"
SAMPRATE = 8000
N_UTT = 8


def austen_audio(i: int) -> np.ndarray:
    """Utterance i: austen.raw dithered by +-2 LSB (seed 100 + i) with
    37*i samples cut from the end, so lengths differ."""
    a = np.fromfile(os.path.join(REPO, "tests", "golden", "austen.raw"),
                    np.int16).astype(np.int32)
    rng = np.random.RandomState(100 + i)
    x = np.clip(a + rng.randint(-2, 3, len(a)), -32768, 32767)
    return x[: len(x) - 37 * i].astype(np.int16)


def segs_rep(segs):
    """WordSeg list -> JSON-able [[word, start, dur, [[ci, start, dur]]]]
    (None for a failed utterance)."""
    if segs is None:
        return None
    return [[s.word, int(s.start), int(s.duration),
             [[p[0], int(p[1]), int(p[2])] for p in s.phones]] for s in segs]


def load_golden() -> dict:
    with open(GOLDEN) as fh:
        return json.load(fh)


def main() -> None:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synth_model import make_synth_model

    from soundswallower_tpu.aligner import TpuAligner

    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, seed=0, width="en-us")
        al = TpuAligner(hmm=d, samprate=SAMPRATE)
        audios = [austen_audio(i) for i in range(N_UTT)]
        out = al.align_batch(audios, [TEXT] * N_UTT)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    head = json.dumps({"model": {"width": "en-us", "seed": 0},
                       "samprate": SAMPRATE, "text": TEXT})
    with open(GOLDEN, "w") as fh:   # one utterance per line
        fh.write(head[:-1] + ', "segs": [\n')
        fh.write(",\n".join(json.dumps(segs_rep(s)) for s in out))
        fh.write("\n]}\n")


if __name__ == "__main__":
    main()
