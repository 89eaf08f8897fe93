"""Golden results of the JAX aligner's mixed-transcript paths on the
synthetic en-us-width model.

Writes ``tests/golden/torch-synth/mixed_segs.json``: for 32 transcripts
of 3-9 words drawn from the synthetic dictionary's base words with
``numpy.random.RandomState(0)`` (``mixed_texts``), over the audio
``austen_audio(i % 8)``, the results of one fresh
``soundswallower_tpu.aligner.TpuAligner`` (JAX, CPU) on
``make_synth_model(width="en-us", seed=0)``, in this order:

1. ``union``: ``align_batch`` on the 32 rows, on the working-set union
   scorer that these rows build (462 senones, 512 columns);
2. ``dense``: ``align_batch`` on the 32 rows with the union forced to
   the full-inventory scorer (``_uni["dense"] = True``);
3. ``scored``: ``align_batch_scored`` on the 32 rows, with word and
   phone scores.

The PyTorch port is held to them on the CPU (tests/test_torch_mixed.py)
and on the GPU (chip_smoke.py), which run the three in the same order.
The helpers import neither JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_mixed_golden.py``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from make_synth_model import WORDS
from make_torch_synth_golden import REPO, SAMPRATE, austen_audio, segs_rep

MIXED_GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth",
                            "mixed_segs.json")
N_MIXED = 32
SEED = 0
SETS = ("union", "dense", "scored")


def mixed_texts(n: int = N_MIXED, seed: int = SEED) -> list[str]:
    """n transcripts of 3-9 words from the dictionary's base words."""
    base = [w for w, _ in WORDS if "(" not in w]
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(base, rng.randint(3, 10))) for _ in range(n)]


def mixed_audio(i: int) -> np.ndarray:
    return austen_audio(i % 8)


def scored_rep(segs):
    """WordSeg list -> [[word, start, dur, score, [[ci, start, dur,
    score]]]] (None for a failed utterance)."""
    if segs is None:
        return None
    return [[s.word, int(s.start), int(s.duration), int(s.score),
             [[p[0], int(p[1]), int(p[2]), int(p[3])] for p in s.phones]]
            for s in segs]


def load_mixed_golden() -> dict:
    with open(MIXED_GOLDEN) as fh:
        return json.load(fh)


def main() -> None:
    sys.path.insert(0, REPO)
    from make_synth_model import make_synth_model

    from soundswallower_tpu.aligner import TpuAligner

    texts = mixed_texts()
    audios = [mixed_audio(i) for i in range(N_MIXED)]
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, seed=0, width="en-us")
        al = TpuAligner(hmm=d, samprate=SAMPRATE)
        union = al.align_batch(audios, texts)
        al._uni["dense"] = True
        dense = al.align_batch(audios, texts)
        scored = al.align_batch_scored(audios, texts)
    head = json.dumps({"model": {"width": "en-us", "seed": 0},
                       "samprate": SAMPRATE, "seed": SEED,
                       "audio": "austen_audio(i % 8)", "texts": texts})
    with open(MIXED_GOLDEN, "w") as fh:   # one utterance per line
        fh.write(head[:-1])
        for name, out, rep in (("union", union, segs_rep),
                               ("dense", dense, segs_rep),
                               ("scored", scored, scored_rep)):
            fh.write(f', "{name}": [\n')
            fh.write(",\n".join(json.dumps(rep(s)) for s in out))
            fh.write("\n]")
        fh.write("}\n")


if __name__ == "__main__":
    main()
