"""The dry run: the batch and the sequence-parallel paths on one
input, on one device, whose segments must agree.

Port of ``__graft_entry__.dryrun_multichip``, on one device (an
aligner runs on one; several cards take an aligner each):

1. ``align_batch`` of n copies of the audio, through the whole
   same-transcript pipeline (front end, K1-K4, backtrace);
2. sequence parallel: ``align_longform_batch`` of two copies on a local
   ring of n ranks (``seq_ring``: the frame axis cut into n chunks, the
   Viterbi carried along the ring, K13 on the way back).

Every row of both must give the transcript's words and the same
segments.  The model directory and the audio are arguments (the JAX
entry point reads a mounted model and goforward.raw).

Usage: ``python -m soundswallower_tpu_torch.dryrun N MODEL_DIR AUDIO.raw
"TEXT" [--device cuda] [--samprate HZ]``.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from .aligner import TorchAligner
from .parallel import seq_ring


def _key(segs) -> list:
    return [(s.word, s.start, s.duration) for s in segs]


def dryrun_multichip(n_devices: int, model_dir: str, audio, text: str,
                     device="cuda", **config) -> list:
    """Both paths at n on ``audio`` (an int16 array or the path of a raw
    int16 file) against ``text``, on ``device``: align_batch of n rows
    and the long form on a ring of n ranks; AssertionError where a row
    fails, lacks the transcript's words or differs from another.
    ``config``: the aligner's other settings (``samprate``, ...).
    Returns the segments as (word, start, duration)."""
    raw = (np.fromfile(audio, np.int16) if isinstance(audio, str)
           else np.asarray(audio, np.int16))
    al = TorchAligner(hmm=model_dir, device=device, **config)
    out = al.align_batch([raw] * n_devices, [text] * n_devices)
    assert all(o is not None for o in out), "batch alignment failed"
    words = [[re.sub(r"\(\d+\)$", "", s.word) for s in segs
              if s.word != "<sil>"] for segs in out]
    assert words == [text.split()] * n_devices, words
    segs0 = _key(out[0])
    for segs in out[1:]:
        assert _key(segs) == segs0, (_key(segs), segs0)
    print(f"dryrun_multichip({n_devices}): batch OK, segs={segs0}")

    sp = al.align_longform_batch([raw, raw], [text, text],
                                 ring=seq_ring(n_devices, al.device))
    for segs in sp:
        assert segs is not None, "SP alignment failed"
        assert _key(segs) == segs0, (_key(segs), segs0)
    print(f"dryrun_multichip({n_devices}): SP OK (matches the batch)")
    return segs0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("model_dir")
    ap.add_argument("audio")
    ap.add_argument("text")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samprate", type=float)
    a = ap.parse_args(argv)
    config = {} if a.samprate is None else {"samprate": a.samprate}
    dryrun_multichip(a.n, a.model_dir, a.audio, a.text, a.device, **config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
