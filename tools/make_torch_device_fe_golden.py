"""Golden results of the JAX aligner's device front end on the synthetic
en-us-width model.

Writes ``tests/golden/torch-synth/device_fe.json`` and
``device_fe.npz``: what ``soundswallower_tpu.aligner.TpuAligner`` (JAX,
CPU) gives under ``SST_FE=device`` (the on-device MFCC instead of the
host C++ one) on ``make_synth_model(width="en-us", seed=0)``:

* ``same``: ``align_batch`` on the 8 utterances ``austen_audio(i)``
  against their one transcript;
* ``mixed``: ``align_batch`` on the 32 mixed transcripts of
  tools/make_torch_mixed_golden.py over ``austen_audio(i % 8)``, on the
  working-set union these rows build (a fresh aligner);
* ``align``: the single-utterance path on ``austen_audio(0)``;
* ``stream``: ``stream(TEXT)`` with ``austen_audio(0)`` pushed in
  1600-sample pieces, then ``end()``;
* in the .npz, ``state/<key>``: the stream's ``state()`` after the first
  ``ckpt_samples`` samples (tuples as ``state/noise/0`` ...), and
  ``spec_raw``/``spec_smooth``: ``spectrogram(austen_audio(0))``.

The PyTorch port is held to them on the CPU (tests/test_torch_device_fe
_golden.py) and on the GPU (chip_smoke.py).  The helpers import neither
JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_device_fe_golden.py``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from make_torch_mixed_golden import N_MIXED, mixed_audio, mixed_texts
from make_torch_synth_golden import (N_UTT, REPO, SAMPRATE, TEXT,
                                     austen_audio, segs_rep)

GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth", "device_fe")
STREAM_SPLIT = 1600
CKPT_SAMPLES = 12800


def pieces(audio: np.ndarray, split: int) -> list:
    return [audio[i:i + split] for i in range(0, len(audio), split)]


def state_to_arrays(state: dict) -> tuple[dict, dict]:
    """A stream state() -> (JSON scalars, npz arrays)."""
    scal, arrs = {}, {}
    for k, v in state.items():
        if isinstance(v, tuple):
            for i, x in enumerate(v):
                arrs[f"state/{k}/{i}"] = np.asarray(x)
        elif isinstance(v, (np.ndarray, np.generic)):
            arrs[f"state/{k}"] = np.asarray(v)
        else:
            scal[k] = v
    return scal, arrs


def state_from_arrays(scal: dict, arrs) -> dict:
    """The inverse of state_to_arrays."""
    state = dict(scal)
    tuples: dict = {}
    for name in arrs.files if hasattr(arrs, "files") else arrs:
        if not name.startswith("state/"):
            continue
        parts = name.split("/")
        x = np.asarray(arrs[name])
        if len(parts) == 3:
            tuples.setdefault(parts[1], {})[int(parts[2])] = x
        elif x.ndim == 0 and x.dtype == np.float32:
            state[parts[1]] = np.float32(x)
        else:
            state[parts[1]] = x
    for k, d in tuples.items():
        state[k] = tuple(d[i] for i in range(len(d)))
    return state


def load_device_fe_golden() -> dict:
    with open(GOLDEN + ".json") as fh:
        g = json.load(fh)
    with np.load(GOLDEN + ".npz") as z:
        arrs = {k: z[k] for k in z.files}
    g["spec_raw"] = arrs["spec_raw"]
    g["spec_smooth"] = arrs["spec_smooth"]
    g["state"] = state_from_arrays(g.pop("state_scalars"), arrs)
    return g


def main() -> None:
    sys.path.insert(0, REPO)
    os.environ["SST_FE"] = "device"
    from make_synth_model import make_synth_model

    from soundswallower_tpu.aligner import TpuAligner

    audio0 = austen_audio(0)
    texts = mixed_texts()
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, seed=0, width="en-us")
        al = TpuAligner(hmm=d, samprate=SAMPRATE)
        assert al.native_fe is None
        same = al.align_batch([austen_audio(i) for i in range(N_UTT)],
                              [TEXT] * N_UTT)
        single = al.align(audio0, TEXT)
        s = al.stream(TEXT)
        pushed = 0
        state = None
        for p in pieces(audio0, STREAM_SPLIT):
            s.push(p)
            pushed += len(p)
            if pushed == CKPT_SAMPLES:
                state = s.state()
        stream = s.end()
        spec_raw = al.spectrogram(audio0)
        spec_smooth = al.spectrogram(audio0, smooth=True)
        mixed_al = TpuAligner(hmm=d, samprate=SAMPRATE)
        mixed = mixed_al.align_batch([mixed_audio(i) for i in range(N_MIXED)],
                                     texts)
    scal, arrs = state_to_arrays(state)
    head = {"model": {"width": "en-us", "seed": 0}, "samprate": SAMPRATE,
            "fe": "device", "text": TEXT, "texts": texts,
            "stream_split": STREAM_SPLIT, "ckpt_samples": CKPT_SAMPLES,
            "state_scalars": scal, "align": segs_rep(single),
            "stream": segs_rep(stream)}
    with open(GOLDEN + ".json", "w") as fh:   # one utterance per line
        fh.write(json.dumps(head)[:-1])
        for name, out in (("same", same), ("mixed", mixed)):
            fh.write(f', "{name}": [\n')
            fh.write(",\n".join(json.dumps(segs_rep(x)) for x in out))
            fh.write("\n]")
        fh.write("}\n")
    np.savez_compressed(GOLDEN + ".npz", spec_raw=spec_raw,
                        spec_smooth=spec_smooth, **arrs)


if __name__ == "__main__":
    main()
