"""Golden results of the JAX aligner on the acoustic-model backends
beside 8-bit ptm, at the published en-us width.

Writes ``tests/golden/torch-synth/backends.json`` and ``backends.npz``:
what ``soundswallower_tpu.aligner.TpuAligner`` (JAX, CPU) computes on
``make_synth_model(width="en-us", seed=0, backend=..., sendump_bits=...)``
(``VARIANTS``) for the audio ``austen_audio(i % 8)``, one fresh aligner
per variant:

* ``ms``: ``same`` (``align_batch`` on the 8 golden utterances of one
  transcript), ``mixed`` (``align_batch`` on the 32 mixed transcripts of
  ``make_torch_mixed_golden.mixed_texts``) and ``scored``
  (``align_batch_scored`` on them, with scores).  An ms model scores the
  full inventory on every route, so each row's result is its own: the
  rows run 8 at a time, which bounds the JAX program's memory;
* ``semi4b``: ``same``, then on that aligner ``union`` (the 32 mixed
  rows on the working-set union they build) and ``dense`` (the union
  forced to the full inventory), in that order;
* ``ptm4b``: ``same``;
* ``semi``: ``scored`` (the 32 mixed rows);
* ``backends.npz``: ``<variant>_dense``, the full-inventory int16
  scores (senone order: ``score_frames`` + ``ungroup``) of the first
  ``DENSE_FRAMES`` frames of ``tests/golden/austen-en/feat.f32``, for
  ``ptm4b``, ``semi``, ``semi4b`` and ``ms``.

The PyTorch port is held to them on the CPU
(tests/test_torch_backends_golden.py) and on the GPU (chip_smoke.py,
tests/test_torch_gpu.py).  The helpers import neither JAX nor the JAX
package.  Usage: ``JAX_PLATFORMS=cpu python
tools/make_torch_backends_golden.py``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from make_synth_model import VARIANTS
from make_torch_mixed_golden import mixed_audio, mixed_texts, scored_rep
from make_torch_synth_golden import (N_UTT, REPO, SAMPRATE, TEXT,
                                     austen_audio, segs_rep)

BACKENDS_GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth",
                               "backends")
DENSE_FRAMES = 12
# variant -> the result sets, in the order one aligner computes them
SETS = {"ms": ("same", "mixed", "scored"),
        "semi4b": ("same", "union", "dense"),
        "ptm4b": ("same",),
        "semi": ("scored",)}
REPS = {"scored": scored_rep}


def dense_feats() -> np.ndarray:
    """The frames whose full-inventory scores the golden keeps."""
    f = np.fromfile(os.path.join(REPO, "tests", "golden", "austen-en",
                                 "feat.f32"), np.float32)
    return f.reshape(-1, 3, 13)[:DENSE_FRAMES].copy()


def load_backends_golden() -> dict:
    """The JSON golden, with the npz arrays under ``<variant>_dense``."""
    with open(BACKENDS_GOLDEN + ".json") as fh:
        g = json.load(fh)
    with np.load(BACKENDS_GOLDEN + ".npz") as z:
        g.update({k: z[k] for k in z.files})
    return g


def run_set(al, variant: str, name: str, texts: list) -> list:
    """One result set of a variant on aligner ``al`` (JAX's or the
    port's), as the golden was made."""
    same = [austen_audio(i) for i in range(N_UTT)]
    mixed = [mixed_audio(i) for i in range(len(texts))]
    if name == "same":
        return al.align_batch(same, [TEXT] * N_UTT)
    if name == "dense":
        al._uni["dense"] = True
    step = 8 if variant == "ms" else len(texts)
    out = []
    for i in range(0, len(texts), step):
        fn = al.align_batch_scored if name == "scored" else al.align_batch
        out += fn(mixed[i:i + step], texts[i:i + step])
    return out


def main() -> None:
    sys.path.insert(0, REPO)
    import jax.numpy as jnp

    from make_synth_model import make_synth_model
    from soundswallower_tpu.aligner import TpuAligner
    from soundswallower_tpu.ops.senscore_jax import score_frames, ungroup

    texts = mixed_texts()
    feats = jnp.asarray(dense_feats())
    results, dense = {}, {}
    for variant in ("ptm4b", "semi", "semi4b", "ms"):
        backend, bits = VARIANTS[variant]
        with tempfile.TemporaryDirectory() as d:
            make_synth_model(d, 0, "en-us", backend, bits)
            al = TpuAligner(hmm=d, samprate=SAMPRATE)
            dense[f"{variant}_dense"] = ungroup(
                al.tables, np.asarray(score_frames(al.tables, feats)))
            for name in SETS.get(variant, ()):
                results[variant, name] = run_set(al, variant, name, texts)
            print(variant, "done", flush=True)
    head = json.dumps({"model": {"width": "en-us", "seed": 0},
                       "samprate": SAMPRATE, "text": TEXT,
                       "audio": "austen_audio(i % 8)", "texts": texts,
                       "dense_frames": DENSE_FRAMES})
    with open(BACKENDS_GOLDEN + ".json", "w") as fh:  # a row per line
        fh.write(head[:-1])
        for variant, names in SETS.items():
            fh.write(f', "{variant}": {{')
            for k, name in enumerate(names):
                rep = REPS.get(name, segs_rep)
                fh.write(f'{", " if k else ""}"{name}": [\n')
                fh.write(",\n".join(json.dumps(rep(s))
                                    for s in results[variant, name]))
                fh.write("\n]")
            fh.write("}")
        fh.write("}\n")
    np.savez_compressed(BACKENDS_GOLDEN + ".npz", **dense)


if __name__ == "__main__":
    main()
