"""How XLA's CPU backend rounds the ms distance fold (the reference of
kernel K11).

``soundswallower_tpu/ops/senscore_jax.py`` ``_dist_stage_ms`` is its own
jit, so whether its compiler contracts ``d - (diff*diff)*var`` into a
fused multiply-add is read here, two ways, on the small synthetic ms
model (tools/make_synth_model.py, seed 0, ``backend="ms"``) and 200
frames of ``tests/golden/austen-en/feat.f32``:

* the compiled program: XLA dumps the fusion's object file, and the
  x86 instructions of its loop are counted with ``objdump`` (an FMA
  fold shows one ``vfnmadd`` per dim beside the square's ``vmulps``);
* the values: the JAX float distances against the port's FMA fold
  (``senscore_torch._fold_plain``) and against a strict fold (a
  rounding after every operation), element by element.

Prints one JSON object.  Usage: ``JAX_PLATFORMS=cpu python
tools/check_ms_fold.py`` (needs ``objdump``; no device).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)


def main() -> dict:
    dump = tempfile.mkdtemp(prefix="xla-dump-")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump}").strip()
    sys.path[:0] = [REPO, TOOLS]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from make_synth_model import make_synth_model
    from soundswallower_tpu.am import AcousticModel
    from soundswallower_tpu.config import Config
    from soundswallower_tpu.ops import senscore_jax as sj
    from soundswallower_tpu_torch.ops import senscore_torch as st

    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, 0, "small", "ms", 8)
        cfg = Config(hmm=d, samprate=8000)
        cfg.expand()
        tables = sj.ScorerTables.from_am(AcousticModel.load(cfg))
    feats = np.fromfile(os.path.join(REPO, "tests", "golden", "austen-en",
                                     "feat.f32"), np.float32)
    feats = feats.reshape(-1, 3, 13)[:200].copy()
    got = np.asarray(sj._dist_stage_ms(tables, jnp.asarray(feats)))

    means = np.asarray(tables.means)
    var_t = np.asarray(tables.var_t)
    strict = np.broadcast_to(np.asarray(tables.det)[None],
                             got.shape).astype(np.float32)
    for i in range(means.shape[-1]):
        diff = feats[:, None, :, None, i] - means[None, :, :, :, i]
        strict = strict - (diff * diff) * var_t[None, :, :, :, i]
    ms = st.ms_scorer_from_jax_tables(tables)
    fma = st._fold_plain(torch.from_numpy(feats), ms).numpy()

    counts: collections.Counter = collections.Counter()
    for obj in glob.glob(os.path.join(dump, "*dist_stage_ms*.o")):
        text = subprocess.run(["objdump", "-d", obj], capture_output=True,
                              text=True, check=True).stdout
        counts.update(re.findall(r"\b(vf\w*ps|vmulps|vsubps|vaddps)\b",
                                 text))
    shutil.rmtree(dump, ignore_errors=True)
    out = {"elements": int(got.size),
           "fma_fold_differs": int((fma != got).sum()),
           "strict_fold_differs": int((strict != got).sum()),
           "compiled_instructions": dict(sorted(counts.items()))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
