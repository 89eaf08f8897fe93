"""Time K11's forms and codebook splits, K12 and the blocked scorer on a
fully continuous model of one 39-dim stream at en-us width (5,126
senones, a codebook each, 32 Gaussians; ``make_cont_model``), on the
card.

    python tools/exp_ms_cont.py [FRAMES ...]

For each frame count (default: one block of ``score_frames_ms``, 2,048
and 40,960) K11 is timed in the frame form and in the runtime-L form,
each with the launcher's split of the codebooks and with none, every
variant checked bit-equal to the launcher's own; then K12 at one block, and
``score_frames_ms`` over a story chunk (128 rows of 3,648 frames) with
the card's peak memory.  Device times are CUDA events around the
launches, the median of 5 after one warm-up.  One JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

from make_synth_model import make_cont_model  # noqa: E402
from make_torch_synth_golden import SAMPRATE, austen_audio  # noqa: E402
from soundswallower_tpu_torch.aligner import TorchAligner  # noqa: E402
from soundswallower_tpu_torch.ops import senscore_torch as st  # noqa: E402

CHUNK = 128 * 3648       # a story chunk's rows times its frame axis


def dev_ms(fn, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def frames(al: TorchAligner, n: int) -> torch.Tensor:
    """n frames [n, 1, 39] of real features (austen rows, tiled)."""
    audios = [austen_audio(i % 8) for i in range(8)]
    aud, Ts, Tmax = al._batch_shape(audios)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).cuda()
    _, _, f = next(iter(al._chunk_feats(aud, Ts_d, Tmax)))
    f = torch.cat([f[b, :int(Ts[b])] for b in range(len(Ts))])
    f = al._scorer_view(f.contiguous())
    reps = -(-n // f.shape[0])
    return f.repeat(reps, 1, 1)[:n].contiguous()


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        make_cont_model(d, 0, "en-us")
        al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    ms = al.dense
    block = st.ms_block_frames(ms)
    Ns = [int(a) for a in sys.argv[1:]] or [block, 2048, 40960]
    out = {"card": smi, "block_frames": block, "k11": []}
    for N in Ns:
        x = frames(al, N)
        ref = st.ms_dist_topn(x, ms)
        tile, parts, form = st.ms_dist_topn_layout(N, 5126, 1, 39, 32, 4)
        row = {"N": N, "layout": [tile, parts, form]}
        for f in (st.MS_FRAME_FORM, 0):
            for p in (0, 1):        # the launcher's split, and none
                what = f"{st.MS_FORMS[f]}, {p or 'launcher'} part(s)"
                got = st.ms_dist_topn(x, ms, form=f, parts=p)
                if not all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(got, ref)):
                    raise AssertionError(f"K11, {what}, differs")
                del got
                row[what] = dev_ms(
                    lambda: st.ms_dist_topn(x, ms, form=f, parts=p))
        row["k12_ms"] = dev_ms(lambda: st.ms_senone_eval(*ref, ms))
        out["k11"].append(row)
        print(json.dumps(row), flush=True)
        del ref, x
    x = frames(al, CHUNK)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out["chunk_ms"] = dev_ms(lambda: st.score_frames_ms(ms, x), runs=3)
    out["chunk_frames"] = CHUNK
    out["chunk_peak_bytes_above_input"] = (torch.cuda.max_memory_allocated()
                                           - base)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
