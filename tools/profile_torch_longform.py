"""Where the long form's time goes in the PyTorch/CUDA port.

On one CUDA device, with the synthetic en-us-width model
(tools/make_synth_model.py, seed 0, 8-bit ptm), ``align_longform_batch``
on a local ring of 8 ranks (``seq_ring(8, "cuda")``) over two inputs:
``batch``, the 4 rows of AUSTEN's sentence tiled 21 times of
tools/make_torch_longform_golden.py (62.5-62.8 s each, chunks of 832
frames, S = 3,714), and ``row``, one row of 100 repeats (about 5
minutes, chunks of about 3,737 frames, S = 17,697).  For each: the
median host wall of N calls (each ending in a synchronize, after one
warm-up), and a torch.profiler trace of 3 calls: device time by kernel
per call, the reverse pass's (K13, every kernel whose name holds
``backtrace``), the forward's (K4's carry form, ``viterbi_chunk``) and
the features' (K1, ``feat_``) apart.

Prints one JSON object.  Usage: ``python tools/profile_torch_longform.py
[N]``.  To compare with an earlier commit, copy this tool into its
unpacked tree.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch  # noqa: E402

from make_synth_model import make_synth_model  # noqa: E402
from make_torch_longform_golden import (LONG_B, N_SEQ,  # noqa: E402
                                        longform_audio, longform_text)
from make_torch_synth_golden import SAMPRATE  # noqa: E402
from soundswallower_tpu_torch.aligner import TorchAligner  # noqa: E402
from soundswallower_tpu_torch.parallel import seq_ring  # noqa: E402

LONG_ROW = 100      # AUSTEN repeats of the one long row


def device_ms(fn, calls: int = 3) -> dict:
    """Device time per call by kernel name (torch.profiler over calls
    runs of fn)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            out[ev.key[:80]] = dt / 1e3 / calls
    return out


def measure(al: TorchAligner, rows: list, texts: list, N: int) -> dict:
    def call():
        out = al.align_longform_batch(rows, texts, ring=seq_ring(N_SEQ,
                                                                 "cuda"))
        torch.cuda.synchronize()
        return out

    call()                                               # warm up
    walls = []
    for _ in range(N):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    by_kernel = device_ms(call)
    return {
        "rows": len(rows),
        "audio_s": [len(a) / SAMPRATE for a in rows],
        "wall_ms_median": statistics.median(walls),
        "wall_ms_all": walls,
        "device_ms": sum(by_kernel.values()),
        "reverse_pass_device_ms": sum(v for k, v in by_kernel.items()
                                      if "backtrace" in k),
        "forward_device_ms": sum(v for k, v in by_kernel.items()
                                 if "viterbi_chunk" in k),
        "features_device_ms": sum(v for k, v in by_kernel.items()
                                  if "feat_" in k),
        "device_ms_by_kernel": dict(sorted(by_kernel.items(),
                                           key=lambda kv: -kv[1])[:8]),
    }


def main(N: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_longform: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, 0, "en-us")
        al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    out = {"gpu": smi, "ranks": N_SEQ,
           "batch": measure(al, [longform_audio(i) for i in range(LONG_B)],
                            [longform_text()] * LONG_B, N),
           "row": measure(al, [longform_audio(0, LONG_ROW)],
                          [longform_text(LONG_ROW)], N)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
