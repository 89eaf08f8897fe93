"""Where a batch's time goes in the PyTorch/CUDA port.

On one CUDA device, with the synthetic en-us-width model
(tools/make_synth_model.py, seed 0; 8-bit ptm, or one of its
``VARIANTS``: ptm4b, semi, semi4b, ms, ptm5st) and B rows of one of
three traffic mixes: ``same``, the 8 golden austen utterances of one
transcript (tools/make_torch_synth_golden.py), ``mixed``, the 32
different transcripts of tools/make_torch_mixed_golden.py (the union
scorer's route), ``fresh``, the same 32 transcripts assigned to the rows
in a new order every batch (a batch of graphs the aligner has not
stacked yet, so each batch builds its stack anew, as traffic whose
transcripts change every batch does; the graphs and the union scorer
stay cached), or ``decode``, the 8 austen utterances decoded against
the grammar of tools/make_torch_decode_golden.py (``decode_batch``'s
route: its begin half ``_batch_begin`` on the decode graph, its end
half ``_decode_end``), each tiled to B:

* host stages, timed alone: the C++ front end for the batch
  (``process_list_i16p`` per upload chunk; absent under
  ``SST_FE=device``, where the device front end K8-K10 runs in the
  batch's device time) and the segment extraction (native; Python
  ``_extract_decode`` for ``decode``);
* steady-state cadence of the begin and end halves
  pipelined over N batches (median and mean wall time per batch;
  audio-seconds per second as all N batches' audio over their whole
  window, and at the median cadence);
* a torch.profiler trace of 3 pipelined batches: device time by kernel
  and the device's busy share of the window.

Prints one JSON object.
Usage: ``[SST_FE=device] python tools/profile_torch_batch.py [B] [N]
[same|mixed|fresh|decode] [ptm|ptm4b|semi|semi4b|ms|ptm5st]``.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from make_synth_model import VARIANTS, make_synth_model  # noqa: E402
from make_torch_decode_golden import GRAMMAR  # noqa: E402
from make_torch_mixed_golden import (N_MIXED, mixed_audio,  # noqa: E402
                                     mixed_texts)
from make_torch_synth_golden import (N_UTT, SAMPRATE, TEXT,  # noqa: E402
                                     austen_audio)
from soundswallower_tpu_torch.aligner import TorchAligner  # noqa: E402


def main(B: int = 256, N: int = 8, traffic: str = "same",
         variant: str = "ptm") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_batch: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, 0, "en-us", *VARIANTS[variant])
        al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    if traffic in ("same", "decode"):
        audios = [austen_audio(i % N_UTT) for i in range(B)]
        texts = [TEXT] * B
    elif traffic in ("mixed", "fresh"):
        audios = [mixed_audio(i % N_MIXED) for i in range(B)]
        texts32 = mixed_texts()
        texts = [texts32[i % N_MIXED] for i in range(B)]
    else:
        raise SystemExit(f"profile_torch_batch: traffic {traffic!r}")
    if traffic == "decode":
        g = al.set_grammar(jsgf_string=GRAMMAR)

        def begin():
            return al._batch_begin(g, audios)

        def end(h):
            return al._decode_end(g, h)

        def extract(h, paths):
            return [al._extract_decode(g, paths[i], int(h.Ts[i]))
                    for i in range(h.realB)]
    else:
        rng = np.random.RandomState(0)

        def begin():
            if traffic == "fresh":
                return al.align_batch_begin(
                    audios, [texts[i] for i in rng.permutation(B)])
            return al.align_batch_begin(audios, texts)

        end = al.align_batch_end

        def extract(h, paths):
            return al._extract_batch_native(h.graphs, paths, h.Ts, h.realB)
    audio_s = sum(len(a) for a in audios) / SAMPRATE
    for _ in range(2):                                   # warm up
        end(begin())
    torch.cuda.synchronize()

    # host stages alone
    _, _, Tmax = al._batch_shape(audios)
    chunk = al._chunk_size(B)
    fe_ms = []
    for _ in range(5 if al.native_fe is not None else 0):
        t0 = time.perf_counter()
        for i0 in range(0, B, chunk):
            al.native_fe.process_list_i16p(audios[i0:i0 + chunk], Tmax,
                                           al.wire_scale)
        fe_ms.append((time.perf_counter() - t0) * 1e3)
    h = begin()
    paths, _ = h.fetch()
    ex_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        extract(h, paths)
        ex_ms.append((time.perf_counter() - t0) * 1e3)

    # pipelined cadence
    walls = []
    prev = begin()
    t_prev = time.perf_counter()
    for _ in range(N):
        nxt = begin()
        end(prev)
        now = time.perf_counter()
        walls.append((now - t_prev) * 1e3)
        t_prev, prev = now, nxt
    end(prev)

    # device view of 3 pipelined batches
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prev = begin()
        for _ in range(2):
            nxt = begin()
            end(prev)
            prev = nxt
        end(prev)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            by_kernel[ev.key[:80]] = dt / 1e3 / 3          # ms per batch
    busy = sum(by_kernel.values()) * 3
    med = statistics.median(walls)
    out = {
        "gpu": smi, "traffic": traffic, "variant": variant, "B": B,
        "Tmax": Tmax,
        "fe": "device" if al.native_fe is None else "host",
        "audio_s_per_batch": audio_s,
        "host_fe_ms": statistics.median(fe_ms) if fe_ms else None,
        "extract_ms": statistics.median(ex_ms),
        "batch_wall_ms_median": med,
        "batch_wall_ms_mean": statistics.fmean(walls),
        "batch_wall_ms_all": walls,
        "audio_s_per_s": N * audio_s / (sum(walls) / 1e3),
        "audio_s_per_s_at_median_cadence": audio_s / (med / 1e3),
        "device_ms_per_batch_by_kernel": dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])),
        "device_busy_share": busy / window_ms if window_ms else None,
        "profile_window_ms": window_ms,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]), *sys.argv[3:5])
