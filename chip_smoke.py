#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA aligner on one NVIDIA Hopper GPU.

Drives ``soundswallower_tpu_torch`` through the entry points a user
calls (``TorchAligner.align_batch``, the pipelined
``align_batch_begin``/``align_batch_end``, and the HTTP service), on a
synthetic model at the published en-us width (tools/make_synth_model.py,
seed 0), against segments the JAX package computed for the same audio
(tests/golden/torch-synth/segs.json).  Phases, in order; any failure
raises, so the exit code is non-zero and the last line is not printed:

1. device: a CUDA device of compute capability 9.0;
2. build every kernel from ``soundswallower_tpu_torch/csrc``;
3. model and batch;
4. each kernel (K1-K4) against its plain PyTorch version on the card,
   bit-equal, at the shapes the main path gives it, with median times;
5. main path: align_batch on the 8 golden utterances, then 4 pipelined
   batches of 256 (the 8 tiled); every row equals its golden;
6. serving: 16 concurrent POST /v1/align and GET /v1/health.

The launch counts are reset before phase 5 and read after phase 6; a
kernel launched no time there fails the run.  The last lines are one
JSON object of per-kernel results, the card's name and power limit
(nvidia-smi), and ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` (one GPU, no arguments, no network).
"""

from __future__ import annotations

import base64
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from make_synth_model import make_synth_model  # noqa: E402
from make_torch_synth_golden import (N_UTT, SAMPRATE, TEXT,  # noqa: E402
                                     austen_audio, load_golden, segs_rep)
from soundswallower_tpu_torch.aligner import TorchAligner, WordSeg  # noqa: E402
from soundswallower_tpu_torch.fe import feat as feat_mod  # noqa: E402
from soundswallower_tpu_torch.ops import align_torch, senscore_torch  # noqa: E402
from soundswallower_tpu_torch.serve import make_server, segs_to_json  # noqa: E402
from soundswallower_tpu_torch.utils import cuda_build  # noqa: E402

KERNELS = [
    # name, wrapper, source, the TPU program it replaces
    ("feat", feat_mod.feat, "soundswallower_tpu_torch/csrc/feat.cu",
     "soundswallower_tpu/fe/feat.py:372"),
    ("dist_topn_norm", senscore_torch.dist_topn_norm,
     "soundswallower_tpu_torch/csrc/senscore.cu",
     "soundswallower_tpu/ops/senscore_jax.py:535"),
    ("senone_eval", senscore_torch.senone_eval,
     "soundswallower_tpu_torch/csrc/senscore.cu",
     "soundswallower_tpu/ops/senscore_jax.py:557"),
    ("viterbi_batch", align_torch.viterbi_batch,
     "soundswallower_tpu_torch/csrc/viterbi.cu",
     "soundswallower_tpu/ops/align_jax.py:607"),
]
BIG_B = 256
N_BATCHES = 4
N_REQUESTS = 16


def log(*a):
    print(*a, flush=True)


def time_ms(fn, runs: int = 10) -> float:
    """Median device time of fn over runs, with CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    d = (a.double() - b.double()).abs()
    nan = torch.isnan(a.double()) != torch.isnan(b.double())
    if bool(nan.any()):
        return float("inf")
    return float(torch.nan_to_num(d, nan=0.0).max())


def compare(name, fn, plain, results):
    """Kernel vs plain PyTorch on the same device inputs: bit-equal."""
    out_k = fn()
    out_p = plain()
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max_abs_err {err})")
    ms = time_ms(fn)
    plain_ms = time_ms(plain)
    log(f"  {name}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out_k


def phase_kernels(al: TorchAligner, audios: list, results: dict):
    """K1-K4 on the inputs of the B=256 batch, bucketed and chunked by
    the main path's own helpers."""
    c = al._graph_consts(al.graph_for_text(TEXT))
    audios, Ts, Tmax = al._batch_shape(audios)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    sen = torch.empty((len(audios), Tmax, c.gs.S), dtype=torch.int32,
                      device=al.device)
    inv = 1.0 / al.wire_scale
    for i0, pl, feats in al._chunk_feats(audios, Ts_d, Tmax):
        n = pl.shape[1]
        Tn = Ts_d[i0:i0 + n]
        first = i0 == 0
        if first:
            compare("feat", lambda: feat_mod.feat(pl, Tn, inv, al.do_cmn),
                    lambda: feat_mod.feat_plain(pl, Tn, inv, al.do_cmn),
                    results)
        flat = feats.view(n * Tmax, 3, -1)
        if first:
            s, cw = compare(
                "dist_topn_norm",
                lambda: senscore_torch.dist_topn_norm(flat, c.gs),
                lambda: senscore_torch.dist_topn_norm_plain(flat, c.gs),
                results)
            compare("senone_eval",
                    lambda: senscore_torch.senone_eval(s, cw, c.gs),
                    lambda: senscore_torch.senone_eval_plain(s, cw, c.gs),
                    results)
        senscore_torch.score_frames_graph(
            c.gs, flat, out=sen[i0:i0 + n].view(n * Tmax, -1))
    log(f"  shapes: B={len(audios)} Tmax={Tmax} S={c.gs.S} "
        f"Cu={c.gs.means.shape[0]} P={c.vit.P} K={c.vit.pred_idx.shape[1]}")
    compare("viterbi_batch",
            lambda: align_torch.viterbi_batch(sen, Ts_d, c.vit),
            lambda: align_torch.viterbi_batch_plain(sen, Ts_d, c.vit),
            results)


def check_rows(out, want, what):
    got = [segs_rep(s) for s in out]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: rows {bad[:8]} differ from the golden")


def phase_main(al: TorchAligner, audios8: list, golden: list):
    t0 = time.perf_counter()
    check_rows(al.align_batch(audios8, [TEXT] * N_UTT), golden,
               "align_batch (B=8)")
    log(f"  align_batch B={N_UTT}: equal to the golden "
        f"({time.perf_counter() - t0:.3f} s, first call)")
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    want = [golden[i % N_UTT] for i in range(BIG_B)]
    audio_s = sum(len(a) for a in big) / SAMPRATE
    handles, walls = [], []
    t_prev = time.perf_counter()
    for k in range(N_BATCHES + 1):
        if k < N_BATCHES:
            handles.append(al.align_batch_begin(big, [TEXT] * BIG_B))
        if k:
            check_rows(al.align_batch_end(handles[k - 1]), want,
                       f"pipelined batch {k - 1}")
            now = time.perf_counter()
            walls.append(now - t_prev)
            t_prev = now
    for k, w in enumerate(walls):
        log(f"  pipelined batch {k}: B={BIG_B} {w * 1e3:.1f} ms wall, "
            f"{audio_s / w:.1f} audio-s/s (informational)")
    log(f"  {N_BATCHES} pipelined batches of {BIG_B}: every row equal to "
        f"its golden")
    return walls, audio_s


def phase_serve(al: TorchAligner, audios8: list, golden_segs: list):
    server = make_server(al, "127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        def post(i):
            body = json.dumps({
                "text": TEXT,
                "audio": base64.b64encode(audios8[i % N_UTT].tobytes())
                .decode()}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/align", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return i, json.loads(r.read())

        with ThreadPoolExecutor(N_REQUESTS) as ex:
            replies = list(ex.map(post, range(N_REQUESTS)))
        frate = al.config.get_int("frate")
        for i, got in replies:
            if got != segs_to_json(golden_segs[i % N_UTT], frate):
                raise AssertionError(f"served request {i} differs")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/health", timeout=30) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok":
            raise AssertionError(f"health: {health}")
        log(f"  {N_REQUESTS} concurrent requests equal to the golden; "
            f"health {health}")
    finally:
        server.shutdown()
        server.service.close()
        server.server_close()
        th.join(timeout=10)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap}, need (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # 2. build
    t0 = time.perf_counter()
    cuda_build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_seconds:.2f} s)")
    # 3. model and batch
    golden = load_golden()
    want = golden["segs"]
    with tempfile.TemporaryDirectory() as model_dir:
        make_synth_model(model_dir, seed=0, width="en-us")
        al = TorchAligner(hmm=model_dir, samprate=SAMPRATE, device="cuda")
    audios8 = [austen_audio(i) for i in range(N_UTT)]
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    log(f"model: {al.am.n_sen} senones, {al.am.n_mgau} codebooks, "
        f"{al.am.n_density} densities; batch of {BIG_B} utterances")
    # 4. kernels vs plain versions
    results: dict = {}
    phase_kernels(al, big, results)
    # 5-6. main path, counted
    wrappers = {name: fn for name, fn, _, _ in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    phase_main(al, audios8, want)
    golden_segs = [[WordSeg(w, st, d, phones=[(ci, ps, pd, 0)
                                             for ci, ps, pd in ph])
                    for w, st, d, ph in segs] for segs in want]
    phase_serve(al, audios8, golden_segs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    missing = [n for n, k in launches.items() if k == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name])
        for name, _, src, rep in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
