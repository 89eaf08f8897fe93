#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA aligner on one NVIDIA Hopper GPU.

Drives ``soundswallower_tpu_torch`` through the entry points a user
calls (``TorchAligner.align_batch``, ``align_batch_scored``, the
pipelined ``align_batch_begin``/``align_batch_end``, and the HTTP
service), on a synthetic model at the published en-us width
(tools/make_synth_model.py, seed 0), against results the JAX package
computed for the same audio (tests/golden/torch-synth/segs.json for one
transcript, mixed_segs.json for 32 different ones).  Phases, in order;
any failure raises, so the exit code is non-zero and the last line is
not printed:

1. device: a CUDA device of compute capability 9.0;
2. build every kernel from ``soundswallower_tpu_torch/csrc``;
3. model and batches;
4. each kernel (K1-K7) against its plain PyTorch version on the card,
   bit-equal, at the shapes the main and mixed paths give it (K2/K3 at
   the full-inventory shape on a slice of the dense route's frames),
   with median times;
5. main path: align_batch on the 8 golden utterances, then 4 pipelined
   batches of 256 (the 8 tiled); every row equals its golden;
6. mixed path, on a fresh union: align_batch on the 32 mixed rows, 4
   pipelined batches of 256 that tile them, align_batch with the union
   forced dense, align_batch_scored (scores included); every row equals
   its golden;
7. serving: concurrent POST /v1/align of one transcript, then of the 32
   mixed ones (the union no longer grows), and GET /v1/health.

The launch counts are reset before phase 5 and read after phase 7; a
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
from make_torch_mixed_golden import (N_MIXED, load_mixed_golden,  # noqa: E402
                                     mixed_audio, scored_rep)
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
    ("gather_cols", senscore_torch.gather_cols,
     "soundswallower_tpu_torch/csrc/gather_cols.cu",
     "soundswallower_tpu/aligner.py:49"),
    ("viterbi_rows", align_torch.viterbi_rows,
     "soundswallower_tpu_torch/csrc/viterbi_rows.cu",
     "soundswallower_tpu/aligner.py:1032"),
    ("frame_best_sub", senscore_torch.frame_best_sub,
     "soundswallower_tpu_torch/csrc/frame_best_sub.cu",
     "soundswallower_tpu/ops/senscore_jax.py:254"),
]
# further measured shapes of a kernel: (entry, kernel, TPU program)
VARIANTS = [
    ("gather_cols[int16 full inventory]", "gather_cols",
     "soundswallower_tpu/aligner.py:49"),
    ("viterbi_rows[scores]", "viterbi_rows",
     "soundswallower_tpu/ops/align_jax.py:700"),
    ("dist_topn_norm[full inventory]", "dist_topn_norm",
     "tools/exp_pallas2.py:54"),
    ("senone_eval[full inventory]", "senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:254"),
]
BIG_B = 256
N_BATCHES = 4
N_REQUESTS = 16
DENSE_SLICE = 2048      # frames of the dense route for K2/K3's comparison


def log(*a):
    print(*a, flush=True)


def time_ms(fn, runs: int = 10) -> float:
    """Median device time of fn over runs (after one warm-up), with
    CUDA events."""
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
    if a is None or b is None:
        if a is not None or b is not None:
            raise AssertionError("one output is None")
        return 0.0
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    d = (a.double() - b.double()).abs()
    nan = torch.isnan(a.double()) != torch.isnan(b.double())
    if bool(nan.any()):
        return float("inf")
    return float(torch.nan_to_num(d, nan=0.0).max())


def compare(name, fn, plain, results, plain_runs: int = 10):
    """Kernel vs plain PyTorch on the same device inputs: bit-equal."""
    out_k = fn()
    out_p = plain()
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max_abs_err {err})")
    ms = time_ms(fn)
    plain_ms = time_ms(plain, plain_runs)
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


def fresh_union(al: TorchAligner) -> None:
    """Forget the working-set union and the stacks built on it."""
    al._uni = None
    al._stack_cache.clear()


def phase_kernels_mixed(al: TorchAligner, texts: list, results: dict):
    """K5, K6, K7 and the full-inventory K2/K3 on the inputs of the
    mixed paths: the union route's B=256 batch (the 32 mixed rows
    tiled) and the dense route's B=32 batch, bucketed and chunked by the
    main path's own helpers."""
    big = [mixed_audio(i % N_MIXED) for i in range(BIG_B)]
    graphs = [al.graph_for_text(texts[i % N_MIXED]) for i in range(BIG_B)]
    fresh_union(al)
    uni = al._union_scorer(graphs)
    st = al._stacked_graphs(graphs, remap=uni["pos"], remap_ver=uni["ver"])
    audios, Ts, Tmax = al._batch_shape(big)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    S = st.sencols.shape[1]
    sen = torch.empty((len(audios), Tmax, S), dtype=torch.int32,
                      device=al.device)
    for i0, _, feats in al._chunk_feats(audios, Ts_d, Tmax):
        n = feats.shape[0]
        src = senscore_torch.score_frames_graph(
            uni["gs"], feats.view(n * Tmax, 3, -1)).view(n, Tmax, -1)
        cols = st.sencols[i0:i0 + n]
        if i0 == 0:
            compare("gather_cols",
                    lambda: senscore_torch.gather_cols(src, cols),
                    lambda: senscore_torch.gather_cols_plain(src, cols),
                    results)
        senscore_torch.gather_cols(src, cols, out=sen[i0:i0 + n])
    v = st.vit
    log(f"  union shapes: B={len(audios)} Tmax={Tmax} Spad={uni['Spad']} "
        f"Cu={uni['gs'].means.shape[0]} P={v.P} K={v.pred_idx.shape[2]} "
        f"W={0 if v.band_pen is None else v.band_pen.shape[1]}")
    if v.band_pen is None:
        raise AssertionError("the mixed batch's stack took no band")
    for name, ws in (("viterbi_rows", False), ("viterbi_rows[scores]", True)):
        compare(name, lambda: align_torch.viterbi_rows(sen, Ts_d, v, ws),
                lambda: align_torch.viterbi_rows_plain(sen, Ts_d, v, ws),
                results, plain_runs=2)
    fresh_union(al)
    # the dense route: B=32, one chunk
    audios, Ts, Tmax = al._batch_shape([mixed_audio(i)
                                        for i in range(N_MIXED)])
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    dgraphs = [al.graph_for_text(t) for t in texts]
    cols = al._stacked_graphs(dgraphs).sencols
    ds = al.dense
    for _, _, feats in al._chunk_feats(audios, Ts_d, Tmax):
        flat = feats.view(-1, 3, feats.shape[-1])
        part = flat[:DENSE_SLICE]
        log(f"  full inventory: N={flat.shape[0]} frames, compared on "
            f"N={part.shape[0]}; Cu={ds.means.shape[0]} S={ds.S}")
        s, cw = compare(
            "dist_topn_norm[full inventory]",
            lambda: senscore_torch.dist_topn_norm(part, ds),
            lambda: senscore_torch.dist_topn_norm_plain(part, ds),
            results, plain_runs=2)
        compare("senone_eval[full inventory]",
                lambda: senscore_torch.senone_eval(s, cw, ds),
                lambda: senscore_torch.senone_eval_plain(s, cw, ds),
                results, plain_runs=2)
        s, cw = senscore_torch.dist_topn_norm(flat, ds)
        x = senscore_torch.senone_eval(s, cw, ds)
        compare("frame_best_sub",
                lambda: senscore_torch.frame_best_sub(x),
                lambda: senscore_torch.frame_best_sub_plain(x), results)
        src = senscore_torch.frame_best_sub(x).view(len(audios), Tmax, -1)
        compare("gather_cols[int16 full inventory]",
                lambda: senscore_torch.gather_cols(src, cols),
                lambda: senscore_torch.gather_cols_plain(src, cols),
                results)


def check_rows(out, want, what, rep=segs_rep):
    got = [rep(s) for s in out]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: rows {bad[:8]} differ from the golden")


def pipelined(al: TorchAligner, big: list, texts: list, want: list,
              what: str):
    """N_BATCHES pipelined batches of the same rows, every row checked;
    one wall time per batch, from end() to end()."""
    audio_s = sum(len(a) for a in big) / SAMPRATE
    handles, walls = [], []
    t_prev = time.perf_counter()
    for k in range(N_BATCHES + 1):
        if k < N_BATCHES:
            handles.append(al.align_batch_begin(big, texts))
        if k:
            check_rows(al.align_batch_end(handles[k - 1]), want,
                       f"{what} pipelined batch {k - 1}")
            now = time.perf_counter()
            walls.append(now - t_prev)
            t_prev = now
    for k, w in enumerate(walls):
        log(f"  {what} pipelined batch {k}: B={len(big)} {w * 1e3:.1f} ms "
            f"wall, {audio_s / w:.1f} audio-s/s (informational)")
    log(f"  {N_BATCHES} pipelined {what} batches of {len(big)}: every row "
        f"equal to its golden")
    return walls, audio_s


def phase_main(al: TorchAligner, audios8: list, golden: list):
    t0 = time.perf_counter()
    check_rows(al.align_batch(audios8, [TEXT] * N_UTT), golden,
               "align_batch (B=8)")
    log(f"  align_batch B={N_UTT}: equal to the golden "
        f"({time.perf_counter() - t0:.3f} s, first call)")
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    want = [golden[i % N_UTT] for i in range(BIG_B)]
    return pipelined(al, big, [TEXT] * BIG_B, want, "same-transcript")


def phase_mixed(al: TorchAligner, mg: dict):
    """The golden's sequence on a fresh union."""
    fresh_union(al)
    texts = mg["texts"]
    audios = [mixed_audio(i) for i in range(N_MIXED)]
    t0 = time.perf_counter()
    check_rows(al.align_batch(audios, texts), mg["union"],
               f"mixed align_batch (B={N_MIXED}, union)")
    u = al._uni
    log(f"  mixed align_batch B={N_MIXED}: equal to the union golden "
        f"({time.perf_counter() - t0:.3f} s, first call; union "
        f"{len(u['senset'])} senones, Spad {u['Spad']}, "
        f"Cu {u['gs'].means.shape[0]})")
    big = [audios[i % N_MIXED] for i in range(BIG_B)]
    out = pipelined(al, big, [texts[i % N_MIXED] for i in range(BIG_B)],
                    [mg["union"][i % N_MIXED] for i in range(BIG_B)],
                    "mixed")
    if len(u["senset"]) != len(al._uni["senset"]) or u["dense"]:
        raise AssertionError("the union changed over the mixed batches")
    al._uni["dense"] = True
    try:
        check_rows(al.align_batch(audios, texts), mg["dense"],
                   f"mixed align_batch (B={N_MIXED}, forced dense)")
    finally:
        al._uni["dense"] = False
    log(f"  mixed align_batch B={N_MIXED}, forced dense: equal to the "
        f"dense golden")
    check_rows(al.align_batch_scored(audios, texts), mg["scored"],
               f"align_batch_scored (B={N_MIXED})", rep=scored_rep)
    log(f"  align_batch_scored B={N_MIXED}: equal to the scored golden, "
        f"scores included")
    return out


def golden_segs(rows: list) -> list:
    return [[WordSeg(w, st, d, phones=[(ci, ps, pd, 0) for ci, ps, pd in ph])
             for w, st, d, ph in segs] for segs in rows]


def phase_serve(al: TorchAligner, requests: list, what: str,
                max_batch: int = 64, max_wait_ms: float = 20.0):
    """Concurrent POST /v1/align of (text, audio, golden WordSegs), then
    GET /v1/health; every reply equals its golden."""
    server = make_server(al, "127.0.0.1", 0, max_batch, max_wait_ms)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        def post(i):
            text, audio, _ = requests[i]
            body = json.dumps({
                "text": text,
                "audio": base64.b64encode(audio.tobytes()).decode()}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/align", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return i, json.loads(r.read())

        with ThreadPoolExecutor(len(requests)) as ex:
            replies = list(ex.map(post, range(len(requests))))
        frate = al.config.get_int("frate")
        for i, got in replies:
            if got != segs_to_json(requests[i][2], frate):
                raise AssertionError(f"{what}: served request {i} differs")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/health", timeout=30) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok":
            raise AssertionError(f"health: {health}")
        log(f"  {len(requests)} concurrent {what} requests equal to the "
            f"golden; health {health}")
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
    # 3. model and batches
    golden = load_golden()
    want = golden["segs"]
    mg = load_mixed_golden()
    with tempfile.TemporaryDirectory() as model_dir:
        make_synth_model(model_dir, seed=0, width="en-us")
        al = TorchAligner(hmm=model_dir, samprate=SAMPRATE, device="cuda")
    audios8 = [austen_audio(i) for i in range(N_UTT)]
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    log(f"model: {al.am.n_sen} senones, {al.am.n_mgau} codebooks, "
        f"{al.am.n_density} densities; batches of {BIG_B} utterances, "
        f"{N_MIXED} mixed transcripts")
    # 4. kernels vs plain versions
    results: dict = {}
    phase_kernels(al, big, results)
    phase_kernels_mixed(al, mg["texts"], results)
    # 5-7. main, mixed and serving paths, counted
    wrappers = {name: fn for name, fn, _, _ in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    phase_main(al, audios8, want)
    phase_mixed(al, mg)
    segs8 = golden_segs(want)
    phase_serve(al, [(TEXT, audios8[i % N_UTT], segs8[i % N_UTT])
                     for i in range(N_REQUESTS)], "same-transcript")
    # batches of 32 that wait long enough to fill: a batch of one
    # transcript would take the same-transcript path
    union_segs = golden_segs(mg["union"])
    phase_serve(al, [(mg["texts"][i % N_MIXED], mixed_audio(i % N_MIXED),
                      union_segs[i % N_MIXED]) for i in range(2 * N_MIXED)],
                "mixed", max_batch=N_MIXED, max_wait_ms=5000.0)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    missing = [n for n, k in launches.items() if k == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    entries = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, _, src, rep in KERNELS]
    sources = {name: src for name, _, src, _ in KERNELS}
    entries += [dict(name=entry, route="cuda", source=sources[kernel],
                     replaces=rep, launches=launches[kernel],
                     **results[entry])
                for entry, kernel, rep in VARIANTS]
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
