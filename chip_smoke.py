#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA aligner on one NVIDIA Hopper GPU.

Drives ``soundswallower_tpu_torch`` through the entry points a user
calls (``TorchAligner.align_batch``, ``align_batch_scored``, the
pipelined ``align_batch_begin``/``align_batch_end``, the HTTP service,
and, on the device front end, ``align``, ``stream`` and
``spectrogram``, and grammar decode: ``set_grammar``, ``decode``,
``decode_batch``, ``decode_batch_scored``, ``decode_search``, ``lattice``
and ``nbest``, and the sequence-parallel ``align_longform_batch`` on a
local ring (parallel.seq_ring)), with ``dist_mode="mxu"``, under
``SST_WIRE=f32`` and with ``remove_dc``, on synthetic models at the
published en-us width
(tools/make_synth_model.py, seed 0: 8-bit ptm, the backends 4-bit ptm,
semi, 4-bit semi and ms, and the 5-state ptm5st), against results the
JAX package computed for the same audio (tests/golden/torch-synth/
segs.json for one transcript, mixed_segs.json for 32 different ones,
device_fe.json and device_fe.npz for its device front end, backends.json
and backends.npz for the other backends, decode.json and decode.npz for
grammar decode, the 5-state model and large graphs, longform.json for
the long form and the repaired configurations) and against the C
reference's cepstra
(tests/golden/austen-en/mfcc.f32).  Phases, in order; any failure
raises, so the exit code is non-zero and the last line is not printed:

1. device: a CUDA device of compute capability 9.0;
2. build every kernel from ``soundswallower_tpu_torch/csrc``;
3. models and batches; two 8-bit ptm aligners and two ptm5st ones, one
   of each on the host C++ front end and one under ``SST_FE=device``,
   one aligner per other backend (host front end), and two more 8-bit
   ptm ones: ``remove_dc=True`` (the device front end) and
   ``SST_WIRE=f32``;
4. each kernel (K1-K12, K1's float32 form and K4's carry form) against
   its plain PyTorch version on the card, bit-equal, at the shapes the
   paths give it (K2/K3 at the full-inventory shape and K11/K12 on a
   slice of the dense routes' frames; K8-K10 on the whole B=256 batch
   and at 16 kHz, nfft 512; K3's wrap_u8 on the 4-bit semi union route,
   K7's semi form on the semi dense route; K4, K6 and the carry form in
   their 5-state forms on the ptm5st paths, K4 with scores on the
   same-transcript batch, the global-state layout with int16 tokens on
   a transcript of REPEATS repeats at B=4, T=256, and with int32 tokens
   on the large grammar's decode paths), with median times, each
   kernel's bound from this run's inputs and, where one PyTorch call
   computes the same function, that call's time; the device front end's
   cepstra of austen.raw against the C reference's; the device front end
   per B=256 batch beside the host C++ one (informational); then K13 on
   rank 0's token chunk of the long-form batch (int16) and of the large
   grammar's batch (int32), K4's carry form on a long-form chunk, K2's
   mxu form (graph scorer, full inventory), K8 with remove_dc and K1's
   float32 form on the f32 wire's cepstra;
5. host-FE paths: align_batch on the 8 golden utterances, then 2
   pipelined batches of 256 (the 8 tiled); on a fresh union, align_batch
   on the 32 mixed rows, 2 pipelined batches of 256 that tile them,
   align_batch with the union forced dense, align_batch_scored (scores
   included); concurrent POST /v1/align of one transcript, then of the
   32 mixed ones (the union no longer grows), and GET /v1/health;
6. device-FE paths: the same-transcript and the mixed batches (B=8 and
   B=32, then 2 pipelined batches of 256 each), ``align`` on the
   single-utterance path, ``spectrogram`` raw and smooth, and ``stream``
   with austen.raw pushed whole, in 1600- and in 777-sample pieces, its
   ``state()`` at the golden's cut, the golden checkpoint restored and a
   mid-stream checkpoint of its own restored;
7. backend paths: each backend's full-inventory scores of 12 golden
   frames; ms: 2 pipelined batches of 256 of one transcript and 2 of
   the 32 mixed ones (the dense route: K11, K12, K5, K6), and
   ``align_batch_scored`` on the 32; 4-bit semi: 2 pipelined batches
   of 256 of one transcript, then on a fresh union 2 of the mixed ones,
   then the 32 with the union forced dense; 4-bit ptm: 2 pipelined
   batches of one transcript; semi: ``align_batch_scored`` on the 32;
8. decode paths (8-bit ptm): ``set_grammar`` on the decode grammar
   (its graph against the golden's arrays), ``decode_batch`` on 256 rows
   of which the last is too short to reach a final node,
   ``decode_batch_scored`` on 32, ``decode`` on the host and on the
   device front end, ``decode_search``'s hyp and segments, the
   ``lattice``'s node and link counts and the first 5 of ``nbest``;
9. 5-state paths (ptm5st): 2 pipelined same-transcript batches of 256,
   on a fresh union 2 of the mixed ones, ``align_batch_scored`` on the
   32, ``align`` on the device front end;
10. large-graph paths (8-bit ptm): a same-transcript batch with
   ``want_scores``; a transcript of REPEATS repeats (more phones than a
   block's shared memory holds), alone and in a forced-dense mixed
   batch; the large grammar (S >= 32,767: int32 tokens, global state)
   through ``decode_batch``, ``decode_batch_scored`` and the device-FE
   ``decode``;
11. the long form (8-bit ptm): ``align_longform_batch`` on 4 rows of
   AUSTEN tiled past 60 s on local rings of 8 and 1 ranks, against
   longform.json and ``align_batch``; ``align_longform`` on the large
   grammar (int32 tokens) against ``viterbi_single``; one row of about 5
   minutes through both routes (its token-stack bytes, informational);
12. the repaired configurations, each counted on its own: ``mxu``
   (``align_batch``, ``align_batch_scored``), ``wire_f32`` (same
   transcript, mixed, scored) and ``remove_dc`` (``align_batch``,
   ``align``, ``spectrogram``).

Every row, score, segment list, spectrogram and checkpoint equals its
golden.  The launch counts are reset before each of phases 5-12 and
read after it; a kernel of a path, or a form of the Viterbi kernels
(5-state, int32, global, scores) on the path that drives it, launched
no time there fails the run.  The last lines are one JSON object of
per-kernel results, the card's name and power limit (nvidia-smi), and
``{"ok": true, "device": {...}}``.

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

from make_synth_model import VARIANTS as MODEL_VARIANTS  # noqa: E402
from make_synth_model import make_synth_model  # noqa: E402
from make_torch_backends_golden import (dense_feats,  # noqa: E402
                                        load_backends_golden)
from make_torch_decode_golden import (GRAMMAR, GRAPH_FIELDS,  # noqa: E402
                                      N_BEST, N_DECODE, decode_audio,
                                      decode_rep, large_grammar,
                                      load_decode_golden, search_rep)
from make_torch_device_fe_golden import (CKPT_SAMPLES,  # noqa: E402
                                         STREAM_SPLIT, load_device_fe_golden,
                                         pieces)
from make_torch_longform_golden import (LONG_B, MIXED,  # noqa: E402
                                        dc_audio, load_longform_golden,
                                        longform_audio, longform_text,
                                        spec_sha)
from make_torch_mixed_golden import (N_MIXED, load_mixed_golden,  # noqa: E402
                                     mixed_audio, scored_rep)
from make_torch_synth_golden import (N_UTT, SAMPRATE, TEXT,  # noqa: E402
                                     austen_audio, load_golden, segs_rep)
from soundswallower_tpu_torch.aligner import TorchAligner, WordSeg  # noqa: E402
from soundswallower_tpu_torch.fe import feat as feat_mod  # noqa: E402
from soundswallower_tpu_torch.fe import frontend as fe_mod  # noqa: E402
from soundswallower_tpu_torch.ops import align_torch, senscore_torch  # noqa: E402
from soundswallower_tpu_torch.parallel import seq_ring  # noqa: E402
from soundswallower_tpu_torch.serve import make_server, segs_to_json  # noqa: E402
from soundswallower_tpu_torch.streaming import AlignStream  # noqa: E402
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
    ("fe_spec", fe_mod.fe_spec, "soundswallower_tpu_torch/csrc/fe_spec.cu",
     "soundswallower_tpu/fe/frontend.py:484"),
    ("fe_noise", fe_mod.fe_noise, "soundswallower_tpu_torch/csrc/fe_noise.cu",
     "soundswallower_tpu/fe/frontend.py:343"),
    ("fe_cep", fe_mod.fe_cep, "soundswallower_tpu_torch/csrc/fe_cep.cu",
     "soundswallower_tpu/fe/frontend.py:418"),
    ("feat_f32", feat_mod.feat_f32, "soundswallower_tpu_torch/csrc/feat.cu",
     "soundswallower_tpu/fe/feat.py:372"),
    ("viterbi_chunk", align_torch.viterbi_chunk,
     "soundswallower_tpu_torch/csrc/viterbi.cu",
     "soundswallower_tpu/ops/align_jax.py:265"),
    ("ms_dist_topn", senscore_torch.ms_dist_topn,
     "soundswallower_tpu_torch/csrc/ms_senscore.cu",
     "soundswallower_tpu/ops/senscore_jax.py:316"),
    ("ms_senone_eval", senscore_torch.ms_senone_eval,
     "soundswallower_tpu_torch/csrc/ms_senscore.cu",
     "soundswallower_tpu/ops/senscore_jax.py:323"),
    ("backtrace_chunk", align_torch.backtrace_chunk,
     "soundswallower_tpu_torch/csrc/backtrace_chunk.cu",
     "soundswallower_tpu/parallel/seqpipe.py:188"),
]
# the kernels each counted path must launch
HOST_PATH = ["feat", "dist_topn_norm", "senone_eval", "viterbi_batch",
             "gather_cols", "viterbi_rows", "frame_best_sub"]
DEVICE_FE_PATH = ["fe_spec", "fe_noise", "fe_cep", "feat_f32",
                  "dist_topn_norm", "senone_eval", "viterbi_batch",
                  "gather_cols", "viterbi_rows", "viterbi_chunk"]
BACKEND_PATH = ["feat", "dist_topn_norm", "senone_eval", "viterbi_batch",
                "gather_cols", "viterbi_rows", "frame_best_sub",
                "ms_dist_topn", "ms_senone_eval"]
# the path each kernel's launch count is read from
PATH_OF = {**{n: "device-FE" for n in DEVICE_FE_PATH},
           **{n: "host-FE" for n in HOST_PATH},
           "ms_dist_topn": "backends", "ms_senone_eval": "backends",
           "backtrace_chunk": "longform"}
BACKENDS = ("ms", "semi4b", "ptm4b", "semi")
# further measured shapes of a kernel: (entry, kernel, TPU program[, path])
VARIANTS = [
    ("gather_cols[int16 full inventory]", "gather_cols",
     "soundswallower_tpu/aligner.py:49"),
    ("viterbi_rows[scores]", "viterbi_rows",
     "soundswallower_tpu/ops/align_jax.py:700"),
    ("dist_topn_norm[full inventory]", "dist_topn_norm",
     "tools/exp_pallas2.py:54"),
    ("senone_eval[full inventory]", "senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:254"),
    ("fe_noise[masked, carried]", "fe_noise",
     "soundswallower_tpu/fe/frontend.py:403"),
    ("fe_cep[logspec]", "fe_cep", "soundswallower_tpu/fe/frontend.py:535"),
    ("fe_spec[16 kHz, nfft 512]", "fe_spec",
     "soundswallower_tpu/fe/frontend.py:285"),
    ("fe_noise[16 kHz]", "fe_noise", "soundswallower_tpu/fe/frontend.py:343"),
    ("fe_cep[16 kHz, legacy]", "fe_cep",
     "soundswallower_tpu/fe/frontend.py:418"),
    ("viterbi_chunk[single, backtrace]", "viterbi_chunk",
     "soundswallower_tpu/ops/align_jax.py:665"),
    ("senone_eval[wrap_u8]", "senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:557", "backends"),
    ("frame_best_sub[semi]", "frame_best_sub",
     "soundswallower_tpu/ops/senscore_jax.py:301", "backends"),
    ("feat_f32[wire f32]", "feat_f32", "soundswallower_tpu/fe/feat.py:372",
     "wire_f32"),
    ("viterbi_chunk[long form, 8 ranks]", "viterbi_chunk",
     "soundswallower_tpu/parallel/seqpipe.py:118", "longform"),
]
# the Viterbi forms beyond 3 states, int16 tokens and shared memory:
# (entry, kernel, form, the path whose count of that form is its
# launches, TPU program)
FORMS = [
    ("viterbi_batch[5-state]", "viterbi_batch", "5-state", "5-state",
     "soundswallower_tpu/ops/align_jax.py:121"),
    ("viterbi_rows[5-state]", "viterbi_rows", "5-state", "5-state",
     "soundswallower_tpu/ops/align_jax.py:121"),
    ("viterbi_rows[5-state, scores]", "viterbi_rows", "5-state, scores",
     "5-state", "soundswallower_tpu/ops/align_jax.py:700"),
    ("viterbi_chunk[5-state]", "viterbi_chunk", "5-state", "5-state",
     "soundswallower_tpu/ops/align_jax.py:265"),
    ("viterbi_batch[3-state, scores]", "viterbi_batch", "3-state, scores",
     "large", "soundswallower_tpu/aligner.py:1499"),
    ("viterbi_batch[3-state, global]", "viterbi_batch", "3-state, global",
     "large", "soundswallower_tpu/ops/align_jax.py:607"),
    ("viterbi_rows[3-state, global]", "viterbi_rows", "3-state, global",
     "large", "soundswallower_tpu/aligner.py:1032"),
    ("viterbi_batch[3-state, int32, global]", "viterbi_batch",
     "3-state, int32, global", "large",
     "soundswallower_tpu/ops/align_jax.py:638"),
    ("viterbi_rows[3-state, int32, global, scores]", "viterbi_rows",
     "3-state, int32, global, scores", "large",
     "soundswallower_tpu/ops/align_jax.py:638"),
    ("viterbi_chunk[3-state, int32, global]", "viterbi_chunk",
     "3-state, int32, global", "large",
     "soundswallower_tpu/ops/align_jax.py:368"),
    # the forms of PR 6: K13's token widths, K2's mxu form, K8's remove_dc
    ("backtrace_chunk[int16]", "backtrace_chunk", "int16", "longform",
     "soundswallower_tpu/parallel/seqpipe.py:188"),
    ("backtrace_chunk[int32]", "backtrace_chunk", "int32", "longform",
     "soundswallower_tpu/parallel/seqpipe.py:188"),
    ("dist_topn_norm[mxu]", "dist_topn_norm", "mxu", "mxu",
     "soundswallower_tpu/ops/senscore_jax.py:538"),
    ("dist_topn_norm[mxu, full inventory]", "dist_topn_norm", "mxu", "mxu",
     "soundswallower_tpu/ops/senscore_jax.py:242"),
    ("fe_spec[remove_dc]", "fe_spec", "remove_dc", "remove_dc",
     "soundswallower_tpu/fe/frontend.py:513"),
]
# the kernels each of the decode, 5-state and large-graph paths must
# launch: both front ends, both batch routes, K7 and the carry form
SLICE_PATH = ["feat", "dist_topn_norm", "senone_eval", "viterbi_batch",
              "gather_cols", "viterbi_rows", "frame_best_sub", "fe_spec",
              "fe_noise", "fe_cep", "feat_f32", "viterbi_chunk"]
# the long form (K4's carry form per chunk, K13 back), and the paths
# of the repaired configurations
LONGFORM_PATH = ["feat", "dist_topn_norm", "senone_eval", "viterbi_chunk",
                 "backtrace_chunk", "viterbi_batch"]
MXU_PATH = ["feat", "dist_topn_norm", "senone_eval", "viterbi_batch",
            "gather_cols", "viterbi_rows", "frame_best_sub"]
WIRE_F32_PATH = ["feat_f32", "dist_topn_norm", "senone_eval",
                 "viterbi_batch", "gather_cols", "viterbi_rows",
                 "frame_best_sub"]
REMOVE_DC_PATH = ["fe_spec", "fe_noise", "fe_cep", "feat_f32",
                  "dist_topn_norm", "senone_eval", "viterbi_batch",
                  "viterbi_chunk"]
N_SEQ = 8               # ranks of the long form's local ring
LONG_K5 = 100           # AUSTEN repeats of the informational long row
REPEATS = 130           # transcript repeats of the int16 global-state graph
BIG_B = 256
N_BATCHES = 2
N_BACKEND_BATCHES = 2
N_FIVE_BATCHES = 2
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


# NVIDIA H100 SXM peaks (data sheet, 700 W): HBM3 bytes/s; float32
# outside the tensor cores; int32 (64 lanes per SM against float32's
# 128: half the float32 rate); float64 outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
I32_OPS = 33.5e12
F64_OPS = 34e12


def nbytes(*xs) -> int:
    """Bytes of tensors, of tuples of them, and of the tensor fields of
    the scorer and graph tables (each counted once)."""
    total = 0
    for x in xs:
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        else:
            total += nbytes(*[v for v in vars(x).values()
                              if isinstance(v, torch.Tensor)])
    return total


def compare(name, fn, plain, results, plain_runs: int = 10, ins=(),
            ops: float = 0.0, rate: float = F32_OPS, library=None,
            runs: int = 10):
    """Kernel vs plain PyTorch on the same device inputs: bit-equal (every
    output, dtypes included).
    ``bound_ms`` is the larger of the bytes (``ins``, read once, and the
    kernel's outputs, written once) over HBM_BPS and ``ops`` over
    ``rate``; ``library`` is one PyTorch call computing the same
    function, timed beside the kernel (used nowhere in the port)."""
    out_k = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = plain()
    end.record()
    torch.cuda.synchronize()
    err = max_abs_err(out_k, out_p)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max_abs_err {err})")
    ms = time_ms(fn, runs)
    # plain_runs=0: the plain version's time is that of the comparison call
    plain_ms = (time_ms(plain, plain_runs) if plain_runs
                else start.elapsed_time(end))
    b = bound(nbytes(*ins) + nbytes(out_k), ops, rate)
    lib_ms = None if library is None else time_ms(library)
    log(f"  {name}: bit-equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
        + ("" if lib_ms is None else f", one PyTorch call {lib_ms:.4f} ms"))
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                         library_ms=lib_ms)
    return out_k


def bound(n_bytes: int, ops: float, rate: float) -> dict:
    """The least time for the work: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    b_ms = n_bytes / HBM_BPS * 1e3
    o_ms = ops / rate * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


def fold_ops(N: int, sc) -> float:
    """K2's and K11's float work: 4 operations per density and dim (a
    subtraction, a square, a fused multiply-add), N frames."""
    C, F, D, L = sc.means.shape
    return 4.0 * N * C * F * D * L


def vit_ops(sen: torch.Tensor) -> float:
    """K4's and K6's int32 work: about 10 operations per frame and state
    (the HMM update's adds and maxes, the predecessor max, the token)."""
    return 10.0 * sen.numel()


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
                    results, ins=(pl, Tn), ops=8.0 * n * Tmax * 13)
        flat = feats.view(n * Tmax, 3, -1)
        if first:
            s, cw = compare(
                "dist_topn_norm",
                lambda: senscore_torch.dist_topn_norm(flat, c.gs),
                lambda: senscore_torch.dist_topn_norm_plain(flat, c.gs),
                results, ins=(flat, c.gs.means, c.gs.var_t, c.gs.det),
                ops=fold_ops(flat.shape[0], c.gs))
            compare("senone_eval",
                    lambda: senscore_torch.senone_eval(s, cw, c.gs),
                    lambda: senscore_torch.senone_eval_plain(s, cw, c.gs),
                    results, **eval_bound(s, cw, c.gs))
        senscore_torch.score_frames_graph(
            c.gs, flat, out=sen[i0:i0 + n].view(n * Tmax, -1))
    log(f"  shapes: B={len(audios)} Tmax={Tmax} S={c.gs.S} "
        f"Cu={c.gs.means.shape[0]} P={c.vit.P} K={c.vit.pred_idx.shape[1]}")
    compare("viterbi_batch",
            lambda: align_torch.viterbi_batch(sen, Ts_d, c.vit),
            lambda: align_torch.viterbi_batch_plain(sen, Ts_d, c.vit),
            results, ins=(sen, Ts_d, c.vit), ops=vit_ops(sen), rate=I32_OPS)


def eval_bound(s, cw, gs) -> dict:
    """K3's bound arguments: the top-N scores and indices, the mixture
    weights, the column map and the table in; about 6 int32 operations
    per (frame, state, stream, top-N entry)."""
    N, _, F, topn = s.shape
    return dict(ins=(s, cw, gs.mixw, gs.cb_pos, gs.logadd),
                ops=6.0 * N * gs.S * F * topn, rate=I32_OPS)


def gather_library(src, cols):
    """One PyTorch call for K5 on in-range columns: torch.gather."""
    idx = cols.long().clamp(0, src.shape[2] - 1)[:, None, :].expand(
        src.shape[0], src.shape[1], -1).contiguous()
    return lambda: torch.gather(src, 2, idx)


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
                    results, ins=(src, cols),
                    library=gather_library(src, cols))
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
                results, plain_runs=0, ins=(sen, Ts_d, v), ops=vit_ops(sen),
                rate=I32_OPS)
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
            results, plain_runs=0, ins=(part, ds.means, ds.var_t, ds.det),
            ops=fold_ops(part.shape[0], ds))
        compare("senone_eval[full inventory]",
                lambda: senscore_torch.senone_eval(s, cw, ds),
                lambda: senscore_torch.senone_eval_plain(s, cw, ds),
                results, plain_runs=0, **eval_bound(s, cw, ds))
        s, cw = senscore_torch.dist_topn_norm(flat, ds)
        x = senscore_torch.senone_eval(s, cw, ds)
        compare("frame_best_sub",
                lambda: senscore_torch.frame_best_sub(x),
                lambda: senscore_torch.frame_best_sub_plain(x), results,
                ins=(x,), ops=2.0 * x.numel(), rate=I32_OPS)
        src = senscore_torch.frame_best_sub(x).view(len(audios), Tmax, -1)
        compare("gather_cols[int16 full inventory]",
                lambda: senscore_torch.gather_cols(src, cols),
                lambda: senscore_torch.gather_cols_plain(src, cols),
                results, ins=(src, cols), library=gather_library(src, cols))


def wall_ms(fn, runs: int = 5) -> float:
    """Median host wall time of fn (which ends in a synchronize), after
    one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_kernels_fe(al_dev: TorchAligner, al_host: TorchAligner,
                     big: list, results: dict):
    """K8, K9, K10 and K1's float32 form on the device-FE route's B=256
    batch, one launch each over all rows (the route launches 128-row
    chunks), K9 also in the stream's masked form from a carried state;
    K8-K10 at 16 kHz with nfft 512; the device FE's cepstra of
    austen.raw against the C reference's; the device FE per B=256 batch
    beside the host C++ FE (informational)."""
    fe, dev = al_dev.fe, al_dev.device
    audios, Ts, Tmax = al_dev._batch_shape(big)
    B = len(audios)
    ns_h = np.array([len(a) for a in audios], np.int32)
    buf = np.zeros((B, int(ns_h.max())), np.int16)
    for i, a in enumerate(audios):
        buf[i, :len(a)] = a
    sig = torch.from_numpy(buf).to(dev)
    ns = torch.from_numpy(ns_h).to(dev)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(dev)
    prior = torch.zeros(B, dtype=torch.float32, device=dev)
    log(f"  device FE shapes: B={B} N={buf.shape[1]} Tmax={Tmax} "
        f"nfft={fe.fft_size} nfilt={fe.num_filters} ncep={fe.num_cepstra}")
    spec = compare("fe_spec", lambda: fe_mod.fe_spec(fe, sig, ns, prior, Tmax),
                   lambda: fe_mod.fe_spec_plain(fe, sig, ns, prior, Tmax),
                   results, plain_runs=0, **spec_bound(fe, sig, ns, prior,
                                                       B * Tmax))
    fresh = fe.noise_init(B, dev)
    den, carry = compare(
        "fe_noise", lambda: fe_mod.fe_noise(fe, spec, fresh),
        lambda: fe_mod.fe_noise_plain(fe, spec, fresh, None), results,
        plain_runs=0, ins=(spec, fresh), ops=40.0 * spec.numel(),
        rate=F64_OPS)
    compare("fe_noise[masked, carried]",
            lambda: fe_mod.fe_noise(fe, spec, carry, Ts_d),
            lambda: fe_mod.fe_noise_plain(fe, spec, carry, Ts_d), results,
            plain_runs=0, ins=(spec, carry, Ts_d), ops=40.0 * spec.numel(),
            rate=F64_OPS)
    cep = compare("fe_cep", lambda: fe_mod.fe_cep(fe, den),
                  lambda: fe_mod.fe_cep_plain(fe, den), results, plain_runs=0,
                  **cep_bound(fe, den))
    compare("fe_cep[logspec]", lambda: fe_mod.fe_cep(fe, den, True),
            lambda: fe_mod.fe_cep_plain(fe, den, True), results, plain_runs=0,
            ins=(den,), ops=2.0 * den.numel(), rate=F64_OPS,
            library=lambda: torch.log(den))
    compare("feat_f32", lambda: feat_mod.feat_f32(cep, Ts_d, al_dev.do_cmn),
            lambda: feat_mod.feats_plain(cep, Ts_d, al_dev.do_cmn), results,
            ins=(cep, Ts_d), ops=6.0 * cep.numel())
    dev_fe = sum(results[k]["ms"] for k in ("fe_spec", "fe_noise", "fe_cep",
                                             "feat_f32"))
    log(f"  device FE kernels on the B={B} batch, K8+K9+K10+K1: "
        f"{dev_fe:.4f} ms")

    # 16 kHz, nfft 512, 40 filters, legacy DCT, noise removal
    fe16 = fe_mod.Frontend(sampling_rate=16000, fft_size=512, num_filters=40,
                           transform="legacy", remove_noise=True)
    rng = np.random.RandomState(16)
    B16, N16 = 64, 3 * 16000
    x16 = torch.from_numpy(np.clip(np.round(rng.randn(B16, N16) * 3000),
                                   -32768, 32767).astype(np.int16)).to(dev)
    ns16 = torch.from_numpy(rng.randint(N16 // 3, N16 + 1, B16)
                            .astype(np.int32)).to(dev)
    T16 = fe16.n_frames(N16)
    p16 = torch.zeros(B16, dtype=torch.float32, device=dev)
    log(f"  16 kHz shapes: B={B16} N={N16} T={T16} nfft={fe16.fft_size} "
        f"nfilt={fe16.num_filters}")
    spec16 = compare("fe_spec[16 kHz, nfft 512]",
                     lambda: fe_mod.fe_spec(fe16, x16, ns16, p16, T16),
                     lambda: fe_mod.fe_spec_plain(fe16, x16, ns16, p16, T16),
                     results, plain_runs=0,
                     **spec_bound(fe16, x16, ns16, p16, B16 * T16))
    fresh16 = fe16.noise_init(B16, dev)
    den16, _ = compare("fe_noise[16 kHz]",
                       lambda: fe_mod.fe_noise(fe16, spec16, fresh16),
                       lambda: fe_mod.fe_noise_plain(fe16, spec16, fresh16,
                                                     None),
                       results, plain_runs=0, ins=(spec16, fresh16),
                       ops=40.0 * spec16.numel(), rate=F64_OPS)
    compare("fe_cep[16 kHz, legacy]", lambda: fe_mod.fe_cep(fe16, den16),
            lambda: fe_mod.fe_cep_plain(fe16, den16), results, plain_runs=0,
            **cep_bound(fe16, den16))

    # the C reference's cepstra for this front end
    golden = os.path.join(REPO, "tests", "golden")
    raw = np.fromfile(os.path.join(golden, "austen.raw"), np.int16)
    want = np.fromfile(os.path.join(golden, "austen-en", "mfcc.f32"),
                       np.float32).reshape(-1, fe.num_cepstra)
    got = fe.process_int16(raw, device=dev)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("device FE cepstra of austen.raw differ from "
                             "tests/golden/austen-en/mfcc.f32")
    log(f"  device FE cepstra of austen.raw ({len(want)} frames): equal to "
        f"the C reference's mfcc.f32")

    # one B=256 batch's front end, host C++ against device (informational)
    chunk = al_host._chunk_size(B)

    def host_fe():
        for i0 in range(0, B, chunk):
            al_host.native_fe.process_list_i16p(audios[i0:i0 + chunk], Tmax,
                                                al_host.wire_scale)

    def device_fe():
        for _ in al_dev._chunk_feats(audios, Ts_d, Tmax):
            pass
        torch.cuda.synchronize()

    order = [("host", host_fe), ("device", device_fe), ("device", device_fe),
             ("host", host_fe)]
    fe_walls = [(k, wall_ms(fn)) for k, fn in order]
    log(f"  front end per B={B} batch, median wall of 5 (host C++ "
        "process_list_i16p per 128-row chunk; device: pinned int16 "
        "upload, K8-K10, K1 per chunk): "
        + ", ".join(f"{k} {ms:.3f} ms" for k, ms in fe_walls)
        + " (informational)")


def spec_bound(fe, sig, ns, prior, frames: int) -> dict:
    """K8's bound arguments: the signal, counts, priors and tables in;
    float64 work per frame: pre-emphasis and window (3 per sample), the
    FFT (5 n log2 n), the power spectrum (3 per bin), the mel fold (2
    per coefficient)."""
    n = fe.fft_size
    per = (3 * fe.frame_size + 5 * n * (n.bit_length() - 1)
           + 3 * (n // 2 + 1) + 2 * int(fe._widths.sum()))
    return dict(ins=(sig, ns, prior, list(fe.tables(sig.device).values())),
                ops=float(per) * frames, rate=F64_OPS)


def cep_bound(fe, den) -> dict:
    """K10's bound arguments: the mel spectra and DCT tables in; per
    frame a log per filter, the DCT (2 per coefficient and filter) and
    the lifter, in float64."""
    M = den.numel() // fe.num_filters
    t = fe.tables(den.device)
    per = fe.num_filters * (1 + 2 * fe.num_cepstra) + fe.num_cepstra
    return dict(ins=(den, t["mel_cosine"], t["lifter"]), ops=float(per) * M,
                rate=F64_OPS)


def phase_kernels_vit_chunk(al_dev: TorchAligner, results: dict):
    """K4's carry form at the stream's shape (the first 128-frame chunk
    from vit_carry0) and at the single-utterance path's (austen_audio(0)
    on the device FE, the frame axis bucketed to 128, with the final
    select and backtrace)."""
    dev = al_dev.device
    a = austen_audio(0)
    c = al_dev._graph_consts(al_dev.graph_for_text(TEXT))
    n = len(a)
    T = al_dev.fe.n_frames(n)
    Tpad = max(128, -(-T // 128) * 128)
    cep = al_dev.fe.mfcc(torch.from_numpy(a).to(dev)[None], n, Tpad)
    Tn = torch.tensor([T], dtype=torch.int32, device=dev)
    feats = feat_mod.feat_f32(cep, Tn, al_dev.do_cmn)[0]
    sen = senscore_torch.score_frames_graph(c.gs, feats)
    first = sen[:AlignStream.CHUNK]
    carry0 = align_torch.vit_carry0(c.vit)
    log(f"  carry-form shapes: chunk {AlignStream.CHUNK} frames, single "
        f"T={T} Tpad={Tpad}, S={sen.shape[1]} P={c.vit.P} "
        f"K={c.vit.pred_idx.shape[1]}")
    compare("viterbi_chunk",
            lambda: align_torch.viterbi_chunk(first, carry0, 0, T, c.vit),
            lambda: align_torch.viterbi_chunk_plain(first, carry0, 0, T,
                                                    c.vit),
            results, plain_runs=0, ins=(first, carry0, c.vit),
            ops=vit_ops(first), rate=I32_OPS)
    compare("viterbi_chunk[single, backtrace]",
            lambda: align_torch.viterbi_single(sen, T, c.vit),
            lambda: align_torch.viterbi_single_plain(sen, T, c.vit),
            results, plain_runs=0, ins=(sen, c.vit), ops=vit_ops(sen),
            rate=I32_OPS)


def check_rows(out, want, what, rep=segs_rep):
    got = [rep(s) for s in out]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: rows {bad[:8]} differ from the golden")


def pipelined(al: TorchAligner, big: list, texts: list, want: list,
              what: str, n_batches: int = N_BATCHES):
    """n_batches pipelined batches of the same rows, every row checked;
    one wall time per batch, from end() to end()."""
    audio_s = sum(len(a) for a in big) / SAMPRATE
    handles, walls = [], []
    t_prev = time.perf_counter()
    for k in range(n_batches + 1):
        if k < n_batches:
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
    log(f"  {n_batches} pipelined {what} batches of {len(big)}: every row "
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


def check_state(got: dict, want: dict, what: str):
    """A stream checkpoint against the golden one: every key, and every
    array's dtype, shape and values."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k, w in want.items():
        xs, ws = (got[k], w) if isinstance(w, tuple) else ((got[k],), (w,))
        if len(xs) != len(ws):
            raise AssertionError(f"{what}: {k} has {len(xs)} parts")
        for x, v in zip(xs, ws):
            if isinstance(v, (np.ndarray, np.generic)):
                x = np.asarray(x)
                same = (x.dtype == v.dtype and x.shape == v.shape
                        and np.array_equal(x, v))
            else:
                same = x == v
            if not same:
                raise AssertionError(f"{what}: {k} differs from the golden")


def phase_device_fe(al: TorchAligner, audios8: list, dg: dict):
    """The device-FE aligner's entry points against device_fe.json."""
    t0 = time.perf_counter()
    check_rows(al.align_batch(audios8, [TEXT] * N_UTT), dg["same"],
               f"device-FE align_batch (B={N_UTT})")
    log(f"  device-FE align_batch B={N_UTT}: equal to the golden "
        f"({time.perf_counter() - t0:.3f} s, first call)")
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    pipelined(al, big, [TEXT] * BIG_B,
              [dg["same"][i % N_UTT] for i in range(BIG_B)],
              "device-FE same-transcript")
    fresh_union(al)
    texts = dg["texts"]
    mixed = [mixed_audio(i) for i in range(N_MIXED)]
    check_rows(al.align_batch(mixed, texts), dg["mixed"],
               f"device-FE mixed align_batch (B={N_MIXED})")
    log(f"  device-FE mixed align_batch B={N_MIXED}: equal to the golden")
    pipelined(al, [mixed[i % N_MIXED] for i in range(BIG_B)],
              [texts[i % N_MIXED] for i in range(BIG_B)],
              [dg["mixed"][i % N_MIXED] for i in range(BIG_B)],
              "device-FE mixed")
    a0 = audios8[0]
    t0 = time.perf_counter()
    check_rows([al.align(a0, TEXT)], [dg["align"]], "device-FE align")
    log(f"  align, single-utterance device path: equal to the golden "
        f"({time.perf_counter() - t0:.3f} s)")
    for smooth, key in ((False, "spec_raw"), (True, "spec_smooth")):
        got = al.spectrogram(a0, smooth)
        if got.dtype != np.float32 or not np.array_equal(got, dg[key]):
            raise AssertionError(f"spectrogram(smooth={smooth}) differs "
                                 f"from the golden")
    log(f"  spectrogram raw and smooth {dg['spec_raw'].shape}: equal to the "
        f"golden")
    mid = None
    for split in (len(a0), STREAM_SPLIT, 777):
        t0 = time.perf_counter()
        s = al.stream(TEXT)
        pushed = 0
        for p in pieces(a0, split):
            s.push(p)
            pushed += len(p)
            if split == STREAM_SPLIT and pushed == CKPT_SAMPLES:
                check_state(s.state(), dg["state"], "stream checkpoint")
            if split == 777 and mid is None and pushed >= len(a0) // 2:
                mid = (s.state(), pushed)
        check_rows([s.end()], [dg["stream"]],
                   f"stream in {split}-sample pieces")
        log(f"  stream, {split}-sample pieces: equal to the golden "
            f"({time.perf_counter() - t0:.3f} s)")
    log(f"  stream state() after {CKPT_SAMPLES} samples: every key, dtype "
        f"and value equal to the golden checkpoint")
    r = AlignStream.restore(al, dg["state"])
    for p in pieces(a0[CKPT_SAMPLES:], STREAM_SPLIT):
        r.push(p)
    check_rows([r.end()], [dg["stream"]], "stream from the golden checkpoint")
    state, pushed = mid
    r = AlignStream.restore(al, state)
    for p in pieces(a0[pushed:], 777):
        r.push(p)
    check_rows([r.end()], [dg["stream"]], "stream from its own checkpoint")
    log(f"  stream restored from the golden checkpoint and from its own "
        f"after {pushed} samples: equal to the golden")


def phase_kernels_backends(als: dict, results: dict):
    """K11 and K12 on the ms model's B=256 same-transcript batch (its
    first 128-row chunk; compared on DENSE_SLICE frames, the kernels
    also timed on the whole chunk), K3's wrap_u8 on the 4-bit semi
    union route's B=256 batch, K7's semi form on the semi dense route's
    B=32 batch; every backend's full-inventory scores of the golden's
    frames."""
    al = als["ms"]
    ms = al.dense
    big = [austen_audio(i % N_UTT) for i in range(BIG_B)]
    audios, Ts, Tmax = al._batch_shape(big)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    flat = feats.view(-1, 3, feats.shape[-1])
    part = flat[:DENSE_SLICE]
    C, F, D, L = ms.means.shape
    log(f"  ms shapes: chunk N={flat.shape[0]} frames, compared on "
        f"N={part.shape[0]}; C={C} F={F} D={D} L={L} top-{ms.n_best} "
        f"S={ms.S} aw={ms.aw}")
    dval, cw = compare(
        "ms_dist_topn", lambda: senscore_torch.ms_dist_topn(part, ms),
        lambda: senscore_torch.ms_dist_topn_plain(part, ms), results,
        plain_runs=0, ins=(part, ms.means, ms.var_t, ms.det),
        ops=fold_ops(part.shape[0], ms))
    compare("ms_senone_eval",
            lambda: senscore_torch.ms_senone_eval(dval, cw, ms),
            lambda: senscore_torch.ms_senone_eval_plain(dval, cw, ms),
            results, plain_runs=0,
            ins=(dval, cw, ms.mixw, ms.sen2cb, ms.logadd),
            ops=8.0 * part.shape[0] * ms.S * F * ms.n_best, rate=I32_OPS)
    k11 = time_ms(lambda: senscore_torch.ms_dist_topn(flat, ms))
    dval, cw = senscore_torch.ms_dist_topn(flat, ms)
    k12 = time_ms(lambda: senscore_torch.ms_senone_eval(dval, cw, ms))
    N = flat.shape[0]
    b11 = bound(nbytes(flat, ms.means, ms.var_t, ms.det, dval, cw),
                fold_ops(N, ms), F32_OPS)
    b12 = bound(nbytes(dval, cw, ms.mixw, ms.sen2cb, ms.logadd)
                + 2 * N * ms.S, 8.0 * N * ms.S * F * ms.n_best, I32_OPS)
    log(f"  ms kernels on the whole {N}-frame chunk (informational): "
        f"K11 {k11:.4f} ms (bound {b11['bound_ms']:.4f} ms, "
        f"{b11['bound_by']}), K12 {k12:.4f} ms (bound "
        f"{b12['bound_ms']:.4f} ms, {b12['bound_by']})")

    al = als["semi4b"]
    fresh_union(al)
    texts = load_backends_golden()["texts"]
    graphs = [al.graph_for_text(texts[i % N_MIXED]) for i in range(BIG_B)]
    uni = al._union_scorer(graphs)
    audios, Ts, Tmax = al._batch_shape([mixed_audio(i % N_MIXED)
                                        for i in range(BIG_B)])
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    gs = uni["gs"]
    if not gs.wrap_u8:
        raise AssertionError("the 4-bit semi union scorer does not wrap")
    s, cw = senscore_torch.dist_topn_norm(feats.view(-1, 3, L), gs)
    compare("senone_eval[wrap_u8]",
            lambda: senscore_torch.senone_eval(s, cw, gs),
            lambda: senscore_torch.senone_eval_plain(s, cw, gs), results,
            **eval_bound(s, cw, gs))
    fresh_union(al)

    al = als["semi"]
    audios, Ts, Tmax = al._batch_shape([mixed_audio(i)
                                        for i in range(N_MIXED)])
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    s, cw = senscore_torch.dist_topn_norm(feats.view(-1, 3, L), al.dense)
    x = senscore_torch.senone_eval(s, cw, al.dense)
    compare("frame_best_sub[semi]",
            lambda: senscore_torch.frame_best_sub(x, False),
            lambda: senscore_torch.frame_best_sub_plain(x, False), results,
            ins=(x,), ops=float(x.numel()), rate=I32_OPS,
            library=lambda: x.to(torch.int16))

    g = load_backends_golden()
    frames = torch.from_numpy(dense_feats()).to(al.device)
    for variant in BACKENDS:
        got = senscore_torch.score_frames(als[variant].dense, frames)
        if not np.array_equal(got.cpu().numpy(), g[f"{variant}_dense"]):
            raise AssertionError(f"{variant}: full-inventory scores differ "
                                 "from backends.npz")
    log(f"  full-inventory scores of {len(frames)} golden frames, "
        f"{', '.join(BACKENDS)}: equal to backends.npz")


def phase_backends(als: dict):
    """The other backends' paths against backends.json; the median
    cadence of each variant's pipelined batches (informational)."""
    g = load_backends_golden()
    texts = g["texts"]
    same = [austen_audio(i % N_UTT) for i in range(BIG_B)]
    mixed = [mixed_audio(i % N_MIXED) for i in range(BIG_B)]
    tiled = [texts[i % N_MIXED] for i in range(BIG_B)]
    mixed32 = [mixed_audio(i) for i in range(N_MIXED)]
    cadence = {}

    def run(variant, name, audios, tx, want):
        walls, audio_s = pipelined(
            als[variant], audios, tx,
            [want[i % len(want)] for i in range(BIG_B)],
            f"{variant} {name}", N_BACKEND_BATCHES)
        cadence[f"{variant} {name}"] = statistics.median(walls) * 1e3

    def scored(variant):
        check_rows(als[variant].align_batch_scored(mixed32, texts),
                   g[variant]["scored"],
                   f"{variant} align_batch_scored (B={N_MIXED})",
                   rep=scored_rep)
        log(f"  {variant} align_batch_scored B={N_MIXED}: equal to the "
            f"golden, scores included")

    run("ms", "same-transcript", same, [TEXT] * BIG_B, g["ms"]["same"])
    run("ms", "mixed", mixed, tiled, g["ms"]["mixed"])
    if not als["ms"]._uni["dense"] or als["ms"]._uni["gs"] is not None:
        raise AssertionError("the ms model left the dense route")
    scored("ms")
    al = als["semi4b"]
    run("semi4b", "same-transcript", same, [TEXT] * BIG_B,
        g["semi4b"]["same"])
    fresh_union(al)
    run("semi4b", "mixed, union", mixed, tiled, g["semi4b"]["union"])
    if al._uni["dense"] or al._uni["gs"] is None:
        raise AssertionError("the 4-bit semi mixed batches left the union")
    al._uni["dense"] = True
    check_rows(al.align_batch(mixed32, texts), g["semi4b"]["dense"],
               f"semi4b mixed align_batch (B={N_MIXED}, forced dense)")
    log(f"  semi4b mixed align_batch B={N_MIXED}, forced dense: equal to "
        f"the golden")
    run("ptm4b", "same-transcript", same, [TEXT] * BIG_B, g["ptm4b"]["same"])
    scored("semi")
    log("  median cadence of the pipelined B=256 batches (informational): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in cadence.items()))


# -- 5-state models, grammar decode, large graphs -----------------------------

def graph_batch_sen(al: TorchAligner, g, audios: list):
    """K4's inputs on the same-transcript route for a batch, bucketed,
    chunked and scored by the path's own helpers: (sen, n_frames,
    VitConsts)."""
    c = al._graph_consts(g)
    audios, Ts, Tmax = al._batch_shape(audios)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    return al._graph_scores(c.gs, audios, Ts_d, Tmax, "fold"), Ts_d, c.vit


def rows_batch_sen(al: TorchAligner, graphs: list, audios: list):
    """K6's inputs on the multi-graph route (the working-set union, or
    the full inventory under want_scores or a dense union): (sen,
    n_frames, RowVitConsts)."""
    audios, Ts, Tmax = al._batch_shape(audios)
    graphs = list(graphs) + [graphs[-1]] * (len(audios) - len(graphs))
    uni = None if al.want_scores else al._union_scorer(graphs)
    st = (al._stacked_graphs(graphs) if uni is None else
          al._stacked_graphs(graphs, remap=uni["pos"], remap_ver=uni["ver"]))
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    sen = torch.empty((len(audios), Tmax, st.sencols.shape[1]),
                      dtype=torch.int32, device=al.device)
    for i0, _, feats in al._chunk_feats(audios, Ts_d, Tmax):
        n = feats.shape[0]
        flat = feats.view(n * Tmax, 3, -1)
        src = (senscore_torch.score_frames(al.dense, flat) if uni is None
               else senscore_torch.score_frames_graph(uni["gs"], flat))
        senscore_torch.gather_cols(src.view(n, Tmax, -1),
                                   st.sencols[i0:i0 + n], out=sen[i0:i0 + n])
    return sen, Ts_d, st.vit


def single_sen(al_dev: TorchAligner, g, audio):
    """The single-utterance device path's inputs to K4's carry form:
    (sen [Tpad, S], T, VitConsts)."""
    c = al_dev._graph_consts(g)
    n = len(audio)
    T = al_dev.fe.n_frames(n)
    Tpad = max(128, -(-T // 128) * 128)
    cep = al_dev.fe.mfcc(torch.from_numpy(audio).to(al_dev.device)[None], n,
                         Tpad)
    Tn = torch.tensor([T], dtype=torch.int32, device=al_dev.device)
    feats = feat_mod.feat_f32(cep, Tn, al_dev.do_cmn)[0]
    return senscore_torch.score_frames_graph(c.gs, feats), T, c.vit


def shape_log(what, sen, v) -> None:
    K = v.pred_idx.shape[-1]
    W = getattr(v, "band_pen", None)
    log(f"  {what}: B={sen.shape[0] if sen.dim() == 3 else 1} "
        f"T={sen.shape[-2]} S={sen.shape[-1]} P={v.P} E={v.E} K={K}"
        + ("" if W is None else f" W={W.shape[1]}") + f" tokens "
        f"{align_torch.tok_dtype(sen.shape[-1])}, state in "
        + ("global memory" if cuda_build.lib().sst_viterbi_smem_bytes(
            v.P, v.E) > align_torch.MAX_SMEM_BYTES else "shared memory"))


def compare_vit(name, sen, n, v, results, ws=False, runs=10):
    """K4 (VitConsts) or K6 (RowVitConsts) against its plain version; the
    plain version's time is that of the comparison call."""
    rows = isinstance(v, align_torch.RowVitConsts)
    fn = align_torch.viterbi_rows if rows else align_torch.viterbi_batch
    plain = (align_torch.viterbi_rows_plain if rows
             else align_torch.viterbi_batch_plain)
    shape_log(name, sen, v)
    compare(name, lambda: fn(sen, n, v, ws), lambda: plain(sen, n, v, ws),
            results, plain_runs=0, ins=(sen, n, v), ops=vit_ops(sen),
            rate=I32_OPS, runs=runs)


def compare_single(name, sen, T, v, results, runs=10):
    shape_log(name, sen, v)
    compare(name, lambda: align_torch.viterbi_single(sen, T, v),
            lambda: align_torch.viterbi_single_plain(sen, T, v), results,
            plain_runs=0, ins=(sen, v), ops=vit_ops(sen), rate=I32_OPS,
            runs=runs)


def phase_kernels_vit_forms(al, al_dev, al5, al5_dev, mg, results):
    """Each new Viterbi form against its plain version at the shape its
    path gives it: E=5 (K4 on the 5-state same-transcript B=256 batch,
    K6 on its union B=256 and scored B=32 batches, the carry form on
    its single-utterance device path); K4 with scores (the 8-bit ptm
    same-transcript B=256 batch); the global-state layout with int16
    tokens (K4 and K6 on a transcript of REPEATS repeats, random scores,
    B=4, T=256) and with int32 tokens (the large grammar: K4 on its
    decode_batch B=8, K6 with scores on its decode_batch_scored B=8,
    the carry form on its device-FE decode)."""
    big = [austen_audio(i % N_UTT) for i in range(BIG_B)]
    texts = mg["texts"]
    mixed = [mixed_audio(i % N_MIXED) for i in range(BIG_B)]
    sen, n, v = graph_batch_sen(al5, al5.graph_for_text(TEXT), big)
    compare_vit("viterbi_batch[5-state]", sen, n, v, results)
    fresh_union(al5)
    sen, n, v = rows_batch_sen(
        al5, [al5.graph_for_text(texts[i % N_MIXED]) for i in range(BIG_B)],
        mixed)
    compare_vit("viterbi_rows[5-state]", sen, n, v, results)
    fresh_union(al5)
    al5.want_scores = True
    try:
        sen, n, v = rows_batch_sen(
            al5, [al5.graph_for_text(t) for t in texts],
            [mixed_audio(i) for i in range(N_MIXED)])
    finally:
        al5.want_scores = False
    compare_vit("viterbi_rows[5-state, scores]", sen, n, v, results, True)
    sen, T, v = single_sen(al5_dev, al5_dev.graph_for_text(TEXT),
                           austen_audio(0))
    compare_single("viterbi_chunk[5-state]", sen, T, v, results)

    sen, n, v = graph_batch_sen(al, al.graph_for_text(TEXT), big)
    compare_vit("viterbi_batch[3-state, scores]", sen, n, v, results, True)

    # int16 tokens, the state in global memory: REPEATS repeats
    long_g = al.graph_for_text(" ".join([TEXT] * REPEATS))
    rng = np.random.RandomState(REPEATS)
    c = al._graph_consts(long_g)
    sen = torch.from_numpy(rng.randint(0, 3000, (4, 256, c.gs.S))
                           .astype(np.int32)).to(al.device)
    n = torch.tensor([256, 200, 150, 2], dtype=torch.int32, device=al.device)
    compare_vit("viterbi_batch[3-state, global]", sen, n, c.vit, results)
    raw = align_torch.stack_graphs(
        [long_g] + [al.graph_for_text(t) for t in texts[:3]],
        al.am.tmat.astype(np.int32), np.arange(al.am.n_sen))
    v = align_torch.row_consts_from_numpy(raw, al.device)
    sen = torch.from_numpy(rng.randint(0, 3000, (4, 256,
                                                 raw["sencols"].shape[1]))
                           .astype(np.int32)).to(al.device)
    compare_vit("viterbi_rows[3-state, global]", sen, n, v, results)

    # int32 tokens, global state: the large grammar's paths
    lg = al.set_grammar(jsgf_string=large_grammar())
    eight = big[:N_UTT]
    sen, n, v = graph_batch_sen(al, lg, eight)
    compare_vit("viterbi_batch[3-state, int32, global]", sen, n, v, results,
                runs=3)
    al.want_scores = True
    try:
        sen, n, v = rows_batch_sen(al, [lg] * N_UTT, eight)
    finally:
        al.want_scores = False
    compare_vit("viterbi_rows[3-state, int32, global, scores]", sen, n, v,
                results, True, runs=3)
    lgd = al_dev.set_grammar(jsgf_string=large_grammar())
    sen, T, v = single_sen(al_dev, lgd, austen_audio(0))
    compare_single("viterbi_chunk[3-state, int32, global]", sen, T, v,
                   results, runs=3)


def check_graph(g, want: dict, prefix: str, what: str) -> None:
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(g, f)), want[f"{prefix}/{f}"]
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: graph field {f} differs from "
                                 "decode.npz")


def phase_decode(al: TorchAligner, al_dev: TorchAligner, dg: dict):
    """Grammar decode on the 8-bit ptm model against decode.json."""
    want = dg["decode"]
    t0 = time.perf_counter()
    g = al.set_grammar(jsgf_string=GRAMMAR)
    check_graph(g, dg, "graph", "set_grammar")
    al_dev.set_grammar(jsgf_string=GRAMMAR)
    log(f"  set_grammar: P={len(g.senid)} K={want['K']}, graph equal to "
        f"decode.npz ({time.perf_counter() - t0:.3f} s)")
    rows = [decode_audio(i % N_UTT) for i in range(BIG_B - 1)] \
        + [decode_audio(N_UTT)]
    exp = [want["batch"][i % N_UTT] for i in range(BIG_B - 1)] \
        + [want["batch"][N_UTT]]
    t0 = time.perf_counter()
    check_rows(al.decode_batch(rows), exp, f"decode_batch (B={BIG_B})",
               rep=decode_rep)
    if exp[-1] is not None:
        raise AssertionError("the truncated row should fail")
    log(f"  decode_batch B={BIG_B} (the last row truncated, failing): equal "
        f"to the golden ({time.perf_counter() - t0:.3f} s)")
    rows = [decode_audio(i % N_DECODE) for i in range(N_MIXED)]
    check_rows(al.decode_batch_scored(rows),
               [want["scored"][i % N_DECODE] for i in range(N_MIXED)],
               f"decode_batch_scored (B={N_MIXED})", rep=decode_rep)
    log(f"  decode_batch_scored B={N_MIXED}: equal to the golden, scores "
        f"included")
    a0 = austen_audio(0)
    check_rows([al.decode(a0), al_dev.decode(a0)],
               [want["decode"], want["decode_device"]],
               "decode (host FE, device FE)", rep=decode_rep)
    log("  decode on the host and on the device front end: equal to the "
        "golden")
    t0 = time.perf_counter()
    search = al.decode_search(a0)
    t1 = time.perf_counter()
    got = search_rep(search, al.lattice(a0),
                     [x for _, x in zip(range(N_BEST), al.nbest(a0))])
    if got != want["search"]:
        raise AssertionError("decode_search, lattice or nbest differs from "
                             "the golden")
    log(f"  decode_search hyp {got['hyp']!r} and {len(got['segs'])} "
        f"segments, lattice {got['lattice_nodes']} nodes and "
        f"{got['lattice_links']} links, {len(got['nbest'])}-best: equal to "
        f"the golden (one search {t1 - t0:.3f} s)")


def phase_5st(al5: TorchAligner, al5_dev: TorchAligner, dg: dict,
              mg: dict):
    """The 5-state model's batch routes and align against decode.json."""
    want = dg["5st"]
    same = [austen_audio(i % N_UTT) for i in range(BIG_B)]
    pipelined(al5, same, [TEXT] * BIG_B,
              [want["same"][i % N_UTT] for i in range(BIG_B)],
              "5-state same-transcript", N_FIVE_BATCHES)
    fresh_union(al5)
    texts = mg["texts"]
    pipelined(al5, [mixed_audio(i % N_MIXED) for i in range(BIG_B)],
              [texts[i % N_MIXED] for i in range(BIG_B)],
              [want["union"][i % N_MIXED] for i in range(BIG_B)],
              "5-state mixed", N_FIVE_BATCHES)
    mixed32 = [mixed_audio(i) for i in range(N_MIXED)]
    check_rows(al5.align_batch_scored(mixed32, texts), want["scored"],
               f"5-state align_batch_scored (B={N_MIXED})", rep=scored_rep)
    log(f"  5-state align_batch_scored B={N_MIXED}: equal to the golden, "
        "scores included")
    check_rows([al5_dev.align(austen_audio(0), TEXT)],
               [want["align_device"]], "5-state align (device FE)")
    log("  5-state align on the device front end: equal to the golden")


def phase_large(al: TorchAligner, al_dev: TorchAligner, dg: dict,
                mg: dict):
    """The repairs: same-transcript want_scores; a transcript of REPEATS
    repeats (more phones than shared memory holds: K4 and K6 in the
    global layout, int16 tokens); the large grammar (S >= 32767: int32
    tokens, global layout) through decode_batch, decode_batch_scored and
    the device-FE decode."""
    audios8 = [austen_audio(i) for i in range(N_UTT)]
    al.want_scores = True
    try:
        check_rows(al.align_batch(audios8, [TEXT] * N_UTT),
                   dg["scores_same"], "same-transcript want_scores",
                   rep=scored_rep)
    finally:
        al.want_scores = False
    log(f"  same-transcript align_batch B={N_UTT} with want_scores: equal "
        "to the golden, scores included")
    long_text = " ".join([TEXT] * REPEATS)
    g = al.graph_for_text(long_text)
    T = max(al.fe.n_frames(len(a)) for a in audios8)
    if int(g.astart[g.final_nodes].min()) <= T:
        raise AssertionError("the long transcript's final nodes are "
                             "reachable in the audio's frames")
    out = al.align_batch(audios8[:4], [long_text] * 4)
    if any(s is not None for s in out):
        raise AssertionError("rows of the long transcript aligned")
    log(f"  align_batch of {REPEATS} repeats (P={len(g.senid)}), 4 rows: "
        f"each None, as its final nodes start after frame "
        f"{int(g.astart[g.final_nodes].min())} > {T}")
    texts = mg["texts"][:N_MIXED - 1] + [long_text]
    audios = [mixed_audio(i) for i in range(N_MIXED)]
    fresh_union(al)
    al._union_scorer([al.graph_for_text(t) for t in mg["texts"]])
    al._uni["dense"] = True
    try:
        out = al.align_batch(audios, texts)
    finally:
        fresh_union(al)
    check_rows(out[:-1], mg["dense"][:N_MIXED - 1],
               f"mixed align_batch with {REPEATS} repeats (forced dense)")
    if out[-1] is not None:
        raise AssertionError("the long transcript's row aligned")
    log(f"  mixed align_batch B={N_MIXED} with one row of {REPEATS} repeats "
        f"(forced dense): the others equal to the dense golden")
    want = dg["large"]
    t0 = time.perf_counter()
    lg = al.set_grammar(jsgf_string=large_grammar())
    check_graph(lg, dg, "large", "set_grammar (large)")
    al_dev.set_grammar(jsgf_string=large_grammar())
    log(f"  large grammar: P={want['P']} S={want['S']} K={want['K']}, graph "
        f"equal to decode.npz ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    check_rows(al.decode_batch(audios8), want["batch"],
               f"large decode_batch (B={N_UTT})", rep=decode_rep)
    check_rows(al.decode_batch_scored(audios8), want["scored"],
               f"large decode_batch_scored (B={N_UTT})", rep=decode_rep)
    check_rows([al_dev.decode(audios8[0])], [want["decode_device"]],
               "large decode (device FE)", rep=decode_rep)
    log(f"  large grammar decode_batch, decode_batch_scored (B={N_UTT}) and "
        f"the device-FE decode: equal to the golden "
        f"({time.perf_counter() - t0:.3f} s)")


# -- the long form and the repaired configurations ----------------------------

def long_batch_sen(al: TorchAligner, audios: list, text: str, nseq: int):
    """The long form's scores as align_longform_batch makes them (the
    same-transcript route's K1, K2, K3, the frame axis rounded up to 64
    per rank): (sen [B, Tmax, S], n_frames [B], VitConsts)."""
    c = al._graph_consts(al.graph_for_text(text))
    Ts = np.array([al.fe.n_frames(len(a)) for a in audios])
    gran = 64 * nseq
    Tmax = -(-int(Ts.max()) // gran) * gran
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    return al._graph_scores(c.gs, audios, Ts_d, Tmax, "fold"), Ts_d, c.vit


def first_chunk_tokens(sen, n, v, C: int) -> torch.Tensor:
    """Rank 0's token chunk [B, C, S] of a long-form batch: K4's carry
    form over each row's first C frames from vit_carry0."""
    carry0 = align_torch.vit_carry0(v, n_emit=3)
    return torch.stack([align_torch.viterbi_chunk(
        sen[b, :C].contiguous(), carry0, 0, int(n[b]), v)[1]
        for b in range(sen.shape[0])])


def gather_loop(tok, start, t0: int, n):
    """K13's function as a loop of torch.gather calls over the chunk's
    frames (the library yardstick; used nowhere in the port)."""
    R, C, S = tok.shape

    def run():
        cid = start.clone()
        path = torch.empty((R, C), dtype=torch.int32, device=tok.device)
        for c in range(C - 1, -1, -1):
            t = t0 + c
            path[:, c] = torch.where(t < n, cid, -1)
            at = torch.where(cid < 0, cid + S, cid).clamp(0, S - 1)
            nxt = torch.gather(tok[:, c], 1, at.long()[:, None])[:, 0]
            cid = torch.where(t < n - 1, nxt.to(torch.int32), cid)
        return path, cid
    return run


def compare_backtrace(name, tok, start, t0: int, n, results, runs=10):
    """K13 against its plain version; bound: the path written, the
    tokens read (one per row and frame), the starts and counts."""
    R, C, S = tok.shape
    log(f"  {name}: R={R} C={C} S={S} tokens {tok.dtype}")
    res = {}
    compare(name, lambda: align_torch.backtrace_chunk(tok, start, t0, n),
            lambda: align_torch.backtrace_chunk_plain(tok, start, t0, n),
            res, plain_runs=0, ins=(start, n), runs=runs,
            library=gather_loop(tok, start, t0, n))
    r = res[name]
    b = bound(R * C * tok.element_size() + nbytes(start, n) + 4 * R * C
              + 4 * R, 0.0, I32_OPS)
    r.update(b)
    results[name] = r


def phase_kernels_slice6(al: TorchAligner, al_dc: TorchAligner,
                         al_f32: TorchAligner, big: list, results: dict):
    """The kernels and forms of the long form and the repairs against
    their plain versions at their paths' shapes: K13 on rank 0's token
    chunk of the long-form batch (int16) and of the large grammar's
    decode batch (int32, S >= 32,767), K4's carry form on a long-form
    chunk, K2's mxu form on the same-transcript B=256 batch's first
    chunk and on DENSE_SLICE frames of the full inventory, K8 with
    remove_dc on the remove_dc aligner's B=256 batch, K1's float32 form
    on the f32 wire's host cepstra."""
    dev = al.device
    rows = [longform_audio(i) for i in range(LONG_B)]
    sen, n, v = long_batch_sen(al, rows, longform_text(), N_SEQ)
    C = sen.shape[1] // N_SEQ
    shape_log("long form", sen, v)
    carry0 = align_torch.vit_carry0(v, n_emit=3)
    chunk = sen[0, :C].contiguous()
    compare("viterbi_chunk[long form, 8 ranks]",
            lambda: align_torch.viterbi_chunk(chunk, carry0, 0, int(n[0]), v),
            lambda: align_torch.viterbi_chunk_plain(chunk, carry0, 0,
                                                    int(n[0]), v),
            results, plain_runs=0, ins=(chunk, carry0, v),
            ops=vit_ops(chunk), rate=I32_OPS)
    tok = first_chunk_tokens(sen, n, v, C)
    rng = np.random.RandomState(13)
    start = torch.from_numpy(rng.randint(-2, tok.shape[2], LONG_B)
                             .astype(np.int32)).to(dev)
    compare_backtrace("backtrace_chunk", tok, start, 0, n, results)
    results["backtrace_chunk[int16]"] = results["backtrace_chunk"]
    lg = al.set_grammar(jsgf_string=large_grammar())
    sen32, n32, v32 = graph_batch_sen(al, lg, big[:N_UTT])
    C32 = sen32.shape[1] // N_SEQ
    tok32 = first_chunk_tokens(sen32, n32, v32, C32)
    start32 = torch.from_numpy(rng.randint(-2, tok32.shape[2], N_UTT)
                               .astype(np.int32)).to(dev)
    compare_backtrace("backtrace_chunk[int32]", tok32, start32, 0, n32,
                      results, runs=3)

    # K2's mxu form: the graph scorer and the full inventory
    c = al._graph_consts(al.graph_for_text(TEXT))
    audios, Ts, Tmax = al._batch_shape(big)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(dev)
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    flat = feats.view(-1, 3, feats.shape[-1])
    for name, x, sc in (("dist_topn_norm[mxu]", flat, c.gs),
                        ("dist_topn_norm[mxu, full inventory]",
                         flat[:DENSE_SLICE].contiguous(), al.dense)):
        log(f"  {name}: N={x.shape[0]} Cu={sc.means.shape[0]}")
        compare(name,
                lambda: senscore_torch.dist_topn_norm(x, sc, "mxu"),
                lambda: senscore_torch.dist_topn_norm_plain(x, sc, "mxu"),
                results, plain_runs=0,
                ins=(x, sc.var_t, sc.det, sc.muv, sc.c),
                ops=fold_ops(x.shape[0], sc))

    # K8 with remove_dc
    fe = al_dc.fe
    dca, _, Tdc = al_dc._batch_shape([dc_audio(i % N_UTT)
                                      for i in range(BIG_B)])
    ns_h = np.array([len(a) for a in dca], np.int32)
    buf = np.zeros((len(dca), int(ns_h.max())), np.int16)
    for i, a in enumerate(dca):
        buf[i, :len(a)] = a
    sig = torch.from_numpy(buf).to(dev)
    ns = torch.from_numpy(ns_h).to(dev)
    prior = torch.zeros(len(dca), dtype=torch.float32, device=dev)
    sb = spec_bound(fe, sig, ns, prior, len(dca) * Tdc)
    sb["ops"] += 2.0 * fe.frame_size * len(dca) * Tdc   # the mean
    log(f"  fe_spec[remove_dc]: B={len(dca)} Tmax={Tdc} "
        f"frame={fe.frame_size}")
    compare("fe_spec[remove_dc]",
            lambda: fe_mod.fe_spec(fe, sig, ns, prior, Tdc),
            lambda: fe_mod.fe_spec_plain(fe, sig, ns, prior, Tdc), results,
            plain_runs=0, **sb)

    # K1's float32 form on the f32 wire's host cepstra
    audios8, T8, Tm8 = al_f32._batch_shape([austen_audio(i)
                                            for i in range(N_UTT)])
    T8_d = torch.from_numpy(T8.astype(np.int32)).to(dev)
    _, cep, _ = next(iter(al_f32._chunk_feats(audios8, T8_d, Tm8)))
    if cep.dtype != torch.float32:
        raise AssertionError("the f32 wire did not ship float32 cepstra")
    compare("feat_f32[wire f32]",
            lambda: feat_mod.feat_f32(cep, T8_d, al_f32.do_cmn),
            lambda: feat_mod.feats_plain(cep, T8_d, al_f32.do_cmn), results,
            ins=(cep, T8_d), ops=6.0 * cep.numel())


def phase_longform(al: TorchAligner, lg: dict, smi: str):
    """align_longform_batch on LONG_B rows of AUSTEN tiled past 60 s, on
    local rings of N_SEQ and of 1 rank, against each other, align_batch
    on the card and longform.json; align_longform on the large grammar's
    decode batch (int32 tokens) against each row's viterbi_single; one
    row of LONG_K5 repeats (about 5 minutes) through the long form and
    align_batch (informational: its token-stack bytes, beside ``smi``,
    the card's name and power limit)."""
    text = longform_text()
    rows = [longform_audio(i) for i in range(LONG_B)]
    secs = [len(a) / SAMPRATE for a in rows]
    outs = {}
    for nseq in (N_SEQ, 1):
        t0 = time.perf_counter()
        outs[nseq] = al.align_longform_batch(rows, [text] * LONG_B,
                                             ring=seq_ring(nseq, "cuda"))
        torch.cuda.synchronize()
        check_rows(outs[nseq], lg["longform"],
                   f"align_longform_batch (ring of {nseq})")
        log(f"  align_longform_batch B={LONG_B} ({min(secs):.1f}-"
            f"{max(secs):.1f} s of audio each), local ring of {nseq}: equal "
            f"to longform.json ({time.perf_counter() - t0:.3f} s)")
    check_rows(al.align_batch(rows, [text] * LONG_B),
               [segs_rep(s) for s in outs[N_SEQ]], "align_batch (long rows)")
    log("  align_batch on the same rows: equal to the long form")

    # int32 tokens: the large grammar's graph through align_longform
    g = al.set_grammar(jsgf_string=large_grammar())
    eight = [austen_audio(i) for i in range(N_UTT)]
    sen, n, v = graph_batch_sen(al, g, eight)
    T = sen.shape[1] - sen.shape[1] % N_SEQ
    P, E = g.senid.shape
    pi, pp, pk = align_torch.build_pred_table(g.edge_src, g.edge_dst,
                                              g.edge_pen, P)
    from soundswallower_tpu_torch.parallel import align_longform
    path, score = align_longform(
        seq_ring(N_SEQ, "cuda"), sen[:, :T], np.arange(P * E).reshape(P, E),
        al.am.tmat.astype(np.int32)[g.tmatid], pi, pp, pk, g.astart, g.aend,
        n.cpu().numpy(), np.where(g.is_entry, g.entry_pen,
                                  align_torch.WORST_SCORE), g.final_nodes)
    for b in range(N_UTT):
        p1, s1 = align_torch.viterbi_single(sen[b, :T].contiguous(),
                                            int(n[b]), v)
        if not (torch.equal(p1, path[b]) and int(s1) == int(score[b])):
            raise AssertionError(f"align_longform (large grammar) row {b} "
                                 "differs from viterbi_single")
    log(f"  align_longform on the large grammar (S={P * E}, int32 tokens), "
        f"B={N_UTT}, ring of {N_SEQ}: equal to viterbi_single per row")

    # one row of about 5 minutes (informational)
    text5 = longform_text(LONG_K5)
    row5 = longform_audio(0, LONG_K5)
    t0 = time.perf_counter()
    lf = al.align_longform_batch([row5], [text5],
                                 ring=seq_ring(N_SEQ, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    base = al.align_batch([row5], [text5])
    t2 = time.perf_counter()
    check_rows(lf, [segs_rep(s) for s in base], "5-minute row")
    if lf[0] is None:
        raise AssertionError("the 5-minute row did not align")
    g5 = al.graph_for_text(text5)
    S5 = g5.senid.size
    T5 = al.fe.n_frames(len(row5))
    tok_bytes = T5 * S5 * align_torch.tok_dtype(S5).itemsize
    # tokens grow with frames times states, both with the audio's length
    per_s2 = tok_bytes / (len(row5) / SAMPRATE) ** 2
    longest = (80e9 / per_s2) ** 0.5
    log(f"  5-minute row ({len(row5) / SAMPRATE:.1f} s, T={T5}, S={S5}): "
        f"long form (ring of {N_SEQ}) {t1 - t0:.3f} s, align_batch "
        f"{t2 - t1:.3f} s, equal segments; token stack {tok_bytes} bytes; "
        f"by that count one 80 GB card holds the tokens of a row of about "
        f"{longest / 60:.0f} minutes of such speech, {N_SEQ} cards "
        f"{longest * N_SEQ ** 0.5 / 60:.0f} minutes ({smi}; informational)")


def phase_repairs(al: TorchAligner, al_f32: TorchAligner,
                  al_dc: TorchAligner, lg: dict, what: str):
    """One repaired configuration's paths against longform.json: mxu
    (align_batch, align_batch_scored with dist_mode="mxu"), wire_f32
    (SST_WIRE=f32: same-transcript, mixed on a fresh union, scored) or
    remove_dc (the device front end: align_batch, align,
    spectrogram)."""
    audios8 = [austen_audio(i) for i in range(N_UTT)]
    want = lg[what]
    if what == "mxu":
        check_rows(al.align_batch(audios8, [TEXT] * N_UTT, "mxu"),
                   want["same"], "mxu align_batch")
        check_rows(al.align_batch_scored(audios8, [TEXT] * N_UTT, "mxu"),
                   want["scored"], "mxu align_batch_scored", rep=scored_rep)
    elif what == "wire_f32":
        check_rows(al_f32.align_batch(audios8, [TEXT] * N_UTT), want["same"],
                   "f32-wire align_batch")
        fresh_union(al_f32)
        check_rows(al_f32.align_batch(audios8, MIXED), want["mixed"],
                   "f32-wire mixed align_batch")
        check_rows(al_f32.align_batch_scored(audios8, [TEXT] * N_UTT),
                   want["scored"], "f32-wire align_batch_scored",
                   rep=scored_rep)
    else:
        dc = [dc_audio(i) for i in range(N_UTT)]
        check_rows(al_dc.align_batch(dc, [TEXT] * N_UTT), want["same"],
                   "remove_dc align_batch")
        check_rows([al_dc.align(dc[0], TEXT)], [want["align"]],
                   "remove_dc align")
        if spec_sha(al_dc.spectrogram(dc[0])) != want["spectrogram_sha256"]:
            raise AssertionError("remove_dc spectrogram differs")
    log(f"  {what}: equal to longform.json")


def count_path(wrappers: dict, drive) -> dict:
    """Launch counts of one path: every count set to 0 just before
    drive(), read just after it."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "forms"):
            fn.forms.clear()
    drive()
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, fn in wrappers.items():
        for form, k in getattr(fn, "forms", {}).items():
            counts[f"{name}[{form}]"] = k
    return counts


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
    dg = load_device_fe_golden()
    dcg = load_decode_golden()
    lg = load_longform_golden()
    als = {}
    with tempfile.TemporaryDirectory() as model_dir:
        for variant in BACKENDS:
            d = os.path.join(model_dir, variant)
            make_synth_model(d, 0, "en-us", *MODEL_VARIANTS[variant])
            als[variant] = TorchAligner(hmm=d, samprate=SAMPRATE,
                                        device="cuda")
        d5 = os.path.join(model_dir, "ptm5st")
        make_synth_model(d5, 0, "en-us", *MODEL_VARIANTS["ptm5st"])
        al5 = TorchAligner(hmm=d5, samprate=SAMPRATE, device="cuda")
        make_synth_model(model_dir, seed=0, width="en-us")
        al = TorchAligner(hmm=model_dir, samprate=SAMPRATE, device="cuda")
        # remove_dc: the host C++ MFCC refuses it, so the device FE
        al_dc = TorchAligner(hmm=model_dir, samprate=SAMPRATE, device="cuda",
                             remove_dc=True)
        prev = {k: os.environ.get(k) for k in ("SST_FE", "SST_WIRE")}
        try:
            os.environ["SST_FE"] = "device"
            al_dev = TorchAligner(hmm=model_dir, samprate=SAMPRATE,
                                  device="cuda")
            al5_dev = TorchAligner(hmm=d5, samprate=SAMPRATE, device="cuda")
            del os.environ["SST_FE"]
            os.environ["SST_WIRE"] = "f32"
            al_f32 = TorchAligner(hmm=model_dir, samprate=SAMPRATE,
                                  device="cuda")
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if (al.native_fe is None or al_dev.native_fe is not None
            or al5.native_fe is None or al5_dev.native_fe is not None
            or al_dc.native_fe is not None or al_f32.native_fe is None
            or al_f32.wire != "f32"):
        raise AssertionError("expected host-FE, device-FE, remove_dc and "
                             "f32-wire aligners")
    if al5.am.mdef.n_emit_state != 5:
        raise AssertionError("the ptm5st model is not 5-state")
    audios8 = [austen_audio(i) for i in range(N_UTT)]
    big = [audios8[i % N_UTT] for i in range(BIG_B)]
    log(f"model: {al.am.n_sen} senones, {al.am.n_mgau} codebooks, "
        f"{al.am.n_density} densities; batches of {BIG_B} utterances, "
        f"{N_MIXED} mixed transcripts; backends: " + ", ".join(
            f"{v} ({a.am.backend}, {a.am.n_mgau} codebooks"
            f"{', 4-bit' if a.am.mixw_cb is not None else ''})"
            for v, a in als.items()))
    # 4. kernels vs plain versions
    results: dict = {}
    phase_kernels(al, big, results)
    phase_kernels_mixed(al, mg["texts"], results)
    phase_kernels_fe(al_dev, al, big, results)
    phase_kernels_vit_chunk(al_dev, results)
    phase_kernels_backends(als, results)
    phase_kernels_vit_forms(al, al_dev, al5, al5_dev, mg, results)
    phase_kernels_slice6(al, al_dc, al_f32, big, results)
    wrappers = {name: fn for name, fn, _, _ in KERNELS}

    # 5. host-FE paths: main, mixed and serving, counted
    def host_paths():
        phase_main(al, audios8, want)
        phase_mixed(al, mg)
        segs8 = golden_segs(want)
        phase_serve(al, [(TEXT, audios8[i % N_UTT], segs8[i % N_UTT])
                         for i in range(N_REQUESTS)], "same-transcript")
        # batches of 32 that wait long enough to fill: a batch of one
        # transcript would take the same-transcript path
        union_segs = golden_segs(mg["union"])
        phase_serve(al, [(mg["texts"][i % N_MIXED], mixed_audio(i % N_MIXED),
                          union_segs[i % N_MIXED])
                         for i in range(2 * N_MIXED)],
                    "mixed", max_batch=N_MIXED, max_wait_ms=5000.0)

    log("host-FE paths:")
    host = count_path(wrappers, host_paths)
    # 6. device-FE paths, counted
    log("device-FE paths:")
    device = count_path(wrappers, lambda: phase_device_fe(al_dev, audios8, dg))
    # 7. the other backends' paths, counted
    log("backend paths (4-bit ptm, semi, 4-bit semi, ms):")
    backends = count_path(wrappers, lambda: phase_backends(als))
    # 8. grammar decode, counted
    log("decode paths (8-bit ptm):")
    decode = count_path(wrappers, lambda: phase_decode(al, al_dev, dcg))
    # 9. the 5-state model, counted
    log("5-state paths (ptm5st):")
    five = count_path(wrappers, lambda: phase_5st(al5, al5_dev, dcg, mg))
    # 10. large graphs and same-transcript scores, counted
    log("large-graph paths (8-bit ptm):")
    large = count_path(wrappers, lambda: phase_large(al, al_dev, dcg, mg))
    # 11. the long form, counted
    log("long-form paths (8-bit ptm):")
    longform = count_path(wrappers, lambda: phase_longform(al, lg, smi))
    # 12. the repaired configurations, each counted
    log("repaired configurations (8-bit ptm):")
    repairs = {what: count_path(wrappers, lambda what=what: phase_repairs(
        al, al_f32, al_dc, lg, what))
        for what in ("mxu", "wire_f32", "remove_dc")}
    counts = {"host-FE": host, "device-FE": device, "backends": backends,
              "decode": decode, "5-state": five, "large": large,
              "longform": longform, **repairs}
    for path, names in (("host-FE", HOST_PATH), ("device-FE", DEVICE_FE_PATH),
                        ("backends", BACKEND_PATH), ("decode", SLICE_PATH),
                        ("5-state", SLICE_PATH), ("large", SLICE_PATH),
                        ("longform", LONGFORM_PATH), ("mxu", MXU_PATH),
                        ("wire_f32", WIRE_F32_PATH),
                        ("remove_dc", REMOVE_DC_PATH)):
        names = list(dict.fromkeys(names + [f"{k}[{f}]"
                                            for _, k, f, ph, _ in FORMS
                                            if ph == path]))
        log(f"  {path} launches: " + ", ".join(
            f"{n} {counts[path].get(n, 0)}" for n in names))
        missing = [n for n in names if counts[path].get(n, 0) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"paths: {missing}")
    # each kernel's count from the path that brought it in
    entries = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[PATH_OF[name]][name], **results[name])
               for name, _, src, rep in KERNELS]
    sources = {name: src for name, _, src, _ in KERNELS}
    for entry, kernel, rep, *path in VARIANTS:
        path = path[0] if path else PATH_OF[kernel]
        entries.append(dict(name=entry, route="cuda", source=sources[kernel],
                            replaces=rep, launches=counts[path][kernel],
                            **results[entry]))
    for entry, kernel, form, path, rep in FORMS:
        entries.append(dict(name=entry, route="cuda", source=sources[kernel],
                            replaces=rep,
                            launches=counts[path][f"{kernel}[{form}]"],
                            **results[entry]))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
