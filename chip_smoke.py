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
``SST_WIRE=f32`` and with ``remove_dc``, and the public API
(``pitch_batch``, the exact ``Decoder``, the command line, ``update_mllr``),
on synthetic models at the published en-us width
(tools/make_synth_model.py, seed 0: 8-bit ptm, the backends 4-bit ptm,
semi, 4-bit semi and ms, and the 5-state ptm5st), against results the
JAX package computed for the same audio (tests/golden/torch-synth/
segs.json for one transcript, mixed_segs.json for 32 different ones,
device_fe.json and device_fe.npz for its device front end, backends.json
and backends.npz for the other backends, decode.json and decode.npz for
grammar decode, the 5-state model and large graphs, longform.json for
the long form and the repaired configurations, api.json for the public
API) and against the C reference's cepstra
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
   slice of the dense routes' frames, K3's full inventory and K11/K12
   also on the whole chunk the path launches them on, K11/K12 also at
   a tile remainder, top-N 8 and aw 2; K8-K10 on the whole B=256 batch
   and at 16 kHz, nfft 512; K3's wrap_u8 on the 4-bit semi union route,
   K7's semi form on the semi dense route; K4, K6 and the carry form in
   their 5-state forms on the ptm5st paths, K4 with scores on the
   same-transcript batch, the global-state layout with int16 tokens on
   a transcript of REPEATS repeats at B=4, T=256, and with int32 tokens
   on the large grammar's decode paths), each timed on the launch alone
   (``ms``: the median device time per launch of 10, each after an L2
   flush, enqueued behind a head start so no host time falls between
   the events) and as one call from an idle device (``call_ms``), with
   its bound from this run's inputs and, where one PyTorch call
   computes the same function, that call's time on the same clock; a
   torch.profiler pass over K10's and K7's forms; K8 and K9 also on the
   device-FE route's 128-row chunk and on one stream piece; the device
   front end's cepstra of austen.raw against the C reference's; the
   device front end per B=256 batch beside the host C++ one
   (informational); then K13 on
   rank 0's token chunk of the long-form batch (int16) and of the large
   grammar's batch (int32), K4's carry form on one row's long-form chunk,
   on a ring step over all rows of each (one launch of R = 4 and of R = 8
   rows) and on the 5-minute row's first chunk, K2's mxu form (graph
   scorer, full inventory), K8 with remove_dc and K1's float32 form on
   the f32 wire's cepstra; K1 also on the long form's rows (4 of 6,656
   frames, and the 5-minute row) and on the device FE's ``align`` (one
   row, the frame axis bucketed to 128); K14 on austen.raw's frames at
   frame sizes 400, 200, 1024 and 4096, bit for bit; K2 also at a tile
   remainder and at top-N 1 and 8, K6 also through the mixed stack's
   K-slot lists and a forced cluster of 8, the large grammar's rows at
   one block and at a cluster of 16 (where the card runs one), and the
   decode grammar's scored rows (K-slot);
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
   each ring launches K4's carry form once a rank, whatever its rows
   (printed and checked, and by rows and phones), and the phase's wall
   is printed;
12. the repaired configurations, each counted on its own: ``mxu``
   (``align_batch``, ``align_batch_scored``), ``wire_f32`` (same
   transcript, mixed, scored) and ``remove_dc`` (``align_batch``,
   ``align``, ``spectrogram``);
13. the public API on the en-us-width model against api.json:
   ``pitch_batch`` and ``cmnd_batch`` (K14) at frame sizes 400 and 200,
   the exact ``Decoder`` with its front end on the card (K8-K10):
   alignment JSON at align levels 0-2, a grammar's hypothesis, segments
   and n-best, a live decode in 1,600-sample pieces; the command line
   (``cli.main``) on two raw files, its fast path and ``--exact``;
   ``update_mllr`` with tools/make_mllr.py's transform, then a
   same-transcript ``align_batch`` and ``align_batch_scored``.

Every row, score, segment list, spectrogram and checkpoint equals its
golden.  The launch counts are reset before each of phases 5-13 and
read after it; a kernel of a path, or a form of a kernel (the Viterbi
kernels' 5-state, int32, global and scores forms, K10's log spectra,
K7's semi form, ...) on the path that drives it, launched no time there
fails the run.  The last lines are rule 2's order of the kernels, one
JSON object of per-kernel results, the card's name and power limit
(nvidia-smi), and ``{"ok": true, "device": {...}}``; an entry that
reads faster than 105% of its bound allows fails the run.

Usage: ``python3 chip_smoke.py`` (one GPU, no arguments, no network).
``python3 chip_smoke.py --before DIR`` also builds K1 and K14 from DIR,
a checkout whose ``soundswallower_tpu_torch/csrc/sst_kernels.h``
declares them as BEFORE_PARAMS lists (their C signatures before their
redesign; any other declaration stops the run), checks them bit-equal to
this tree's on every K1 and K14 entry's inputs and times both in turns
(``ms_before``).  K1's entries print the rows a fold block, the frames a
pass, the frame tile (or the one-launch form) and the launches its
launcher takes, K14's the lags a thread (R), the threads a slot, the
slots a block, the lag tiles a frame and the launches.  K3's entries
print the columns a block, the frame tile
and the frames a pass of terms its launcher takes, K13's the segment
length; K11's entries print the frame tile its launcher takes, K12's
the senone group and frame tile; an entry timed at a shape a path
launches counts that path's launches at that shape (``shape``), so rule
2's order reads the path's own shapes.  K8's and K9's entries print the
frames a block and the frame tile their launchers take.  K6's entries print the
layout they take (one block, a cluster of N blocks a row, or the state
in global memory) and K2's the frame tile; each path's launches are
also counted by K6 layout and table form and by K2 tile.
"""

from __future__ import annotations

import base64
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
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
from make_torch_api_golden import (API_FRAMES, austen_frames,  # noqa: E402
                                   cli_results, decoder_results,
                                   load_api_golden, mllr_file, mllr_results,
                                   pitch_rep)
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
from soundswallower_tpu_torch import cli  # noqa: E402
from soundswallower_tpu_torch import yin as yin_mod  # noqa: E402
from soundswallower_tpu_torch.aligner import TorchAligner, WordSeg  # noqa: E402
from soundswallower_tpu_torch.decoder import Decoder  # noqa: E402
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
    ("yin_cmnd", yin_mod.yin_cmnd, "soundswallower_tpu_torch/csrc/yin.cu",
     "soundswallower_tpu/yin.py:280"),
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
           "backtrace_chunk": "longform", "yin_cmnd": "api"}
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
    # the whole chunks the paths launch K3's full inventory (the dense
    # route's B=32 rows) and K11/K12 (the ms route's 128 rows) on
    ("senone_eval[full inventory, chunk]", "senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:254"),
    ("ms_dist_topn[chunk]", "ms_dist_topn",
     "soundswallower_tpu/ops/senscore_jax.py:316", "backends"),
    ("ms_senone_eval[chunk]", "ms_senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:323", "backends"),
    ("fe_noise[masked, carried]", "fe_noise",
     "soundswallower_tpu/fe/frontend.py:403"),
    ("fe_spec[16 kHz, nfft 512]", "fe_spec",
     "soundswallower_tpu/fe/frontend.py:285"),
    ("fe_noise[16 kHz]", "fe_noise", "soundswallower_tpu/fe/frontend.py:343"),
    ("fe_cep[16 kHz, legacy]", "fe_cep",
     "soundswallower_tpu/fe/frontend.py:418"),
    ("viterbi_chunk[single, backtrace]", "viterbi_chunk",
     "soundswallower_tpu/ops/align_jax.py:665"),
    ("senone_eval[wrap_u8]", "senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:557", "backends"),
    ("feat_f32[wire f32]", "feat_f32", "soundswallower_tpu/fe/feat.py:372",
     "wire_f32"),
    # K1 at the shapes the long form launches it on (its 4 rows on a ring
    # of 8, and the 5-minute row) and the device FE's align (one row),
    # counted on their paths at those rows and frames (``shape``)
    ("feat[long form]", "feat", "soundswallower_tpu/fe/feat.py:372",
     "longform"),
    ("feat[long form, 5-minute row]", "feat",
     "soundswallower_tpu/fe/feat.py:372", "longform"),
    ("feat_f32[align]", "feat_f32", "soundswallower_tpu/fe/feat.py:372",
     "device-FE"),
    # K14 at the frame sizes beside 400: 8 kHz (200), 1024 and 4096
    # (XLA's two tree levels and the scan's recursion)
    ("yin_cmnd[200]", "yin_cmnd", "soundswallower_tpu/yin.py:280", "api"),
    ("yin_cmnd[1024]", "yin_cmnd", "soundswallower_tpu/yin.py:255", "api"),
    ("yin_cmnd[4096]", "yin_cmnd", "soundswallower_tpu/yin.py:255", "api"),
    # the forms of K2's tiling and K6's lists and clusters that no
    # path takes at their timed shape (launches 0): K2 on the host-FE
    # batch's frames at a tile remainder and at top-N 1 and 8; K6 on the
    # mixed batch through the K-slot lists and a forced cluster of 8, and
    # on the large grammar's scored rows at one block (global memory) and
    # at a cluster of 16 (where the card runs one: OPTIONAL)
    ("dist_topn_norm[tile remainder]", "dist_topn_norm",
     "soundswallower_tpu/ops/senscore_jax.py:535", "forced"),
    ("dist_topn_norm[topn 1]", "dist_topn_norm",
     "soundswallower_tpu/ops/senscore_jax.py:535", "forced"),
    ("dist_topn_norm[topn 8]", "dist_topn_norm",
     "soundswallower_tpu/ops/senscore_jax.py:535", "forced"),
    ("viterbi_rows[K-slot]", "viterbi_rows",
     "soundswallower_tpu/aligner.py:1032", "forced"),
    ("viterbi_rows[cluster 8]", "viterbi_rows",
     "soundswallower_tpu/aligner.py:1032", "forced"),
    ("viterbi_rows[3-state, int32, scores, cluster 1]", "viterbi_rows",
     "soundswallower_tpu/ops/align_jax.py:638", "forced"),
    ("viterbi_rows[3-state, int32, scores, cluster 16]", "viterbi_rows",
     "soundswallower_tpu/ops/align_jax.py:638", "forced"),
    # K11 at a tile remainder and at top-N 8, K12 at top-N 8 and aw 2, on
    # the ms slice's frames
    ("ms_dist_topn[tile remainder]", "ms_dist_topn",
     "soundswallower_tpu/ops/senscore_jax.py:316", "forced"),
    ("ms_dist_topn[topn 8]", "ms_dist_topn",
     "soundswallower_tpu/ops/senscore_jax.py:316", "forced"),
    ("ms_senone_eval[topn 8]", "ms_senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:323", "forced"),
    ("ms_senone_eval[aw 2]", "ms_senone_eval",
     "soundswallower_tpu/ops/senscore_jax.py:323", "forced"),
]
# entries that a card may not run (a cluster of 16 needs 16 free SMs of
# one GPC): absent from the kernels line where they did not run
OPTIONAL = {"viterbi_rows[3-state, int32, scores, cluster 16]"}
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
    # the decode grammar's decode_batch_scored (K-slot lists)
    ("viterbi_rows[decode, K-slot, scores]", "viterbi_rows",
     "3-state, scores", "decode", "soundswallower_tpu/aligner.py:1032"),
    # one utterance, with the backtrace: the large grammar's device-FE
    # decode, and the long form's checks of its rows
    ("viterbi_chunk[3-state, int32, global]", "viterbi_chunk",
     "3-state, int32, global", ("large", "longform"),
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
    # K8 and K9 at the device-FE route's 128-row chunk and at one
    # stream piece (B=1, 32 frames, the masked scan), counted on their
    # path by form and by rows and frames (``shape``)
    ("fe_spec[route chunk]", "fe_spec", "window", "device-FE",
     "soundswallower_tpu/fe/frontend.py:484"),
    ("fe_noise[route chunk]", "fe_noise", "plain", "device-FE",
     "soundswallower_tpu/fe/frontend.py:357"),
    ("fe_spec[stream piece]", "fe_spec", "window", "device-FE",
     "soundswallower_tpu/fe/frontend.py:484"),
    ("fe_noise[stream piece]", "fe_noise", "masked", "device-FE",
     "soundswallower_tpu/fe/frontend.py:403"),
    # PR 8: K10's log spectra (spectrogram) and K7's semi form
    ("fe_cep[logspec]", "fe_cep", "logspec", "device-FE",
     "soundswallower_tpu/fe/frontend.py:535"),
    ("frame_best_sub[semi]", "frame_best_sub", "semi", "backends",
     "soundswallower_tpu/ops/senscore_jax.py:301"),
    # the long form's carry form, counted on its path by form and by the
    # rows and phones of the timed launch (its ``shape``): one row's
    # chunk of the 4-row batch (R=1, which the rank-major forward no
    # longer launches: one launch a rank takes all rows), a ring step
    # over the 4 rows (R=4), the 5-minute row's (R=1 of its own graph),
    # all of the int16 shared form; the large grammar's 8 rows (int32
    # tokens, global)
    ("viterbi_chunk[long form, 8 ranks]", "viterbi_chunk", "3-state",
     "longform", "soundswallower_tpu/parallel/seqpipe.py:118"),
    ("viterbi_chunk[long form, ring step]", "viterbi_chunk", "3-state",
     "longform", "soundswallower_tpu/parallel/seqpipe.py:118"),
    ("viterbi_chunk[long form, 5-minute row]", "viterbi_chunk", "3-state",
     "longform", "soundswallower_tpu/parallel/seqpipe.py:118"),
    ("viterbi_chunk[3-state, int32, global, long form]", "viterbi_chunk",
     "3-state, int32, global", "longform",
     "soundswallower_tpu/parallel/seqpipe.py:118"),
]
# the form whose count is a kernel's own entry's launches, where its
# other forms have entries of their own
ENTRY_FORM = {"fe_cep": "cepstra", "backtrace_chunk": "int16"}
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
# the public API's path: pitch_batch (K14), the exact Decoder's front end
# (K8-K10), the same-transcript batch after update_mllr (K1-K4) and the
# scored full-inventory route of the CLI's fast path and of the batch
# after update_mllr (K2, K3, K7, K5, K6)
API_PATH = ["yin_cmnd", "fe_spec", "fe_noise", "fe_cep", "feat",
            "dist_topn_norm", "senone_eval", "viterbi_batch", "gather_cols",
            "viterbi_rows", "frame_best_sub"]
N_SEQ = 8               # ranks of the long form's local ring
LONG_K5 = 100           # AUSTEN repeats of the informational long row
REPEATS = 130           # transcript repeats of the int16 global-state graph
BIG_B = 256
N_BATCHES = 2
N_BACKEND_BATCHES = 2
N_FIVE_BATCHES = 2
N_REQUESTS = 16
DENSE_SLICE = 2048      # frames of the dense routes' slice (K2, K3, K11, K12)


def log(*a):
    print(*a, flush=True)


# -- the kernel clock ---------------------------------------------------------

L2_BYTES = 50 * 2 ** 20         # the H100's L2 cache
FLUSH_BYTES = 2 * L2_BYTES      # written before each timed launch
BOUND_LIMIT = 1.05              # bound_ms / ms above this: a miscounted bound
_clock: dict = {}
# what time_ms timed with host time in its window: the host could not get
# ahead of the device (a call that waits on it, or more launches than the
# stream's queue holds)
HOST_IN_WINDOW: set = set()


def flush_l2() -> None:
    """Write a scratch buffer twice the L2's size, so the next launch
    reads its inputs from HBM, as the main path's kernels do (their
    inputs come from the previous kernel and exceed the L2); then read a
    clean buffer as large, so that the L2 holds no dirty line whose
    write-back would fall into the next launch's time."""
    if "buf" not in _clock:
        _clock["buf"] = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                    device="cuda")
        _clock["clean"] = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64,
                                      device="cuda")
        _clock["max"] = torch.empty((), dtype=torch.int64, device="cuda")
    _clock["buf"].zero_()
    torch.amax(_clock["clean"], dim=0, out=_clock["max"])


def sleep_ms(ms: float) -> None:
    """Hold the stream for about ms milliseconds (torch.cuda._sleep,
    calibrated once against CUDA events)."""
    if "cycles_per_ms" not in _clock:
        cycles = 10 ** 7
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _clock["cycles_per_ms"] = cycles / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _clock["cycles_per_ms"]))


def time_ms(fn, runs: int = 10, name: str = "") -> float:
    """Device time per launch of fn: one warm-up; then the stream held
    for longer than the host takes to enqueue ``runs`` iterations (L2
    flush, start event, fn, end event) with no synchronisation between
    them; the median of the ``runs`` event pairs.  A head start shorter
    than the host's enqueue is lengthened, and said; where that does not
    help, ``name`` goes into HOST_IN_WINDOW."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush_l2()
    fn()
    ahead = max(2.0, 3e3 * runs * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    for tries in range(3):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
        sleep_ms(ahead)
        t0 = time.perf_counter()
        for start, end in ev:
            flush_l2()
            start.record()
            fn()
            end.record()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue < ahead:
            break
        if tries == 2:
            HOST_IN_WINDOW.add(name)
            log(f"  clock {name}: the host took {enqueue:.3f} ms to enqueue "
                f"{runs} launches behind a {ahead:.3f} ms head start; it "
                "waits on the device, so this time holds host time")
            break
        log(f"  clock {name}: the host took {enqueue:.3f} ms to enqueue "
            f"{runs} launches, past the {ahead:.3f} ms head start; "
            f"lengthened to {3 * enqueue:.3f} ms")
        ahead = 3 * enqueue
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def call_ms(fn, runs: int = 10) -> float:
    """Median time of one call of fn from an idle device (after one
    warm-up), between two events around the Python call: what a lone
    caller pays, the wrapper's host time included."""
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


def rank_kernels(entries: list) -> list:
    """Rule 2's order of kernel entries (dicts with name, ms, bound_ms,
    library_ms, launches): first those slower than their one PyTorch
    call, the largest factor ms / library_ms first; then the others by
    launches x (ms - bound_ms), leaving out those within twice their
    bound.  Returns (name, "factor" or "gap", value) triples."""
    slower = sorted(((e["name"], "factor", e["ms"] / e["library_ms"])
                     for e in entries if e.get("library_ms") is not None
                     and e["ms"] > e["library_ms"]), key=lambda r: -r[2])
    done = {r[0] for r in slower}
    gaps = sorted(((e["name"], "gap", e["launches"] * (e["ms"] - e["bound_ms"]))
                   for e in entries if e["name"] not in done
                   and e["ms"] > 2 * e["bound_ms"]), key=lambda r: -r[2])
    return slower + gaps


# wrappers cross-checked with torch.profiler: entry -> (call, a substring
# of the kernels' names)
PROBES: dict = {}


def profile_check(results: dict, launches: int = 5) -> None:
    """One torch.profiler pass over ``launches`` launches of each probe
    (each after an L2 flush): the device time of its kernels per launch,
    kept as ``profiler_ms`` beside the events' ``ms``."""
    from torch.profiler import ProfilerActivity, profile
    # a first session may record no device time while the tracer starts
    with profile(activities=[ProfilerActivity.CUDA]):
        flush_l2()
        torch.cuda.synchronize()
    for name, (fn, tag) in PROBES.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if tag in e.key)
        r = results[name]
        r["profiler_ms"] = us / 1e3 / launches if us > 0 else None
        log(f"  profiler {name}: " + (
            f"{r['profiler_ms']:.4f} ms of device time a launch, the events "
            f"{r['ms']:.4f} ms" if us > 0 else
            "no device time recorded; the events' time stands"))


def over_bound(entries: list, limit: float = BOUND_LIMIT) -> list:
    """Names of the entries that read faster than ``limit`` times their
    bound allows: a bound whose bytes or operations are miscounted."""
    return [e["name"] for e in entries if e["bound_ms"] > limit * e["ms"]]


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
            runs: int = 10, n_bytes: int | None = None, before=None):
    """Kernel vs plain PyTorch on the same device inputs: bit-equal (every
    output, dtypes included).  ``ms`` is the device time per launch
    (time_ms), ``call_ms`` one call from an idle device (call_ms).
    ``bound_ms`` is the larger of the bytes (``ins``, read once, or
    ``n_bytes`` where the data decide what is read, and the kernel's
    outputs, written once) over HBM_BPS and ``ops`` over ``rate``;
    ``library`` is one PyTorch call computing the same function, timed
    as the kernel is (used nowhere in the port).  ``before`` (the same
    function on the parent's kernel, under ``--before``) must give the
    same bits; it and the kernel are then timed in turns (kernel, before,
    before, kernel: ``ms`` and ``ms_before`` the means of two)."""
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
    ms = time_ms(fn, runs, name)
    turns = None
    if before is not None:
        berr = max_abs_err(before(), out_k)
        if berr != 0.0:
            raise AssertionError(f"{name}: the parent's kernel differs "
                                 f"(max_abs_err {berr})")
        turns = [ms, time_ms(before, runs, f"{name} before"),
                 time_ms(before, runs, f"{name} before"),
                 time_ms(fn, runs, name)]
        ms = (turns[0] + turns[3]) / 2
    c_ms = call_ms(fn, runs)
    # plain_runs=0: the plain version's time is that of the comparison call
    plain_ms = (call_ms(plain, plain_runs) if plain_runs
                else start.elapsed_time(end))
    b = (bound(nbytes(*ins) + nbytes(out_k), ops, rate) if n_bytes is None
         else bound(n_bytes + nbytes(out_k), ops, rate))
    lib_ms = (None if library is None
              else time_ms(library, runs, f"{name} library"))
    log(f"  {name}: bit-equal, kernel {ms:.4f} ms a launch (one call "
        f"{c_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})"
        + ("" if lib_ms is None else f", one PyTorch call {lib_ms:.4f} ms"))
    results[name] = dict(max_abs_err=err, ms=ms, call_ms=c_ms,
                         plain_ms=plain_ms, **b, library_ms=lib_ms)
    if turns is not None:
        r = results[name]
        r["ms_before"] = (turns[1] + turns[2]) / 2
        r["turns_ms"] = turns
        log(f"  {name}: the parent's kernel {r['ms_before']:.4f} ms, this "
            f"one {ms:.4f} ms (turns {', '.join(f'{t:.4f}' for t in turns)})")
    for what in (name, f"{name} library"):
        if what in HOST_IN_WINDOW:
            results[name].setdefault("host_in_window", []).append(
                "library" if what != name else "kernel")
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


def vit_bytes(v) -> int:
    """The bytes of K4's graph tables its bounded loop reads: the tmat
    rows, windows, in-degrees, entries and final nodes, and each phone's
    real predecessor slots (index and penalty), not the padded [P, K]."""
    return (nbytes(v.tp, v.astart, v.aend, v.pred_n, v.entry, v.fin)
            + 8 * int(v.pred_n.sum()))


def rows_bytes(v) -> int:
    """The bytes of K6's graph tables its bounded loop reads: the tmat
    rows, windows, entries, final masks and list lengths, and each
    phone's real predecessors (index and penalty) in its form's lists."""
    nin = v.lists()[3]
    return (nbytes(v.tp, v.astart, v.aend, v.entry, v.final_mask, nin)
            + 8 * int(nin.sum()))


# -- the parent's K1 and K14 (--before DIR) --------------------------------

# DIR's soundswallower_tpu_torch/csrc/feat.cu and yin.cu built into a
# library of their own: K1 and K14 before their redesign (K1 a block a
# row whose 13 threads walk the frames from global memory, K14 a block a
# frame, a lag a thread), called below with the parameters their
# declarations in DIR's sst_kernels.h must list
BEFORE: dict = {}
BEFORE_SOURCES = ("feat", "yin")
BEFORE_PARAMS = {
    "sst_feat": "planes n_frames out B T ncep inv_scale do_cmn stream",
    "sst_feat_f32": "cep n_frames out B T ncep do_cmn stream",
    "sst_yin_cmnd": "frames is_i16 cmnd period best N F ndiff thr stream",
}
# ctypes types of the declared scalar parameters
BEFORE_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float,
                  "double": ctypes.c_double}


def header_params(header: str, name: str) -> list:
    """(type, name) of each parameter of ``int name(...);`` in a C
    header's text; ValueError where it declares no such function."""
    m = re.search(rf"\bint {name}\(([^)]*)\);", header)
    if m is None:
        raise ValueError(f"no declaration of {name}")
    out = []
    for param in m.group(1).split(","):
        *typ, nm = param.replace("*", " * ").split()
        out.append((" ".join(typ), nm))
    return out


def before_argtypes(header: str) -> dict:
    """ctypes argument types of BEFORE_PARAMS's launchers as the header
    declares them (pointers and the stream c_void_p, int c_int, float
    c_float, double c_double); ValueError where a declaration lists
    other parameters or a scalar of another type (another signature:
    calling it would be undefined)."""
    sigs = {}
    for name, want in BEFORE_PARAMS.items():
        params = header_params(header, name)
        got = [nm for _, nm in params]
        if got != want.split():
            raise ValueError(f"{name} is declared ({', '.join(got)}), not "
                             f"({', '.join(want.split())})")
        types = []
        for t, nm in params:
            if "*" in t or t == "cudaStream_t":
                types.append(ctypes.c_void_p)
            elif t in BEFORE_SCALARS:
                types.append(BEFORE_SCALARS[t])
            else:
                raise ValueError(f"{name}: parameter {nm} of type {t}")
        sigs[name] = types
    return sigs


def build_before(root: str) -> None:
    """Compile root's BEFORE_SOURCES (one nvcc each, all started
    together) and load them as BEFORE["lib"]; root's header must declare
    the launchers as BEFORE_PARAMS lists."""
    src = os.path.join(root, "soundswallower_tpu_torch", "csrc")
    with open(os.path.join(src, "sst_kernels.h")) as f:
        sigs = before_argtypes(f.read())
    out = os.path.join(cuda_build.BUILD_DIR, "before")
    os.makedirs(out, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    objs = [os.path.join(out, f + ".o") for f in BEFORE_SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-c", "-o", o,
                               os.path.join(src, os.path.basename(o)[:-2]
                                            + ".cu")],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for o in objs]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("the parent's K1 and K14 did not build:\n"
                           + "".join(logs))
    so = os.path.join(out, "libsst_before.so")
    subprocess.run([nvcc, *cuda_build.LINK_FLAGS, "-o", so, *objs],
                   check=True, timeout=300)
    lib = ctypes.CDLL(so)
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    BEFORE["lib"] = lib
    log(f"  the parent's K1 and K14 from {root}: built in "
        f"{time.perf_counter() - t0:.2f} s")


def before_feat(x, n, inv_scale, do_cmn: bool):
    """K1 (byte planes, or its float32 form on float32 cepstra) on the
    parent's kernel: float32 [B, T, 3, ncep], or None without
    --before."""
    if "lib" not in BEFORE:
        return None

    def run():
        planes = x.dtype == torch.uint8
        B, T, ncep = x.shape[1:] if planes else x.shape
        out = torch.empty((B, T, 3, ncep), dtype=torch.float32,
                          device=x.device)
        if planes:
            err = BEFORE["lib"].sst_feat(
                x.data_ptr(), n.data_ptr(), out.data_ptr(), B, T, ncep,
                float(inv_scale), int(do_cmn), cuda_build.stream(x))
        else:
            err = BEFORE["lib"].sst_feat_f32(
                x.data_ptr(), n.data_ptr(), out.data_ptr(), B, T, ncep,
                int(do_cmn), cuda_build.stream(x))
        cuda_build.check(err, "feat (parent)")
        return out
    return run


def before_yin(fr, nd: int, thr: float):
    """K14 on the parent's kernel: (cmnd [N, nd], period [N], best [N]),
    or None without --before."""
    if "lib" not in BEFORE:
        return None

    def run():
        N, F = fr.shape
        cmnd = torch.empty((N, nd), dtype=torch.float32, device=fr.device)
        period = torch.empty(N, dtype=torch.int64, device=fr.device)
        best = torch.empty(N, dtype=torch.float32, device=fr.device)
        err = BEFORE["lib"].sst_yin_cmnd(
            fr.data_ptr(), int(fr.dtype == torch.int16), cmnd.data_ptr(),
            period.data_ptr(), best.data_ptr(), N, F, nd, float(thr),
            cuda_build.stream(fr))
        cuda_build.check(err, "yin_cmnd (parent)")
        return cmnd, period, best
    return run


def feat_bytes(x, n) -> int:
    """K1's bytes in: each row's frames up to min(max(n, 1), T) (those
    its features read; frame 0 for a row of none), from both byte planes
    (x uint8 [2, B, T, ncep]) or the float32 cepstra (x [B, T, ncep]),
    and the frame counts."""
    T, ncep = x.shape[-2], x.shape[-1]
    frames = int(torch.clamp(n.long(), min=1, max=T).sum())
    per = 2 if x.dtype == torch.uint8 else x.element_size()
    return frames * ncep * per + nbytes(n)


def compare_feat(name, x, n, inv_scale, do_cmn: bool, results,
                 plain_runs: int = 10):
    """K1 on byte planes (x uint8 [2, B, T, ncep]) or its float32 form (x
    float32 [B, T, ncep]) against its plain version and, under --before,
    the parent's kernel, with the layout its launcher takes.  Bound:
    feat_bytes in, the features out; 8 float32 operations an element on
    planes (dequant, CMN, differences), 6 on float32."""
    planes = x.dtype == torch.uint8
    B, T, ncep = x.shape[1:] if planes else x.shape
    lay = feat_mod.feat_layout(B, T, ncep, do_cmn)
    log(f"  {name}: B={B} T={T} ncep={ncep}: {lay['rows']} rows a fold "
        f"block, passes of {lay['pass_frames']} frames, "
        + ("one launch (the fold block writes its rows)" if lay["tile"] == 0
           else f"tiles of {lay['tile']} frames")
        + f", {lay['launches']} launch{'es' if lay['launches'] > 1 else ''}")
    if planes:
        fn = functools.partial(feat_mod.feat, x, n, inv_scale, do_cmn)
        plain = functools.partial(feat_mod.feat_plain, x, n, inv_scale,
                                  do_cmn)
    else:
        fn = functools.partial(feat_mod.feat_f32, x, n, do_cmn)
        plain = functools.partial(feat_mod.feats_plain, x, n, do_cmn)
    out = compare(name, fn, plain, results, plain_runs=plain_runs,
                  n_bytes=feat_bytes(x, n),
                  ops=(8.0 if planes else 6.0) * B * T * ncep,
                  before=before_feat(x, n, inv_scale, do_cmn))
    results[name]["layout"] = lay
    return out


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
            compare_feat("feat", pl, Tn, inv, al.do_cmn, results)
        flat = feats.view(n * Tmax, 3, -1)
        if first:
            s, cw = compare_dist("dist_topn_norm", flat, c.gs, results,
                                 plain_runs=10)
            # a tile remainder, and top-N 1 and 8, on the same frames
            compare_dist("dist_topn_norm[tile remainder]",
                         flat[:flat.shape[0] - 37], c.gs, results)
            for topn in (1, 8):
                compare_dist(f"dist_topn_norm[topn {topn}]", flat,
                             dataclasses.replace(c.gs, topn=topn), results)
            compare_eval("senone_eval", s, cw, c.gs, results,
                         plain_runs=10)
        senscore_torch.score_frames_graph(
            c.gs, flat, out=sen[i0:i0 + n].view(n * Tmax, -1))
    log(f"  shapes: B={len(audios)} Tmax={Tmax} S={c.gs.S} "
        f"Cu={c.gs.means.shape[0]} P={c.vit.P} K={c.vit.pred_idx.shape[1]}")
    compare("viterbi_batch",
            lambda: align_torch.viterbi_batch(sen, Ts_d, c.vit),
            lambda: align_torch.viterbi_batch_plain(sen, Ts_d, c.vit),
            results, n_bytes=nbytes(sen, Ts_d) + vit_bytes(c.vit),
            ops=vit_ops(sen), rate=I32_OPS)


def compare_dist(name, x, gs, results, mode: str = "fold",
                 plain_runs: int = 0):
    """K2 (``mode`` fold or mxu) against its plain version, with the tile
    the launcher takes."""
    N, F, _ = x.shape
    tile = cuda_build.lib().sst_dist_topn_tile(N, F)
    log(f"  {name}: N={N} frames, Cu={gs.means.shape[0]} F={F} "
        f"D={gs.means.shape[2]} top-{gs.topn}, tiles of {tile} frames "
        f"({-(-N // tile)} x {F} blocks, the last tile {N - (N - 1) // tile * tile} "
        "frames)")
    out = compare(name, lambda: senscore_torch.dist_topn_norm(x, gs, mode),
                  lambda: senscore_torch.dist_topn_norm_plain(x, gs, mode),
                  results, plain_runs=plain_runs,
                  ins=((x, gs.var_t, gs.det, gs.muv, gs.c) if mode == "mxu"
                       else (x, gs.means, gs.var_t, gs.det)),
                  ops=fold_ops(N, gs))
    results[name]["tile"] = tile
    return out


def k3_ops(N: int, S: int, F: int, topn: int, wrap_u8: bool) -> float:
    """K3's int32 operations: per (frame, state, stream) the first term's
    add, then per later term the add, the min, |diff| (two) and the
    table's subtraction, and the sum over streams; wrap_u8's & 0xFF a
    term more."""
    return float(N * S * F) * (5 * topn - 3 + (topn if wrap_u8 else 0))


def compare_eval(name, s, cw, gs, results, plain_runs: int = 0):
    """K3 against its plain version, with the layout its launcher
    takes.  Bound: the top-N scores
    and indices, the mixture weights, the column map and the table in;
    the int32 operations of its chains (k3_ops)."""
    N, Cu, F, topn = s.shape
    G, tile, sub = senscore_torch.senone_eval_layout(N, gs.S, Cu, F, topn)
    log(f"  {name}: N={N} frames, S={gs.S}, Cu={Cu} F={F} top-{topn}"
        f"{' wrap_u8' if gs.wrap_u8 else ''}: ranges of {G} columns, tiles "
        f"of {tile} frames ({-(-gs.S // G)} x {-(-N // tile)} blocks), "
        f"terms in passes of {sub} frames where a range holds "
        f"{min(Cu, G)} codebooks")
    out = compare(name, lambda: senscore_torch.senone_eval(s, cw, gs),
                  lambda: senscore_torch.senone_eval_plain(s, cw, gs),
                  results, plain_runs=plain_runs,
                  ins=(s, cw, gs.mixw, gs.cb_pos, gs.logadd),
                  ops=k3_ops(N, gs.S, F, topn, gs.wrap_u8), rate=I32_OPS)
    results[name].update(cols=G, tile=tile, pass_frames=sub)
    return out


def gather_bytes(src, cols) -> int:
    """K5's bytes in: the columns, and the source values this run's
    columns select (each row's distinct in-range columns, wrapped as the
    kernel wraps them, at every frame)."""
    B, T, Sx = src.shape
    idx = cols.long()
    idx = torch.where(idx < 0, idx + Sx, idx)
    used = sum(int(torch.unique(r[(r >= 0) & (r < Sx)]).numel()) for r in idx)
    return used * T * src.element_size() + nbytes(cols)


def gather_library(src, cols):
    """One PyTorch call for K5 on in-range columns: torch.gather (int64
    indices, expanded over the frames; the source's dtype out)."""
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
                    results, n_bytes=gather_bytes(src, cols),
                    library=gather_library(src, cols))
        senscore_torch.gather_cols(src, cols, out=sen[i0:i0 + n])
    v = st.vit
    log(f"  union shapes: B={len(audios)} Tmax={Tmax} Spad={uni['Spad']} "
        f"Cu={uni['gs'].means.shape[0]} P={v.P} K={v.pred_idx.shape[2]} "
        f"W={0 if v.band_pen is None else v.band_pen.shape[1]}")
    if v.band_pen is None:
        raise AssertionError("the mixed batch's stack took no band")
    # the band lists' build on the card, once per stack (informational)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    align_torch.band_lists(v.band_pen, v.band_ok)
    torch.cuda.synchronize()
    log(f"  band_lists of the B={v.band_pen.shape[0]} stack "
        f"(W={v.band_pen.shape[1]}, P={v.P}): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms of wall on the card, "
        "once per stack")
    compare_vit("viterbi_rows", sen, Ts_d, v, results)
    compare_vit("viterbi_rows[scores]", sen, Ts_d, v, results, True)
    # the same rows through the K-slot lists, and through a cluster of 8
    compare_vit("viterbi_rows[K-slot]", sen, Ts_d, dataclasses.replace(
        v, band_pen=None, band_ok=None, band_src=None, band_pen_c=None,
        band_n=None), results)
    compare_vit("viterbi_rows[cluster 8]", sen, Ts_d, v, results, cluster=8)
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
        s, cw = compare_dist("dist_topn_norm[full inventory]", part, ds,
                             results)
        compare_eval("senone_eval[full inventory]", s, cw, ds, results)
        s, cw = senscore_torch.dist_topn_norm(flat, ds)
        # K3 on the whole chunk, as the dense route launches it
        x = compare_eval("senone_eval[full inventory, chunk]", s, cw, ds,
                         results)
        for name, n in (("senone_eval[full inventory]", part.shape[0]),
                        ("senone_eval[full inventory, chunk]",
                         flat.shape[0])):
            results[name]["shape"] = f"N={n}, S={ds.S}"
        compare("frame_best_sub",
                lambda: senscore_torch.frame_best_sub(x),
                lambda: senscore_torch.frame_best_sub_plain(x), results,
                ins=(x,), ops=2.0 * x.numel(), rate=I32_OPS)
        PROBES["frame_best_sub"] = (lambda: senscore_torch.frame_best_sub(x),
                                    "frame_best_sub")
        src = senscore_torch.frame_best_sub(x).view(len(audios), Tmax, -1)
        compare("gather_cols[int16 full inventory]",
                lambda: senscore_torch.gather_cols(src, cols),
                lambda: senscore_torch.gather_cols_plain(src, cols),
                results, n_bytes=gather_bytes(src, cols),
                library=gather_library(src, cols))


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
    batch, one launch each over all rows, K9 also in the stream's masked
    form from a carried state; K8 and K9 also on the route's own 128-row
    chunk and on one stream piece (B=1, 20 of 32 frames, masked, from the
    carry of the frames before it); K8-K10 at 16 kHz with nfft 512; the
    device FE's cepstra of austen.raw against the C reference's; the
    device FE per B=256 batch beside the host C++ FE (informational)."""
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
    spec = compare_spec("fe_spec", fe, sig, ns, prior, Tmax, results)
    fresh = fe.noise_init(B, dev)
    den, carry = compare_noise("fe_noise", fe, spec, fresh, None, results)
    compare_noise("fe_noise[masked, carried]", fe, spec, carry, Ts_d,
                  results)
    # the route's own 128-row chunk (_chunk_feats_device), from a fresh
    # state
    ck = al_dev._chunk_size(B)
    spec_c = compare_spec("fe_spec[route chunk]", fe, sig[:ck], ns[:ck],
                          prior[:ck], Tmax, results)
    compare_noise("fe_noise[route chunk]", fe, spec_c,
                  fe.noise_init(ck, dev), None, results)
    sig_s, ns_s, prior_s, nf_s, carry_s = stream_piece(fe, dev)
    spec_s = compare_spec("fe_spec[stream piece]", fe, sig_s, ns_s, prior_s,
                          32, results)
    compare_noise("fe_noise[stream piece]", fe, spec_s, carry_s, nf_s,
                  results)
    # these entries count their path's launches of their own rows and
    # frames (fe_spec.shapes, fe_noise.shapes)
    for name, rows, frames in (("route chunk", ck, Tmax),
                               ("stream piece", 1, 32)):
        for k in ("fe_spec", "fe_noise"):
            results[f"{k}[{name}]"]["shape"] = f"B={rows}, T={frames}"
    cep = compare("fe_cep", lambda: fe_mod.fe_cep(fe, den),
                  lambda: fe_mod.fe_cep_plain(fe, den), results, plain_runs=0,
                  **cep_bound(fe, den))
    compare("fe_cep[logspec]", lambda: fe_mod.fe_cep(fe, den, True),
            lambda: fe_mod.fe_cep_plain(fe, den, True), results, plain_runs=0,
            ins=(den,), ops=2.0 * den.numel(), rate=F64_OPS,
            library=lambda: torch.log(den))
    PROBES["fe_cep"] = (lambda: fe_mod.fe_cep(fe, den), "fe_cep")
    PROBES["fe_cep[logspec]"] = (lambda: fe_mod.fe_cep(fe, den, True),
                                 "fe_cep")
    compare_feat("feat_f32", cep, Ts_d, None, al_dev.do_cmn, results)
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
    spec16 = compare_spec("fe_spec[16 kHz, nfft 512]", fe16, x16, ns16, p16,
                          T16, results)
    den16, _ = compare_noise("fe_noise[16 kHz]", fe16, spec16,
                             fe16.noise_init(B16, dev), None, results)
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


def stream_piece(fe, dev):
    """K8's and K9's inputs for one stream piece as AlignStream._fe_frames
    makes them: the 1,600 samples of austen.raw after its first 4,800,
    20 frames of float32 samples padded to 2,048 and 32 frames, the
    prior, and the masked scan's frame count and the carry of the frames
    before it: (sig, n_samps, prior, n_frames, carry), B=1."""
    a0 = austen_audio(0)
    shift, size = fe.frame_shift, fe.frame_size
    head = 4800
    n0 = 1 + (head - size) // shift
    _, state = fe.mfcc_chunk(torch.from_numpy(a0[:head].astype(np.float32))
                             .to(dev), head, 64, 0.0, None, n0)
    off = n0 * shift
    count = 1 + (head + 1600 - off - size) // shift
    n_seg = (count - 1) * shift + size
    seg = np.zeros((1, 2048), np.float32)
    seg[0, :n_seg] = a0[off:off + n_seg]
    log(f"  stream piece: B=1, {n_seg} samples of 2048, {count} frames of "
        f"32, masked, carried")
    return (torch.from_numpy(seg).to(dev),
            torch.tensor([n_seg], dtype=torch.int32, device=dev),
            torch.tensor([float(a0[off - 1])], dtype=torch.float32,
                         device=dev),
            torch.tensor([count], dtype=torch.int32, device=dev),
            tuple(x[None] for x in state))


def compare_spec(name, fe, sig, ns, prior, T: int, results: dict,
                 extra_ops: float = 0.0):
    """K8 against its plain version, with the frames a block its
    launcher takes; ``extra_ops`` beside spec_bound's (remove_dc's
    mean)."""
    B = sig.shape[0]
    W = fe_mod.spec_frames(fe)
    log(f"  {name}: B={B} T={T} nfft={fe.fft_size} nfilt={fe.num_filters}, "
        f"{W} frames a block ({-(-T // W)} x {B} blocks)")
    sb = spec_bound(fe, sig, ns, prior, B * T)
    sb["ops"] += extra_ops
    out = compare(name, lambda: fe_mod.fe_spec(fe, sig, ns, prior, T),
                  lambda: fe_mod.fe_spec_plain(fe, sig, ns, prior, T),
                  results, plain_runs=0, **sb)
    results[name]["frames_a_block"] = W
    return out


def compare_noise(name, fe, spec, carry, n_frames, results: dict):
    """K9 (the masked scan where n_frames is given) against its plain
    version, with the frame tile its launcher takes."""
    B, T, nf = spec.shape
    F = fe_mod.noise_tile(nf)
    log(f"  {name}: B={B} T={T} nf={nf}, "
        f"{'masked' if n_frames is not None else 'plain'}, tiles of {F} "
        f"frames ({-(-T // F)} a row)")
    ins = (spec, carry) if n_frames is None else (spec, carry, n_frames)
    out = compare(name, lambda: fe_mod.fe_noise(fe, spec, carry, n_frames),
                  lambda: fe_mod.fe_noise_plain(fe, spec, carry, n_frames),
                  results, plain_runs=0, ins=ins, ops=40.0 * spec.numel(),
                  rate=F64_OPS)
    results[name]["tile"] = F
    return out


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
    select and backtrace); K1's float32 form on that path's cepstra."""
    dev = al_dev.device
    a = austen_audio(0)
    c = al_dev._graph_consts(al_dev.graph_for_text(TEXT))
    n = len(a)
    T = al_dev.fe.n_frames(n)
    Tpad = max(128, -(-T // 128) * 128)
    cep = al_dev.fe.mfcc(torch.from_numpy(a).to(dev)[None], n, Tpad)
    Tn = torch.tensor([T], dtype=torch.int32, device=dev)
    # K1's float32 form as align launches it: one row of Tpad frames
    feats = compare_feat("feat_f32[align]", cep, Tn, None, al_dev.do_cmn,
                         results)[0]
    results["feat_f32[align]"]["shape"] = f"B=1, T={Tpad}"
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
            results, plain_runs=0,
            n_bytes=nbytes(first, carry0) + vit_bytes(c.vit),
            ops=vit_ops(first), rate=I32_OPS)
    compare_single("viterbi_chunk[single, backtrace]", sen, T, c.vit,
                   results)


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


def compare_ms_dist(name, x, ms, results):
    """K11 against its plain version, with the tile its launcher takes;
    its launches count at its frames (``shape``)."""
    N, F, _ = x.shape
    C, _, D, L = ms.means.shape
    tile = cuda_build.lib().sst_dist_topn_tile(N, F)
    log(f"  {name}: N={N} frames, C={C} F={F} D={D} L={L} "
        f"top-{ms.n_best}, tiles of {tile} frames ({-(-N // tile)} x {F} "
        f"blocks, the last tile {N - (N - 1) // tile * tile} frames)")
    out = compare(name, lambda: senscore_torch.ms_dist_topn(x, ms),
                  lambda: senscore_torch.ms_dist_topn_plain(x, ms), results,
                  plain_runs=0, ins=(x, ms.means, ms.var_t, ms.det),
                  ops=fold_ops(N, ms))
    results[name].update(tile=tile, shape=f"N={N}, S={ms.S}")
    return out


def compare_ms_eval(name, dval, cw, ms, results):
    """K12 against its plain version, with the senone group and frame
    tile its launcher takes; its launches count at its frames
    (``shape``).  Bound: 8 int32 operations per (frame, senone, stream,
    top-N entry)."""
    N, C, F, n = dval.shape
    g = senscore_torch.ms_groups(ms)
    tile = cuda_build.lib().sst_ms_senone_eval_tile(N, ms.S, g.G, g.U, F, n)
    log(f"  {name}: N={N} frames, S={ms.S} in groups of {g.G} senones "
        f"(at most {g.U} codebooks a group), tiles of {tile} frames "
        f"({-(-N // tile)} x {-(-ms.S // g.G)} blocks), top-{n}, aw {ms.aw}")
    out = compare(name, lambda: senscore_torch.ms_senone_eval(dval, cw, ms),
                  lambda: senscore_torch.ms_senone_eval_plain(dval, cw, ms),
                  results, plain_runs=0,
                  ins=(dval, cw, ms.mixw, ms.sen2cb, ms.logadd),
                  ops=8.0 * N * ms.S * F * n, rate=I32_OPS)
    results[name].update(tile=tile, group=g.G, shape=f"N={N}, S={ms.S}")
    return out


def phase_kernels_backends(als: dict, results: dict):
    """K11 and K12 on the ms model's B=256 same-transcript batch: on
    DENSE_SLICE frames of its first 128-row chunk, on the whole chunk
    (the shape the path launches them at), and, on the slice, K11 at a
    tile remainder and at top-N 8, K12 at top-N 8 and aw 2; K3's wrap_u8
    on the 4-bit semi union route's B=256 batch, K7's semi form on the
    semi dense route's B=32 batch; every backend's full-inventory scores
    of the golden's frames."""
    al = als["ms"]
    ms = al.dense
    big = [austen_audio(i % N_UTT) for i in range(BIG_B)]
    audios, Ts, Tmax = al._batch_shape(big)
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    _, _, feats = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    flat = feats.view(-1, 3, feats.shape[-1])
    part = flat[:DENSE_SLICE]
    L = ms.means.shape[3]
    log(f"  ms shapes: chunk N={flat.shape[0]} frames, slice "
        f"N={part.shape[0]}; S={ms.S} aw={ms.aw}")
    dval, cw = compare_ms_dist("ms_dist_topn", part, ms, results)
    compare_ms_eval("ms_senone_eval", dval, cw, ms, results)
    dval_c, cw_c = compare_ms_dist("ms_dist_topn[chunk]", flat, ms, results)
    compare_ms_eval("ms_senone_eval[chunk]", dval_c, cw_c, ms, results)
    del dval_c, cw_c
    compare_ms_dist("ms_dist_topn[tile remainder]",
                    part[:part.shape[0] - 37], ms, results)
    ms8 = dataclasses.replace(ms, topn=8)
    d8, c8 = compare_ms_dist("ms_dist_topn[topn 8]", part, ms8, results)
    compare_ms_eval("ms_senone_eval[topn 8]", d8, c8, ms8, results)
    compare_ms_eval("ms_senone_eval[aw 2]", dval, cw,
                    dataclasses.replace(ms, aw=2), results)

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
    compare_eval("senone_eval[wrap_u8]", s, cw, gs, results, plain_runs=10)
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
    PROBES["frame_best_sub[semi]"] = (
        lambda: senscore_torch.frame_best_sub(x, False), "frame_best_sub")

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


def compare_vit(name, sen, n, v, results, ws=False, runs=10,
                cluster: int = 0):
    """K4 (VitConsts) or K6 (RowVitConsts, at ``cluster`` blocks a row,
    0 the launcher's choice) against its plain version; the plain
    version's time is that of the comparison call."""
    rows = isinstance(v, align_torch.RowVitConsts)
    shape_log(name, sen, v)
    if rows:
        cs = align_torch.rows_layout(v.P, v.E, sen.shape[2], ws, cluster)
        log(f"  {name}: {v.lists()[0]} lists of up to "
            f"{int(v.lists()[3].max())} of {v.lists()[1].shape[2]} slots, "
            + ("one block, the state in global memory" if cs == 0 else
               "one block" if cs == 1 else f"a cluster of {cs} blocks")
            + " a row")

        def fn():
            return align_torch.viterbi_rows(sen, n, v, ws, cluster)
        graph = dict(n_bytes=nbytes(sen, n) + rows_bytes(v))
        plain = align_torch.viterbi_rows_plain
    else:
        def fn():
            return align_torch.viterbi_batch(sen, n, v, ws)
        graph = dict(n_bytes=nbytes(sen, n) + vit_bytes(v))
        plain = align_torch.viterbi_batch_plain
    compare(name, fn, lambda: plain(sen, n, v, ws), results, plain_runs=0,
            ops=vit_ops(sen), rate=I32_OPS, runs=runs, **graph)
    if rows:
        results[name]["cluster"] = cs


def compare_single(name, sen, T, v, results, runs=10):
    """The single-utterance path (K4's carry form from vit_carry0 with
    the final select and backtrace) against its plain version."""
    shape_log(name, sen, v)
    carry0 = tuple(x[None] for x in align_torch.vit_carry0(v))
    compare(name, lambda: align_torch.viterbi_single(sen, T, v),
            lambda: align_torch.viterbi_single_plain(sen, T, v), results,
            plain_runs=0, n_bytes=nbytes(sen) + vit_bytes(v),
            ops=vit_ops(sen), rate=I32_OPS, runs=runs)


def phase_kernels_vit_forms(al, al_dev, al5, al5_dev, mg, results):
    """Each new Viterbi form against its plain version at the shape its
    path gives it: E=5 (K4 on the 5-state same-transcript B=256 batch,
    K6 on its union B=256 and scored B=32 batches, the carry form on
    its single-utterance device path); K4 with scores (the 8-bit ptm
    same-transcript B=256 batch); the global-state layout with int16
    tokens (K4 and K6 on a transcript of REPEATS repeats, random scores,
    B=4, T=256) and with int32 tokens (the large grammar: K4 on its
    decode_batch B=8, K6 with scores on its decode_batch_scored B=8 at
    the launcher's layout, at one block and at a cluster of 16, the
    carry form on its device-FE decode); K6 on the decode grammar's
    decode_batch_scored B=32 (K-slot lists)."""
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
    # the same rows at one block (its state in global memory) and at a
    # cluster of 16 blocks a row, where the card runs one
    compare_vit("viterbi_rows[3-state, int32, scores, cluster 1]", sen, n, v,
                results, True, runs=3, cluster=1)
    try:
        align_torch.rows_layout(v.P, v.E, sen.shape[2], True, 16)
    except ValueError as e:
        log(f"  viterbi_rows at a cluster of 16: {e}")
    else:
        compare_vit("viterbi_rows[3-state, int32, scores, cluster 16]", sen,
                    n, v, results, True, runs=3, cluster=16)
    # the decode scored path's K-slot stack: the decode grammar's graph
    # (P=200, K=33) at B=32
    dgr = al.set_grammar(jsgf_string=GRAMMAR)
    al.want_scores = True
    try:
        sen, n, v = rows_batch_sen(al, [dgr] * N_MIXED,
                                   [decode_audio(i % N_DECODE)
                                    for i in range(N_MIXED)])
    finally:
        al.want_scores = False
    compare_vit("viterbi_rows[decode, K-slot, scores]", sen, n, v, results,
                True)
    lgd = al_dev.set_grammar(jsgf_string=large_grammar())
    sen, T, v = single_sen(al_dev, lgd, austen_audio(0))
    compare_single("viterbi_chunk[3-state, int32, global]", sen, T, v,
                   results, runs=3)
    results["viterbi_chunk[3-state, int32, global]"]["shape"] = (
        f"R=1, P={v.P}")


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


def long_planes(al: TorchAligner, audios: list, nseq: int):
    """The wire's byte planes and frame counts of long rows as
    align_longform_batch uploads them (the frame axis rounded up to 64
    per rank; one upload chunk)."""
    Ts = np.array([al.fe.n_frames(len(a)) for a in audios])
    gran = 64 * nseq
    Tmax = -(-int(Ts.max()) // gran) * gran
    Ts_d = torch.from_numpy(Ts.astype(np.int32)).to(al.device)
    _, pl, _ = next(iter(al._chunk_feats(audios, Ts_d, Tmax)))
    return pl, Ts_d


def compare_long_feat(name, al: TorchAligner, audios: list, results):
    """K1 on long rows at the long form's shape (a ring of N_SEQ),
    counted on its path at those rows and frames."""
    pl, Ts_d = long_planes(al, audios, N_SEQ)
    compare_feat(name, pl, Ts_d, 1.0 / al.wire_scale, al.do_cmn, results,
                 plain_runs=0)
    results[name]["shape"] = f"B={pl.shape[1]}, T={pl.shape[2]}"


def first_chunk_tokens(sen, n, v, C: int) -> torch.Tensor:
    """Rank 0's token chunk [B, C, S] of a long-form batch: one launch of
    K4's carry form over every row's first C frames from vit_carry0."""
    B = sen.shape[0]
    carry0 = tuple(x.expand(B, *x.shape)
                   for x in align_torch.vit_carry0(v, n_emit=3))
    return align_torch.viterbi_chunk_rows(sen[:, :C].contiguous(), carry0, 0,
                                          n, v)[1]


def compare_ring_step(name, sen, n, v, C: int, results, runs=10):
    """One ring step of the long form: rank 0's launch over every row's
    first C frames from vit_carry0 (the R-row carry form), against its
    plain version; bound over the R rows' scores, carries and tokens;
    the parent ran it as one launch a row."""
    R = sen.shape[0]
    chunk = sen[:, :C].contiguous()
    carry = tuple(x.expand(R, *x.shape).contiguous()
                  for x in align_torch.vit_carry0(v, n_emit=3))
    log(f"  {name}: R={R} C={C} S={chunk.shape[2]} P={v.P} "
        f"K={v.pred_idx.shape[1]} tokens {align_torch.tok_dtype(v.P * 3)}")
    compare(name, lambda: align_torch.viterbi_chunk_rows(chunk, carry, 0, n,
                                                         v),
            lambda: align_torch.viterbi_chunk_rows_plain(chunk, carry, 0, n,
                                                         v),
            results, plain_runs=0,
            n_bytes=nbytes(chunk, carry, n) + vit_bytes(v),
            ops=vit_ops(chunk), rate=I32_OPS, runs=runs)
    results[name]["shape"] = f"R={R}, P={v.P}"


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
    """K13 against its plain version, with the segment length its
    launcher takes; bound: the path
    written, the tokens read (one per row and frame), the starts and
    counts."""
    R, C, S = tok.shape
    L = cuda_build.lib().sst_backtrace_segment_len(R, C, S,
                                                   tok.element_size())
    log(f"  {name}: R={R} C={C} S={S} tokens {tok.dtype}: segments of {L} "
        f"frames ({-(-C // L)} a row"
        f"{', one chain' if L == C else ''})")
    res = {}
    compare(name, lambda: align_torch.backtrace_chunk(tok, start, t0, n),
            lambda: align_torch.backtrace_chunk_plain(tok, start, t0, n),
            res, plain_runs=0, ins=(start, n), runs=runs,
            library=gather_loop(tok, start, t0, n))
    r = res[name]
    b = bound(R * C * tok.element_size() + nbytes(start, n) + 4 * R * C
              + 4 * R, 0.0, I32_OPS)
    r.update(b, segment=L)
    r["other_form"] = other_backtrace_form(name, tok, start, t0, n, L,
                                           r["ms"], runs)
    results[name] = r


def backtrace_at(tok, start, t0: int, n, L: int):
    """K13's launcher with segments of L frames (the wrapper takes
    sst_backtrace_segment_len's): (path [R, C], the state leaving the
    chunk [R])."""
    R, C, S = tok.shape
    K = -(-C // L)

    def run():
        path = torch.empty((R, C), dtype=torch.int32, device=tok.device)
        out = torch.empty(R, dtype=torch.int32, device=tok.device)
        maps = torch.empty((R, K, S) if K > 1 else (0,), dtype=torch.int32,
                           device=tok.device)
        err = cuda_build.lib().sst_backtrace_chunk(
            tok.data_ptr(), tok.element_size(), start.data_ptr(),
            n.data_ptr(), path.data_ptr(), out.data_ptr(), maps.data_ptr(),
            R, C, S, int(t0), L, cuda_build.stream(tok))
        cuda_build.check(err, "backtrace_chunk")
        return path, out
    return run


def other_backtrace_form(name, tok, start, t0: int, n, L: int, ms: float,
                         runs: int) -> dict:
    """The form K13's launcher did not take on this chunk, checked
    bit-equal and timed in turns with the one it took (taken, other,
    other, taken): one chain where it cut segments, segments of
    ceil(sqrt(C)) frames where it kept one chain.  It reads which side
    of sst_backtrace_segment_len's estimate is faster here."""
    C = tok.shape[1]
    other = (C if L < C
             else max(math.ceil(math.sqrt(C)), -(-C // 1024)))
    taken = backtrace_at(tok, start, t0, n, L)
    alt = backtrace_at(tok, start, t0, n, other)
    if max_abs_err(alt(), taken()) != 0.0:
        raise AssertionError(f"{name}: segments of {other} frames differ "
                             f"from segments of {L}")
    what = f"{name} segments"
    turns = [time_ms(taken, runs, what), time_ms(alt, runs, what),
             time_ms(alt, runs, what), time_ms(taken, runs, what)]
    res = dict(segment=other, ms=(turns[1] + turns[2]) / 2,
               taken_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
    log(f"  {name}: segments of {other} frames "
        f"{'(one chain) ' if other == C else ''}{res['ms']:.4f} ms, of "
        f"{L} (taken) {res['taken_ms']:.4f} ms (turns "
        f"{', '.join(f'{t:.4f}' for t in turns)}); the wrapper's launch "
        f"{ms:.4f} ms")
    return res


def phase_kernels_slice6(al: TorchAligner, al_dc: TorchAligner,
                         al_f32: TorchAligner, big: list, results: dict):
    """The kernels and forms of the long form and the repairs against
    their plain versions at their paths' shapes: K1 on the long form's
    rows (the 4-row batch and the 5-minute row), K13 on rank 0's token
    chunk of the long-form batch (int16) and of the large grammar's
    decode batch (int32, S >= 32,767), K4's carry form on one row's
    long-form chunk, on a ring step over each batch's rows and on the
    5-minute row's (LONG_K5 repeats) first chunk, K2's mxu
    form on the same-transcript B=256 batch's first
    chunk and on DENSE_SLICE frames of the full inventory, K8 with
    remove_dc on the remove_dc aligner's B=256 batch, K1's float32 form
    on the f32 wire's host cepstra."""
    dev = al.device
    rows = [longform_audio(i) for i in range(LONG_B)]
    compare_long_feat("feat[long form]", al, rows, results)
    sen, n, v = long_batch_sen(al, rows, longform_text(), N_SEQ)
    C = sen.shape[1] // N_SEQ
    shape_log("long form", sen, v)
    carry0 = align_torch.vit_carry0(v, n_emit=3)
    chunk = sen[0, :C].contiguous()
    n0 = int(n[0])
    compare("viterbi_chunk[long form, 8 ranks]",
            lambda: align_torch.viterbi_chunk(chunk, carry0, 0, n0, v),
            lambda: align_torch.viterbi_chunk_plain(chunk, carry0, 0, n0, v),
            results, plain_runs=0,
            n_bytes=nbytes(chunk, carry0) + vit_bytes(v),
            ops=vit_ops(chunk), rate=I32_OPS)
    results["viterbi_chunk[long form, 8 ranks]"]["shape"] = f"R=1, P={v.P}"
    compare_ring_step("viterbi_chunk[long form, ring step]", sen, n, v, C,
                      results)
    compare_long_feat("feat[long form, 5-minute row]", al,
                      [longform_audio(0, LONG_K5)], results)
    sen5, n5, v5 = long_batch_sen(al, [longform_audio(0, LONG_K5)],
                                  longform_text(LONG_K5), N_SEQ)
    shape_log("5-minute row", sen5, v5)
    compare_ring_step("viterbi_chunk[long form, 5-minute row]", sen5, n5, v5,
                      sen5.shape[1] // N_SEQ, results)
    del sen5
    tok = first_chunk_tokens(sen, n, v, C)
    rng = np.random.RandomState(13)
    start = torch.from_numpy(rng.randint(-2, tok.shape[2], LONG_B)
                             .astype(np.int32)).to(dev)
    compare_backtrace("backtrace_chunk", tok, start, 0, n, results)
    results["backtrace_chunk[int16]"] = results["backtrace_chunk"]
    lg = al.set_grammar(jsgf_string=large_grammar())
    sen32, n32, v32 = graph_batch_sen(al, lg, big[:N_UTT])
    C32 = sen32.shape[1] // N_SEQ
    compare_ring_step("viterbi_chunk[3-state, int32, global, long form]",
                      sen32, n32, v32, C32, results, runs=3)
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
        compare_dist(name, x, sc, results, "mxu")

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
    log(f"  fe_spec[remove_dc]: frame={fe.frame_size}")
    compare_spec("fe_spec[remove_dc]", fe, sig, ns, prior, Tdc, results,
                 extra_ops=2.0 * fe.frame_size * len(dca) * Tdc)   # the mean

    # K1's float32 form on the f32 wire's host cepstra
    audios8, T8, Tm8 = al_f32._batch_shape([austen_audio(i)
                                            for i in range(N_UTT)])
    T8_d = torch.from_numpy(T8.astype(np.int32)).to(dev)
    _, cep, _ = next(iter(al_f32._chunk_feats(audios8, T8_d, Tm8)))
    if cep.dtype != torch.float32:
        raise AssertionError("the f32 wire did not ship float32 cepstra")
    compare_feat("feat_f32[wire f32]", cep, T8_d, None, al_f32.do_cmn,
                 results)


def carry_launches(k0: int, nseq: int, what: str) -> int:
    """Launches of K4's carry form since the count read k0: one a rank
    of the ring, whatever the rows (the rank-major forward)."""
    k = align_torch.viterbi_chunk.launches - k0
    if k != nseq:
        raise AssertionError(f"{what}: {k} launches of K4's carry form on "
                             f"a ring of {nseq}")
    return k


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
        k0 = align_torch.viterbi_chunk.launches
        outs[nseq] = al.align_longform_batch(rows, [text] * LONG_B,
                                             ring=seq_ring(nseq, "cuda"))
        torch.cuda.synchronize()
        k = carry_launches(k0, nseq, f"align_longform_batch (ring of {nseq})")
        check_rows(outs[nseq], lg["longform"],
                   f"align_longform_batch (ring of {nseq})")
        log(f"  align_longform_batch B={LONG_B} ({min(secs):.1f}-"
            f"{max(secs):.1f} s of audio each), local ring of {nseq}: equal "
            f"to longform.json ({time.perf_counter() - t0:.3f} s), {k} "
            f"launches of K4's carry form")
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
    t0 = time.perf_counter()
    k0 = align_torch.viterbi_chunk.launches
    path, score = align_longform(
        seq_ring(N_SEQ, "cuda"), sen[:, :T], np.arange(P * E).reshape(P, E),
        al.am.tmat.astype(np.int32)[g.tmatid], pi, pp, pk, g.astart, g.aend,
        n.cpu().numpy(), np.where(g.is_entry, g.entry_pen,
                                  align_torch.WORST_SCORE), g.final_nodes)
    torch.cuda.synchronize()
    k = carry_launches(k0, N_SEQ, "align_longform (large grammar)")
    t1 = time.perf_counter()
    for b in range(N_UTT):
        p1, s1 = align_torch.viterbi_single(sen[b, :T].contiguous(),
                                            int(n[b]), v)
        if not (torch.equal(p1, path[b]) and int(s1) == int(score[b])):
            raise AssertionError(f"align_longform (large grammar) row {b} "
                                 "differs from viterbi_single")
    log(f"  align_longform on the large grammar (S={P * E}, int32 tokens), "
        f"B={N_UTT}, ring of {N_SEQ}: {k} launches of K4's carry form "
        f"({t1 - t0:.3f} s), equal to viterbi_single per row "
        f"({time.perf_counter() - t1:.3f} s, {N_UTT} launches)")

    # one row of about 5 minutes (informational)
    text5 = longform_text(LONG_K5)
    row5 = longform_audio(0, LONG_K5)
    t0 = time.perf_counter()
    k0 = align_torch.viterbi_chunk.launches
    lf = al.align_longform_batch([row5], [text5],
                                 ring=seq_ring(N_SEQ, "cuda"))
    torch.cuda.synchronize()
    carry_launches(k0, N_SEQ, "the 5-minute row's long form")
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


def phase_kernels_yin(results: dict):
    """K14 against yin_cmnd_plain and, under --before, the parent's
    kernel, on the int16 frames of austen.raw (FRAME_SHIFT apart) at
    frame sizes 400, 200, 1024 and 4096 with pitch_batch's ndiff and
    threshold: the CMND and best bit for bit, the period equal; each with
    the layout its launcher takes.  Bound: 3 float32 operations (a
    subtraction, a square, an add) per lag and sample of each frame."""
    thr = float(np.float32(0.1 * 32768.0))
    for F in (400, 200, 1024, 4096):
        fr = torch.from_numpy(austen_frames(F)).cuda()
        nd = F // 2
        name = "yin_cmnd" if F == 400 else f"yin_cmnd[{F}]"
        lay = yin_mod.yin_layout(fr.shape[0], nd)
        log(f"  {name}: N={fr.shape[0]} F={F} ndiff={nd}: R={lay['R']} lags "
            f"a thread, blocks of {lay['tpf']} threads, {lay['tiles']} "
            f"lag tile{'s' if lay['tiles'] > 1 else ''} a frame, "
            f"{lay['blocks']} blocks, {lay['launches']} "
            f"launch{'es' if lay['launches'] > 1 else ''} (no cluster)")
        got = compare(name, lambda: yin_mod.yin_cmnd(fr, nd, thr),
                      lambda: yin_mod.yin_cmnd_plain(fr, nd, thr), results,
                      ins=(fr,), ops=3.0 * fr.shape[0] * nd * nd,
                      before=before_yin(fr, nd, thr))
        results[name]["layout"] = lay
        want = yin_mod.yin_cmnd_plain(fr, nd, thr)
        for a, b in zip(got, want):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: not bit-equal to its plain "
                                     "version")


def _json(x):
    """x as the golden's JSON reads it (tuples as lists)."""
    return json.loads(json.dumps(x))


def phase_api(ag: dict):
    """The public API on the en-us-width model against api.json:
    pitch_batch and cmnd_batch on austen.raw's frames; the exact
    Decoder's scenario (alignment JSON at align levels 0-2, a grammar's
    hyp, segments and n-best, a live decode in 1,600-sample pieces); the
    CLI's fast path and --exact on two raw files; update_mllr with
    tools/make_mllr.py's transform, then a same-transcript batch and its
    scored form."""
    for F in API_FRAMES:
        fr = austen_frames(F)
        period, best = yin_mod.pitch_batch(fr)
        cmnd = yin_mod.cmnd_batch(fr)
        if not (period.is_cuda and cmnd.is_cuda):
            raise AssertionError("pitch_batch left the card")
        got = pitch_rep(cmnd.cpu().numpy(), period.cpu().numpy(),
                        best.cpu().numpy())
        if got != ag["pitch"][str(F)]:
            raise AssertionError(f"pitch_batch at frame size {F} differs "
                                 "from api.json")
    log(f"  pitch_batch/cmnd_batch at frame sizes {API_FRAMES}: equal")
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "en-us-synth")
        make_synth_model(d, seed=0, width="en-us")
        t0 = time.perf_counter()
        got = _json(decoder_results(Decoder, d))
        for part in ("align", "grammar", "live"):
            if got[part] != ag["decoder"][part]:
                raise AssertionError(f"Decoder {part} differs from api.json")
        log(f"  Decoder (align levels 0-2, grammar with n-best, live in "
            f"1,600-sample pieces): equal, {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        got = cli_results(cli.main, d, tmp)
        for mode in ("fast", "exact"):
            if got[mode] != ag["cli"][mode]:
                raise AssertionError(f"CLI {mode} differs from api.json")
        log(f"  CLI fast and --exact on 2 files: equal, "
            f"{time.perf_counter() - t0:.1f} s")
        got = _json(mllr_results(TorchAligner, d, mllr_file(tmp)))
        for part in ("same", "scored"):
            if got[part] != ag["mllr"][part]:
                raise AssertionError(f"update_mllr {part} batch differs from "
                                     "api.json")
        log("  update_mllr, then align_batch and align_batch_scored: equal")


# a wrapper's counters beside its launches: forms, the carry form's
# shapes, K6's layouts and tables, K2's tiles
COUNTERS = ("forms", "shapes", "layouts", "tables", "tiles")


# the K6 layouts each path's launches take: one block a row, but on the
# large path, where the REPEATS stack (P=7,680) takes a cluster of 4 and
# the large grammar (P=13,184, int32 tokens) one of 8; a row that falls
# to the global-memory layout where a cluster should hold it fails
K6_LAYOUTS = {"large": {"cluster 4", "cluster 8"}}


def k6_layouts(counts: dict) -> set:
    """The layouts of a path's K6 launches ("block", "cluster N",
    "global memory") from its counts."""
    out = set()
    for key, k in counts.items():
        if k and key.startswith("viterbi_rows["):
            layout = key[len("viterbi_rows["):-1]
            if layout in ("block", "global memory") or layout.startswith(
                    "cluster "):
                out.add(layout)
    return out


def count_path(wrappers: dict, drive) -> dict:
    """Launch counts of one path: every count set to 0 just before
    drive(), read just after it; ``name[form]`` for each form and, for
    the carry form, ``name[form, R=.., P=..]`` for each shape, K6's
    ``name[cluster 8]`` (layout) and ``name[band]`` (table), K2's
    ``name[64]`` (tile)."""
    for fn in wrappers.values():
        fn.launches = 0
        for counter in COUNTERS:
            if hasattr(fn, counter):
                getattr(fn, counter).clear()
    drive()
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, fn in wrappers.items():
        for counter in COUNTERS:
            for form, k in getattr(fn, counter, {}).items():
                counts[f"{name}[{form}]"] = k
    return counts


def form_paths(path) -> tuple:
    """A FORMS entry's paths: one name or a tuple of them."""
    return path if isinstance(path, tuple) else (path,)


def count_key(kernel: str, result: dict) -> str:
    """The count a KERNELS or VARIANTS entry's launches read: the
    kernel's, or its count at the entry's timed shape where its result
    records one (``shape``, the frames and states of ``fn.shapes``)."""
    shape = result.get("shape")
    return f"{kernel}[{shape}]" if shape else kernel


def kernel_entries(counts: dict, results: dict) -> list:
    """The kernels line's entries: each kernel's launches from the path
    that brought it in (its entry form's count where its other forms
    have entries), each VARIANTS entry's from its kernel's count on its
    path, each FORMS entry's from its form's count summed over its paths;
    of its timed launch's frames and states (KERNELS, VARIANTS) or rows
    and phones (FORMS) only where its result records them (``shape``)."""
    entries = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[PATH_OF[name]].get(
                        f"{name}[{ENTRY_FORM[name]}]" if name in ENTRY_FORM
                        else count_key(name, results[name]), 0),
                    **results[name])
               for name, _, src, rep in KERNELS]
    sources = {name: src for name, _, src, _ in KERNELS}
    for entry, kernel, rep, *path in VARIANTS:
        if entry not in results and entry in OPTIONAL:
            log(f"  {entry}: did not run on this card, left out")
            continue
        path = path[0] if path else PATH_OF[kernel]
        entries.append(dict(name=entry, route="cuda", source=sources[kernel],
                            replaces=rep,
                            launches=counts.get(path, {}).get(
                                count_key(kernel, results[entry]), 0),
                            **results[entry]))
    for entry, kernel, form, path, rep in FORMS:
        shape = results[entry].get("shape")
        key = f"{kernel}[{form}" + (f", {shape}]" if shape else "]")
        entries.append(dict(name=entry, route="cuda", source=sources[kernel],
                            replaces=rep,
                            launches=sum(counts[p].get(key, 0)
                                         for p in form_paths(path)),
                            **results[entry]))
    return entries


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
    # 2. build (and, with --before DIR, the parent's K1 and K14)
    t0 = time.perf_counter()
    if "--before" in sys.argv[1:]:
        with ThreadPoolExecutor(1) as ex:
            parent = ex.submit(build_before,
                               sys.argv[sys.argv.index("--before") + 1])
            cuda_build.lib()
            parent.result()
    else:
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
    ag = load_api_golden()
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
    phase_kernels_yin(results)
    profile_check(results)
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
    t0 = time.perf_counter()
    longform = count_path(wrappers, lambda: phase_longform(al, lg, smi))
    log(f"  long-form phase wall: {time.perf_counter() - t0:.3f} s")
    # 12. the repaired configurations, each counted
    log("repaired configurations (8-bit ptm):")
    repairs = {what: count_path(wrappers, lambda what=what: phase_repairs(
        al, al_f32, al_dc, lg, what))
        for what in ("mxu", "wire_f32", "remove_dc")}
    # 13. the public API (YIN, the exact Decoder, the CLI, MLLR), counted
    log("public API paths (en-us width, 8-bit ptm):")
    api = count_path(wrappers, lambda: phase_api(ag))
    counts = {"host-FE": host, "device-FE": device, "backends": backends,
              "decode": decode, "5-state": five, "large": large,
              "longform": longform, **repairs, "api": api}
    for path, names in (("host-FE", HOST_PATH), ("device-FE", DEVICE_FE_PATH),
                        ("backends", BACKEND_PATH), ("decode", SLICE_PATH),
                        ("5-state", SLICE_PATH), ("large", SLICE_PATH),
                        ("longform", LONGFORM_PATH), ("mxu", MXU_PATH),
                        ("wire_f32", WIRE_F32_PATH),
                        ("remove_dc", REMOVE_DC_PATH), ("api", API_PATH)):
        names = list(dict.fromkeys(names + [f"{k}[{f}]"
                                            for _, k, f, ph, _ in FORMS
                                            if path in form_paths(ph)]))
        log(f"  {path} launches: " + ", ".join(
            f"{n} {counts[path].get(n, 0)}" for n in names
            + sorted(k for k in counts[path]
                     if ", R=" in k or "[N=" in k or "[B=" in k)))
        log(f"  {path} K6 layouts and tables, K2 tiles: " + (", ".join(
            f"{k} {v}" for k, v in sorted(counts[path].items())
            if k.startswith(("viterbi_rows[", "dist_topn_norm["))
            and not k.split("[", 1)[1].startswith(("3-state", "5-state",
                                                   "fold", "mxu")))
            or "none"))
        missing = [n for n in names if counts[path].get(n, 0) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"paths: {missing}")
        got = k6_layouts(counts[path])
        want = K6_LAYOUTS.get(path, {"block"}) if got else set()
        if got != want:
            raise AssertionError(f"K6 on the {path} paths took the layouts "
                                 f"{sorted(got)}, not {sorted(want)}")
    entries = kernel_entries(counts, results)
    log("rule-2 order (slower than the one PyTorch call, by ms / library "
        "ms; then launches x (ms - bound) ms): " + ", ".join(
            f"{n} {how} {v:.4f}" for n, how, v in rank_kernels(entries)))
    log(json.dumps({"kernels": entries}))
    bad = over_bound(entries)
    if bad:
        raise AssertionError(f"entries above {BOUND_LIMIT:.0%} of their bound "
                             f"(miscounted bytes or operations): {bad}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
