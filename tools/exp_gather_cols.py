"""K5 (``gather_cols``) against the forms of tools/exp_gather_cols.cu
and, with ``--before DIR``, DIR's kernel, at the two shapes the paths
launch it on, on one CUDA device.

With the synthetic en-us-width model (tools/make_synth_model.py, seed
0, 8-bit ptm): ``union``, the first 128-row chunk of the mixed B=256
batch (the 32 mixed transcripts tiled; the union's int32 scores
[128, 320, 512], seeded random values) and ``int16``, the dense route's
B=32 batch (int16 [32, 320, 5,126]); the columns are the stacked
graphs' own (``TorchAligner._stacked_graphs``).  Every form is checked
bit-equal to ``gather_cols_plain`` and timed on chip_smoke.py's clock
(the median device time a launch of 10, each after an L2 flush, behind
a head start); the shipped kernel and DIR's in turns (shipped, DIR, DIR,
shipped).  Prints one JSON object: per shape the bound, the sector
floor and each form's time in ms.

Forms (``kind, par, tile``): ``quad U`` (a plan in shared memory, 4
adjacent outputs a lane, int4 stores, U quads in flight) at tiles of 4
to 64 frames; ``staged`` (the same gathering from the tile's frames in
shared memory, where the frames allow it); ``flat U`` (an output a lane);
``column F`` (the shipped mapping at F frames a block).

Usage: ``python tools/exp_gather_cols.py [--before DIR]``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from make_synth_model import make_synth_model  # noqa: E402
from make_torch_mixed_golden import N_MIXED, load_mixed_golden  # noqa: E402
from make_torch_synth_golden import SAMPRATE  # noqa: E402
from soundswallower_tpu_torch.aligner import TorchAligner  # noqa: E402
from soundswallower_tpu_torch.ops import senscore_torch as st  # noqa: E402
from soundswallower_tpu_torch.utils import cuda_build  # noqa: E402

# (name, kind, par, tiles): the forms of exp_gather_cols.cu
FORMS = [("quad 1", 1, 1, (4, 8, 16)), ("quad 2", 1, 2, (4, 8, 16)),
         ("quad 4", 1, 4, (4, 8, 16, 32, 64)), ("staged", 4, 4, (16, 32)),
         ("flat 4", 2, 4, (4, 8, 16)), ("flat 8", 2, 8, (8, 16, 32)),
         ("flat 16", 2, 16, (16, 32)), ("column 4", 3, 4, (0,)),
         ("column 16", 3, 16, (0,))]


def build() -> ctypes.CDLL:
    """exp_gather_cols.cu into a library of its own under the build
    directory (nvcc, the kernels' flags)."""
    out = os.path.join(cuda_build.BUILD_DIR, "exp")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libexp_gather.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    "-shared", "-o", so,
                    os.path.join(REPO, "tools", "exp_gather_cols.cu")],
                   check=True, timeout=600)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_gather.argtypes = [I, I, P, I, P, P, I, I, I, I, I, P]
    lib.exp_gather.restype = I
    return lib


def inputs(al: TorchAligner, texts: list) -> dict:
    """The two shapes' sources (seeded values) and the paths' columns."""
    rng = np.random.RandomState(0)
    graphs = [al.graph_for_text(texts[i % N_MIXED]) for i in range(256)]
    uni = al._union_scorer(graphs)
    cols = al._stacked_graphs(graphs, remap=uni["pos"],
                              remap_ver=uni["ver"]).sencols[:128]
    src = torch.from_numpy(rng.randint(-2 ** 30, 2 ** 30,
                                       (128, 320, uni["Spad"]),
                                       dtype=np.int32)).cuda()
    al._uni = None
    al._stack_cache.clear()
    dcols = al._stacked_graphs([al.graph_for_text(t) for t in texts]).sencols
    dsrc = torch.from_numpy(rng.randint(-32768, 32768, (32, 320, al.am.n_sen),
                                        dtype=np.int16)).cuda()
    return {"union": (src, cols), "int16": (dsrc, dcols)}


def sweep(lib, src, cols) -> dict:
    """Every form on (src, cols), bit-equal, then timed; the shipped
    kernel in turns with the parent's (--before)."""
    want = st.gather_cols_plain(src, cols)
    B, T, Sx = src.shape
    S = cols.shape[1]
    res = dict(bound_ms=cs.bound(cs.gather_bytes(src, cols)
                                 + cs.nbytes(want), 0.0, 1.0)["bound_ms"],
               sector_floor_ms=cs.bound(cs.sector_bytes(src, cols)
                                        + cs.nbytes(cols, want), 0.0,
                                        1.0)["bound_ms"], forms={})
    for name, kind, par, tiles in FORMS:
        for tile in tiles:
            out = torch.empty_like(want)

            def fn(out=out, kind=kind, par=par, tile=tile):
                cuda_build.check(lib.exp_gather(
                    kind, par, src.data_ptr(), src.element_size(),
                    cols.data_ptr(), out.data_ptr(), B, T, Sx, S, tile,
                    cuda_build.stream(src)), name)
                return out
            try:
                fn()
            except RuntimeError:
                continue        # a form these frames cannot take
            if not torch.equal(out, want):
                raise AssertionError(f"{name}, tile {tile} differs")
            res["forms"][name + (f", tile {tile}" if tile else "")] = \
                cs.time_ms(fn)

    def shipped():
        return st.gather_cols(src, cols)
    if not torch.equal(shipped(), want):
        raise AssertionError("the shipped kernel differs")
    turns = [cs.time_ms(shipped)]
    before = cs.before_gather(src, cols)
    if before is not None:
        if not torch.equal(before(), want):
            raise AssertionError("the parent's kernel differs")
        turns += [cs.time_ms(before), cs.time_ms(before),
                  cs.time_ms(shipped)]
        res["ms_before"] = (turns[1] + turns[2]) / 2
    res.update(turns_ms=turns, ms=(turns[0] + turns[-1]) / 2)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("exp_gather_cols: no CUDA device")
    cuda_build.lib()
    if "--before" in sys.argv[1:]:
        cs.build_before(sys.argv[sys.argv.index("--before") + 1])
    lib = build()
    with tempfile.TemporaryDirectory() as d:
        make_synth_model(d, seed=0, width="en-us")
        al = TorchAligner(hmm=d, samprate=SAMPRATE, device="cuda")
    res = {name: sweep(lib, *x)
           for name, x in inputs(al, load_mixed_golden()["texts"]).items()}
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
