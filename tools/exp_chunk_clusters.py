"""K4's carry form (``viterbi_chunk_rows``) on one row at the long
form's chapter sizes, at each layout it can take, on one CUDA device.

A chapter is one row of a ring of 1: one launch over all its frames
(R = 1, C = T).  The graph here is a chain of P phones of 3 states, each
entered from the phone before it and a seventh of them also from the
one before that (an optional silence), windows open, seeded transition
costs and penalties; the scores are seeded random values.  For each P
the launcher's layout and every other one that can run (one block: the
state in shared memory where it fits, else in global memory; clusters
of 2, 4, 8 and 16 blocks) take the same inputs; every layout's tokens
and carries are checked bit-equal to the first's, and each is timed on
chip_smoke.py's clock (the median device time of ``runs`` launches, each
after an L2 flush, behind a head start).  Prints one JSON object a P:
the layout the launcher chose and each layout's ms and us a frame.

Usage: ``python tools/exp_chunk_clusters.py [--rows R] [FRAMES [P ...]]``
(default one row of 2,000 frames at 3,731, 7,000, 9,500 and 12,586
phones: the chapters cell's smallest and largest graph and two between;
R rows a launch as a ring rank of the long form takes them).
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from soundswallower_tpu_torch.ops import align_torch as at  # noqa: E402

CHAPTER_P = (3731, 7000, 9500, 12586)


def chain_graph(P: int, E: int, rng) -> dict:
    """A chain of P phones under the keys of ``graph_consts_from_numpy``:
    phone p entered from p - 1 and, for a seventh of them, p - 2."""
    dst = np.arange(1, P)
    src = dst - 1
    skip = np.arange(2, P)[rng.random_sample(P - 2) < 1 / 7]
    src = np.concatenate([src, skip - 2])
    dst = np.concatenate([dst, skip])
    pen = -rng.randint(0, 4000, len(dst))
    order = np.lexsort((src, dst))
    pi, pp, pk = at.build_pred_table(src[order], dst[order], pen[order], P)
    entry = np.full(P, at.WORST_SCORE, np.int32)
    entry[0] = 0
    return dict(tp=rng.randint(0, 300, (P, E, E + 1)).astype(np.int32),
                pi=pi, pp=pp, pk=pk, ast=np.zeros(P, np.int32),
                aen=np.full(P, 1 << 30, np.int32), entry=entry,
                fin=np.array([P - 2, P - 1], np.int32))


def layouts(P: int, E: int) -> dict:
    """Each layout that can run at P: {asked cluster: blocks a row}."""
    out = {}
    for cluster in (0, 1, 2, 4, 8, 16):
        try:
            out[cluster] = at.chunk_layout(P, E, E * P, cluster)
        except ValueError:
            pass
    return out


def main(argv: list) -> int:
    R = 1
    if argv[:1] == ["--rows"]:
        R, argv = int(argv[1]), argv[2:]
    frames = int(argv[0]) if argv else 2000
    sizes = [int(x) for x in argv[1:]] or list(CHAPTER_P)
    dev = torch.device("cuda")
    for P in sizes:
        E = 3
        rng = np.random.RandomState(P)
        c = at.graph_consts_from_numpy(chain_graph(P, E, rng), dev)
        sen = torch.from_numpy(rng.randint(0, 4000, (R, frames, E * P))
                               .astype(np.int32)).to(dev)
        carry = tuple(x.expand(R, *x.shape).contiguous()
                      for x in at.vit_carry0(c, n_emit=3))
        n = frames - 7                                # a padded tail
        lay = layouts(P, E)
        first = None
        row = {"P": P, "R": R, "frames": frames,
               "chosen": at.layout_name(lay[0]), "ms": {}}
        for cluster, blocks in lay.items():
            if cluster == 0:
                continue

            def run(cluster=cluster):
                return at.viterbi_chunk_rows(sen, carry, 0, n, c,
                                             cluster=cluster)
            out = run()
            if first is None:
                first = out
            elif cs.max_abs_err(out, first) != 0.0:
                raise AssertionError(
                    f"P={P}: {at.layout_name(blocks)} differs")
            ms = cs.time_ms(run, 3, f"P={P} {at.layout_name(blocks)}")
            row["ms"][at.layout_name(blocks)] = ms
            print(f"P={P} R={R} {at.layout_name(blocks)}: {ms:.3f} ms, "
                  f"{1e3 * ms / frames:.2f} us a frame", file=sys.stderr,
                  flush=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
