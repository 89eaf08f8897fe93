"""Helpers shared by the port's parity tests (tests/test_torch_*.py):
the synthetic models and the golden audio of tools/."""

import os
import sys

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

from make_synth_model import VARIANTS, make_synth_model  # noqa: E402
from make_torch_synth_golden import (SAMPRATE, TEXT, austen_audio,  # noqa: E402,F401
                                     load_golden, segs_rep)


def model_dir(tmp_path_factory, width: str = "small") -> str:
    return make_synth_model(str(tmp_path_factory.mktemp(f"synth-{width}")),
                            seed=0, width=width)


def variant_dir(tmp_path_factory, variant: str, width: str = "small") -> str:
    """A synthetic model of one VARIANTS entry (ptm4b, semi, ms, ...)."""
    backend, bits = VARIANTS[variant]
    d = tmp_path_factory.mktemp(f"synth-{width}-{variant}")
    return make_synth_model(str(d), 0, width, backend, bits)


def random_graph(P: int, E: int, rng, K: int = 3, T: int = 64,
                 cyclic: bool = True) -> dict:
    """A random phone graph's Viterbi tables under the keys of the JAX
    aligner's ``_graph_consts`` (tp, pi, pp, pk, ast, aen, entry, fin)
    and a seeded numpy draw: up to K predecessors per node (any node
    when ``cyclic``, else an earlier one), penalties to -4000, transition
    costs 0..299 (from 255 a 3-state skip counts as absent), entries at
    a fifth of the nodes, start frames 0..4, a tenth of the nodes leaving
    at frame T // 2, and three final nodes."""
    import numpy as np

    from soundswallower_tpu_torch.ops.align_torch import (WORST_SCORE,
                                                          build_pred_table)

    dst = np.repeat(np.arange(P), rng.randint(0, K + 1, P))
    if cyclic:
        src = rng.randint(0, P, len(dst))
    else:
        src = (rng.random_sample(len(dst)) * dst).astype(np.int64)
    pen = -rng.randint(0, 4000, len(dst))
    order = np.lexsort((src, dst))
    pi, pp, pk = build_pred_table(src[order], dst[order], pen[order], P)
    entry = np.where(rng.random_sample(P) < 0.2, -rng.randint(0, 100, P),
                     WORST_SCORE).astype(np.int32)
    entry[0] = 0
    aen = np.full(P, 1 << 30, np.int32)
    aen[rng.random_sample(P) < 0.1] = T // 2
    return dict(tp=rng.randint(0, 300, (P, E, E + 1)).astype(np.int32),
                pi=pi, pp=pp, pk=pk,
                ast=rng.randint(0, 5, P).astype(np.int32), aen=aen,
                entry=entry,
                fin=np.sort(rng.choice(P, 3, replace=False)).astype(np.int32))


def stack_random(graphs: list, band_w: int = 0) -> dict:
    """Random graphs (``random_graph``) stacked per row under the keys of
    ``stack_graphs``; with ``band_w`` > 0 also a band of that width from
    each row's edges of offset 1..band_w (the others dropped)."""
    import numpy as np

    B, (P, K) = len(graphs), graphs[0]["pi"].shape
    st = dict(tp=np.stack([g["tp"] for g in graphs]),
              pred_idx=np.stack([g["pi"] for g in graphs]),
              pred_pen=np.stack([g["pp"] for g in graphs]),
              pred_ok=np.stack([g["pk"] for g in graphs]),
              astart=np.stack([g["ast"] for g in graphs]),
              aend=np.stack([g["aen"] for g in graphs]),
              entry=np.stack([g["entry"] for g in graphs]),
              final_mask=np.zeros((B, P), bool))
    for b, g in enumerate(graphs):
        st["final_mask"][b, g["fin"]] = True
    if band_w:
        st["band_pen"] = np.full((B, band_w, P), -(1 << 30), np.int32)
        st["band_ok"] = np.zeros((B, band_w, P), bool)
        for b in range(B):
            dst = np.nonzero(st["pred_ok"][b])[0]
            src = st["pred_idx"][b][st["pred_ok"][b]]
            pen = st["pred_pen"][b][st["pred_ok"][b]]
            off = dst - src
            keep = (off >= 1) & (off <= band_w)
            slot = band_w - off[keep]
            np.maximum.at(st["band_pen"][b], (slot, dst[keep]), pen[keep])
            st["band_ok"][b][slot, dst[keep]] = True
    return st
