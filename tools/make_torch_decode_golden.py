"""Golden results of the JAX aligner's grammar decode, 5-state and
large-graph paths on the synthetic en-us-width models.

Writes ``tests/golden/torch-synth/decode.json`` and ``decode.npz``:
what ``soundswallower_tpu.aligner.TpuAligner`` (JAX, CPU) gives on
``make_synth_model(width="en-us", seed=0)`` and its ``ptm5st`` variant:

* ``decode`` (8-bit ptm, host FE; ``GRAMMAR``, the decode grammar,
  through ``set_grammar(jsgf_string=...)``): ``decode_batch`` and
  ``decode_batch_scored`` on ``decode_audio(i)`` for i < 9 (the 8
  austen rows and ``TRUNCATED``, a row too short to reach a final node),
  ``decode`` of ``austen_audio(0)`` on the host FE and, on a fresh
  ``SST_FE=device`` aligner, on the device FE; ``decode_search``'s hyp
  and segments, the ``lattice``'s node and link counts and the first
  ``N_BEST`` of ``nbest`` on ``austen_audio(0)``; in the .npz the decode
  graph's arrays (``graph/<field>``);
* ``5st`` (ptm5st, host FE): ``align_batch`` on the 8 austen rows of
  one transcript, then, on a fresh aligner, the 32 mixed transcripts of
  tools/make_torch_mixed_golden.py on their working-set union, and
  ``align_batch_scored`` on them; ``align`` of ``austen_audio(0)`` on
  the device FE (a fresh ``SST_FE=device`` aligner);
* ``large`` (8-bit ptm): ``decode_batch`` and ``decode_batch_scored``
  on the 8 austen rows against ``large_grammar()``, whose decode graph
  has S >= 32767 states (int32 token stacks) and more phones than a
  block's shared memory holds, and ``decode`` of ``austen_audio(0)`` on
  the device FE; in the .npz that graph's arrays (``large/<field>``);
* ``scores_same`` (8-bit ptm, host FE): ``align_batch`` on the 8 austen
  rows of one transcript with ``want_scores`` on (the same-transcript
  route's token and path scores), word and phone scores included.

The JAX graph scorer evaluates every graph state through a one-hot
[Cu*D, S] matrix, which at the large graph's S is a 1 GB table and
terabytes of CPU float work, so the large rows score each distinct
senone once and gather its column to the states (``distinct_senones``):
the same int32 scores (the codebooks used, hence the per-frame norm, are
the same, and a column depends on its senone alone).  The tool checks
that the gathered route equals the direct one on the decode grammar.

The PyTorch port is held to them on the CPU
(tests/test_torch_decode_golden.py) and on the GPU (chip_smoke.py).  The
helpers import neither JAX nor the JAX package.
Usage: ``JAX_PLATFORMS=cpu python tools/make_torch_decode_golden.py``
(about 6 minutes on one CPU core).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile

import numpy as np

from make_synth_model import WORDS
from make_torch_mixed_golden import (N_MIXED, mixed_audio, mixed_texts,
                                     scored_rep)
from make_torch_synth_golden import (N_UTT, REPO, SAMPRATE, TEXT,
                                     austen_audio, segs_rep)

GOLDEN = os.path.join(REPO, "tests", "golden", "torch-synth", "decode")
# the decode grammar: alternatives at several positions, an optional, a
# Kleene loop; was(2) and an(2) join through fsgusealtpron and the filler
# self-loops through fsgusefiller (both on by default)
GRAMMAR = """#JSGF V1.0;
grammar slice;
public <s> = (he | young man) was [not] (an | not an) (ill | young)*
    disposed (young man | man);
"""
TRUNCATED = 1200        # samples of austen_audio(0) in the failing row
N_DECODE = N_UTT + 1    # the 8 austen rows and the truncated one
N_BEST = 5
# the large grammar: the sentence, and N_ALT distinct sequences of ALT_LEN
# base words drawn with numpy.random.RandomState(LARGE_SEED)
N_ALT, ALT_LEN, LARGE_SEED = 28, 50, 5
GRAPH_FIELDS = ("ssid", "tmatid", "senid", "edge_src", "edge_dst",
                "edge_pen", "entry_pen", "is_entry", "astart", "aend",
                "word_of", "variant_of", "pos_of", "cipid", "final_nodes")


def decode_audio(i: int) -> np.ndarray:
    """Row i of the decode sets: austen_audio(i) for i < 8, then the
    truncated row."""
    return austen_audio(i) if i < N_UTT else austen_audio(0)[:TRUNCATED]


def large_grammar(n_alt: int = N_ALT) -> str:
    """A JSGF grammar whose decode graph passes 10,923 phones on the
    en-us-width model: the sentence (so that the austen audio reaches a
    final node) beside n_alt distinct ALT_LEN-word sequences."""
    base = [w for w, _ in WORDS if "(" not in w]
    rng = np.random.RandomState(LARGE_SEED)
    alts = {TEXT}
    while len(alts) < n_alt + 1:
        alts.add(" ".join(rng.choice(base, ALT_LEN)))
    body = " | ".join(sorted(alts))
    return f"#JSGF V1.0;\ngrammar large;\npublic <s> = {body};\n"


def decode_rep(res):
    """A decode result (hyp, segs) -> [hyp, [[word, wid, start, dur,
    score, [[ci, start, dur, score]]]]] (None for a failed row)."""
    if res is None:
        return None
    hyp, segs = res
    return [hyp, [[s.word, int(s.wid), int(s.start), int(s.duration),
                   int(s.score),
                   [[p[0], int(p[1]), int(p[2]), int(p[3])]
                    for p in s.phones]] for s in segs]]


def search_rep(search, dag, nbest) -> dict:
    """decode_search's hyp and segments, the lattice's node and link
    counts and the n-best list."""
    hyp, score = search.hyp()
    segs = [[s["word"], int(s["sf"]), int(s["ef"]), int(s["ascr"]),
             int(s["lscr"])] for s in search.seg_iter()]
    nodes = -1 if dag is None else len(dag.nodes)
    links = -1 if dag is None else sum(len(n.exits) for n in dag.nodes)
    return dict(hyp=hyp, score=int(score), segs=segs, lattice_nodes=nodes,
                lattice_links=links, nbest=[[h, int(s)] for h, s in nbest])


def graph_arrays(g, prefix: str) -> dict:
    return {f"{prefix}/{f}": np.asarray(getattr(g, f)) for f in GRAPH_FIELDS}


def load_decode_golden() -> dict:
    with open(GOLDEN + ".json") as fh:
        out = json.load(fh)
    with np.load(GOLDEN + ".npz") as z:
        out.update({k: z[k] for k in z.files})
    return out


@contextlib.contextmanager
def distinct_senones():
    """TpuAligner's graph scorer built on each graph's distinct senones,
    its columns gathered to the graph's states (see the module
    docstring)."""
    import soundswallower_tpu.aligner as ja
    from soundswallower_tpu.ops import senscore_jax as sj

    class Gathered:
        def __init__(self, gs, inv):
            self.gs, self.inv = gs, inv

    class Builder:
        @staticmethod
        def build(am, tables, senid_flat):
            uniq, inv = np.unique(np.asarray(senid_flat).reshape(-1),
                                  return_inverse=True)
            return Gathered(sj.GraphScorer.build(am, tables, uniq),
                            inv.reshape(-1))

    def score(gs, feats, dist_mode="fold"):
        return sj.score_frames_graph(gs.gs, feats, dist_mode)[:, gs.inv]

    saved = ja.GraphScorer, ja.score_frames_graph
    ja.GraphScorer, ja.score_frames_graph = Builder, score
    try:
        yield
    finally:
        ja.GraphScorer, ja.score_frames_graph = saved


@contextlib.contextmanager
def device_fe():
    prev = os.environ.get("SST_FE")
    os.environ["SST_FE"] = "device"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["SST_FE"]
        else:
            os.environ["SST_FE"] = prev


def main() -> None:
    sys.path.insert(0, REPO)
    from make_synth_model import make_synth_model

    from soundswallower_tpu.aligner import TpuAligner

    rows = [decode_audio(i) for i in range(N_DECODE)]
    a0 = austen_audio(0)
    out: dict = {"model": {"width": "en-us", "seed": 0},
                 "samprate": SAMPRATE, "grammar": GRAMMAR,
                 "truncated": TRUNCATED}
    arrays: dict = {}
    with tempfile.TemporaryDirectory() as d:
        ptm = os.path.join(d, "ptm")
        make_synth_model(ptm, seed=0, width="en-us")
        al = TpuAligner(hmm=ptm, samprate=SAMPRATE)
        g = al.set_grammar(jsgf_string=GRAMMAR)
        arrays.update(graph_arrays(g, "graph"))
        batch = al.decode_batch(rows)
        with distinct_senones():
            al2 = TpuAligner(hmm=ptm, samprate=SAMPRATE)
            al2.set_grammar(jsgf_string=GRAMMAR)
            if [decode_rep(r) for r in al2.decode_batch(rows)] != \
                    [decode_rep(r) for r in batch]:
                raise AssertionError("the distinct-senone scorer differs")
        search = al.decode_search(a0)
        dag = al.lattice(a0)
        nbest = [x for _, x in zip(range(N_BEST), al.nbest(a0))]
        dec = dict(P=int(len(g.senid)), K=int(np.bincount(g.edge_dst).max()),
                   batch=[decode_rep(r) for r in batch],
                   scored=[decode_rep(r) for r in
                           al.decode_batch_scored(rows)],
                   decode=decode_rep(al.decode(a0)),
                   search=search_rep(search, dag, nbest))
        with device_fe():
            ald = TpuAligner(hmm=ptm, samprate=SAMPRATE)
            ald.set_grammar(jsgf_string=GRAMMAR)
            dec["decode_device"] = decode_rep(ald.decode(a0))
        out["decode"] = dec
        al = TpuAligner(hmm=ptm, samprate=SAMPRATE)
        al.want_scores = True
        out["scores_same"] = [scored_rep(s) for s in al.align_batch(
            [austen_audio(i) for i in range(N_UTT)], [TEXT] * N_UTT)]

        with distinct_senones():
            al = TpuAligner(hmm=ptm, samprate=SAMPRATE)
            lg = al.set_grammar(jsgf_string=large_grammar())
            P = len(lg.senid)
            if 3 * P < 32767:
                raise AssertionError(f"the large grammar has {P} phones")
            arrays.update(graph_arrays(lg, "large"))
            eight = [austen_audio(i) for i in range(N_UTT)]
            out["large"] = dict(
                P=int(P), S=int(3 * P), K=int(np.bincount(lg.edge_dst).max()),
                batch=[decode_rep(r) for r in al.decode_batch(eight)],
                scored=[decode_rep(r) for r in al.decode_batch_scored(eight)])
            with device_fe():
                ald = TpuAligner(hmm=ptm, samprate=SAMPRATE)
                ald.set_grammar(jsgf_string=large_grammar())
                out["large"]["decode_device"] = decode_rep(ald.decode(a0))

        m5 = os.path.join(d, "ptm5st")
        make_synth_model(m5, 0, "en-us", "ptm5st", 8)
        al = TpuAligner(hmm=m5, samprate=SAMPRATE)
        st = dict(same=[segs_rep(s) for s in al.align_batch(
            [austen_audio(i) for i in range(N_UTT)], [TEXT] * N_UTT)])
        al = TpuAligner(hmm=m5, samprate=SAMPRATE)
        texts = mixed_texts()
        mixed = [mixed_audio(i) for i in range(N_MIXED)]
        st["union"] = [segs_rep(s) for s in al.align_batch(mixed, texts)]
        st["scored"] = [scored_rep(s)
                        for s in al.align_batch_scored(mixed, texts)]
        with device_fe():
            ald = TpuAligner(hmm=m5, samprate=SAMPRATE)
            st["align_device"] = segs_rep(ald.align(a0, TEXT))
        out["5st"] = st
    with open(GOLDEN + ".json", "w") as fh:
        json.dump(out, fh, separators=(",", ":"))
        fh.write("\n")
    np.savez_compressed(GOLDEN + ".npz", **arrays)


if __name__ == "__main__":
    main()
