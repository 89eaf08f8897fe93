"""FSG -> static decode graph for grammar decoding.

A copy of the JAX package's ``ops/decode_graph.py``, so that both
packages build the same decode graphs.  The reference decodes grammars
with a dynamic beam search over a lazily activated lextree
(fsg_search.c / fsg_lextree.c): active lists, adaptive beams, and a
deduplicated history table.  Here the WHOLE search space compiles to a
static phone graph at grammar-load time, and dense global Viterbi runs
over it with the kernels the aligner uses (ops/align_torch.py):

* every FSG transition (state s --word--> state t, fsg_model.h:71-76)
  becomes a triphone chain, expanded over the left-context set of s and
  the right-context set of t (the lextree's lc/rc sets incl. null-
  transition propagation, fsg_lextree.c:86-204), deduplicated by ssid
  exactly like the prefix tree's per-(first-phone, rc) root sharing;
* cross-word edges connect a transition's word-final node (picked by
  the successor's first phone via the compressed rssid map) to the
  successor's word-initial node (picked by the predecessor's last
  phone), carrying logs2prob >> SENSCR_SHIFT + wip + pip: the same
  penalty the beam search pays (fsg_search.c:314,333,423);
* null transitions are pre-closed into direct edges (the closure lives
  on fsg_model, fsg_model.c:151-220), so the graph has no epsilons;
* silence/filler self-loops and alternate pronunciations are ordinary
  transitions (fsg_model add_silence/add_alt).

No beams: dense Viterbi evaluates every state every frame and therefore
finds the global optimum.  Decode graphs are cyclic: ``aend`` is 1<<30
everywhere and ``astart`` comes from a breadth-first search from the
entries (1<<30 where no entry reaches a node).
"""

from __future__ import annotations

import numpy as np

from ..logmath import SENSCR_SHIFT
from .align_graph import AlignGraph

START = -2


def build_fsg_graph(fsg, d, d2p, am, lmath, config) -> AlignGraph:
    mdef = am.mdef
    sil = mdef.silphone
    lw = config.get_float("lw")
    wip = int(lmath.log(config.get_float("wip")) * lw) >> SENSCR_SHIFT
    pip = int(lmath.log(config.get_float("pip")) * lw) >> SENSCR_SHIFT

    # -- transitions + null closure ----------------------------------------
    trans = []  # (s, t, dictwid, pen) pen = logs2prob>>SHIFT + wip + pip
    for s in range(fsg.n_state):
        for t, links in fsg.trans[s].items():
            for l in links:
                wid = d.wordid(fsg.word_str(l.wid))
                if wid < 0:
                    raise KeyError(f"FSG word {fsg.word_str(l.wid)} "
                                   "missing from dictionary")
                trans.append((s, t, wid,
                              (l.logs2prob >> SENSCR_SHIFT) + wip + pip))
    nulls = {}  # (a, b) -> pen
    for a in range(fsg.n_state):
        for b, l in fsg.null_trans[a].items():
            if a != b:
                nulls[(a, b)] = l.logs2prob >> SENSCR_SHIFT

    # -- per-state context sets (fsg_lextree_lc_rc) -------------------------
    n_state = fsg.n_state
    in_ctx = [set() for _ in range(n_state)]   # last ciphones entering
    out_ctx = [set() for _ in range(n_state)]  # first ciphones leaving
    in_ctx[fsg.start_state].add(sil)
    out_ctx[fsg.final_state].add(sil)
    for (s, t, wid, _) in trans:
        in_ctx[t].add(int(d.prons[wid][-1]))
        out_ctx[s].add(int(d.first_phone(wid)))
    # propagate through (closed) null transitions: a word ending at a
    # also "enters" b when null a->b; a word leaving b also "leaves" a
    changed = True
    while changed:
        changed = False
        for (a, b) in nulls:
            if not in_ctx[a] <= in_ctx[b]:
                in_ctx[b] |= in_ctx[a]
                changed = True
            if not out_ctx[b] <= out_ctx[a]:
                out_ctx[a] |= out_ctx[b]
                changed = True

    # -- per-transition chains ----------------------------------------------
    nodes: list[dict] = []
    edges: list[tuple[int, int, int]] = []

    def add_node(ssid, ci, ti, wid, pos):
        nodes.append(dict(ssid=int(ssid), ci=int(ci), word=ti, var=wid,
                          pos=pos))
        return len(nodes) - 1

    recs = []  # per transition: dict(entry: lc->node, exit: rc->node, ...)
    for ti, (s, t, wid, pen) in enumerate(trans):
        pron = d.prons[wid]
        k = len(pron)
        lcs = sorted(in_ctx[s]) or [sil]
        rcs = sorted(out_ctx[t]) or [sil]
        entry: dict[int, int] = {}
        exit_: dict[int, int] = {}
        if k == 1:
            if d.filler_word(wid):
                # fillers are context-independent CI phones entered from
                # any context (fsg_lextree.c filler branch; lextree.py)
                ni = add_node(mdef.pid2ssid(pron[0]), pron[0], ti, wid, 0)
                for lc in lcs:
                    entry[lc] = ni
            else:
                # single-phone word: lrdiph_rc with SIL right context —
                # the reference's approximation (fsg_lextree.c:392-439);
                # using the true rc here would change variant choices
                # away from the C decoder's
                by_ssid: dict[int, int] = {}
                for lc in lcs:
                    ssid = int(d2p.lrdiph_rc[pron[0], lc, sil])
                    ni = by_ssid.get(ssid)
                    if ni is None:
                        ni = by_ssid.setdefault(
                            ssid, add_node(ssid, pron[0], ti, wid, 0))
                    entry[lc] = ni
            recs.append(dict(s=s, t=t, wid=wid, pen=pen, k=1,
                             entry=entry, exit=None,
                             last_ci=int(pron[-1]),
                             first_ci=int(pron[0])))
            continue
        by_ssid1: dict[int, int] = {}
        for lc in lcs:
            ssid = int(d2p.ldiph_lc[pron[0], pron[1], lc])
            ni = by_ssid1.get(ssid)
            if ni is None:
                ni = by_ssid1.setdefault(
                    ssid, add_node(ssid, pron[0], ti, wid, 0))
            entry[lc] = ni
        prev = sorted(set(by_ssid1.values()))
        for pos in range(1, k - 1):
            ni = add_node(d2p.internal(wid, pos), pron[pos], ti, wid, pos)
            for p in prev:
                edges.append((p, ni, pip))
            prev = [ni]
        rssid = d2p.get_rssid(pron[-1], pron[-2])
        by_j: dict[int, int] = {}
        for rc in rcs:
            j = int(rssid.cimap[rc])
            ni = by_j.get(j)
            if ni is None:
                ni = by_j.setdefault(
                    j, add_node(int(rssid.ssid[j]), pron[-1], ti, wid,
                                k - 1))
                for p in prev:
                    edges.append((p, ni, pip))
            exit_[rc] = ni
        recs.append(dict(s=s, t=t, wid=wid, pen=pen, k=k,
                         entry=entry, exit=exit_,
                         last_ci=int(pron[-1]), first_ci=int(pron[0])))

    # -- cross-word wiring ----------------------------------------------------
    def entry_nodes(rec, lc):
        """Word-initial node(s) for a predecessor ending in ciphone lc."""
        return [rec["entry"][lc]]

    def exit_nodes(rec, fc):
        """Word-final node(s) presenting right context fc: the rc-picked
        leaf for multi-phone words; for single-phone words every entered
        lc-variant can exit (rc was approximated as SIL)."""
        if rec["k"] == 1:
            return sorted(set(rec["entry"].values()))
        return [rec["exit"][fc]]

    # state connectivity pairs: (x -> y, extra_pen) meaning a word ending
    # at x may be followed by a word starting at y
    pairs = {(x, x): 0 for x in range(n_state)}
    for (a, b), pen in nulls.items():
        pairs[(a, b)] = min(pairs.get((a, b), 1 << 30), pen)

    by_end: dict[int, list] = {}
    by_startst: dict[int, list] = {}
    for rec in recs:
        by_end.setdefault(rec["t"], []).append(rec)
        by_startst.setdefault(rec["s"], []).append(rec)

    for (x, y), npen in pairs.items():
        for r1 in by_end.get(x, ()):  # word ending at x
            for r2 in by_startst.get(y, ()):  # word starting at y
                lc, fc = r1["last_ci"], r2["first_ci"]
                for src in exit_nodes(r1, fc):
                    for dst in entry_nodes(r2, lc):
                        edges.append((src, dst, r2["pen"] + npen))

    # -- entries (start state, lc = SIL) -------------------------------------
    is_entry_pen: dict[int, int] = {}
    start_pairs = [(fsg.start_state, 0)] + \
        [(b, pen) for (a, b), pen in nulls.items()
         if a == fsg.start_state]
    for (st0, npen) in start_pairs:
        for rec in by_startst.get(st0, ()):
            for ni in entry_nodes(rec, sil):
                pen = rec["pen"] + npen
                is_entry_pen[ni] = max(is_entry_pen.get(ni, -(1 << 30)),
                                       pen)

    # -- finals (final state, rc = SIL) ---------------------------------------
    finals: set[int] = set()
    final_pairs = [fsg.final_state] + \
        [a for (a, b) in nulls if b == fsg.final_state]
    for fs in final_pairs:
        for rec in by_end.get(fs, ()):
            finals.update(exit_nodes(rec, sil))

    # -- assemble (same layout as build_chain_graph) --------------------------
    P = len(nodes)
    n_emit = am.mdef.n_emit_state
    ssid = np.zeros(P, np.int32)
    tmatid = np.zeros(P, np.int32)
    senid = np.zeros((P, n_emit), np.int32)
    entry_pen = np.zeros(P, np.int32)
    is_entry = np.zeros(P, bool)
    word_of = np.zeros(P, np.int32)
    variant_of = np.zeros(P, np.int32)
    pos_of = np.zeros(P, np.int32)
    cipid = np.zeros(P, np.int32)
    for i, nd in enumerate(nodes):
        ssid[i] = nd["ssid"]
        tmatid[i] = mdef.pid2tmatid(nd["ci"])
        senid[i] = mdef.sseq[nd["ssid"]]
        word_of[i] = nd["word"]
        variant_of[i] = nd["var"]
        pos_of[i] = nd["pos"]
        cipid[i] = nd["ci"]
    for ni, pen in is_entry_pen.items():
        is_entry[ni] = True
        entry_pen[ni] = pen

    dedup = sorted(set(edges), key=lambda e: (e[1], e[0], -e[2]))
    # keep the best (max) penalty per (src, dst)
    best: dict[tuple[int, int], int] = {}
    for (s_, t_, p_) in dedup:
        if (s_, t_) not in best:
            best[(s_, t_)] = p_
        else:
            best[(s_, t_)] = max(best[(s_, t_)], p_)
    real = sorted(((s_, t_, p_) for (s_, t_), p_ in best.items()),
                  key=lambda e: (e[1], e[0]))
    edge_src = np.asarray([e[0] for e in real], np.int32)
    edge_dst = np.asarray([e[1] for e in real], np.int32)
    edge_pen = np.asarray([e[2] for e in real], np.int32)

    # earliest-active frame: multi-source BFS (graph may be cyclic)
    from collections import deque

    astart = np.full(P, 1 << 30, np.int64)
    dq = deque()
    for ni in is_entry_pen:
        astart[ni] = 0
        dq.append(ni)
    adj: dict[int, list[int]] = {}
    for (s_, t_, _) in real:
        adj.setdefault(s_, []).append(t_)
    while dq:
        u = dq.popleft()
        for v in adj.get(u, ()):
            if astart[v] > astart[u] + 1:
                astart[v] = astart[u] + 1
                dq.append(v)
    aend = np.full(P, 1 << 30, np.int64)

    from .align_graph import pad_graph
    return pad_graph(AlignGraph(
        ssid=ssid, tmatid=tmatid, senid=senid,
        edge_src=edge_src, edge_dst=edge_dst, edge_pen=edge_pen,
        entry_pen=entry_pen, is_entry=is_entry,
        astart=np.minimum(astart, 1 << 30).astype(np.int32),
        aend=aend.astype(np.int32),
        word_of=word_of, variant_of=variant_of, pos_of=pos_of,
        cipid=cipid,
        final_nodes=np.asarray(sorted(finals), np.int32),
        wids=[],
    ))
