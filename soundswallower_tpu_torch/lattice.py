"""Word lattice (DAG) with bestpath, posteriors and A* N-best.

Reimplements ``src/ps_lattice.c`` and the lattice construction from FSG
history (``fsg_search_lattice``, fsg_search.c:1344-1524):

* nodes = unique (word, start-frame, destination-state) triples from the
  history table; links carry the inter-entry score deltas as "acoustic"
  scores (including the transition prob, per the FIXME at
  fsg_search.c:1390-1397)
* start/end node discovery with artificial <s>/</s> nodes when needed
* reachability pruning and filler penalties
* forward bestpath + alpha accumulation (lattice_bestpath, :759-904)
* forward-backward posteriors (lattice_posterior, :921-991)
* A* N-best over the DAG (astar_search_start/next/hyp, :1167-1290)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .logmath import SENSCR_SHIFT, LogMath

MAX_NEG_INT32 = -2147483648
WORST_SCORE = -0x20000000
MAX_PATHS = 500


def _ascale_term(ascr: int, ascale: float) -> int:
    """``(int32)((ascr << SENSCR_SHIFT) * ascale)`` with C float32
    arithmetic: the int32 shift result is promoted to FLOAT (not
    double) for the multiply, so products above 2^24 lose low bits
    exactly as the reference does (ps_lattice.c:824,978-985,911)."""
    return int(np.float32(np.int32(ascr << SENSCR_SHIFT)) *
               np.float32(ascale))


class LatNode:
    __slots__ = ("wid", "basewid", "sf", "fef", "lef", "node_id",
                 "best_exit", "entries", "exits", "reachable", "rem_score")

    def __init__(self, wid, sf, ef, node_id, ascr):
        self.wid = wid
        self.basewid = wid
        self.sf = sf
        self.fef = ef
        self.lef = ef
        self.node_id = node_id
        self.best_exit = ascr
        self.entries: list[LatLink] = []
        self.exits: list[LatLink] = []
        self.reachable = False
        self.rem_score = 1


class LatLink:
    __slots__ = ("src", "dst", "ascr", "ef", "path_scr", "alpha", "beta",
                 "best_prev")

    def __init__(self, src, dst, ascr, ef):
        self.src = src
        self.dst = dst
        self.ascr = ascr
        self.ef = ef
        self.path_scr = MAX_NEG_INT32
        self.alpha = 0
        self.beta = 0
        self.best_prev: LatLink | None = None


class Lattice:
    def __init__(self, lmath: LogMath, n_frames: int, dictionary):
        self.lmath = lmath
        self.n_frames = n_frames
        self.dict = dictionary
        self.nodes: list[LatNode] = []
        self.start: LatNode | None = None
        self.end: LatNode | None = None
        self.final_node_ascr = 0
        self.norm = 0

    # -- construction ------------------------------------------------------

    def _find_node(self, sf, wid, node_id):
        for n in self.nodes:
            if n.sf == sf and n.wid == wid and n.node_id == node_id:
                return n
        return None

    def new_node(self, sf, ef, wid, node_id, ascr):
        """new_node (fsg_search.c:1179-1212)."""
        node = self._find_node(sf, wid, node_id)
        if node is not None:
            if node.lef == -1 or node.lef < ef:
                node.lef = ef
            if node.fef == -1 or node.fef > ef:
                node.fef = ef
            if ascr > node.best_exit:
                node.best_exit = ascr
        else:
            node = LatNode(wid, sf, ef, node_id, ascr)
            self.nodes.append(node)
        return node

    def link(self, src: LatNode, dst: LatNode, score: int, ef: int):
        """lattice_link (ps_lattice.c:79-117): keep the best score for
        duplicate links."""
        for l in src.exits:
            if l.dst is dst:
                if l.ascr < score:
                    l.ascr = score
                    l.ef = ef
                return
        l = LatLink(src, dst, score, ef)
        src.exits.append(l)
        dst.entries.append(l)

    @classmethod
    def from_fsg_search(cls, fsgs, config) -> "Lattice | None":
        """fsg_search_lattice (fsg_search.c:1344-1524)."""
        fsg = fsgs.fsg
        d = fsgs.dict
        dag = cls(fsgs.lmath, fsgs.frame, d)
        h = fsgs.history

        def entry_link_params(fh):
            if fh.pred:
                pfh = h.get(fh.pred)
                return fh.score - pfh.score, pfh.frame + 1
            return fh.score, 0

        # Pass 1: nodes
        for i in range(h.n_entries()):
            fh = h.get(i)
            if fh.fsglink is None or fh.fsglink.wid == -1:
                continue
            ascr, sf = entry_link_params(fh)
            dag.new_node(sf, fh.frame, fh.fsglink.wid,
                         fh.fsglink.to_state, ascr)
        # Pass 2: links to existing nodes
        for i in range(h.n_entries()):
            fh = h.get(i)
            if fh.fsglink is None or fh.fsglink.wid == -1:
                continue
            ascr, sf = entry_link_params(fh)
            src = dag._find_node(sf, fh.fsglink.wid, fh.fsglink.to_state)
            sf = fh.frame + 1
            for link in fsg.arcs(fh.fsglink.to_state):
                if link.wid >= 0:
                    dst = dag._find_node(sf, link.wid, link.to_state)
                    if dst is not None:
                        dag.link(src, dst, ascr, fh.frame)
                else:
                    for link2 in fsg.arcs(link.to_state):
                        if link2.wid == -1:
                            continue
                        dst = dag._find_node(sf, link2.wid, link2.to_state)
                        if dst is not None:
                            dag.link(src, dst, ascr, fh.frame)

        # start node (find_start_node, fsg_search.c:1214-1250)
        starts = [n for n in dag.nodes if n.sf == 0 and n.exits]
        if len(starts) == 1:
            dag.start = starts[0]
        else:
            wid = fsg.word_add("<s>")
            fsg.silwords.add(wid)
            node = dag.new_node(0, 0, wid, -1, 0)
            for s in starts:
                dag.link(node, s, 0, 0)
            dag.start = node
        # end node (find_end_node, fsg_search.c:1252-1308)
        ends = [n for n in dag.nodes
                if n.lef == dag.n_frames - 1 and n.entries]
        if len(ends) == 1:
            dag.end = ends[0]
        elif len(ends) == 0:
            last, ef = None, 0
            for n in dag.nodes:
                if n.lef > ef and n.entries:
                    last, ef = n, n.lef
            dag.end = last
        else:
            wid = fsg.word_add("</s>")
            fsg.silwords.add(wid)
            node = dag.new_node(fsgs.frame, fsgs.frame, wid, -1, 0)
            for s in ends:
                dag.link(s, node, s.best_exit, fsgs.frame)
            dag.end = node
        if dag.start is None or dag.end is None:
            return None

        # FSG word ids -> dictionary word ids
        for n in dag.nodes:
            n.wid = d.wordid(fsg.word_str(n.wid))
            n.basewid = d.basewid_of(n.wid) if n.wid >= 0 else n.wid

        # reachability from end (mark_reachable + delete_unreachable)
        dag._mark_reachable()
        dag.nodes = [n for n in dag.nodes if n.reachable]
        for n in dag.nodes:
            n.exits = [l for l in n.exits if l.dst.reachable]
            n.entries = [l for l in n.entries if l.src.reachable]

        # filler penalties (lattice_penalize_fillers, ps_lattice.c:119-130)
        lw = config.get_float("lw")
        silpen = int(fsgs.lmath.log(config.get_float("silprob")) * lw) \
            >> SENSCR_SHIFT
        fillpen = int(fsgs.lmath.log(config.get_float("fillprob")) * lw) \
            >> SENSCR_SHIFT
        for n in dag.nodes:
            if n is dag.start or n is dag.end:
                continue
            if n.basewid >= 0 and d.filler_word(n.basewid):
                pen = silpen if n.basewid == d.silwid else fillpen
                for l in n.entries:
                    l.ascr += pen
        return dag

    def _mark_reachable(self):
        self.end.reachable = True
        q = [self.end]
        while q:
            node = q.pop()
            for l in node.entries:
                if not l.src.reachable:
                    l.src.reachable = True
                    q.append(l.src)

    # -- traversal ---------------------------------------------------------

    def edges_topological(self):
        """Forward topological edge order (lattice_traverse_edges)."""
        indeg = {}
        for n in self.nodes:
            for l in n.exits:
                indeg[id(l.dst)] = indeg.get(id(l.dst), 0) + 1
        order = []
        q = [n for n in self.nodes if indeg.get(id(n), 0) == 0]
        seen = set()
        while q:
            n = q.pop()
            for l in n.exits:
                order.append(l)
                indeg[id(l.dst)] -= 1
                if indeg[id(l.dst)] == 0:
                    q.append(l.dst)
        return order

    # -- bestpath / posterior (ps_lattice.c:759-991) -----------------------

    def bestpath(self, ascale: float) -> LatLink | None:
        lmath = self.lmath
        zero = lmath.zero
        for n in self.nodes:
            for l in n.exits:
                l.path_scr = MAX_NEG_INT32
                l.alpha = zero
        for l in self.start.exits:
            l.path_scr = l.ascr
            l.best_prev = None
            l.alpha = 0
        for link in self.edges_topological():
            if link.path_scr == MAX_NEG_INT32:
                continue
            link.alpha += _ascale_term(link.ascr, ascale)
            for x in link.dst.exits:
                x.alpha = lmath.add(x.alpha, link.alpha)
                score = link.path_scr + x.ascr
                if score > x.path_scr:
                    x.path_scr = score
                    x.best_prev = link
        bestend = None
        bestescr = MAX_NEG_INT32
        self.norm = lmath.zero
        for x in self.end.entries:
            self.norm = lmath.add(self.norm, x.alpha)
            if x.path_scr > bestescr:
                bestescr = x.path_scr
                bestend = x
        # C quirk (ps_lattice.c:890): ``dag->norm +=
        # (int32)(final_node_ascr << SHIFT) * ascale`` — the += runs in
        # FLOAT (norm promotes to float32, truncating its low bits),
        # unlike every other term site which casts the product to int32
        self.norm = int(np.float32(
            np.float32(self.norm)
            + np.float32(np.int32(self.final_node_ascr << SENSCR_SHIFT))
            * np.float32(ascale)))
        return bestend

    def joint(self, link: LatLink | None, ascale: float) -> int:
        jprob = _ascale_term(self.final_node_ascr, ascale)
        while link is not None:
            jprob += _ascale_term(link.ascr, ascale)
            link = link.best_prev
        return jprob

    def posterior(self, ascale: float) -> int:
        """lattice_posterior: returns P(S|O) in log units."""
        lmath = self.lmath
        zero = lmath.zero
        for n in self.nodes:
            for l in n.exits:
                l.beta = zero
        bestend = None
        bestescr = MAX_NEG_INT32
        for link in reversed(self.edges_topological()):
            if link.dst is self.end:
                if link.path_scr > bestescr:
                    bestescr = link.path_scr
                    bestend = link
                link.beta = _ascale_term(self.final_node_ascr, ascale)
            else:
                for x in link.dst.exits:
                    link.beta = lmath.add(
                        link.beta,
                        x.beta + _ascale_term(x.ascr, ascale))
        return self.joint(bestend, ascale) - self.norm

    def hyp(self, bestend: LatLink) -> str:
        """lattice_hyp: backtrace a bestpath link chain to words."""
        words = []
        link = bestend
        if self.dict.real_word(link.dst.basewid):
            words.append(self.dict.wordstr(link.dst.basewid))
        while link is not None:
            if self.dict.real_word(link.src.basewid):
                words.append(self.dict.wordstr(link.src.basewid))
            link = link.best_prev
        return " ".join(reversed(words))


@dataclass
class LatPath:
    node: LatNode
    parent: "LatPath | None"
    score: int


class AstarSearch:
    """A* N-best over the lattice (ps_lattice.c:1040-1290)."""

    def __init__(self, dag: Lattice, sf: int = 0, ef: int = -1):
        self.dag = dag
        self.sf = sf
        self.ef = dag.n_frames + 1 if ef < 0 else ef
        self.paths: list[LatPath] = []
        for node in dag.nodes:
            if node is dag.end:
                node.rem_score = 0
            elif not node.exits:
                node.rem_score = WORST_SCORE
            else:
                node.rem_score = 1  # unknown
        for node in dag.nodes:
            if node.sf == sf:
                self._best_rem_score(node)
                self._insert(LatPath(node, None, 0))

    def _best_rem_score(self, node: LatNode) -> int:
        """best_rem_score (ps_lattice.c:1040-1060): backward best score.
        Iterative post-order (lattices can be thousands of nodes deep)."""
        stack = [(node, False)]
        while stack:
            n, expanded = stack.pop()
            if n.rem_score <= 0:
                continue
            if not expanded:
                stack.append((n, True))
                for x in n.exits:
                    if x.dst.rem_score > 0:
                        stack.append((x.dst, False))
            else:
                best = WORST_SCORE
                for x in n.exits:
                    rem = x.dst.rem_score
                    if rem > WORST_SCORE and x.ascr + rem > best:
                        best = x.ascr + rem
                n.rem_score = best
        return node.rem_score

    def _total(self, p: LatPath) -> int:
        return p.score + p.node.rem_score

    def _insert(self, p: LatPath):
        import bisect

        keys = [-self._total(q) for q in self.paths]
        i = bisect.bisect_right(keys, -self._total(p))
        self.paths.insert(i, p)
        if len(self.paths) > MAX_PATHS:
            self.paths = self.paths[:MAX_PATHS]

    def next(self) -> LatPath | None:
        """astar_next (ps_lattice.c:1215-1246)."""
        while self.paths:
            top = self.paths.pop(0)
            if (top.node.sf >= self.ef) or \
                    (top.node is self.dag.end and self.ef > self.dag.end.sf):
                return top
            if top.node.fef < self.ef:
                for x in top.node.exits:
                    if x.dst.rem_score <= WORST_SCORE:
                        continue
                    self._best_rem_score(x.dst)
                    self._insert(LatPath(x.dst, top, top.score + x.ascr))
        return None

    def hyp(self, path: LatPath) -> str:
        """astar_hyp (ps_lattice.c:1248-1290): real words only."""
        words = []
        p = path
        while p is not None:
            if p.node.basewid >= 0 and self.dag.dict.real_word(p.node.basewid):
                words.append(self.dag.dict.wordstr(p.node.basewid))
            p = p.parent
        return " ".join(reversed(words))
