"""FSG phonetic-prefix lextree: compiles FSG x dictionary x dict2pid into
a network of per-phone HMMs.

Reimplements ``src/fsg_lextree.c``: left/right context sets with null-
transition propagation (fsg_lextree_lc_rc, :86-204) and the per-state
prefix-tree construction with its sharing rules (psubtree_add_trans,
:356-671):

* root nodes: one per (first-phone ssid) per (ci, rc) group, shared across
  words/left-contexts; carry wip+pip (+ word prob for single-phone words)
* internal nodes: shared by ssid within the predecessor's child chain;
  carry pip
* leaf nodes: one per distinct right-context ssid per (word, link); carry
  the FSG transition prob + pip; hold the fsglink for word exit
* filler single-phone words: context-independent ssid, SIL presented as
  context to neighbors

Context sets are 128-bit masks (ctxt.bv[4] in C; a Python int here).
"""

from __future__ import annotations

from .dict2pid import Dict2Pid
from .dictionary import Dictionary
from .fsg import FsgModel
from .hmm import Hmm
from .logmath import SENSCR_SHIFT
from .mdef import BinMdef

ALL_CTXT = (1 << 128) - 1


class PNode:
    __slots__ = ("hmm", "logs2prob", "ci_ext", "ppos", "leaf", "ctxt",
                 "fsglink", "succ", "sibling", "alloc_next")

    def __init__(self, ssid, tmatid, sseq, logs2prob, ci_ext, ppos, leaf):
        self.hmm = Hmm(ssid, tmatid, sseq)
        self.logs2prob = logs2prob
        self.ci_ext = ci_ext
        self.ppos = ppos
        self.leaf = leaf
        self.ctxt = 0
        self.fsglink = None
        self.succ = None       # first child (non-leaf)
        self.sibling = None
        self.alloc_next = None

    def add_ctxt(self, ci: int):
        self.ctxt |= 1 << ci

    def children(self):
        n = self.succ
        while n is not None:
            yield n
            n = n.sibling


class FsgLextree:
    def __init__(self, fsg: FsgModel, dictionary: Dictionary, d2p: Dict2Pid,
                 mdef: BinMdef, wip: int, pip: int):
        self.fsg = fsg
        self.dict = dictionary
        self.d2p = d2p
        self.mdef = mdef
        self.wip = wip
        self.pip = pip
        self.sseq = mdef.sseq
        self._compute_lc_rc()
        self.root: list[PNode | None] = []
        self.alloc: list[list[PNode]] = []
        self.n_pnode = 0
        for s in range(fsg.n_state):
            nodes: list[PNode] = []
            self.root.append(self._psubtree_init(s, nodes))
            self.alloc.append(nodes)
            self.n_pnode += len(nodes)

    # -- context sets (fsg_lextree_lc_rc, fsg_lextree.c:86-204) ------------

    def _compute_lc_rc(self):
        fsg, mdef, d = self.fsg, self.mdef, self.dict
        n_ci = mdef.n_ciphone
        sil = mdef.silphone
        lc = [set() for _ in range(fsg.n_state)]
        rc = [set() for _ in range(fsg.n_state)]
        for s in range(fsg.n_state):
            for link in fsg.arcs(s):
                if link.wid < 0:
                    continue
                if fsg.is_filler(link.wid):
                    rc[link.from_state].add(sil)
                    lc[link.to_state].add(sil)
                else:
                    dictwid = d.wordid(fsg.word_str(link.wid))
                    pron = d.prons[dictwid]
                    rc[link.from_state].add(pron[0])
                    lc[link.to_state].add(pron[-1])
        for s in range(fsg.n_state):
            lc[s].add(sil)
            rc[s].add(sil)
        # Propagate past null transitions (single step; FSG holds closure)
        for s in range(fsg.n_state):
            for link in fsg.null_trans[s].values():
                lc[link.to_state] |= lc[link.from_state]
                rc[link.from_state] |= rc[link.to_state]
        self.lc = [sorted(x) for x in lc]
        self.rc = [sorted(x) for x in rc]

    # -- tree construction (psubtree_add_trans, fsg_lextree.c:356-671) -----

    def _psubtree_init(self, from_state: int, nodes: list[PNode]) -> PNode | None:
        root = None
        glist: dict[tuple[int, int], list[PNode]] = {}
        for link in self.fsg.arcs(from_state):
            if link.wid < 0:
                continue
            root = self._add_trans(root, glist, link,
                                   self.lc[from_state],
                                   self.rc[link.to_state], nodes)
        return root

    def _add_trans(self, root, glist, fsglink, lclist, rclist, nodes):
        fsg, d, d2p, mdef = self.fsg, self.dict, self.d2p, self.mdef
        sil = mdef.silphone
        wid = fsglink.wid
        dictwid = d.wordid(fsg.word_str(wid))
        pron = d.prons[dictwid]
        pronlen = len(pron)
        link_prob = (fsglink.logs2prob >> SENSCR_SHIFT)

        if pronlen == 1:
            ci = pron[0]
            if not d.filler_word(dictwid):
                # single-phone word: left contexts, SIL right ctx assumed
                lc_pnodes: list[PNode] = []
                for lcp in lclist:
                    ssid = int(d2p.lrdiph_rc[ci, lcp, sil])
                    tmatid = mdef.pid2tmatid(ci)
                    shared = None
                    for pn in lc_pnodes:
                        if pn.hmm.ssid == ssid:
                            shared = pn
                            break
                    if shared is not None:
                        shared.add_ctxt(lcp)
                        continue
                    pn = PNode(ssid, tmatid, self.sseq,
                               link_prob + self.wip + self.pip,
                               ci, 0, True)
                    pn.fsglink = fsglink
                    pn.add_ctxt(lcp)
                    pn.sibling = root
                    root = pn
                    nodes.append(pn)
                    lc_pnodes.append(pn)
            else:
                # filler word: no context modelled
                ssid = mdef.pid2ssid(ci)
                tmatid = mdef.pid2tmatid(ci)
                pn = PNode(ssid, tmatid, self.sseq,
                           link_prob + self.wip + self.pip,
                           sil, 0, True)
                pn.fsglink = fsglink
                pn.ctxt = ALL_CTXT
                pn.sibling = root
                root = pn
                nodes.append(pn)
            return root

        # Multi-phone word
        pred = None
        lc_pnodelist: list[PNode] = []
        ssid_pnode_map: dict[int, PNode] = {}
        for p in range(pronlen):
            ci = pron[p]
            if p == 0:
                rcp = pron[1]
                key = (ci, rcp)
                if key in glist and glist[key]:
                    lc_pnodelist = glist[key]
                    pred = lc_pnodelist[0]
                    continue
                lc_pnodelist = []
                ssid_map_list: list[PNode] = []
                for lcp in lclist:
                    ssid = int(d2p.ldiph_lc[ci, rcp, lcp])
                    tmatid = mdef.pid2tmatid(pron[0])
                    # Replicates the C scan at fsg_lextree.c:513-520
                    # faithfully, including its quirk: when no entry
                    # matches, `pnode` is left pointing at the *last*
                    # examined map entry, so no new node is allocated and
                    # the context bit merges into that node.  In effect
                    # each (ci, rc) group gets exactly one root node whose
                    # ssid comes from the first left context.
                    pn = None
                    for q in ssid_map_list:
                        pn = q
                        if q.hmm.ssid == ssid:
                            break
                    if pn is None:
                        pn = PNode(ssid, tmatid, self.sseq,
                                   self.wip + self.pip, pron[0], 0, False)
                        pn.sibling = root
                        root = pn
                        nodes.append(pn)
                        lc_pnodelist.insert(0, pn)
                        ssid_map_list.append(pn)
                    pn.add_ctxt(lcp)
                glist[key] = lc_pnodelist
                pred = root
            elif p != pronlen - 1:
                ssid = d2p.internal(dictwid, p)
                tmatid = mdef.pid2tmatid(ci)
                # search pred's child chain for shared internal node
                pnode = pred.succ
                youngest = pnode
                while pnode is not None and (pnode.hmm.ssid != ssid or pnode.leaf):
                    pnode = pnode.sibling
                if pnode is not None and pnode.hmm.ssid == ssid and not pnode.leaf:
                    pred = pnode
                    continue
                pn = PNode(ssid, tmatid, self.sseq, self.pip, ci, p, False)
                pn.sibling = youngest
                if p == 1:
                    for q in lc_pnodelist:
                        q.succ = pn
                else:
                    pred.succ = pn
                nodes.append(pn)
                pred = pn
            else:
                # leaf phone: one node per distinct right-context ssid
                lcp = pron[p - 1]
                rssid = d2p.get_rssid(ci, lcp)
                tmatid = mdef.pid2tmatid(ci)
                rc_map: dict[int, PNode] = {}
                rc_head: PNode | None = None
                for rcp in rclist:
                    j = int(rssid.cimap[rcp])
                    ssid = int(rssid.ssid[j])
                    pn = rc_map.get(j)
                    if pn is None:
                        pn = PNode(ssid, tmatid, self.sseq,
                                   link_prob + self.pip, ci, p, True)
                        pn.fsglink = fsglink
                        pn.sibling = rc_head
                        rc_head = pn
                        nodes.append(pn)
                        rc_map[j] = pn
                    pn.add_ctxt(rcp)
                # attach leaf chain to predecessors
                if p == 1:
                    for q in lc_pnodelist:
                        if q.succ is None:
                            q.succ = rc_head
                        else:
                            succ = q.succ
                            while succ.sibling is not None:
                                succ = succ.sibling
                            succ.sibling = rc_head
                            break  # shared chain; one link suffices
                else:
                    if pred.succ is None:
                        pred.succ = rc_head
                    else:
                        succ = pred.succ
                        while succ.sibling is not None:
                            succ = succ.sibling
                        succ.sibling = rc_head
        return root

    def roots(self, state: int):
        n = self.root[state]
        while n is not None:
            yield n
            n = n.sibling

    def all_pnodes(self):
        for nodes in self.alloc:
            yield from nodes
