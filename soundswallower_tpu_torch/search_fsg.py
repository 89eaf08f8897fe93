"""FSG beam search (host exact path).

Reimplements ``src/fsg_search.c`` + ``src/fsg_history.c``: the per-frame
loop of HMM evaluation, beam prune/propagate, word-exit history entries
with per-(state, left-context) right-context-set deduplication, null
transition propagation, and cross-word transitions into lextree roots.

This is the exactness/parity implementation (plain Python over the lextree
node objects), fed by the card's dense senone scores in
``TorchAligner.decode_search``; the grammar decode's dense Viterbi lives
in ops/.  A copy of the JAX package's module.  Scores, beams and
history-entry semantics match the C reference; the only tolerated
divergence is tie-breaking that depends on the C hash-table iteration
order (see fsg_history_entry_add ordering).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .am import AcousticModel
from .dict2pid import Dict2Pid
from .dictionary import Dictionary
from .fsg import FsgLink, FsgModel
from .hmm import WORST_SCORE
from .lextree import ALL_CTXT, FsgLextree, PNode
from .logmath import SENSCR_SHIFT, LogMath


@dataclass
class HistEntry:
    """fsg_hist_entry_t (fsg_history.h:97-107)."""

    fsglink: FsgLink | None
    frame: int
    score: int
    pred: int
    lc: int
    rc: int  # 128-bit context mask (python int)


class FsgHistory:
    """Viterbi backpointer table with in-frame dedup (src/fsg_history.c)."""

    def __init__(self, fsg: FsgModel):
        self.fsg = fsg
        self.entries: list[HistEntry] = []
        # frame_entries[(state, lc)] -> score-descending list
        self.frame_entries: dict[tuple[int, int], list[HistEntry]] = {}

    def reset(self):
        self.entries.clear()
        self.frame_entries.clear()

    def n_entries(self) -> int:
        return len(self.entries)

    def get(self, idx: int) -> HistEntry:
        return self.entries[idx]

    def entry_add(self, link, frame, score, pred, lc, rc):
        """fsg_history_entry_add (fsg_history.c:128-201)."""
        if frame < 0:
            self.entries.append(HistEntry(link, frame, score, pred, lc, rc))
            return
        s = link.to_state
        lst = self.frame_entries.setdefault((s, lc), [])
        # find insertion point; reduce new rc by rc of better entries
        i = 0
        while i < len(lst):
            entry = lst[i]
            if score > entry.score:
                break
            rc &= ~entry.rc
            if rc == 0:
                return
            i += 1
        new = HistEntry(link, frame, score, pred, lc, rc)
        lst.insert(i, new)
        # prune dominated worse entries
        j = i + 1
        while j < len(lst):
            lst[j].rc &= ~rc
            if lst[j].rc == 0:
                del lst[j]
            else:
                j += 1

    def end_frame(self):
        """fsg_history_end_frame (fsg_history.c:207-228): commit per-frame
        survivors to the permanent table in (state, lc) order."""
        n_ci = 256  # iterate keys in (state, lc) sorted order like C
        for key in sorted(self.frame_entries.keys()):
            for entry in self.frame_entries[key]:
                self.entries.append(entry)
        self.frame_entries.clear()


class FsgSearch:
    """fsg_search_t (src/fsg_search.c)."""

    def __init__(self, fsg: FsgModel, config, am: AcousticModel,
                 dictionary: Dictionary, d2p: Dict2Pid, lmath: LogMath):
        self.fsg = fsg
        self.config = config
        self.am = am
        self.dict = dictionary
        self.d2p = d2p
        self.lmath = lmath

        self.beam_orig = int(lmath.log(config.get_float("beam"))) >> SENSCR_SHIFT
        self.pbeam_orig = int(lmath.log(config.get_float("pbeam"))) >> SENSCR_SHIFT
        self.wbeam_orig = int(lmath.log(config.get_float("wbeam"))) >> SENSCR_SHIFT
        self.lw = config.get_float("lw")
        self.pip = int(lmath.log(config.get_float("pip")) * self.lw) >> SENSCR_SHIFT
        self.wip = int(lmath.log(config.get_float("wip")) * self.lw) >> SENSCR_SHIFT
        self.maxhmmpf = config.get_int("maxhmmpf")

        if not self._check_dict(fsg):
            raise ValueError("FSG has words missing from the dictionary")
        if config.get_bool("fsgusefiller") and not fsg.has_sil:
            self._add_silences(fsg)
        if config.get_bool("fsgusealtpron") and not fsg.has_alt:
            self._add_altpron(fsg)

        self.history = FsgHistory(fsg)
        self.lextree = FsgLextree(fsg, dictionary, d2p, am.mdef,
                                  self.wip, self.pip)
        self.frame = -1
        self.final = False
        self.bestscore = 0
        self.beam = self.beam_orig
        self.pbeam = self.pbeam_orig
        self.wbeam = self.wbeam_orig
        self.beam_factor = 1.0
        self.pnode_active: list[PNode] = []
        self.pnode_active_next: list[PNode] = []
        self.bpidx_start = 0
        self.n_hmm_eval = 0
        self.n_sen_eval = 0

    # -- init helpers (fsg_search.c:84-170) --------------------------------

    def _check_dict(self, fsg) -> bool:
        return all(self.dict.wordid(w) >= 0 for w in fsg.vocab)

    def _add_silences(self, fsg):
        fsg.add_silence("<sil>", -1, self.config.get_float("silprob"))
        d = self.dict
        for wid in range(d.filler_start, d.filler_end + 1):
            if wid in (d.startwid, d.finishwid):
                continue
            fsg.add_silence(d.wordstr(wid), -1, self.config.get_float("fillprob"))

    def _add_altpron(self, fsg):
        d = self.dict
        for i in range(fsg.n_word):
            word = fsg.word_str(i)
            wid = d.wordid(word)
            if wid >= 0:
                alt = d.nextalt(wid)
                while alt >= 0:
                    fsg.add_alt(word, d.wordstr(alt))
                    alt = d.nextalt(alt)

    # -- per-utterance interface -------------------------------------------

    def start(self):
        """fsg_search_start (fsg_search.c:746-798)."""
        self.beam_factor = 1.0
        self.beam, self.pbeam, self.wbeam = (
            self.beam_orig, self.pbeam_orig, self.wbeam_orig)
        silcipid = self.am.mdef.silphone
        self.history.reset()
        self.final = False
        self.frame = -1
        self.bestscore = 0
        self.pnode_active = []
        self.pnode_active_next = []
        self.history.entry_add(None, -1, 0, -1, silcipid, ALL_CTXT)
        self.bpidx_start = 0
        self._null_prop()
        self._word_trans()
        self.pnode_active = self.pnode_active_next
        self.pnode_active_next = []
        self.frame += 1
        self.n_hmm_eval = 0
        self.n_sen_eval = 0

    def active_hmms(self):
        return [pn.hmm for pn in self.pnode_active]

    def sen_active(self) -> set[int]:
        """fsg_search_sen_active: senones of active pnodes."""
        sens = set()
        for pn in self.pnode_active:
            for s in pn.hmm.senid:
                sens.add(s)
        return sens

    def step(self, senscr: np.ndarray, frame_idx: int):
        """fsg_search_step (fsg_search.c:664-739), minus acmod scoring
        which the decoder does (senscr passed in)."""
        assert self.frame == frame_idx
        self.bpidx_start = self.history.n_entries()
        self._hmm_eval(senscr)
        self._hmm_prune_prop()
        self.history.end_frame()
        self._null_prop()
        self.history.end_frame()
        self._word_trans()
        for pn in self.pnode_active:
            if pn.hmm.frame == self.frame:
                pn.hmm.clear()  # fsg_psubtree_pnode_deactivate
            else:
                assert pn.hmm.frame == self.frame + 1
        self.pnode_active = self.pnode_active_next
        self.pnode_active_next = []
        self.frame += 1
        return 1

    def finish(self):
        """fsg_search_finish (fsg_search.c:803-852)."""
        for pn in self.pnode_active:
            pn.hmm.clear()
        for pn in self.pnode_active_next:
            pn.hmm.clear()
        self.pnode_active = []
        self.pnode_active_next = []
        self.final = True

    # -- internals ---------------------------------------------------------

    def _hmm_eval(self, senscr):
        """fsg_search_hmm_eval (fsg_search.c:330-402)."""
        best = WORST_SCORE
        n = 0
        tmat = self.am.tmat
        for pn in self.pnode_active:
            hmm = pn.hmm
            assert hmm.frame == self.frame
            score = hmm.vit_eval(senscr, tmat[hmm.tmatid])
            if score > best:
                best = score
            n += 1
        self.n_hmm_eval += n
        if self.maxhmmpf != -1 and n > self.maxhmmpf:
            if self.beam_factor > 0.1:
                self.beam_factor *= 0.9
                self.beam = int(self.beam_orig * self.beam_factor)
                self.pbeam = int(self.pbeam_orig * self.beam_factor)
                self.wbeam = int(self.wbeam_orig * self.beam_factor)
        else:
            self.beam_factor = 1.0
            self.beam, self.pbeam, self.wbeam = (
                self.beam_orig, self.pbeam_orig, self.wbeam_orig)
        self.bestscore = best

    def _pnode_trans(self, pnode):
        """fsg_search_pnode_trans (fsg_search.c:405-436)."""
        nf = self.frame + 1
        thresh = self.bestscore + self.beam
        hmm = pnode.hmm
        for child in pnode.children():
            newscore = hmm.out_score + child.logs2prob
            if newscore > thresh and newscore > child.hmm.score[0]:
                if child.hmm.frame < nf:
                    self.pnode_active_next.insert(0, child)
                child.hmm.enter(newscore, hmm.out_history, nf)

    def _pnode_exit(self, pnode):
        """fsg_search_pnode_exit (fsg_search.c:438-495)."""
        hmm = pnode.hmm
        fl = pnode.fsglink
        wid = fl.wid
        d = self.dict
        if self.fsg.is_filler(wid) or d.is_single_phone(
                d.wordid(self.fsg.word_str(wid))):
            ctxt = ALL_CTXT
        else:
            ctxt = pnode.ctxt
        self.history.entry_add(fl, self.frame, hmm.out_score,
                               hmm.out_history, pnode.ci_ext, ctxt)

    def _hmm_prune_prop(self):
        """fsg_search_hmm_prune_prop (fsg_search.c:497-541)."""
        thresh = self.bestscore + self.beam
        phone_thresh = self.bestscore + self.pbeam
        word_thresh = self.bestscore + self.wbeam
        for pn in self.pnode_active:
            hmm = pn.hmm
            if hmm.bestscore >= thresh:
                if hmm.frame == self.frame:
                    hmm.frame = self.frame + 1
                    self.pnode_active_next.insert(0, pn)
                else:
                    assert hmm.frame == self.frame + 1
                if not pn.leaf:
                    if hmm.out_score >= phone_thresh:
                        self._pnode_trans(pn)
                else:
                    if hmm.out_score >= word_thresh:
                        self._pnode_exit(pn)

    def _null_prop(self):
        """fsg_search_null_prop (fsg_search.c:546-595)."""
        thresh = self.bestscore + self.wbeam
        n_entries = self.history.n_entries()
        for bpidx in range(self.bpidx_start, n_entries):
            entry = self.history.get(bpidx)
            l = entry.fsglink
            s = l.to_state if l is not None else self.fsg.start_state
            for link in self.fsg.null_trans[s].values():
                newscore = entry.score + (link.logs2prob >> SENSCR_SHIFT)
                if newscore >= thresh:
                    self.history.entry_add(link, entry.frame, newscore,
                                           bpidx, entry.lc, entry.rc)

    def _word_trans(self):
        """fsg_search_word_trans (fsg_search.c:600-662)."""
        n_entries = self.history.n_entries()
        thresh = self.bestscore + self.beam
        nf = self.frame + 1
        for bpidx in range(self.bpidx_start, n_entries):
            entry = self.history.get(bpidx)
            score = entry.score
            l = entry.fsglink
            d = l.to_state if l is not None else self.fsg.start_state
            lc = entry.lc
            for root in self.lextree.roots(d):
                rc = root.ci_ext
                if (root.ctxt >> lc) & 1 and (entry.rc >> rc) & 1:
                    newscore = score + root.logs2prob
                    if newscore > thresh and newscore > root.hmm.score[0]:
                        if root.hmm.frame < nf:
                            self.pnode_active_next.insert(0, root)
                        root.hmm.enter(newscore, bpidx, nf)

    # -- results (fsg_search.c:855-1142) -----------------------------------

    def find_exit(self, frame_idx: int, final: bool):
        """fsg_search_find_exit (fsg_search.c:857-924)."""
        if frame_idx == -1:
            frame_idx = self.frame - 1
        h = self.history
        bpidx = h.n_entries() - 1
        entry = None
        while bpidx > 0:
            entry = h.get(bpidx)
            if entry.frame <= frame_idx:
                frm = last_frm = entry.frame
                break
            bpidx -= 1
        if bpidx <= 0:
            return bpidx, None
        bestscore = -(1 << 62)
        besthist = -1
        fsg = self.fsg
        while frm == last_frm:
            fl = entry.fsglink
            score = entry.score
            if fl is None:
                break
            if score == bestscore and fl.to_state == fsg.final_state:
                besthist = bpidx
            elif score > bestscore:
                if (not final) or fl.to_state == fsg.final_state:
                    bestscore = score
                    besthist = bpidx
            bpidx -= 1
            if bpidx < 0:
                break
            entry = h.get(bpidx)
            frm = entry.frame
        if besthist == -1:
            return -1, None
        return besthist, bestscore

    def backtrace(self, bpidx: int):
        """Walk the pred chain yielding history entries root-first."""
        chain = []
        while bpidx > 0:
            entry = self.history.get(bpidx)
            chain.append(entry)
            bpidx = entry.pred
        chain.reverse()
        return chain

    def hyp(self):
        """fsg_search_hyp (fsg_search.c:946-1010): real words only."""
        bpidx, score = self.find_exit(self.frame, self.final)
        if bpidx is None or bpidx <= 0:
            return None, 0
        words = []
        d = self.dict
        for entry in self.backtrace(bpidx):
            if entry.fsglink is None or entry.fsglink.wid < 0:
                continue
            if self.fsg.is_filler(entry.fsglink.wid):
                continue
            wid = d.wordid(self.fsg.word_str(entry.fsglink.wid))
            words.append(d.basestr(wid))
        return " ".join(words), score

    def seg_iter(self):
        """fsg_search_seg_iter + fsg_seg_bp2itor (fsg_search.c:1031-1142).

        Yields ALL backtrace entries (null-transition entries have
        word=None and must be filtered by callers, mirroring
        decoder_alignment's BAD_S3WID skip)."""
        bpidx, score = self.find_exit(self.frame, self.final)
        if bpidx is None or bpidx <= 0:
            return []
        segs = []
        for entry in self.backtrace(bpidx):
            ph = self.history.get(entry.pred) if entry.pred >= 0 else None
            wid = entry.fsglink.wid if entry.fsglink else -1
            word = self.fsg.word_str(wid) if wid >= 0 else None
            ef = entry.frame
            sf = ph.frame + 1 if ph is not None else 0
            if sf > ef:
                sf = ef  # null transitions (fsg_seg_bp2itor)
            lscr = entry.fsglink.logs2prob >> SENSCR_SHIFT
            if ph is not None:
                ascr = entry.score - ph.score - lscr
            else:
                ascr = entry.score - lscr
            segs.append(dict(word=word, sf=sf, ef=ef, ascr=ascr, lscr=lscr,
                             prob=lscr + ascr, score=entry.score))
        return segs
