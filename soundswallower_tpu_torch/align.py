"""Multi-level alignment container: words -> phones -> states.

Reimplements ``src/ps_alignment.c``: alignment_add_word (:115-131),
alignment_populate (:132-247: word pronunciations expanded to context-
dependent senone-sequence ids via dict2pid, with cross-word contexts from
adjacent words and SIL at the edges), alignment_propagate (:316-352:
state durations rolled up to phones and words), and the hierarchical
iterators used by the decoder API and the JSON writer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .dict2pid import Dict2Pid

ALIGNMENT_NONE = -1


@dataclass
class AlignmentEntry:
    """alignment_entry_t (alignment.h).  ``id`` is wid for words,
    (cipid, ssid, tmatid) for phones, senid for states."""

    id: object
    start: int = 0
    duration: int = 0
    score: int = 0
    parent: int = ALIGNMENT_NONE
    child: int = ALIGNMENT_NONE


class Alignment:
    def __init__(self, d2p: Dict2Pid):
        self.d2p = d2p
        self.words: list[AlignmentEntry] = []
        self.phones: list[AlignmentEntry] = []
        self.states: list[AlignmentEntry] = []

    def add_word(self, wid: int, start: int, duration: int) -> int:
        self.words.append(AlignmentEntry(wid, start, duration))
        return len(self.words)

    def populate(self) -> None:
        """alignment_populate (ps_alignment.c:132-247)."""
        d2p = self.d2p
        d = d2p.dict
        mdef = d2p.mdef
        self.phones = []
        self.states = []
        lc = mdef.silphone
        for i, went in enumerate(self.words):
            wid = went.id
            pron = d.prons[wid]
            length = len(pron)
            if i < len(self.words) - 1:
                rc = d.first_phone(self.words[i + 1].id)
            else:
                rc = mdef.silphone

            # First phone
            cipid = pron[0]
            tmatid = mdef.pid2tmatid(cipid)
            if length == 1:
                ssid = int(d2p.lrdiph_rc[cipid, lc, rc])
            else:
                ssid = int(d2p.ldiph_lc[cipid, pron[1], lc])
            went.child = len(self.phones)
            self.phones.append(AlignmentEntry(
                (cipid, ssid, tmatid), went.start, went.duration, 0, i))

            # Internal phones
            for j in range(1, length - 1):
                cipid = pron[j]
                self.phones.append(AlignmentEntry(
                    (cipid, d2p.internal(wid, j), mdef.pid2tmatid(cipid)),
                    went.start, went.duration, 0, i))

            # Last phone
            if length > 1:
                cipid = pron[-1]
                rssid = d2p.get_rssid(cipid, pron[-2])
                ssid = int(rssid.ssid[int(rssid.cimap[rc])])
                self.phones.append(AlignmentEntry(
                    (cipid, ssid, mdef.pid2tmatid(cipid)),
                    went.start, went.duration, 0, i))
            lc = pron[-1]

        # Expand phones to states
        n_emit = mdef.n_emit_state
        for i, pent in enumerate(self.phones):
            _, ssid, _ = pent.id
            for j in range(n_emit):
                if j == 0:
                    pent.child = len(self.states)
                self.states.append(AlignmentEntry(
                    int(mdef.sseq[ssid, j]), pent.start, pent.duration, 0, i))

    def propagate(self) -> None:
        """alignment_propagate (ps_alignment.c:316-352): roll up state
        start/duration/score to phones, then phones to words."""
        for level_up, level_down in ((self.phones, self.states),
                                     (self.words, self.phones)):
            parent = None
            for ent in level_down:
                up = level_up[ent.parent]
                if ent.parent != parent:
                    parent = ent.parent
                    up.start = ent.start
                    up.duration = 0
                    up.score = 0
                up.duration += ent.duration
                up.score += ent.score

    @property
    def n_phones(self) -> int:
        return len(self.phones)

    @property
    def n_states(self) -> int:
        return len(self.states)
