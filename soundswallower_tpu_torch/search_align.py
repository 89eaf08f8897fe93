"""State-level forced alignment search (host exact path).

Reimplements ``src/state_align_search.c``: a linear chain of one 3-state
HMM per phone of the alignment, Viterbi-stepped per frame with optional
per-phone start/end windows from the first pass (prune_hmms :88-106,
phone_transition :108-133), a full per-frame token stack of state
backpointers (record_transitions :149-175), score renormalization when the
best score drops below -0x300000 (:193-197), and the token-stack backtrace
that assigns state start/duration/score (:215-268).

The batched Viterbi on the card is in ops/align_torch.py; this version
is the exact host path of the two-pass decoder protocol (the Decoder's
second pass).  A copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np

from .align import Alignment
from .am import AcousticModel
from .hmm import WORST_SCORE, Hmm


class StateAlignSearch:
    def __init__(self, am: AcousticModel, al: Alignment):
        self.am = am
        self.al = al
        self.n_phones = al.n_phones
        self.n_emit_state = al.n_states
        self.hmms: list[Hmm] = []
        self.sf = np.zeros(self.n_phones, dtype=np.int64)
        self.ef = np.zeros(self.n_phones, dtype=np.int64)
        for i, pent in enumerate(al.phones):
            cipid, ssid, tmatid = pent.id
            self.hmms.append(Hmm(ssid, tmatid, am.mdef.sseq))
            self.sf[i] = pent.start if pent.start > 0 else 0
            if pent.duration > 0:
                self.ef[i] = pent.start + pent.duration
            else:
                self.ef[i] = np.iinfo(np.int64).max
        self.tokens: list[np.ndarray] = []  # per frame: [n_emit_state, 2]
        self.frame = 0
        self.best_score = 0

    def start(self):
        self.hmms[0].enter(0, 0, 0)
        self.frame = 0
        self.best_score = 0

    def active_senones(self) -> set[int]:
        """Senones of HMMs active at the current frame (step's
        acmod_activate_hmm loop, state_align_search.c:186-188)."""
        sens = set()
        for hmm in self.hmms:
            if hmm.frame == self.frame:
                sens.update(hmm.senid)
        return sens

    def step(self, senscr: np.ndarray, frame_idx: int):
        """state_align_search_step (state_align_search.c:177-213)."""
        # Renormalize if needed
        if self.best_score - 0x300000 < WORST_SCORE:
            for hmm in self.hmms:
                hmm.normalize(self.best_score)
        # Viterbi step
        bs = WORST_SCORE
        tmat = self.am.tmat
        for hmm in self.hmms:
            if hmm.frame < frame_idx:
                continue
            score = hmm.vit_eval(senscr, tmat[hmm.tmatid])
            if score > bs:
                bs = score
        self.best_score = bs
        # Prune (window constraints)
        nf = frame_idx + 1
        for i, hmm in enumerate(self.hmms):
            if hmm.frame < frame_idx:
                continue
            if nf > self.ef[i]:
                continue
            hmm.frame = nf
        # Phone transitions
        for i in range(self.n_phones - 1):
            hmm = self.hmms[i]
            if hmm.frame != nf:
                continue
            if nf < self.sf[i + 1]:
                continue
            nhmm = self.hmms[i + 1]
            if nhmm.frame < frame_idx or hmm.out_score > nhmm.score[0]:
                nhmm.enter(hmm.out_score, hmm.out_history, nf)
        # Record tokens (index 0 is the "in" slot, like hmm_history(h,0))
        S = self.am.mdef.n_emit_state
        tok = np.full((self.n_phones * S, 2), -1, dtype=np.int64)
        for i, hmm in enumerate(self.hmms):
            if hmm.frame < frame_idx:
                continue
            for j in range(S):
                idx = i * S + j
                tok[idx, 0] = hmm.history[j]
                tok[idx, 1] = hmm.score[j]
                hmm.history[j] = idx
        self.tokens.append(tok)
        self.frame += 1
        return 0

    def finish(self) -> int:
        """state_align_search_finish (state_align_search.c:215-268)."""
        final = self.hmms[-1]
        last_id = final.out_history
        last_score = final.out_score
        if last_id == -1:
            return -1  # Failed to reach final state
        al = self.al
        last = (last_id, last_score)
        last_frame = self.frame
        cur_frame = self.frame - 2
        while cur_frame >= 0:
            tok = self.tokens[cur_frame]
            cur = (int(tok[last[0], 0]), int(tok[last[0], 1]))
            if cur[0] == -1:
                return -1  # Alignment failed
            if cur[0] != last[0]:
                ent = al.states[last[0]]
                ent.start = cur_frame + 1
                ent.duration = last_frame - ent.start
                ent.score = last[1] - cur[1]
                last = cur
                last_frame = cur_frame + 1
            cur_frame -= 1
        ent = al.states[0]
        ent.start = 0
        ent.duration = last_frame
        al.propagate()
        return 0

    def hyp(self):
        """state_align_search_hyp: words of the alignment."""
        d = self.al.d2p.dict
        words = [d.basestr(w.id) for w in self.al.words if d.real_word(w.id)]
        score = self.al.words[-1].score if self.al.words else 0
        return " ".join(words), score
