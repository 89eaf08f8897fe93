"""Per-HMM Viterbi step (host exact path).

Reimplements the reference's hand-unrolled 3-state left-to-right topology
with optional skip transitions (``hmm_vit_eval_3st_lr``, src/hmm.c:482-567)
using Python integers (the C int32 never overflows by design:
WORST_SCORE = 0xE0000000 is chosen so 4x WORST_SCORE > INT32_MIN,
hmm.h:74-80).

Senone scores come in as the decoder's non-negative int16 convention and
are *negated* at use (hmm_senscr macro, hmm.h:208-210).  Transition probs
are negated quantized uint8 (tmat.py), used as ``-tp[i][j]``
(hmm.h:211).
"""

from __future__ import annotations

WORST_SCORE = -0x20000000  # (int)0xE0000000
TMAT_WORST_SCORE = -255


class Hmm:
    """3/5-state left-to-right HMM instance (hmm_t, hmm.h:100-133)."""

    __slots__ = ("ssid", "tmatid", "senid", "score", "history",
                 "out_score", "out_history", "bestscore", "frame",
                 "n_emit_state")

    def __init__(self, ssid: int, tmatid: int, sseq):
        self.ssid = ssid
        self.tmatid = tmatid
        self.senid = [int(s) for s in sseq[ssid]]
        self.n_emit_state = len(self.senid)
        self.clear()

    def clear(self):
        """hmm_clear (hmm.c:121-135)."""
        n = self.n_emit_state
        self.score = [WORST_SCORE] * n  # in, s1, ..., s_{n-1}
        self.history = [-1] * n
        self.out_score = WORST_SCORE
        self.out_history = -1
        self.bestscore = WORST_SCORE
        self.frame = -1

    def vit_eval(self, senscore, tp_row) -> int:
        """hmm_vit_eval dispatch (hmm.c:741-759), non-multiplex."""
        if self.n_emit_state == 5:
            return self.vit_eval_5st(senscore, tp_row)
        if self.n_emit_state == 3:
            return self.vit_eval_3st(senscore, tp_row)
        return self.vit_eval_anytopo(senscore, tp_row)

    def vit_eval_5st(self, senscore, tp_row) -> int:
        """hmm_vit_eval_5st_lr (hmm.c:166-305)."""
        senid = self.senid
        sc = self.score
        hist = self.history

        def tprob(i, j):
            return -int(tp_row[i, j])

        best = WORST_SCORE
        s4 = sc[4] + -int(senscore[senid[4]])
        s3 = sc[3] + -int(senscore[senid[3]])
        if s3 > WORST_SCORE:
            t1 = s4 + tprob(4, 5)
            t2 = s3 + tprob(3, 5)
            if t1 > t2:
                s5 = t1
                self.out_history = hist[4]
            else:
                s5 = t2
                self.out_history = hist[3]
            s5 = max(s5, WORST_SCORE)
            self.out_score = s5
            best = s5
        s2 = sc[2] + -int(senscore[senid[2]])
        if s2 > WORST_SCORE:
            t0 = s4 + tprob(4, 4)
            t1 = s3 + tprob(3, 4)
            t2 = s2 + tprob(2, 4)
            if t0 > t1:
                if t2 > t0:
                    s4 = t2
                    hist[4] = hist[2]
                else:
                    s4 = t0
            else:
                if t2 > t1:
                    s4 = t2
                    hist[4] = hist[2]
                else:
                    s4 = t1
                    hist[4] = hist[3]
            s4 = max(s4, WORST_SCORE)
            best = max(best, s4)
            sc[4] = s4
        s1 = sc[1] + -int(senscore[senid[1]])
        if s1 > WORST_SCORE:
            t0 = s3 + tprob(3, 3)
            t1 = s2 + tprob(2, 3)
            t2 = s1 + tprob(1, 3)
            if t0 > t1:
                if t2 > t0:
                    s3 = t2
                    hist[3] = hist[1]
                else:
                    s3 = t0
            else:
                if t2 > t1:
                    s3 = t2
                    hist[3] = hist[1]
                else:
                    s3 = t1
                    hist[3] = hist[2]
            s3 = max(s3, WORST_SCORE)
            best = max(best, s3)
            sc[3] = s3
        s0 = sc[0] + -int(senscore[senid[0]])
        t0 = s2 + tprob(2, 2)
        t1 = s1 + tprob(1, 2)
        t2 = s0 + tprob(0, 2)
        if t0 > t1:
            if t2 > t0:
                s2 = t2
                hist[2] = hist[0]
            else:
                s2 = t0
        else:
            if t2 > t1:
                s2 = t2
                hist[2] = hist[0]
            else:
                s2 = t1
                hist[2] = hist[1]
        s2 = max(s2, WORST_SCORE)
        best = max(best, s2)
        sc[2] = s2
        t0 = s1 + tprob(1, 1)
        t1 = s0 + tprob(0, 1)
        if t0 > t1:
            s1 = t0
        else:
            s1 = t1
            hist[1] = hist[0]
        s1 = max(s1, WORST_SCORE)
        best = max(best, s1)
        sc[1] = s1
        s0 = max(s0 + tprob(0, 0), WORST_SCORE)
        best = max(best, s0)
        sc[0] = s0
        self.bestscore = best
        return best

    def vit_eval_anytopo(self, senscore, tp_row) -> int:
        """hmm_vit_eval_anytopo (hmm.c:671-739): arbitrary upper-
        triangular topology."""
        n = self.n_emit_state
        sc = self.score
        hist = self.history

        def tprob(i, j):
            return -int(tp_row[i, j])

        st = [0] * n
        st[0] = sc[0] + -int(senscore[self.senid[0]])
        for i in range(1, n):
            v = sc[i] + -int(senscore[self.senid[i]])
            st[i] = v if v > WORST_SCORE else WORST_SCORE
        # final (non-emitting) state
        scr = WORST_SCORE
        bestfrom = -1
        for frm in range(n - 1, -1, -1):
            if tprob(frm, n) > TMAT_WORST_SCORE:
                new = st[frm] + tprob(frm, n)
                if new > scr:
                    scr = new
                    bestfrom = frm
        self.out_score = scr
        if bestfrom >= 0:
            self.out_history = hist[bestfrom]
        bestscr = scr
        newsc = list(sc)
        newhist = list(hist)
        for to in range(n - 1, -1, -1):
            scr = st[to] + tprob(to, to) if tprob(to, to) > TMAT_WORST_SCORE \
                else WORST_SCORE
            bestfrom = -1
            for frm in range(to - 1, -1, -1):
                if tprob(frm, to) > TMAT_WORST_SCORE:
                    new = st[frm] + tprob(frm, to)
                    if new > scr:
                        scr = new
                        bestfrom = frm
            newsc[to] = scr
            if bestfrom >= 0:
                newhist[to] = hist[bestfrom]
            if scr > bestscr:
                bestscr = scr
        sc[:] = newsc
        hist[:] = newhist
        self.bestscore = bestscr
        return bestscr

    def enter(self, score: int, histid: int, frame: int):
        """hmm_enter (hmm.c:137-143)."""
        self.score[0] = score
        self.history[0] = histid
        self.frame = frame

    def normalize(self, bestscr: int):
        """hmm_normalize (hmm.c:145-156)."""
        for i in range(self.n_emit_state):
            if self.score[i] > WORST_SCORE:
                self.score[i] -= bestscr

    def vit_eval_3st(self, senscore, tp_row) -> int:
        """hmm_vit_eval_3st_lr (hmm.c:482-567).

        senscore: int16 array indexed by senone id (non-negative scores).
        tp_row: uint8 [3, 4] quantized negated transition probs.
        Returns the best score; updates scores/histories in place.
        """
        senid = self.senid
        sc = self.score
        hist = self.history

        def tprob(i, j):
            return -int(tp_row[i, j])

        s2 = sc[2] + -int(senscore[senid[2]])
        s1 = sc[1] + -int(senscore[senid[1]])
        s0 = sc[0] + -int(senscore[senid[0]])

        best = WORST_SCORE
        # NB: the C code initializes t2 = INT_MIN *once* (hmm.c:497) and the
        # state-2 block reuses whatever t2 holds if the 0->2 skip transition
        # is absent -- including a stale value from the state-3 block.  We
        # replicate that data flow exactly.
        t2 = -2147483648

        # Transitions into non-emitting state 3
        if s1 > WORST_SCORE:
            t1 = s2 + tprob(2, 3)
            if tprob(1, 3) > TMAT_WORST_SCORE:
                t2 = s1 + tprob(1, 3)
            if t1 > t2:
                s3 = t1
                self.out_history = hist[2]
            else:
                s3 = t2
                self.out_history = hist[1]
            if s3 < WORST_SCORE:
                s3 = WORST_SCORE
            self.out_score = s3
            best = s3

        # Transitions into state 2
        t0 = s2 + tprob(2, 2)
        t1 = s1 + tprob(1, 2)
        if tprob(0, 2) > TMAT_WORST_SCORE:
            t2 = s0 + tprob(0, 2)
        if t0 > t1:
            if t2 > t0:
                ns2 = t2
                hist[2] = hist[0]
            else:
                ns2 = t0
        else:
            if t2 > t1:
                ns2 = t2
                hist[2] = hist[0]
            else:
                ns2 = t1
                hist[2] = hist[1]
        if ns2 < WORST_SCORE:
            ns2 = WORST_SCORE
        if ns2 > best:
            best = ns2
        sc[2] = ns2

        # Transitions into state 1
        t0 = s1 + tprob(1, 1)
        t1 = s0 + tprob(0, 1)
        if t0 > t1:
            ns1 = t0
        else:
            ns1 = t1
            hist[1] = hist[0]
        if ns1 < WORST_SCORE:
            ns1 = WORST_SCORE
        if ns1 > best:
            best = ns1
        sc[1] = ns1

        # Self-transition into state 0
        ns0 = s0 + tprob(0, 0)
        if ns0 < WORST_SCORE:
            ns0 = WORST_SCORE
        if ns0 > best:
            best = ns0
        sc[0] = ns0

        self.bestscore = best
        return best
