"""Frozen copy of ``soundswallower_tpu_torch/dict2pid.py``
for the benchmark's reference (see ``__init__``).

Cross-word triphone tables (dict2pid).

Reimplements ``src/dict2pid.c`` (dict2pid_build at :376-470,
compress_table at :47-80, populate_lrdiph at :255-287):

* ``ldiph_lc[b][r][l]``  - ssid of word-initial triphone b(l,r) (BEGIN pos)
* ``lrdiph_rc[b][l][r]`` - ssid of single-phone-word triphone b(l,r) (SINGLE)
* ``rssid[b][l]``        - compressed right-context table for word-final
  phone b with left ctx l: unique ssids + cimap from rc -> compressed index
* ``lrssid[b][l]``       - same compression of lrdiph_rc for single-phone
  word right contexts
* ``dict2pid_internal(w, pos)`` - word-internal triphone ssid

Tables are only filled for (phone, context) pairs that actually occur in the
dictionary, exactly like the reference (anything else stays BAD_SSID and
would indicate a bug if consulted).
"""

from __future__ import annotations

import numpy as np

from .dictionary import Dictionary
from .mdef import (
    BAD_SSID,
    BinMdef,
    WORD_POSN_BEGIN,
    WORD_POSN_END,
    WORD_POSN_INTERNAL,
    WORD_POSN_SINGLE,
)

BAD_S3CIPID = -1


class Xwdssid:
    """Compressed cross-word ssid table (dict2pid.h:73-89 xwdssid_t)."""

    __slots__ = ("ssid", "cimap", "n_ssid")

    def __init__(self, ssid: np.ndarray, cimap: np.ndarray, n_ssid: int):
        self.ssid = ssid
        self.cimap = cimap
        self.n_ssid = n_ssid


def compress_table(uncomp: np.ndarray, n_ci: int) -> Xwdssid:
    """compress_table (dict2pid.c:47-80): dedup ssids, build rc->index map."""
    com = np.full(n_ci, BAD_SSID, dtype=np.uint16)
    cimap = np.full(n_ci, BAD_S3CIPID, dtype=np.int16)
    n = 0
    for r in range(n_ci):
        found = False
        for t in range(n):
            if uncomp[r] == com[t]:
                cimap[r] = t
                found = True
                break
        if not found:
            com[n] = uncomp[r]
            cimap[r] = n
            n += 1
    return Xwdssid(com[:n].copy(), cimap, n)


class Dict2Pid:
    def __init__(self, mdef: BinMdef, dictionary: Dictionary):
        self.mdef = mdef
        self.dict = dictionary
        n_ci = mdef.n_ciphone
        self.ldiph_lc = np.full((n_ci, n_ci, n_ci), BAD_SSID, dtype=np.uint16)
        self.lrdiph_rc = np.full((n_ci, n_ci, n_ci), BAD_SSID, dtype=np.uint16)
        # rssid[b][l] and lrssid[b][l] dicts keyed by (b, l)
        self.rssid: dict[tuple[int, int], Xwdssid] = {}
        self.lrssid: dict[tuple[int, int], Xwdssid] = {}

        rdiph_rc = np.full((n_ci, n_ci, n_ci), BAD_SSID, dtype=np.uint16)
        ldiph_done = np.zeros((n_ci, n_ci), dtype=bool)
        rdiph_done = np.zeros((n_ci, n_ci), dtype=bool)
        single_done = np.zeros(n_ci, dtype=bool)

        d = dictionary
        for w in range(d.size()):
            pron = d.prons[w]
            if len(pron) >= 2:
                b, r = pron[0], pron[1]
                if not ldiph_done[b, r]:
                    ldiph_done[b, r] = True
                    for l in range(n_ci):
                        p = mdef.phone_id_nearest(b, l, r, WORD_POSN_BEGIN)
                        self.ldiph_lc[b, r, l] = mdef.pid2ssid(p)
                l, b = pron[-2], pron[-1]
                if not rdiph_done[b, l]:
                    rdiph_done[b, l] = True
                    for r in range(n_ci):
                        p = mdef.phone_id_nearest(b, l, r, WORD_POSN_END)
                        rdiph_rc[b, l, r] = mdef.pid2ssid(p)
            elif len(pron) == 1:
                b = pron[0]
                if not single_done[b]:
                    single_done[b] = True
                    self._populate_lrdiph(b, rdiph_rc)

        # Compress rdiph_rc into rssid for seen (b, l) pairs
        # (dict2pid.c:472-500 scans all pairs; we keep only the filled ones).
        for b in range(n_ci):
            for l in range(n_ci):
                if rdiph_rc[b, l, 0] != BAD_SSID:
                    self.rssid[(b, l)] = compress_table(rdiph_rc[b, l], n_ci)
        # Compress lrdiph_rc into lrssid (compress_left_right_context_tree,
        # dict2pid.c:133-190).
        for b in range(n_ci):
            for l in range(n_ci):
                if self.lrdiph_rc[b, l, 0] != BAD_SSID:
                    self.lrssid[(b, l)] = compress_table(self.lrdiph_rc[b, l], n_ci)

    def _populate_lrdiph(self, b: int, rdiph_rc: np.ndarray | None) -> None:
        """populate_lrdiph (dict2pid.c:255-287)."""
        mdef = self.mdef
        n_ci = mdef.n_ciphone
        sil = mdef.silphone
        for l in range(n_ci):
            for r in range(n_ci):
                p = mdef.phone_id_nearest(b, l, r, WORD_POSN_SINGLE)
                ssid = mdef.pid2ssid(p)
                self.lrdiph_rc[b, l, r] = ssid
                if r == sil:
                    self.ldiph_lc[b, r, l] = ssid
                if rdiph_rc is not None and l == sil:
                    rdiph_rc[b, l, r] = ssid

    # -- runtime additions (dict2pid_add_word, dict2pid.c:289-352) ---------

    def add_word(self, wid: int) -> None:
        d, mdef = self.dict, self.mdef
        n_ci = mdef.n_ciphone
        pron = d.prons[wid]
        if len(pron) > 1:
            b, r = pron[0], pron[1]
            if self.ldiph_lc[b, r, 0] == BAD_SSID:
                for l in range(n_ci):
                    p = mdef.phone_id_nearest(b, l, r, WORD_POSN_BEGIN)
                    self.ldiph_lc[b, r, l] = mdef.pid2ssid(p)
            b, l = pron[-1], pron[-2]
            if (b, l) not in self.rssid:
                rmap = np.empty(n_ci, dtype=np.uint16)
                for r in range(n_ci):
                    p = mdef.phone_id_nearest(b, l, r, WORD_POSN_END)
                    rmap[r] = mdef.pid2ssid(p)
                self.rssid[(b, l)] = compress_table(rmap, n_ci)
        else:
            b = pron[0]
            if self.lrdiph_rc[b, 0, 0] == BAD_SSID:
                self._populate_lrdiph(b, None)
                for l in range(n_ci):
                    self.lrssid[(b, l)] = compress_table(self.lrdiph_rc[b, l], n_ci)

    # -- queries -----------------------------------------------------------

    def internal(self, wid: int, pos: int) -> int:
        """dict2pid_internal (dict2pid.c:354-374)."""
        d, mdef = self.dict, self.mdef
        pron = d.prons[wid]
        if pos == 0 or pos >= len(pron):
            return BAD_SSID
        b, l, r = pron[pos], pron[pos - 1], pron[pos + 1] if pos + 1 < len(pron) else None
        if r is None:
            return BAD_SSID
        p = mdef.phone_id_nearest(b, l, r, WORD_POSN_INTERNAL)
        return mdef.pid2ssid(p)

    def get_rssid(self, b: int, l: int) -> Xwdssid:
        return self.rssid[(b, l)]

    def get_lrssid(self, b: int, l: int) -> Xwdssid:
        return self.lrssid[(b, l)]
