"""Frozen copy of ``soundswallower_tpu_torch/dictionary.py``
for the benchmark's reference (see ``__init__``).

Pronunciation dictionary (main + filler).

Reimplements ``src/dict.c``: text parsing (dict_read_s3file, dict.c:165-236),
alternate pronunciations via the ``word(2)`` convention (dict_word2basestr,
dict.c:401-418), filler ranges and the special words ``<s>``, ``</s>``,
``<sil>`` (dict_init_s3file, dict.c:241-355).

Note on case: mirroring the reference, lookups are case-sensitive unless
``dictcase`` is true (the reference's ``d->nocase`` flag feeds
``hash_table_new`` whose HASH_CASE_YES==0 means case-*sensitive*; the
config help string is misleading, the behavior is what we copy).
"""

from __future__ import annotations

from .mdef import BinMdef

BAD_S3WID = -1
S3_START_WORD = "<s>"
S3_FINISH_WORD = "</s>"
S3_SILENCE_WORD = "<sil>"


def word2basestr(word: str) -> str | None:
    """Strip a ``(n)`` alternate suffix; None if not an alternate form."""
    if word.endswith(")"):
        i = word.rfind("(", 0, len(word) - 1)
        if i > 0:
            return word[:i]
    return None


class Dictionary:
    """Word -> CI phone-id pronunciations with filler segregation."""

    def __init__(
        self,
        mdef: BinMdef,
        dict_path: str | None = None,
        fdict_path: str | None = None,
        dictcase: bool = False,
    ):
        self.mdef = mdef
        self.nocase = dictcase  # see module docstring
        self.words: list[str] = []
        self.prons: list[list[int]] = []
        self.basewid: list[int] = []
        self.alt: list[int] = []  # next alternate in chain, -1 at end
        self._ht: dict[str, int] = {}

        if dict_path:
            self._read_file(dict_path)
        for w in (S3_START_WORD, S3_FINISH_WORD, S3_SILENCE_WORD):
            if self.wordid(w) != BAD_S3WID:
                raise ValueError(
                    f"Remove special word '{w}' from the main dictionary"
                )
        self.filler_start = len(self.words)
        if fdict_path:
            self._read_file(fdict_path)
        sil = mdef.silphone if mdef is not None else 0
        for w in (S3_START_WORD, S3_FINISH_WORD, S3_SILENCE_WORD):
            if self.wordid(w) == BAD_S3WID:
                self.add_word(w, [sil])
        self.filler_end = len(self.words) - 1
        self.startwid = self.wordid(S3_START_WORD)
        self.finishwid = self.wordid(S3_FINISH_WORD)
        self.silwid = self.wordid(S3_SILENCE_WORD)
        if self.filler_start > self.filler_end or not self.filler_word(self.silwid):
            raise ValueError("'<sil>' must occur (only) in filler dictionary")

    # -- construction ------------------------------------------------------

    def _key(self, word: str) -> str:
        return word.lower() if self.nocase else word

    def _read_file(self, path: str) -> None:
        with open(path, "rb") as fh:
            for raw in fh:
                line = raw.decode("utf-8", "replace")
                if line.startswith("##") or line.startswith(";;"):
                    continue
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 1:
                    continue  # no pronunciation; ignored with error in C
                word = parts[0]
                pron = []
                ok = True
                for ph in parts[1:]:
                    pid = self.mdef.ciphone_id(ph)
                    if pid < 0:
                        ok = False  # phone missing; word ignored
                        break
                    pron.append(pid)
                if ok:
                    self.add_word(word, pron)

    def add_word(self, word: str, pron: list[int]) -> int:
        """dict_add_word (dict.c:71-135): returns new wid or BAD_S3WID."""
        base = word2basestr(word)
        if base is not None:
            w = self._ht.get(self._key(base))
            if w is None:
                return BAD_S3WID  # missing base word
            basewid = w
            alt = self.alt[w]
            self.alt[w] = len(self.words)
            # the new entry takes over the head of the base's alt chain
            new_alt = alt
        else:
            basewid = len(self.words)
            new_alt = BAD_S3WID
        key = self._key(word)
        if key in self._ht:
            return BAD_S3WID  # duplicate
        wid = len(self.words)
        self._ht[key] = wid
        self.words.append(word)
        self.prons.append(list(pron))
        self.basewid.append(basewid)
        self.alt.append(new_alt)
        return wid

    # -- queries (dict.h accessors) ---------------------------------------

    def wordid(self, word: str) -> int:
        return self._ht.get(self._key(word), BAD_S3WID)

    def wordstr(self, wid: int) -> str:
        return self.words[wid]

    def basestr(self, wid: int) -> str:
        return self.words[self.basewid[wid]]

    def basewid_of(self, wid: int) -> int:
        return self.basewid[wid]

    def nextalt(self, wid: int) -> int:
        """dict_nextalt: next alternative pronunciation of wid's base."""
        return self.alt[wid]

    def pronlen(self, wid: int) -> int:
        return len(self.prons[wid])

    def pron(self, wid: int, pos: int) -> int:
        return self.prons[wid][pos]

    def first_phone(self, wid: int) -> int:
        return self.prons[wid][0]

    def second_phone(self, wid: int) -> int:
        return self.prons[wid][1]

    def last_phone(self, wid: int) -> int:
        return self.prons[wid][-1]

    def second_last_phone(self, wid: int) -> int:
        return self.prons[wid][-2]

    def is_single_phone(self, wid: int) -> bool:
        return len(self.prons[wid]) == 1

    def size(self) -> int:
        return len(self.words)

    def filler_word(self, wid: int) -> bool:
        """dict_filler_word (dict.c:372-384)."""
        w = self.basewid[wid]
        if w in (self.startwid, self.finishwid):
            return True
        return self.filler_start <= w <= self.filler_end

    def real_word(self, wid: int) -> bool:
        """dict_real_word (dict.c:386-399)."""
        w = self.basewid[wid]
        if w in (self.startwid, self.finishwid):
            return False
        return not (self.filler_start <= w <= self.filler_end)
