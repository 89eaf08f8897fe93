"""Word-level finite-state grammar model.

Reimplements ``src/fsg_model.c``: integer states, weighted word transitions
(``logs2prob`` = logmath_log(p) * lw, unshifted), separate null transitions
with transitive closure (fsg_model.c:151-216), silence/filler self-loops
(:359-390) and alternate-pronunciation duplication (:392-450), and the
Sphinx text FSG file format (FSG_BEGIN/NUM_STATES/.../TRANSITION, :474-696).
"""

from __future__ import annotations

from dataclasses import dataclass

from .logmath import LogMath


@dataclass
class FsgLink:
    from_state: int
    to_state: int
    logs2prob: int
    wid: int  # FSG word id; -1 for null transitions


class FsgModel:
    def __init__(self, name: str | None, lmath: LogMath, lw: float, n_state: int):
        self.name = name
        self.lmath = lmath
        self.lw = float(lw)
        self.n_state = n_state
        self.start_state = 0
        self.final_state = 0
        self.vocab: list[str] = []
        self._word_ids: dict[str, int] = {}
        # trans[from][to] -> list[FsgLink]; null_trans[from][to] -> FsgLink
        self.trans: list[dict[int, list[FsgLink]]] = [dict() for _ in range(n_state)]
        self.null_trans: list[dict[int, FsgLink]] = [dict() for _ in range(n_state)]
        self.silwords: set[int] = set()
        self.altwords: set[int] = set()

    # -- vocabulary --------------------------------------------------------

    def word_id(self, word: str) -> int:
        return self._word_ids.get(word, -1)

    def word_add(self, word: str) -> int:
        wid = self._word_ids.get(word)
        if wid is None:
            wid = len(self.vocab)
            self.vocab.append(word)
            self._word_ids[word] = wid
        return wid

    def word_str(self, wid: int) -> str:
        return self.vocab[wid]

    @property
    def n_word(self) -> int:
        return len(self.vocab)

    def is_filler(self, wid: int) -> bool:
        """fsg_model_is_filler: in silwords bitvec (fsg_model.h)."""
        return wid in self.silwords

    def is_alt(self, wid: int) -> bool:
        return wid in self.altwords

    @property
    def has_sil(self) -> bool:
        return bool(self.silwords)

    @property
    def has_alt(self) -> bool:
        return bool(self.altwords)

    # -- transitions (fsg_model.c:61-144) ----------------------------------

    def trans_add(self, frm: int, to: int, logp: int, wid: int) -> None:
        links = self.trans[frm].setdefault(to, [])
        for link in links:
            if link.wid == wid:
                if link.logs2prob < logp:
                    link.logs2prob = logp
                return
        # glist_add_ptr prepends (matters for in-frame tie order only)
        links.insert(0, FsgLink(frm, to, logp, wid))

    def null_trans_add(self, frm: int, to: int, logp: int) -> int:
        """Returns 1 if new, 0 if updated to higher prob, -1 if redundant."""
        if logp > 0:
            raise ValueError("Null transition prob must be <= 1.0")
        if frm == to:
            return -1
        link = self.null_trans[frm].get(to)
        if link is not None:
            if link.logs2prob < logp:
                link.logs2prob = logp
                return 0
            return -1
        self.null_trans[frm][to] = FsgLink(frm, to, logp, -1)
        return 1

    def null_trans_closure(self) -> None:
        """Transitive closure of null transitions (fsg_model.c:151-216)."""
        nulls = [l for d in self.null_trans for l in d.values()]
        while True:
            updated = False
            for tl1 in list(nulls):
                for tl2 in list(self.null_trans[tl1.to_state].values()):
                    k = self.null_trans_add(
                        tl1.from_state, tl2.to_state,
                        tl1.logs2prob + tl2.logs2prob,
                    )
                    if k >= 0:
                        updated = True
                        if k > 0:
                            nulls.append(self.null_trans[tl1.from_state][tl2.to_state])
            if not updated:
                break

    def arcs(self, state: int):
        """All arcs out of state: word links first, then null links
        (fsg_model_arcs iteration contract, fsg_model.c:248-302)."""
        for links in self.trans[state].values():
            yield from links
        yield from self.null_trans[state].values()

    # -- silence / alternates (fsg_model.c:359-450) ------------------------

    def add_silence(self, silword: str, state: int, silprob: float) -> int:
        silwid = self.word_add(silword)
        logsilp = int(self.lmath.log(silprob) * self.lw)
        self.silwords.add(silwid)
        n = 0
        if state == -1:
            for src in range(self.n_state):
                self.trans_add(src, src, logsilp, silwid)
                n += 1
        else:
            self.trans_add(state, state, logsilp, silwid)
            n += 1
        return n

    def add_alt(self, baseword: str, altword: str) -> int:
        basewid = self.word_id(baseword)
        if basewid < 0:
            return -1
        altwid = self.word_add(altword)
        self.altwords.add(altwid)
        if self.is_filler(basewid):
            self.silwords.add(altwid)
        ntrans = 0
        for i in range(self.n_state):
            for to, links in self.trans[i].items():
                add = []
                for fl in links:
                    if fl.wid == basewid:
                        add.append(FsgLink(fl.from_state, fl.to_state,
                                           fl.logs2prob, altwid))
                        ntrans += 1
                for l in add:
                    links.insert(0, l)
        return ntrans

    # -- text format (fsg_model.c:474-696) ---------------------------------

    @classmethod
    def read_fsg_file(cls, path: str, lmath: LogMath, lw: float) -> "FsgModel":
        with open(path, encoding="utf-8") as fh:
            return cls.read_fsg_string(fh.read(), lmath, lw, name=path)

    @classmethod
    def read_fsg_string(cls, text: str, lmath: LogMath, lw: float,
                        name: str | None = None) -> "FsgModel":
        fsg = None
        n_state = None
        lines = text.splitlines()
        started = False
        fsg_name = name
        nulls = []
        for line in lines:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            kw = toks[0].upper()
            if kw == "FSG_BEGIN":
                started = True
                if len(toks) > 1:
                    fsg_name = toks[1]
            elif kw in ("NUM_STATES", "N"):
                n_state = int(toks[1])
                fsg = cls(fsg_name, lmath, lw, n_state)
            elif kw in ("START_STATE", "S"):
                fsg.start_state = int(toks[1])
            elif kw in ("FINAL_STATE", "F"):
                fsg.final_state = int(toks[1])
            elif kw in ("TRANSITION", "T"):
                frm, to = int(toks[1]), int(toks[2])
                prob = float(toks[3])
                logp = int(lmath.log(prob) * lw)
                if len(toks) > 4:
                    wid = fsg.word_add(toks[4])
                    fsg.trans_add(frm, to, logp, wid)
                else:
                    fsg.null_trans_add(frm, to, logp)
            elif kw == "FSG_END":
                break
        if fsg is None:
            raise ValueError("No NUM_STATES in FSG file")
        if started:
            fsg.null_trans_closure()
        return fsg

    def write_fsg_text(self) -> str:
        out = [f"FSG_BEGIN {self.name or ''}".rstrip()]
        out.append(f"NUM_STATES {self.n_state}")
        out.append(f"START_STATE {self.start_state}")
        out.append(f"FINAL_STATE {self.final_state}")
        for s in range(self.n_state):
            for link in self.arcs(s):
                p = self.lmath.exp(int(link.logs2prob / self.lw)) if self.lw else 0.0
                if link.wid >= 0:
                    out.append(
                        f"TRANSITION {link.from_state} {link.to_state} "
                        f"{p:f} {self.vocab[link.wid]}"
                    )
                else:
                    out.append(
                        f"TRANSITION {link.from_state} {link.to_state} {p:f}"
                    )
        out.append("FSG_END")
        return "\n".join(out) + "\n"
