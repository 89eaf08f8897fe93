"""JSGF grammar compiler: JSGF text -> FsgModel.

Reimplements ``src/jsgf.c`` + the flex/bison grammar
(``jsgf_scanner.l``/``jsgf_parser.y``) as a hand-written tokenizer and
recursive-descent parser with the same semantics:

* alternatives chain in reverse source order (parser.y alternate_list
  builds the chain head at the LAST alternative) - replicated so state
  numbering matches;
* weights ``/w/`` attach to the following atom; an alternative's weight
  is its first atom's, normalized across alternatives (expand_rule,
  jsgf.c:389-404);
* ``(...)`` groups and ``[...]`` optionals become anonymous rules
  ``<grammar.gNNNNN>`` (parser.y rule_group/rule_optional);
* ``*``/``+`` build right-recursive helper rules (jsgf_kleene_new,
  jsgf.c:173-195);
* rule references expand inline with right-recursion allowed
  (expand_rhs, jsgf.c:301-380);
* the FSG gets word transitions with ``logmath_log(weight)`` (NO language
  weight - jsgf_build_fsg_internal, jsgf.c:495-506) and null transitions
  for rule entries/exits, then null closure.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

from .fsg import FsgModel
from .logmath import LogMath


@dataclass
class Atom:
    name: str
    weight: float = 1.0
    tags: list = field(default_factory=list)

    @property
    def is_rule(self) -> bool:
        return self.name.startswith("<")


@dataclass
class Rhs:
    atoms: list  # list[Atom], source order
    alt: "Rhs | None" = None  # chain to the PREVIOUS alternative


@dataclass
class Rule:
    name: str  # fully qualified "<grammar.rule>"
    rhs: Rhs
    is_public: bool
    entry: int = 0
    exit: int = 0


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<rulename><[^<>]+>)
  | (?P<tag>\{(?:\\.|[^}])*\})
  | (?P<weight>/[0-9]*(?:\.[0-9]+)?(?:e-)?[0-9]*/)
  | (?P<qstring>"(?:\\.|[^"])*")
  | (?P<punct>[=;|*+()\[\]])
  | (?P<token>[^ \t\r\n=;|*+<>()\[\]{}/]+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str):
    # strip BOM
    if text.startswith("﻿"):
        text = text[1:]
    pos = 0
    out = []
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            pos += 1  # unmatched stuff is ignored (scanner catch-all)
            continue
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    return out


class Jsgf:
    def __init__(self, name: str | None = None, parent: "Jsgf | None" = None):
        self.name = name
        self.version = None
        self.charset = None
        self.rules: dict[str, Rule] = {}  # insertion-ordered
        self.searchpath: list[str] = ["."]
        self._ngen = 0 if parent is None else parent._ngen
        # expansion state
        self.nstate = 0
        self.links: list = []
        self.rulestack: list = []

    # -- parsing -----------------------------------------------------------

    @classmethod
    def parse_file(cls, path: str) -> "Jsgf":
        # the file's own directory must be searchable BEFORE parsing:
        # imports resolve eagerly during the parse (jsgf_parse_file
        # seeds the search path first, jsgf.c:662-740)
        with open(path, encoding="utf-8") as fh:
            return cls.parse_string(
                fh.read(),
                searchpath=[os.path.dirname(path) or ".", "."])

    @classmethod
    def parse_string(cls, text: str,
                     searchpath: list[str] | None = None) -> "Jsgf":
        g = cls()
        if searchpath is not None:
            g.searchpath = list(searchpath)
        toks = _tokenize(text)
        i = 0

        def expect(kind=None, value=None):
            nonlocal i
            if i >= len(toks):
                raise ValueError("Premature end of JSGF")
            k, v = toks[i]
            if kind and k != kind:
                raise ValueError(f"Expected {kind}, got {k} '{v}'")
            if value and v != value:
                raise ValueError(f"Expected '{value}', got '{v}'")
            i += 1
            return v

        # header: #JSGF [version [charset [locale]]] ;
        if i < len(toks) and toks[i][1].startswith("#JSGF"):
            i += 1
            hdr = []
            while toks[i][1] != ";":
                hdr.append(toks[i][1])
                i += 1
            i += 1  # ';'
            if len(hdr) > 0:
                g.version = hdr[0]
            if len(hdr) > 1:
                g.charset = hdr[1]
        # grammar name
        if i < len(toks) and toks[i][1] == "grammar":
            i += 1
            g.name = expect("token")
            expect(value=";")
        # imports
        while i < len(toks) and toks[i][1] == "import":
            i += 1
            rulename = expect("rulename")
            expect(value=";")
            g.import_rule(rulename)
        # rules
        while i < len(toks):
            is_public = False
            if toks[i][1] == "public":
                is_public = True
                i += 1
            name = expect("rulename")
            expect(value="=")
            rhs, i = g._parse_alternate_list(toks, i)
            expect(value=";")
            g.define_rule(name, rhs, is_public)
        return g

    def _parse_alternate_list(self, toks, i):
        """alternate_list: chain with head at LAST alternative."""
        rhs, i = self._parse_rule_expansion(toks, i)
        while i < len(toks) and toks[i][1] == "|":
            i += 1
            nxt, i = self._parse_rule_expansion(toks, i)
            nxt.alt = rhs
            rhs = nxt
        return rhs, i

    def _parse_rule_expansion(self, toks, i):
        atoms = []
        while i < len(toks):
            k, v = toks[i]
            if v in (";", "|", ")", "]"):
                break
            weight = 1.0
            if k == "weight":
                weight = float(v[1:-1]) if len(v) > 2 else 0.0
                i += 1
                k, v = toks[i]
            if k in ("token", "qstring"):
                atom = Atom(v, weight)
                i += 1
            elif k == "rulename":
                atom = Atom(v, weight)
                i += 1
            elif v == "(":
                i += 1
                inner, i = self._parse_alternate_list(toks, i)
                if toks[i][1] != ")":
                    raise ValueError("Expected )")
                i += 1
                rule = self.define_rule(None, inner, False)
                atom = Atom(rule.name, weight)
            elif v == "[":
                i += 1
                inner, i = self._parse_alternate_list(toks, i)
                if toks[i][1] != "]":
                    raise ValueError("Expected ]")
                i += 1
                rule = self._optional_new(inner)
                atom = Atom(rule.name, weight)
            elif k == "tag":
                if atoms:
                    atoms[-1].tags.append(v)
                i += 1
                continue
            else:
                raise ValueError(f"Unexpected token {k} '{v}'")
            # kleene star / plus postfix
            while i < len(toks) and toks[i][1] in ("*", "+"):
                atom = self._kleene_new(atom, toks[i][1] == "+")
                i += 1
            atoms.append(atom)
        if not atoms:
            raise ValueError("Empty rule expansion")
        return Rhs(atoms), i

    # -- rule management (jsgf.c:604-660) ----------------------------------

    def _fullname(self, name: str) -> str:
        # "<rule>" -> "<grammar.rule>"
        if "." in name[1:-1]:
            return name
        return f"<{self.name}.{name[1:]}"

    def define_rule(self, name: str | None, rhs: Rhs, is_public: bool) -> Rule:
        if name is None:
            name = f"<{self.name}.g{len(self.rules):05d}>"
        else:
            name = self._fullname(name)
        rule = Rule(name, rhs, is_public)
        self.rules[name] = rule
        return rule

    def _kleene_new(self, atom: Atom, plus: bool) -> Atom:
        """jsgf_kleene_new (jsgf.c:173-195)."""
        if plus:
            rhs1 = Rhs([Atom(atom.name, 1.0)])
        else:
            rhs1 = Rhs([Atom("<NULL>", 1.0)])
        rule = self.define_rule(None, rhs1, False)
        rhs2 = Rhs([atom, Atom(rule.name, 1.0)])
        rule.rhs.alt = rhs2
        return Atom(rule.name, 1.0)

    def _optional_new(self, exp: Rhs) -> Rule:
        """jsgf_optional_new (jsgf.c:197-205)."""
        rhs = Rhs([Atom("<NULL>", 1.0)])
        rhs.alt = exp
        return self.define_rule(None, rhs, False)

    def import_rule(self, rulename: str) -> None:
        """jsgf_import_rule (jsgf.c:662-740): parse the referenced grammar
        file and copy its public rules (or the named rule)."""
        # rulename like <com.example.grammar.rulename> or <grammar.*>
        inner = rulename[1:-1]
        last_dot = inner.rfind(".")
        grammar_name = inner[:last_dot]
        target = inner[last_dot + 1:]
        path = grammar_name.replace(".", os.sep) + ".gram"
        for root in self.searchpath:
            full = os.path.join(root, path)
            if os.path.exists(full):
                imported = Jsgf.parse_file(full)
                for rname, rule in imported.rules.items():
                    if not rule.is_public:
                        continue
                    short = rname[1:-1].split(".")[-1]
                    if target in ("*",) or short == target:
                        self.rules[rname] = rule
                return
        raise FileNotFoundError(f"Failed to import {rulename}")

    def get_rule(self, name: str) -> Rule | None:
        """jsgf_get_rule (jsgf.c:429-442): name without <>."""
        return self.rules.get(f"<{name}>")

    def default_rule(self) -> Rule | None:
        """jsgf_get_public_rule (jsgf.c:444-469): first public rule of this
        grammar (definition order; the C uses hash order)."""
        for rule in self.rules.values():
            if rule.is_public:
                inner = rule.name[1:-1]
                dot = inner.rfind(".")
                if dot < 0 or inner[:dot] == self.name:
                    return rule
        return None

    # -- expansion to FSG (jsgf.c:301-506) ---------------------------------

    def _expand_rhs(self, rule: Rule, rhs: Rhs):
        lastnode = rule.entry
        for gi, atom in enumerate(rhs.atoms):
            if atom.is_rule:
                if atom.name == "<NULL>":
                    self.links.append((atom, lastnode, self.nstate))
                    lastnode = self.nstate
                    self.nstate += 1
                    continue
                if atom.name == "<VOID>":
                    return -1
                fullname = self._fullname_from_rule(rule, atom.name)
                subrule = self.rules.get(fullname)
                if subrule is None:
                    raise ValueError(f"Undefined rule in RHS: {fullname}")
                if subrule in self.rulestack:
                    if gi != len(rhs.atoms) - 1:
                        raise ValueError(
                            f"Only right-recursion is permitted (in {rule.name})")
                    self.links.append((atom, lastnode, subrule.entry))
                    return "recursion"
                if self._expand_rule(subrule) == -1:
                    return -1
                self.links.append((atom, lastnode, subrule.entry))
                lastnode = subrule.exit
            else:
                self.links.append((atom, lastnode, self.nstate))
                lastnode = self.nstate
                self.nstate += 1
        return lastnode

    def _fullname_from_rule(self, rule: Rule, name: str) -> str:
        if "." in name[1:-1]:
            return name
        inner = rule.name[1:-1]
        dot = inner.rfind(".")
        if dot < 0:
            return name
        return f"<{inner[:dot]}.{name[1:]}"

    def _expand_rule(self, rule: Rule):
        """expand_rule (jsgf.c:383-425)."""
        self.rulestack.append(rule)
        norm = 0.0
        r = rule.rhs
        while r is not None:
            if r.atoms:
                norm += r.atoms[0].weight
            r = r.alt
        rule.entry = self.nstate
        self.nstate += 1
        rule.exit = self.nstate
        self.nstate += 1
        if norm == 0:
            norm = 1
        r = rule.rhs
        while r is not None:
            if r.atoms:
                r.atoms[0].weight /= norm
            lastnode = self._expand_rhs(rule, r)
            if lastnode == -1:
                return -1
            elif lastnode == "recursion":
                pass
            else:
                self.links.append((None, lastnode, rule.exit))
            r = r.alt
        self.rulestack.pop()
        return rule.exit

    def build_fsg(self, rule: Rule, lmath: LogMath, lw: float) -> FsgModel:
        """jsgf_build_fsg (jsgf.c:483-540): expand + null closure."""
        self.links = []
        self.rulestack = []
        self.nstate = 0
        rule.entry = rule.exit = 0
        self._expand_rule(rule)
        fsg = FsgModel(rule.name, lmath, lw, self.nstate)
        fsg.start_state = rule.entry
        fsg.final_state = rule.exit
        for atom, frm, to in self.links:
            if atom is not None:
                if atom.is_rule:
                    fsg.null_trans_add(frm, to, lmath.log(atom.weight))
                else:
                    wid = fsg.word_add(atom.name)
                    fsg.trans_add(frm, to, lmath.log(atom.weight), wid)
            else:
                fsg.null_trans_add(frm, to, 0)
        fsg.null_trans_closure()
        return fsg
