"""GBNF grammar-constrained sampling for backbone-token samplers.

Reference behavior: common/tts_runner.h:64-73 + llama.cpp's llama-grammar —
a GBNF grammar attached to the sampler that picks BACKBONE tokens (cb0-from-
backbone / text warmup); it never applies to codec_lm audio-codebook heads.
A parse failure surfaces as a clean error (GbnfError), not a crash.

Supported GBNF subset (covers the reference's shipped grammars, including
tts_auto_grammar's output — common/audio_lm.cpp:1164):
  rule ::= alternates           alternates:  seq ("|" seq)*
  seq elements: "literal", [char-classes] with ranges and ^negation,
                rule references, ( groups ), postfix * + ?,
                escape sequences \\n \\r \\t \\\\ \\" \\[ \\] \\x## inside
                literals/classes
  comments: '#' to end of line

Matching is the llama.cpp pushdown algorithm: a grammar state is a set of
stacks of pending element frames; accepting a character advances every
stack whose top matches and kills the rest; a token is viable if at least
one stack survives all its characters. Sampling mirrors llama.cpp's
`grammar_first=false` fast path: sample unconstrained, check the winner
against the grammar, and only on rejection compute the full token mask and
resample — the O(V·len) mask walk happens only when the base sampler
strays.

A copy of codec_tpu/lm/gbnf.py (pure Python and NumPy), kept here because
importing codec_tpu imports JAX, with two fixes at the end of the text:
codec_tpu's parser loops forever on a rule name that ends the text (`x`)
and reads the end as a dangling quantifier (`root ::= "a"` without a
trailing newline raises); here both parse as they would with a newline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class GbnfError(ValueError):
    pass


# --- grammar IR -------------------------------------------------------------
# Element kinds: ("char", ((lo, hi), ...), negated) | ("ref", rule_name)
# An alternate is a tuple of elements; a rule is a list of alternates.
# Repetition is rewritten into synthetic rules at parse time (like
# llama.cpp): e* -> R where R ::= e R | ε ; e+ -> e R ; e? -> R' ::= e | ε.


@dataclass
class Grammar:
    rules: Dict[str, List[Tuple]]
    root: str = "root"


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: Dict[str, List[Tuple]] = {}
        self.synth = 0

    def error(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        raise GbnfError(f"GBNF parse error at line {line}: {msg}")

    def _ws(self, newlines: bool = False):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        # (_peek() is "" at the end, which `in` finds in any string:
        # codec_tpu's copy loops forever on a name that ends the text)
        while self._peek() and (self._peek().isalnum()
                                or self._peek() in "-_"):
            self.pos += 1
        if start == self.pos:
            self.error("expected rule name")
        return self.text[start:self.pos]

    def _escape(self) -> str:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return c
        e = self.text[self.pos]
        self.pos += 1
        table = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", '"': '"',
                 "[": "[", "]": "]"}
        if e in table:
            return table[e]
        if e == "x":
            h = self.text[self.pos:self.pos + 2]
            self.pos += 2
            return chr(int(h, 16))
        self.error(f"bad escape \\{e}")

    def _char_class(self) -> Tuple:
        assert self.text[self.pos] == "["
        self.pos += 1
        neg = False
        if self._peek() == "^":
            neg = True
            self.pos += 1
        ranges: List[Tuple[int, int]] = []
        while self._peek() != "]":
            if self.pos >= len(self.text):
                self.error("unterminated char class")
            lo = self._escape()
            hi = lo
            if self._peek() == "-" and self.text[self.pos + 1] != "]":
                self.pos += 1
                hi = self._escape()
            ranges.append((ord(lo), ord(hi)))
        self.pos += 1
        if not ranges:
            self.error("empty char class")
        return ("char", tuple(ranges), neg)

    def _literal(self) -> List[Tuple]:
        assert self.text[self.pos] == '"'
        self.pos += 1
        out = []
        while self._peek() != '"':
            if self.pos >= len(self.text):
                self.error("unterminated literal")
            ch = self._escape()
            out.append(("char", ((ord(ch), ord(ch)),), False))
        self.pos += 1
        return out

    def _new_rule(self, alts: List[Tuple]) -> str:
        name = f"__synth_{self.synth}"
        self.synth += 1
        self.rules[name] = alts
        return name

    def _apply_rep(self, elems: List[Tuple], op: str) -> List[Tuple]:
        """elems is the last parsed element group; wrap per the postfix op."""
        if op == "?":
            r = self._new_rule([tuple(elems), ()])
            return [("ref", r)]
        # e* -> R ::= e... R | ε ;  e+ -> e... R
        rname = f"__synth_{self.synth}"
        self.synth += 1
        self.rules[rname] = [tuple(list(elems) + [("ref", rname)]), ()]
        if op == "*":
            return [("ref", rname)]
        return list(elems) + [("ref", rname)]

    def _sequence(self) -> Tuple:
        elems: List[Tuple] = []
        last_group: Optional[List[Tuple]] = None
        while True:
            self._ws()
            c = self._peek()
            if c == '"':
                group = self._literal()
            elif c == "[":
                group = [self._char_class()]
            elif c == "(":
                self.pos += 1
                alts = self._alternates()
                self._ws(newlines=True)
                if self._peek() != ")":
                    self.error("expected )")
                self.pos += 1
                group = [("ref", self._new_rule(alts))]
            elif c.isalpha() or c == "_":
                group = [("ref", self._name())]
            elif c and c in "*+?":        # not the end of the text
                if last_group is None:
                    self.error(f"dangling {c}")
                self.pos += 1
                n = len(last_group)
                elems = elems[:-n] + self._apply_rep(last_group, c)
                last_group = None
                continue
            else:
                break
            elems.extend(group)
            # repetition binds to the single preceding element (or group)
            last_group = group if c in "([" or c == "(" else group[-1:]
            if c == '"':
                last_group = group  # "abc"* repeats the whole literal
        return tuple(elems)

    def _alternates(self) -> List[Tuple]:
        alts = [self._sequence()]
        while True:
            self._ws()
            if self._peek() == "|":
                self.pos += 1
                alts.append(self._sequence())
            else:
                return alts

    def parse(self) -> Grammar:
        while True:
            self._ws(newlines=True)
            if self.pos >= len(self.text):
                break
            name = self._name()
            self._ws()
            if self.text[self.pos:self.pos + 3] != "::=":
                self.error(f"expected ::= after {name!r}")
            self.pos += 3
            alts = self._alternates()
            self._ws()
            if self._peek() and self._peek() not in "\r\n":
                self.error(f"unexpected {self._peek()!r}")
            self.rules[name] = alts
        if "root" not in self.rules:
            raise GbnfError("grammar has no root rule")
        for alts in list(self.rules.values()):
            for alt in alts:
                for el in alt:
                    if el[0] == "ref" and el[1] not in self.rules:
                        raise GbnfError(f"undefined rule {el[1]!r}")
        return Grammar(self.rules)


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()


# --- pushdown matching ------------------------------------------------------

def _expand(g: Grammar, stack: Tuple) -> List[Tuple]:
    """Expand rule refs at the stack top until a char matcher (or empty
    stack) is exposed. A stack is a tuple of elements, top = last."""
    out = []
    seen = set()
    work = [stack]
    while work:
        st = work.pop()
        if not st:
            out.append(st)
            continue
        top = st[-1]
        if top[0] == "char":
            out.append(st)
            continue
        if st in seen:
            continue
        seen.add(st)
        base = st[:-1]
        for alt in g.rules[top[1]]:
            work.append(base + tuple(reversed(alt)))
    return out


def _char_matches(el: Tuple, c: str) -> bool:
    _, ranges, neg = el
    o = ord(c)
    hit = any(lo <= o <= hi for lo, hi in ranges)
    return hit != neg


class GrammarState:
    """Set of pushdown stacks; immutable-ish (accept returns a new state)."""

    def __init__(self, grammar: Grammar, stacks: Optional[List[Tuple]] = None):
        self.g = grammar
        if stacks is None:
            stacks = _expand(grammar, (("ref", grammar.root),))
        self.stacks = stacks

    def accept_char(self, c: str) -> "GrammarState":
        nxt: List[Tuple] = []
        seen = set()
        for st in self.stacks:
            if st and st[-1][0] == "char" and _char_matches(st[-1], c):
                for e in _expand(self.g, st[:-1]):
                    if e not in seen:
                        seen.add(e)
                        nxt.append(e)
        return GrammarState(self.g, nxt)

    def accepts_text(self, text: str) -> Optional["GrammarState"]:
        st = self
        for c in text:
            st = st.accept_char(c)
            if not st.stacks:
                return None
        return st

    @property
    def alive(self) -> bool:
        return bool(self.stacks)

    @property
    def can_stop(self) -> bool:
        """True when the grammar can terminate here (an empty stack)."""
        return any(not st for st in self.stacks)


class GrammarSampler:
    """Wraps a host logits sampler with a GBNF constraint over detokenized
    piece strings (reference: common_sampler with common_grammar attached,
    tts_runner.cpp:134-192). Fast path: sample unconstrained, verify, and
    only mask+resample when the winner violates the grammar. Call
    `accept(token)` after each committed token to advance grammar state.

    `pieces[i]` must be the exact text token i contributes to the stream
    (detokenized piece); non-EOG tokens with empty pieces are always
    REJECTED, matching llama.cpp's grammar apply (an empty piece is masked
    to -inf — it cannot advance the grammar). `eog_tokens` are admissible
    once the grammar can stop.
    """

    def __init__(self, grammar_text: str, pieces: Sequence[str],
                 sampler: Callable[[np.ndarray], int],
                 eog_tokens: Sequence[int] = ()):
        self.grammar = parse_gbnf(grammar_text)
        self.pieces = list(pieces)
        self.sampler = sampler
        self.eog = set(int(t) for t in eog_tokens)
        self.state = GrammarState(self.grammar)

    def _viable(self, tok: int) -> bool:
        if tok in self.eog:
            return self.state.can_stop
        piece = self.pieces[tok] if tok < len(self.pieces) else ""
        if not piece:
            return False
        return self.state.accepts_text(piece) is not None

    def mask(self, logits: np.ndarray) -> np.ndarray:
        out = np.full_like(logits, -np.inf)
        for tok in range(len(logits)):
            if self._viable(tok):
                out[tok] = logits[tok]
        return out

    def __call__(self, logits: np.ndarray) -> int:
        tok = self.sampler(logits)
        if self._viable(tok):
            return tok
        masked = self.mask(logits)
        if not np.isfinite(masked).any():
            raise GbnfError("grammar admits no token at this position")
        return self.sampler(masked)

    def accept(self, tok: int) -> None:
        if tok in self.eog:
            return
        piece = self.pieces[tok] if tok < len(self.pieces) else ""
        nxt = self.state.accepts_text(piece)
        if nxt is None:
            raise GbnfError(f"token {tok} ({piece!r}) violates the grammar")
        self.state = nxt

    def reset(self) -> None:
        self.state = GrammarState(self.grammar)


# --- auto-grammar (reference: tts_auto_grammar, common/audio_lm.cpp) --------

def gbnf_uint_range_rule(max_inclusive: int) -> str:
    """GBNF alternates matching the decimal strings "0".."max_inclusive"
    with no leading zeros (reference: gbnf_uint_range_rule). Beyond 9999
    the reference falls back to unconstrained digits
    (common/audio_lm.cpp:1116) — mirrored here; the 4-digit
    construction below would emit malformed char classes past that."""
    if max_inclusive < 0:
        raise GbnfError("max_inclusive must be >= 0")
    if max_inclusive > 9999:
        return "[0-9]+"
    alts = []
    alts.append("[0-9]" if max_inclusive >= 9 else f"[0-{max_inclusive}]")
    if max_inclusive >= 10:
        alts.append("[1-9] [0-9]" if max_inclusive >= 99 else None)
        if max_inclusive < 99:
            tens, ones = divmod(max_inclusive, 10)
            sub = []
            if tens >= 2:
                sub.append(f"[1-{tens - 1}] [0-9]")
            sub.append(f'"{tens}" [0-{ones}]')
            alts[-1] = " | ".join(sub)
    if max_inclusive >= 100:
        if max_inclusive >= 999:
            alts.append("[1-9] [0-9] [0-9]")
        else:
            h, rem = divmod(max_inclusive, 100)
            t, o = divmod(rem, 10)
            sub = []
            if h >= 2:
                sub.append(f"[1-{h - 1}] [0-9] [0-9]")
            if t >= 1:
                sub.append(f'"{h}" [0-{t - 1}] [0-9]')
            sub.append(f'"{h}" "{t}" [0-{o}]')
            alts.append(" | ".join(sub))
    if max_inclusive >= 1000:
        thousands, rem = divmod(max_inclusive, 1000)
        if thousands >= 2:
            alts.append(f"[1-{thousands - 1}] [0-9] [0-9] [0-9]")
        h, rem2 = divmod(rem, 100)
        t, o = divmod(rem2, 10)
        sub = []
        if h >= 1:
            sub.append(f"[0-{h - 1}] [0-9] [0-9]")
        if t >= 1:
            sub.append(f'"{h}" [0-{t - 1}] [0-9]')
        sub.append(f'"{h}" "{t}" [0-{o}]')
        alts.append(f'"{thousands}" ( ' + " | ".join(sub) + " )")
    return " | ".join(f"( {a} )" for a in alts if a)


def tts_auto_grammar(pi) -> str:
    """Model-derived default grammar (reference: tts_auto_grammar,
    common/audio_lm.cpp:1164): MOSS-TTSD-style merged-cb0 models get their
    decode-phase cb0 constrained to "<CODE>" speech pieces followed by the
    end-of-speech sentinel. Returns "" when no auto-grammar applies."""
    if (getattr(pi, "cb0_from_backbone", False)
            and getattr(pi, "cb0_speech_range_start", -1) >= 0
            and getattr(pi, "cb0_speech_range_end", -1)
            > pi.cb0_speech_range_start):
        n_speech = pi.cb0_speech_range_end - pi.cb0_speech_range_start
        num_rule = gbnf_uint_range_rule(n_speech - 1)
        return ('root ::= speech* end+\n'
                'speech ::= "<" SPEECHID ">"\n'
                'end ::= "<|end_of_speech|>"\n'
                f"SPEECHID ::= {num_rule}\n")
    return ""
