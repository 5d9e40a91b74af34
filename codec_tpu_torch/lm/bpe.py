"""Byte-level BPE tokenizer (GPT-2 family: Llama-3, Qwen2/3, GPT-2), the
port's copy of codec_tpu/lm/bpe.py.

The backbone GGUF carries the HF ``tokenizer.json`` itself,
zlib-compressed and base64 in the KV ``backbone.tokenizer.bpe_json_zb64``.
Parsing covers the subset those families use:

- ``model.type == "BPE"``: vocab (token string → id), ranked merges (the
  ``"a b"`` string form and the ``["a","b"]`` list form),
  ``ignore_merges`` (Llama-3: pretokens already in the vocab bypass
  merging),
- pre_tokenizer: ``ByteLevel`` (GPT-2's internal regex when
  ``use_regex``) or ``Sequence[Split{Regex}, ByteLevel]`` (Llama-3 /
  Qwen2 style); ``add_prefix_space``,
- ``added_tokens``: matched verbatim before pretokenization (llama.cpp
  tokenize with ``parse_special=true``).

A non-null normalizer raises rather than silently mis-tokenizing.

codec_tpu compiles the split regex with the third-party ``regex`` module
for its ``\\p{L}`` / ``\\p{N}`` classes. The port runs on the standard
``re`` module: `translate_pattern` rewrites ``\\p{L}`` (categories L*) and
``\\p{N}`` (Nd, Nl, No), inside and outside brackets, into explicit
code-point classes built once from ``unicodedata``, and ``\\s`` / ``\\S``
into the Unicode White_Space set ``regex`` uses (``re``'s ``\\s`` also
takes U+001C..U+001F). A construct it does not translate (another
``\\p{…}``, ``\\P{…}``, a possessive quantifier, an atomic group) raises.
"""

from __future__ import annotations

import base64
import json
import re
import sys
import unicodedata
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

# GPT-2's internal ByteLevel pretokenizer regex (used when the
# pre_tokenizer is a bare ByteLevel with use_regex=true)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# the Unicode White_Space property (what `regex` matches with \s)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
_CATEGORIES = {"L": ("Lu", "Ll", "Lt", "Lm", "Lo"), "N": ("Nd", "Nl", "No")}


def _ranges_text(ranges) -> str:
    """Code-point ranges as the inside of a bracket class (\\U escapes)."""
    return "".join(f"\\U{lo:08X}" if lo == hi else
                   f"\\U{lo:08X}-\\U{hi:08X}" for lo, hi in ranges)


@lru_cache(maxsize=1)
def _category_bodies() -> Dict[str, str]:
    """{"L": ..., "N": ...}: each class's code points as the inside of a
    bracket class, from one pass over unicodedata (about 0.3 s)."""
    ranges = {name: [] for name in _CATEGORIES}
    start = {name: None for name in _CATEGORIES}
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp)) if cp <= sys.maxunicode else ""
        for name, cats in _CATEGORIES.items():
            hit = cat in cats
            if hit and start[name] is None:
                start[name] = cp
            elif not hit and start[name] is not None:
                ranges[name].append((start[name], cp - 1))
                start[name] = None
    return {name: _ranges_text(r) for name, r in ranges.items()}


def _class_body(name: str) -> str:
    """The inside of a bracket class for \\p{name} (L or N) or \\s."""
    if name == "s":
        return _ranges_text(_WHITE_SPACE)
    return _category_bodies()[name]


def translate_pattern(pattern: str) -> str:
    """A tokenizer.json split regex written for the `regex` module → the
    same pattern for `re` (see the module docstring). Raises ValueError on
    a construct it does not translate."""
    out, i, n = [], 0, len(pattern)
    in_class = False
    quantified = False            # the last token was a quantifier
    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                raise ValueError("pattern ends in a lone backslash")
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\w+)\}|(\w)", pattern[i + 2:])
                name = m and (m.group(1) or m.group(2))
                if e == "P" or name not in _CATEGORIES:
                    raise ValueError(f"cannot translate \\{e}"
                                     f"{pattern[i + 2:i + 8]!r}: only \\p{{L}} "
                                     f"and \\p{{N}} are supported")
                body = _class_body(name)
                out.append(body if in_class else f"[{body}]")
                i += 2 + m.end()
            elif e in "sS":
                if in_class and e == "S":
                    raise ValueError("cannot translate \\S inside a class")
                body = _class_body("s")
                out.append(body if in_class else
                           f"[{'^' if e == 'S' else ''}{body}]")
                i += 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
            quantified = False
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[" and pattern[i + 1:i + 2] == ":":
                raise ValueError("POSIX classes are not supported")
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":          # a literal ] first
                out.append("\\]")
                i += 1
            quantified = False
            continue
        if c == "(" and pattern[i + 1:i + 2] == "?":
            if pattern[i + 2:i + 3] == ">":
                raise ValueError("atomic groups are not supported")
            out.append("(?")
            i += 2
            quantified = False
            continue
        if c == "+" and quantified:
            raise ValueError("possessive quantifiers are not supported")
        if c in "*+?":
            quantified = c != "?" or not quantified   # x?? is lazy, not x?+
            out.append(c)
            i += 1
            continue
        if c == "{":
            m = re.match(r"\{\d*(,\d*)?\}", pattern[i:])
            if m:
                out.append(m.group(0))
                i += m.end()
                quantified = True
                continue
        out.append(c)
        i += 1
        quantified = False
    if in_class:
        raise ValueError("unterminated character class")
    return "".join(out)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BpeByteLevel:
    def __init__(self, vocab: Dict[str, int],
                 merges: List[Tuple[str, str]],
                 pattern: str = GPT2_PATTERN,
                 added: Optional[Dict[str, int]] = None,
                 ignore_merges: bool = False,
                 add_prefix_space: bool = False):
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.pattern = re.compile(translate_pattern(pattern))
        self.added = dict(added or {})
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self.ignore_merges = ignore_merges
        self.add_prefix_space = add_prefix_space
        self._b2u = bytes_to_unicode()
        self._u2b = {v: k for k, v in self._b2u.items()}
        # added tokens are matched verbatim, longest first
        self._added_re = None
        if self.added:
            alts = sorted(self.added, key=len, reverse=True)
            self._added_re = re.compile("|".join(re.escape(a) for a in alts))
        self._cache: Dict[str, List[int]] = {}

    # -- construction --------------------------------------------------
    @classmethod
    def from_hf_json(cls, js: dict) -> "BpeByteLevel":
        model = js.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer.json "
                             f"(model.type={model.get('type')!r})")
        if js.get("normalizer") is not None:
            raise ValueError("tokenizer.json normalizer is not supported "
                             "(byte-level BPE families ship null)")
        merges: List[Tuple[str, str]] = []
        for m in model.get("merges", []):
            if isinstance(m, str):
                a, b = m.split(" ", 1)
            else:
                a, b = m
            merges.append((a, b))
        pattern, add_prefix = cls._parse_pre_tokenizer(js.get("pre_tokenizer"))
        added = {t["content"]: int(t["id"])
                 for t in js.get("added_tokens", [])}
        return cls(vocab=dict(model["vocab"]), merges=merges,
                   pattern=pattern, added=added,
                   ignore_merges=bool(model.get("ignore_merges", False)),
                   add_prefix_space=add_prefix)

    @staticmethod
    def _parse_pre_tokenizer(pre) -> Tuple[str, bool]:
        """(split regex, add_prefix_space) from the pre_tokenizer tree:
        bare ByteLevel, or Sequence[... Split{Regex} ... ByteLevel]."""
        pattern = GPT2_PATTERN
        add_prefix = False
        if pre is None:
            return pattern, add_prefix
        nodes = (pre.get("pretokenizers", [pre])
                 if pre.get("type") == "Sequence" else [pre])
        saw_split = False
        for node in nodes:
            t = node.get("type")
            if t == "Split":
                pat = node.get("pattern") or {}
                if "Regex" not in pat:
                    raise ValueError("Split pre_tokenizer without Regex "
                                     "pattern is not supported")
                if node.get("behavior", "Isolated").lower() != "isolated" \
                        or node.get("invert"):
                    raise ValueError("only Split(behavior=Isolated, "
                                     "invert=false) is supported")
                pattern = pat["Regex"]
                saw_split = True
            elif t == "ByteLevel":
                add_prefix = bool(node.get("add_prefix_space", False))
                if node.get("use_regex", True) and not saw_split:
                    pattern = GPT2_PATTERN   # GPT-2 style: regex built in
                elif not node.get("use_regex", True) and not saw_split \
                        and len(nodes) == 1:
                    # ByteLevel with no regex at all: the whole text is one
                    # pretoken per added-token segment
                    pattern = r"(?s).+"
            else:
                raise ValueError(f"unsupported pre_tokenizer {t!r}")
        return pattern, add_prefix

    @classmethod
    def from_json_bytes(cls, data: bytes) -> "BpeByteLevel":
        return cls.from_hf_json(json.loads(data.decode("utf-8")))

    @classmethod
    def from_zb64(cls, zb64: str) -> "BpeByteLevel":
        return cls.from_json_bytes(zlib.decompress(base64.b64decode(zb64)))

    @staticmethod
    def json_to_zb64(data: bytes) -> str:
        """The GGUF KV's form of a tokenizer.json."""
        return base64.b64encode(zlib.compress(data, 9)).decode("ascii")

    # -- encoding -------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        top = max(max(self.vocab.values(), default=-1),
                  max(self.added.values(), default=-1))
        return top + 1

    def _bpe(self, tok: str) -> List[int]:
        cached = self._cache.get(tok)
        if cached is not None:
            return cached
        if self.ignore_merges and tok in self.vocab:
            out = [self.vocab[tok]]
            self._cache[tok] = out
            return out
        parts = list(tok)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = [self.vocab[p] for p in parts if p in self.vocab]
        if len(out) != len(parts):
            missing = [p for p in parts if p not in self.vocab]
            raise ValueError(f"BPE pieces not in vocab: {missing[:4]}")
        if len(tok) < 32:                      # bound the cache key size
            self._cache[tok] = out
        return out

    def _encode_segment(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in self.pattern.finditer(text):
            word = m.group(0)
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self._bpe(mapped))
        return ids

    def encode(self, text: str) -> List[int]:
        """Token ids; added tokens in the text are matched verbatim
        (llama.cpp parse_special=true)."""
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        if self._added_re is None:
            return self._encode_segment(text)
        ids: List[int] = []
        pos = 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                ids.extend(self._encode_segment(text[pos:m.start()]))
            ids.append(self.added[m.group(0)])
            pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_segment(text[pos:]))
        return ids

    # -- decoding -------------------------------------------------------
    def decode_piece(self, token_id: int) -> str:
        tok = self.id_to_token.get(token_id, "")
        if tok in self.added:
            return tok
        return bytes(self._u2b[c] for c in tok).decode("utf-8",
                                                       errors="replace")

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        buf: List[int] = []
        for i in ids:
            tok = self.id_to_token.get(i, "")
            if tok in self.added:
                if buf:
                    out.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf = []
                out.append(tok)
            else:
                buf.extend(self._u2b[c] for c in tok)
        if buf:
            out.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(out)
