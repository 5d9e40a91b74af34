"""The port's byte-level BPE tokenizer (codec_tpu_torch/lm/bpe.py) and the
tts-cli's BPE backbone branch against codec_tpu's BpeByteLevel on the CPU.

codec_tpu compiles the tokenizer.json split regex with the `regex` module;
the port translates it for `re` (\\p{L}, \\p{N} and \\s into explicit
code-point classes). Fixtures: tests/test_bpe.py's tokenizers, trained
offline with HF `tokenizers` on GPT-2-, Llama-3- and Qwen2-style
pre-tokenizers. Bounds: ids and pieces equal; the translated classes
match the `regex` module's on every code point this Python's unicodedata
assigns.
"""

import json
import re
import unicodedata

import numpy as np
import pytest
import regex

from codec_tpu.cli.tts_cli import load_backbone_tokenizer as jax_load_tok
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm.bpe import BpeByteLevel as JaxBpe
from codec_tpu_torch.cli.tts_cli import load_backbone_tokenizer
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.lm import bpe

from test_bpe import (CORPUS, LLAMA3_PATTERN, QWEN2_PATTERN, TEXTS,
                      gpt2_pair, llama3_pair, qwen2_pair)  # noqa: F401

MORE = [
    "Ça va? Ärger über Öl — naïve façade, crème brûlée.",
    "東京タワーと大阪城、北京和上海。한국어 텍스트도.",
    "digits 0 00 000 0000 1234567890 3.14159 1,000,000 ①②③ ⅫⅣ ٣٤٥",
    "lines\nand\n\nmore\r\n\r\n\tindent\n  trailing  \n",
    "emoji 🦜🎉👍🏽 and ZWJ 👩‍👩‍👧 sequences",
    "sep\x1cchars\x1d\x1e\x1f and nbsp and　ideographic space",
    "mixed'S 'LL caps DON'T WON'T it'S",
]
PAIRS = ["gpt2_pair", "llama3_pair", "qwen2_pair"]


def _port(pair):
    oracle, _ = pair
    return bpe.BpeByteLevel.from_hf_json(json.loads(oracle.to_str()))


@pytest.mark.parametrize("pair_name", PAIRS)
def test_ids_match_codec_tpu(pair_name, request):
    pair = request.getfixturevalue(pair_name)
    oracle, ref = pair
    ours = _port(pair)
    for text in TEXTS + MORE + CORPUS:
        got = ours.encode(text)
        assert got == ref.encode(text), text
        assert got == oracle.encode(text, add_special_tokens=False).ids, text
    specials = sorted(ours.added, key=ours.added.get)
    if specials:
        text = f"{specials[0]}hello {specials[-1]} 東京 {specials[0]}"
        assert ours.encode(text) == ref.encode(text)


@pytest.mark.parametrize("pair_name", PAIRS)
def test_pieces_and_decode_match(pair_name, request):
    pair = request.getfixturevalue(pair_name)
    ours, ref = _port(pair), pair[1]
    assert ours.vocab_size == ref.vocab_size
    for i in range(ours.vocab_size):
        assert ours.decode_piece(i) == ref.decode_piece(i)
    for text in MORE:
        ids = ours.encode(text)
        assert ours.decode(ids) == ref.decode(ids) == text


@pytest.mark.parametrize("pattern", [bpe.GPT2_PATTERN, LLAMA3_PATTERN,
                                     QWEN2_PATTERN])
def test_translated_pattern_splits_as_regex(pattern):
    ours, theirs = re.compile(bpe.translate_pattern(pattern)), \
        regex.compile(pattern)
    for text in TEXTS + MORE + CORPUS:
        assert [m.group(0) for m in ours.finditer(text)] == \
            [m.group(0) for m in theirs.finditer(text)], text


@pytest.mark.parametrize("name,rx", [("L", r"\p{L}"), ("N", r"\p{N}"),
                                     ("s", r"\s")])
def test_classes_match_regex_module(name, rx):
    """Every code point this Python's unicodedata assigns (a newer `regex`
    knows later assignments, which are unassigned here)."""
    ours, theirs = re.compile(f"[{bpe._class_body(name)}]"), regex.compile(rx)
    bad = [cp for cp in range(0x110000)
           if unicodedata.category(chr(cp)) != "Cn"
           and bool(ours.match(chr(cp))) != bool(theirs.match(chr(cp)))]
    assert not bad, [hex(c) for c in bad[:8]]


@pytest.mark.parametrize("pattern,what", [
    (r"\p{Lu}+", "only"), (r"\P{L}", "only"), (r"\pM", "only"),
    (r"a++", "possessive"), (r"x{2,3}+", "possessive"),
    (r"(?>ab)c", "atomic"), (r"[[:alpha:]]", "POSIX"), (r"[\S]", "inside"),
    (r"[abc", "unterminated")])
def test_untranslatable_pattern_raises(pattern, what):
    with pytest.raises(ValueError, match=what):
        bpe.translate_pattern(pattern)
    js = {"model": {"type": "BPE", "vocab": {"a": 0}, "merges": []},
          "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
              {"type": "Split", "pattern": {"Regex": pattern},
               "behavior": "Isolated"},
              {"type": "ByteLevel", "use_regex": False}]}}
    with pytest.raises(ValueError, match=what):
        bpe.BpeByteLevel.from_hf_json(js)


@pytest.mark.parametrize("pattern", [r"a+?b*?c??", r"x{2,3}?y{4}", r"(?i:ab)",
                                     r"(?:a|b)+(?=c)(?!d)", r"[^\r\n\s]{1,3}"])
def test_lazy_and_groups_pass_through(pattern):
    out = bpe.translate_pattern(pattern)
    for text in ("aabbbc", "xxxyyyy", "AB ab", "abac", "q\r\n x yz"):
        assert [m.group(0) for m in re.finditer(out, text)] == \
            [m.group(0) for m in regex.finditer(pattern, text)]


def test_rejections_match_codec_tpu():
    for js, what in (({"model": {"type": "Unigram"}}, "not a BPE"),
                     ({"model": {"type": "BPE", "vocab": {}, "merges": []},
                       "normalizer": {"type": "NFC"}}, "normalizer")):
        with pytest.raises(ValueError, match=what):
            bpe.BpeByteLevel.from_hf_json(js)
        with pytest.raises(ValueError, match=what):
            JaxBpe.from_hf_json(js)


def test_cli_loads_bpe_backbone_tokenizer(llama3_pair, tmp_path):
    """load_backbone_tokenizer's BPE branch: the zlib+base64 tokenizer.json
    baked into a backbone GGUF gives codec_tpu's ids and pieces."""
    oracle, _ = llama3_pair
    path = tmp_path / "bb.gguf"
    w = GGUFWriter(path, "llama_backbone")
    w.add_string("backbone.tokenizer.bpe_json_zb64",
                 bpe.BpeByteLevel.json_to_zb64(oracle.to_str().encode()))
    w.write()
    ours = load_backbone_tokenizer(GGUFReader(path))
    ref = jax_load_tok(JaxReader(str(path)))
    assert isinstance(ours, bpe.BpeByteLevel)
    for text in MORE:
        assert ours.encode(text) == ref.encode(text)
    assert [ours.decode_piece(i) for i in range(50)] == \
        [ref.decode_piece(i) for i in range(50)]
    empty = tmp_path / "none.gguf"
    GGUFWriter(empty, "llama_backbone").write()
    with pytest.raises(ValueError, match="no baked tokenizer"):
        load_backbone_tokenizer(GGUFReader(empty))
    assert np.array_equal(ours.encode(""), [])
