"""Minimal SentencePiece UNIGRAM tokenizer (Viterbi + byte fallback).

Reference behavior: src/lm/spm_unigram.{h,cpp} — parses the raw `.model`
protobuf (base64-decoded from the `codec.lm.tokenizer.spm_b64` GGUF KV)
without libsentencepiece: only `pieces` (field 1: {piece=1 str, score=2
float, type=3 varint}) are read. Encoding: escape spaces to U+2581 with
add_dummy_prefix, Viterbi over the unigram vocab, per-byte `<0xXX>`
fallback scored min_score − 10 so real pieces always win.

A copy of codec_tpu/lm/spm.py (pure Python), kept here because importing
codec_tpu imports JAX.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Optional, Tuple

UNDERSCORE = "▁"

NORMAL, UNKNOWN, CONTROL, UNUSED, USER_DEFINED, BYTE = 1, 2, 3, 5, 4, 6


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out, pos
        shift += 7


def _parse_piece(data: bytes) -> Tuple[str, float, int]:
    import struct
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            ln, pos = _read_varint(data, pos)
            piece = data[pos:pos + ln].decode("utf-8", errors="replace")
            pos += ln
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", data[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(data, pos)
        elif wire == 0:
            _, pos = _read_varint(data, pos)
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"bad wire type {wire}")
    return piece, score, ptype


class SpmUnigram:
    def __init__(self):
        self.pieces: List[Tuple[str, float, int]] = []
        self.lookup: Dict[str, int] = {}
        self.byte0_id = -1
        self.unk_id = 0
        self.max_piece_len = 1
        self.min_score = 0.0

    @classmethod
    def from_proto(cls, data: bytes) -> "SpmUnigram":
        self = cls()
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:      # repeated SentencePiece pieces
                ln, pos = _read_varint(data, pos)
                self.pieces.append(_parse_piece(data[pos:pos + ln]))
                pos += ln
            elif wire == 0:
                _, pos = _read_varint(data, pos)
            elif wire == 2:
                ln, pos = _read_varint(data, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"bad wire type {wire}")
        for i, (piece, score, ptype) in enumerate(self.pieces):
            if ptype == UNKNOWN:
                self.unk_id = i
            if ptype == BYTE:
                if piece == "<0x00>":
                    self.byte0_id = i
                continue
            if ptype in (CONTROL, UNKNOWN):
                continue
            if piece:
                self.lookup[piece] = i
                self.max_piece_len = max(self.max_piece_len, len(piece.encode()))
                self.min_score = min(self.min_score, score)
        return self

    @classmethod
    def from_b64(cls, b64: str) -> "SpmUnigram":
        return cls.from_proto(base64.b64decode(b64))

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def encode(self, text: str) -> List[int]:
        norm = UNDERSCORE + text.replace(" ", UNDERSCORE)
        data = norm.encode("utf-8")
        n = len(data)
        neg_inf = float("-inf")
        best = [neg_inf] * (n + 1)
        back_pos = [-1] * (n + 1)
        back_id = [-1] * (n + 1)
        best[0] = 0.0
        fallback_score = self.min_score - 10.0
        for i in range(n):
            if best[i] == neg_inf:
                continue
            max_len = min(self.max_piece_len, n - i)
            for ln in range(max_len, 0, -1):
                sub = data[i:i + ln]
                try:
                    sub_s = sub.decode("utf-8")
                except UnicodeDecodeError:
                    continue
                pid = self.lookup.get(sub_s, -1)
                if pid < 0:
                    continue
                sc = best[i] + self.pieces[pid][1]
                j = i + ln
                if sc > best[j]:
                    best[j], back_pos[j], back_id[j] = sc, i, pid
            # per-byte fallback
            j = i + 1
            if self.byte0_id >= 0:
                sc = best[i] + fallback_score
                pid = self.byte0_id + data[i]
            else:
                sc = best[i] + self.pieces[self.unk_id][1] - 10.0
                pid = self.unk_id
            if sc > best[j]:
                best[j], back_pos[j], back_id[j] = sc, i, pid

        rev = []
        pos = n
        while pos > 0 and back_pos[pos] >= 0:
            rev.append(back_id[pos])
            pos = back_pos[pos]
        return rev[::-1]

    def decode_piece(self, token_id: int) -> str:
        piece, _, ptype = self.pieces[token_id]
        if ptype == BYTE:
            return chr(int(piece[1:-1], 16))
        return piece.replace(UNDERSCORE, " ")
