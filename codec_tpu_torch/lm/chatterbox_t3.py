"""Chatterbox T3 helpers: punc-norm text cleanup, the baked BPE tokenizer,
prompt-embedding assembly with CFG lanes, and the per-step speech embedding
compose (counterpart of codec_tpu/lm/chatterbox_t3.py).

Reference behavior: src/lm/chatterbox_t3.cpp (codec_lm_chatterbox_tokenize /
_build_prompt / _compose_speech_embd). The backbone itself is external (a
llama.cpp model in the reference, any `Backbone` here); these helpers own
everything on the codec_lm side of that boundary. The tokenizer, the
prompt and the compose are codec_tpu's host NumPy, copied (importing
codec_tpu imports JAX); the speaker encoder's weights live on `device`,
and `speech_tables(device)` puts the speech tables there for the device
chunk (lm/fused_gen.py::build_chatterbox_chunk).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.gguf import GGUFReader

_PUNC_REPS = [
    ("...", ", "), ("…", ", "),
    (":", ","), (" - ", ", "), (";", ", "),
    ("—", "-"), ("–", "-"),
    (" ,", ","),
    ("“", '"'), ("”", '"'),
    ("‘", "'"), ("’", "'"),
]


def punc_norm(text: str) -> str:
    """tts.py punc_norm parity (chatterbox_t3.cpp:91-142)."""
    if not text:
        return "You need to add some text for me to talk."
    if text[0].islower() and text[0].isascii():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for frm, to in _PUNC_REPS:
        text = text.replace(frm, to)
    text = text.rstrip(" ")
    if not text or text[-1] not in ".!?-,":
        text += "."
    return text


@dataclass
class BpeTokenizer:
    """EnTokenizer parity: [SPACE] substitution, greedy added-token scan,
    whitespace \\w+|[^\\w\\s]+ split, char-level rank-BPE merges."""

    id_to_tok: List[str]
    tok_to_id: Dict[str, int]
    merge_rank: Dict[str, int]
    added: List[Tuple[str, int]]            # longest-first
    unk_id: int = 1
    space_tok: str = "[SPACE]"
    space_id: int = -1

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> Optional["BpeTokenizer"]:
        tokens_blob = r.get_str("codec.lm.chatterbox.tokenizer.tokens", "")
        if not tokens_blob:
            return None
        merges_blob = r.get_str("codec.lm.chatterbox.tokenizer.merges", "")
        added_blob = r.get_str("codec.lm.chatterbox.tokenizer.added", "")
        unk = r.get_str("codec.lm.chatterbox.tokenizer.unk_token", "[UNK]")
        id_to_tok = tokens_blob.split("\n")
        tok_to_id = {t: i for i, t in enumerate(id_to_tok)}
        merge_rank = {m: i for i, m in
                      enumerate([l for l in merges_blob.split("\n") if l])}
        added = []
        for line in added_blob.split("\n"):
            if "\t" not in line:
                continue
            content, _, sid = line.partition("\t")
            try:
                added.append((content, int(sid)))
            except ValueError:
                continue
        added.sort(key=lambda a: len(a[0]), reverse=True)
        tk = cls(id_to_tok, tok_to_id, merge_rank, added,
                 unk_id=tok_to_id.get(unk, 1))
        tk.space_id = tok_to_id.get(tk.space_tok, -1)
        return tk

    def _bpe_merge(self, syms: List[str]) -> List[str]:
        while len(syms) >= 2:
            best_rank, best_i = None, -1
            for i in range(len(syms) - 1):
                r = self.merge_rank.get(syms[i] + " " + syms[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        return syms

    @staticmethod
    def _is_word_char(c: str) -> bool:
        return c.isalnum() or c == "_"

    def _encode_chunk(self, chunk: str, out: List[int]) -> None:
        i, n = 0, len(chunk)
        while i < n:
            if chunk[i].isspace():
                i += 1
                continue
            j = i
            word = self._is_word_char(chunk[i])
            while j < n and not chunk[j].isspace() and \
                    self._is_word_char(chunk[j]) == word:
                j += 1
            piece = chunk[i:j]
            i = j
            for s in self._bpe_merge(list(piece)):
                out.append(self.tok_to_id.get(s, self.unk_id))

    def encode(self, text: str) -> List[int]:
        text = text.replace(" ", self.space_tok)
        out: List[int] = []
        pos, n = 0, len(text)
        pending = ""

        def flush():
            nonlocal pending
            if pending:
                self._encode_chunk(pending, out)
                pending = ""

        while pos < n:
            for content, tid in self.added:
                if content and text.startswith(content, pos):
                    flush()
                    out.append(tid)
                    pos += len(content)
                    break
            else:
                pending += text[pos]
                pos += 1
        flush()
        return out


@dataclass(frozen=True)
class ChatterboxInfo:
    hidden_dim: int = 1024
    text_vocab_size: int = 704
    speech_vocab_size: int = 8194
    start_text_token: int = 255
    stop_text_token: int = 0
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    cond_rows: int = 34
    has_tokenizer: bool = False
    has_builtin_conds: bool = False
    is_multilingual: bool = False


def is_chatterbox(reader: GGUFReader) -> bool:
    return "codec.lm.chatterbox.start_speech_token" in reader.kv


class ChatterboxT3:
    """reference: the CbxState surface of chatterbox_t3.cpp. The speaker
    encoder's weights on `device`."""

    def __init__(self, reader: GGUFReader, device="cuda"):
        if not is_chatterbox(reader):
            raise ValueError("not a chatterbox codec_lm GGUF")
        cbs = reader.get_arr("codec.lm.codebook_sizes") or []
        has_spk = reader.get_bool("codec.speaker.has_encoder", False)
        self.info = ChatterboxInfo(
            hidden_dim=reader.get_i32("codec.lm.hidden_dim", 1024),
            text_vocab_size=reader.get_i32(
                "codec.lm.chatterbox.text_vocab_size", 704),
            speech_vocab_size=int(cbs[0]) if len(cbs) else 8194,
            start_text_token=reader.get_i32(
                "codec.lm.chatterbox.start_text_token", 255),
            stop_text_token=reader.get_i32(
                "codec.lm.chatterbox.stop_text_token", 0),
            start_speech_token=reader.get_i32(
                "codec.lm.chatterbox.start_speech_token", 6561),
            stop_speech_token=reader.get_i32(
                "codec.lm.chatterbox.stop_speech_token", 6562),
            cond_rows=(reader.get_i32("codec.speaker.n_rows", 34)
                       if has_spk else 34),
            has_tokenizer="codec.lm.chatterbox.tokenizer.tokens" in reader.kv,
            has_builtin_conds=reader.get_bool(
                "codec.lm.chatterbox.has_builtin_conds", False),
            is_multilingual=reader.get_bool(
                "codec.lm.chatterbox.is_multilingual", False),
        )
        self.tokenizer = (BpeTokenizer.from_gguf(reader)
                          if self.info.has_tokenizer else None)

        h = self.info.hidden_dim
        self.text_emb = np.asarray(
            reader.get("lm.chatterbox.text_emb.weight"),
            np.float32).reshape(-1, h)
        self.text_pos_emb = np.asarray(
            reader.get("lm.chatterbox.text_pos_emb.weight"),
            np.float32).reshape(-1, h)
        self.speech_emb = np.asarray(
            reader.get("lm.audio_embd_0.weight"), np.float32).reshape(-1, h)
        self.speech_pos_emb = np.asarray(
            reader.get("lm.chatterbox.speech_pos_emb.weight"),
            np.float32).reshape(-1, h)

        self.speaker: Optional[object] = None
        if has_spk and reader.get_str("codec.speaker.encoder_arch", "") == \
                "chatterbox_voice_encoder":
            from .speaker_chatterbox import ChatterboxSpeakerEncoder

            self.speaker = ChatterboxSpeakerEncoder(reader, h, device=device)

        self.builtin_speaker_emb = None
        self.builtin_cond_tokens = None
        self.builtin_emotion = 0.5
        if self.info.has_builtin_conds:
            se = reader.get_arr("codec.lm.chatterbox.builtin.speaker_emb")
            ct = reader.get_arr(
                "codec.lm.chatterbox.builtin.cond_prompt_speech_tokens")
            if se is not None:
                self.builtin_speaker_emb = np.asarray(se, np.float32)
            if ct is not None:
                self.builtin_cond_tokens = np.asarray(ct, np.int32)
            self.builtin_emotion = reader.get_f32(
                "codec.lm.chatterbox.builtin.emotion_adv", 0.5)

    def speech_tables(self, device):
        """(speech_emb [V, hidden], speech_pos_emb [P, hidden]) as f32
        tensors on `device`, made once a device."""
        cache = self.__dict__.setdefault("_tables", {})
        dev = torch.device(device)
        if dev not in cache:
            cache[dev] = tuple(torch.from_numpy(t).to(dev) for t in
                               (self.speech_emb, self.speech_pos_emb))
        return cache[dev]

    def tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("chatterbox: no tokenizer baked into GGUF")
        return np.asarray(self.tokenizer.encode(punc_norm(text)), np.int32)

    def build_prompt(self, text_ids, cfg_weight: float = 0.5,
                     speaker_emb=None, ref_speech_tokens=None,
                     emotion: Optional[float] = None,
                     ref_pcm=None) -> np.ndarray:
        """→ prompt embeds [n_seq, seq_len, hidden]; lane 1 (when
        cfg_weight > 0) zeroes text-token content but keeps positions
        (reference codec_lm_chatterbox_build_prompt)."""
        ci = self.info
        h = ci.hidden_dim
        emo = emotion if emotion is not None else self.builtin_emotion
        if speaker_emb is None and ref_pcm is None:
            if self.builtin_speaker_emb is None:
                raise ValueError("chatterbox: no speaker_emb and no builtin conds")
            speaker_emb = self.builtin_speaker_emb
        if ref_speech_tokens is None:
            if self.builtin_cond_tokens is None:
                raise ValueError("chatterbox: ref_speech_tokens required")
            ref_speech_tokens = self.builtin_cond_tokens

        if self.speaker is None:
            raise ValueError("chatterbox: GGUF has no speaker encoder section")
        if ref_pcm is not None:
            cond = self.speaker.encode(ref_pcm, ref_speech_tokens, emo)
        else:
            cond = self.speaker.cond_emb(speaker_emb, ref_speech_tokens, emo)

        wrapped = np.concatenate([[ci.start_text_token],
                                  np.asarray(text_ids, np.int64).reshape(-1),
                                  [ci.stop_text_token]])
        n_wrapped = len(wrapped)
        seq_len = ci.cond_rows + n_wrapped + 2
        n_seq = 2 if cfg_weight > 0.0 else 1
        out = np.zeros((n_seq, seq_len, h), np.float32)
        for s in range(n_seq):
            uncond = s == 1
            out[s, :ci.cond_rows] = cond
            row = ci.cond_rows
            for p, tok in enumerate(wrapped):
                if not uncond and 0 <= tok < ci.text_vocab_size:
                    out[s, row] = self.text_emb[tok]
                if p < len(self.text_pos_emb):
                    out[s, row] += self.text_pos_emb[p]
                row += 1
            # speech BOS twice (prepare_input_embeds row + appended BOS)
            bos = ci.start_speech_token
            for _ in range(2):
                if 0 <= bos < ci.speech_vocab_size:
                    out[s, row] = self.speech_emb[bos]
                if len(self.speech_pos_emb) > 0:
                    out[s, row] += self.speech_pos_emb[0]
                row += 1
        return out

    def compose_speech_embd(self, code: int, pos: int) -> np.ndarray:
        if not 0 <= code < self.info.speech_vocab_size:
            raise ValueError(f"bad speech code {code}")
        e = self.speech_emb[code].copy()
        if 0 <= pos < len(self.speech_pos_emb):
            e += self.speech_pos_emb[pos]
        return e
