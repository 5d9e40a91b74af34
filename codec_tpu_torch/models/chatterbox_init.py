"""Random Chatterbox TTS and Qwen3-TTS speaker-encoder fixtures from a seed.

Widths default to the published ones:

  - T3 (ResembleAI/chatterbox, t3/llama_configs.py LLAMA_520M and
    t3_config.py): a Llama backbone of hidden 1024, 30 layers, 16 heads x
    64 (16 KV heads), FFN 4096, llama3 rope (factor 8, theta 500 000),
    vocabulary 8 with an untied head (T3 feeds its own embeddings); text
    vocabulary 704 (start 255, stop 0), speech vocabulary 8194 (start
    6561, stop 6562), 2050 text and 4100 speech position rows, the
    conditioning encoder's perceiver (32 queries, 4 heads at 1024) and a
    built-in conditioning of a 256 speaker embedding and 150 prompt speech
    tokens; the VoiceEncoder (40 mels, a 3-layer LSTM of 256, a 256
    embedding) with the librosa mel basis of its 16 kHz STFT. The T3
    section goes into the S3Gen GGUF of s3g_init.py, as codec_tpu's
    converter writes both into one file (convert/lm_adaptor.py:621-680),
    with a baked tokenizer whose vocabulary is made up here (its specials
    at the published ids, single characters, and merges of frequent
    English letter pairs): real tokenizer.json files are not in the
    repository.
  - Qwen3-TTS's ECAPA-TDNN speaker encoder (EcapaConfig's defaults: 128
    mels of a 1024-point 24 kHz STFT, channels 512 x 4 and 1536, kernels
    5, 3, 3, 3, 1, dilations 1, 2, 3, 4, 1, Res2Net scale 8, SE and
    attention 128, embedding 1024).

Matrices are drawn at 1/sqrt(fan-in), norm scales N(1, 0.02), biases
N(0, 0.02), written F16 as the reference's converters write them (biases
and norms F32). The speech head's rows for the ids from the start token
up are drawn at `special_gain` x that scale: random weights would emit
those ids (BOS, EOS and the 1631 unused ids past them: a fifth of the
vocabulary) where the trained head does not, and the flow drops every id
past the BOS from the speech codes, so a random request would keep only
four fifths of its frames. A test that wants the stop raises its row with
`stop_gain`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

from ..dsp.audio import hann_periodic, slaney_mel_filterbank
from ..io.gguf import GGUFWriter
from ..lm.backbone import BackboneConfig
from ..lm.speaker_chatterbox import VeConfig
from ..lm.speaker_qwen3_tts import EcapaConfig
from .lm_init import LLAMA3_SCALING
from .s3g_init import write_random_s3g_gguf

LLAMA_520M = BackboneConfig(
    hidden=1024, n_layers=30, n_heads=16, n_kv_heads=16, head_dim=64,
    ffn_dim=4096, vocab_size=8, rope_theta=500000.0, rms_eps=1e-5,
    max_ctx=2048, tied_lm_head=False)
T3_ROPE_SCALING = dict(LLAMA3_SCALING, factor=8.0)


@dataclass(frozen=True)
class T3Config:
    """A Chatterbox T3 section's widths and ids (the published ones)."""
    hidden: int = 1024
    text_vocab: int = 704
    speech_vocab: int = 8194
    start_text: int = 255
    stop_text: int = 0
    start_speech: int = 6561
    stop_speech: int = 6562
    text_pos: int = 2050
    speech_pos: int = 4100
    speaker_embed: int = 256
    cond_tokens: int = 150
    emotion: float = 0.5
    special_gain: float = 0.01
    stop_gain: float = 0.01


_TEXT = ("the quick brown fox jumps over the lazy dog while she sells sea "
         "shells on the sea shore and hello there this is a test of the "
         "speech synthesis system that reads english text aloud")


def t3_vocab(size: int, start_text: int = 255
             ) -> Tuple[List[str], List[str], List[Tuple[str, int]]]:
    """(id → token, merges "a b", added (content, id)) of a made-up T3
    tokenizer of `size` tokens: [STOP] 0, [UNK] 1, [SPACE] 2, [START] at
    `start_text`, the printable ASCII characters and a few accented
    letters, then merges of the most frequent adjacent pairs of _TEXT."""
    chars = [chr(c) for c in range(33, 127)] + list("éèàüöäñçß")
    toks: List[str] = ["[STOP]", "[UNK]", "[SPACE]"]
    merges: List[str] = []
    words = [list(w) for w in _TEXT.split()]
    pending = list(chars)
    while len(toks) < size:
        if len(toks) == start_text:
            toks.append("[START]")
            continue
        if pending:
            toks.append(pending.pop(0))
            continue
        counts = {}
        for w in words:
            for a, b in zip(w, w[1:]):
                counts[a, b] = counts.get((a, b), 0) + 1
        if counts:
            (a, b), _ = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
            merges.append(f"{a} {b}")
            toks.append(a + b)
            for w in words:
                i = 0
                while i < len(w) - 1:
                    if (w[i], w[i + 1]) == (a, b):
                        w[i:i + 2] = [a + b]
                    i += 1
        else:
            toks.append(f"[PAD{len(toks)}]")
    added = [("[STOP]", 0), ("[UNK]", 1), ("[SPACE]", 2)]
    if start_text < size:
        added.append(("[START]", start_text))
    return toks, merges, added


class _Draw:
    def __init__(self, wr: GGUFWriter, seed: int):
        self.wr, self.rng = wr, np.random.default_rng(seed)

    def normal(self, *shape, std: float, mean: float = 0.0) -> np.ndarray:
        return (self.rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std) + np.float32(mean))

    def mat(self, name, out_d, in_d, *rest, gain=1.0, st="F16"):
        w = self.normal(out_d, in_d, *rest,
                        std=gain / math.sqrt(in_d * math.prod(rest)))
        self.wr.add_tensor(name, w, st)
        return w

    def vec(self, name, *shape, std=0.02, mean=0.0, st="F32"):
        v = self.normal(*shape, std=std, mean=mean)
        self.wr.add_tensor(name, v, st)
        return v


def add_chatterbox_t3(wr: GGUFWriter, seed: int = 0,
                      cfg: T3Config = T3Config(),
                      ve: VeConfig = VeConfig()) -> None:
    """Add a Chatterbox T3 adaptor (parallel_heads_delay, one codebook, the
    chatterbox.* section, the baked tokenizer and built-in conditioning)
    and its VoiceEncoder speaker section to an open codec writer."""
    h = cfg.hidden
    d = _Draw(wr, seed)
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "parallel_heads_delay")
    wr.add_string("codec.lm.host_arch", "llama")
    wr.add_uint32("codec.lm.hidden_dim", h)
    wr.add_uint32("codec.lm.audio_embed_dim", h)
    wr.add_uint32("codec.lm.n_codebook", 1)
    wr.add_array("codec.lm.codebook_sizes", [cfg.speech_vocab])
    wr.add_array("codec.lm.delay_pattern", [0])
    wr.add_bool("codec.lm.parallel.tied_heads_to_embd", False)
    for key, val in (("text_vocab_size", cfg.text_vocab),
                     ("start_text_token", cfg.start_text),
                     ("stop_text_token", cfg.stop_text),
                     ("start_speech_token", cfg.start_speech),
                     ("stop_speech_token", cfg.stop_speech),
                     ("max_text_tokens", cfg.text_pos - 2),
                     ("max_speech_tokens", cfg.speech_pos - 4),
                     ("speaker_embed_dim", cfg.speaker_embed),
                     ("cond_len", 32)):
        wr.add_uint32(f"codec.lm.chatterbox.{key}", val)
    wr.add_int32("codec.lm.eos_code_c0", cfg.stop_speech)
    wr.add_int32("codec.lm.eos_min_step", 0)
    wr.add_int32("codec.lm.bos_code_c0", cfg.start_speech)
    wr.add_bool("codec.lm.chatterbox.is_multilingual", False)
    wr.add_bool("codec.lm.chatterbox.has_emotion_cond", True)

    d.mat("lm.audio_embd_0.weight", cfg.speech_vocab, h)
    head = d.normal(cfg.speech_vocab, h, std=1.0 / math.sqrt(h))
    head[cfg.start_speech:] *= np.float32(cfg.special_gain)
    head[cfg.stop_speech] *= np.float32(cfg.stop_gain / cfg.special_gain)
    wr.add_tensor("lm.heads_0.weight", head, "F16")
    d.mat("lm.chatterbox.text_emb.weight", cfg.text_vocab, h)
    d.mat("lm.chatterbox.text_head.weight", cfg.text_vocab, h)
    d.mat("lm.chatterbox.text_pos_emb.weight", cfg.text_pos, h)
    d.mat("lm.chatterbox.speech_pos_emb.weight", cfg.speech_pos, h)
    c = "lm.chatterbox.cond"
    d.mat(c + ".spkr_enc.weight", h, cfg.speaker_embed)
    d.vec(c + ".spkr_enc.bias", h)
    d.vec(c + ".emotion_adv_fc.weight", h, 1, std=0.5)
    d.vec(c + ".perceiver.queries", 1, 32, h, std=1.0, st="F16")
    d.vec(c + ".perceiver.norm.weight", h, mean=1.0)
    d.vec(c + ".perceiver.norm.bias", h)
    for n in ("to_q", "to_k", "to_v", "proj_out"):
        d.mat(f"{c}.perceiver.{n}.weight", h, h)
        d.vec(f"{c}.perceiver.{n}.bias", h)

    toks, merges, added = t3_vocab(cfg.text_vocab, cfg.start_text)
    wr.add_string("codec.lm.chatterbox.tokenizer.model", "bpe")
    wr.add_uint32("codec.lm.chatterbox.tokenizer.n_vocab", len(toks))
    wr.add_string("codec.lm.chatterbox.tokenizer.tokens", "\n".join(toks))
    wr.add_string("codec.lm.chatterbox.tokenizer.merges", "\n".join(merges))
    wr.add_string("codec.lm.chatterbox.tokenizer.added",
                  "\n".join(f"{a}\t{i}" for a, i in added))
    wr.add_string("codec.lm.chatterbox.tokenizer.unk_token", "[UNK]")

    spk = d.normal(cfg.speaker_embed, std=1.0)
    wr.add_bool("codec.lm.chatterbox.has_builtin_conds", True)
    wr.add_array("codec.lm.chatterbox.builtin.speaker_emb",
                 [float(x) for x in spk / np.linalg.norm(spk)])
    wr.add_array("codec.lm.chatterbox.builtin.cond_prompt_speech_tokens",
                 [int(t) for t in d.rng.integers(0, cfg.start_speech,
                                                 cfg.cond_tokens)])
    wr.add_float32("codec.lm.chatterbox.builtin.emotion_adv", cfg.emotion)

    # the VoiceEncoder (the S3Gen converter's speaker section)
    for l in range(ve.num_layers):
        fan = ve.n_mels if l == 0 else ve.hidden_size
        pre = f"speaker.voice_encoder.lstm_{l}."
        d.mat(pre + "W_ih", 4 * ve.hidden_size, fan, st="F32")
        d.mat(pre + "W_hh", 4 * ve.hidden_size, ve.hidden_size, st="F32")
        d.vec(pre + "b_ih", 4 * ve.hidden_size)
        d.vec(pre + "b_hh", 4 * ve.hidden_size)
    d.mat("speaker.voice_encoder.proj.weight", ve.embed_size, ve.hidden_size,
          st="F32")
    d.vec("speaker.voice_encoder.proj.bias", ve.embed_size)
    wr.add_tensor("speaker.voice_encoder.mel_basis", slaney_mel_filterbank(
        ve.sample_rate, ve.n_fft, ve.n_mels, 0.0, ve.sample_rate / 2), "F32")
    wr.add_tensor("speaker.voice_encoder.window", hann_periodic(ve.win), "F32")
    wr.add_bool("codec.speaker.has_encoder", True)
    wr.add_string("codec.speaker.encoder_arch", "chatterbox_voice_encoder")
    for key, val in (("n_rows", 34), ("hidden_dim", h),
                     ("ref_sample_rate", ve.sample_rate),
                     ("speaker_emb_dim", ve.embed_size),
                     ("ve.num_mels", ve.n_mels),
                     ("ve.hidden_size", ve.hidden_size),
                     ("ve.num_layers", ve.num_layers),
                     ("ve.speaker_embed_dim", ve.embed_size),
                     ("ve.n_fft", ve.n_fft), ("ve.hop_size", ve.hop),
                     ("ve.win_size", ve.win),
                     ("ve.partial_frames", ve.partial_frames)):
        wr.add_uint32(f"codec.speaker.{key}", val)
    for key in ("needs_ref_pcm", "needs_ref_speech_tokens",
                "needs_emotion_scalar", "ve.final_relu"):
        wr.add_bool(f"codec.speaker.{key}", True)
    wr.add_float32("codec.speaker.emotion_default", 0.5)
    wr.add_float32("codec.speaker.ve.overlap", ve.overlap)
    wr.add_float32("codec.speaker.ve.rate", ve.rate)
    wr.add_float32("codec.speaker.ve.min_coverage", ve.min_coverage)


def write_chatterbox_tts_gguf(path: Union[str, Path], seed: int = 0,
                              t3: T3Config = T3Config(),
                              ve: VeConfig = VeConfig(), **s3g) -> Path:
    """Chatterbox TTS: the random S3Gen of s3g_init.py (`s3g`: its
    write_random_s3g_gguf keywords; defaults full width, 0.5 GB) with the
    T3 section and the VoiceEncoder from seed + 1."""
    write_random_s3g_gguf(path, seed, extra=lambda wr: add_chatterbox_t3(
        wr, seed + 1, t3, ve), **s3g)
    return Path(path)


def add_ecapa_speaker(wr: GGUFWriter, seed: int = 0,
                      cfg: EcapaConfig = EcapaConfig()) -> None:
    """Add a Qwen3-TTS ECAPA-TDNN speaker section (F32) to an open writer."""
    d = _Draw(wr, seed)
    ch, ks, dil = cfg.enc_channels, cfg.enc_kernels, cfg.enc_dilations

    def conv(name, out_d, in_d, k):
        d.mat(name + ".weight", out_d, in_d, k, st="F32")
        d.vec(name + ".bias", out_d)

    conv("speaker.qwen3_tts.blocks.0.conv", ch[0], cfg.mel_dim, ks[0])
    for bi in range(1, len(ch) - 1):
        base = f"speaker.qwen3_tts.blocks.{bi}"
        conv(base + ".tdnn1.conv", ch[bi], ch[bi - 1], 1)
        conv(base + ".tdnn2.conv", ch[bi], ch[bi], 1)
        conv(base + ".se.conv1", cfg.se_ch, ch[bi], 1)
        conv(base + ".se.conv2", ch[bi], cfg.se_ch, 1)
        part = ch[bi] // cfg.res2net_scale
        for ri in range(cfg.res2net_scale - 1):
            conv(f"{base}.res2net.{ri}.conv", part, part, ks[bi])
    conv("speaker.qwen3_tts.mfa.conv", ch[-1], sum(ch[1:-1]), ks[-1])
    conv("speaker.qwen3_tts.asp.tdnn.conv", cfg.attn_ch, 3 * ch[-1], 1)
    conv("speaker.qwen3_tts.asp.conv", ch[-1], cfg.attn_ch, 1)
    conv("speaker.qwen3_tts.fc", cfg.enc_dim, 2 * ch[-1], 1)
    wr.add_tensor("speaker.qwen3_tts.mel_basis", slaney_mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.mel_dim, 0.0, 12000.0), "F32")
    wr.add_tensor("speaker.qwen3_tts.window", hann_periodic(cfg.win), "F32")
    wr.add_bool("codec.speaker.has_encoder", True)
    wr.add_string("codec.speaker.encoder_arch", "qwen3_tts_ecapa_tdnn")
    wr.add_bool("codec.speaker.needs_ref_pcm", True)
    for key, val in (("ref_sample_rate", cfg.sample_rate),
                     ("n_rows", cfg.n_rows), ("hidden_dim", cfg.hidden_dim),
                     ("ecapa.mel_dim", cfg.mel_dim),
                     ("ecapa.enc_dim", cfg.enc_dim),
                     ("ecapa.enc_attention_channels", cfg.attn_ch),
                     ("ecapa.enc_res2net_scale", cfg.res2net_scale),
                     ("ecapa.enc_se_channels", cfg.se_ch),
                     ("ecapa.n_fft", cfg.n_fft), ("ecapa.hop_size", cfg.hop),
                     ("ecapa.win_size", cfg.win)):
        wr.add_uint32(f"codec.speaker.{key}", val)
    for key, val in (("enc_channels", ch), ("enc_kernel_sizes", ks),
                     ("enc_dilations", dil)):
        wr.add_array(f"codec.speaker.ecapa.{key}", [int(v) for v in val])


def write_qwen3_speaker_gguf(path: Union[str, Path], seed: int = 0,
                             cfg: EcapaConfig = EcapaConfig()) -> Path:
    """A GGUF holding only a Qwen3-TTS speaker section (and the LM hidden
    it feeds), which `create_speaker_encoder` reads."""
    wr = GGUFWriter(path, "qwen3_tts_tokenizer")
    wr.add_uint32("codec.sample_rate", cfg.sample_rate)
    wr.add_bool("codec.has_decoder", False)
    wr.add_uint32("codec.lm.hidden_dim", cfg.hidden_dim)
    add_ecapa_speaker(wr, seed, cfg)
    wr.write()
    return Path(path)
