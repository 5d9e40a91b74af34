"""Random merged TTS GGUFs from a seed: a codec with its LM adaptor (and,
where the flow reads one, a baked SPM tokenizer), for the three adaptor
kinds past CSM's. The port's own copy of
codec_tpu/models/bench_lm_init.py's adaptor writers; both packages read
the files.

Widths default to the published ones:

  - Pocket-TTS (kyutai/pocket-tts): flow_lm d_model 1024, 6 layers, 16
    heads x 64, ffn 4096, ldim 32, flow_dim 512, flow_depth 6, 4000 text
    bins (bench_lm_init.py:13-15, after the reference's
    src/lm/flow_lm.cpp:50-62), over the full-width Pocket-Mimi of
    pocket_init.py with its encoder (voice prompts).
  - MOSS-TTSD (fnlp/MOSS-TTSD-v0.5): parallel_heads_delay over a
    Qwen3-1.7B-wide backbone (hidden 2048, 28 layers, 16 query heads x
    128, 8 KV heads, ffn 6144, qk-norm, rope_theta 1e6), 8 codebooks with
    delay pattern 0..7 and heads tied to the tables, cb0 the merged text
    vocabulary (152 697) and cb1-7 1025 codes each (the fields of
    codec_tpu/convert/lm_adaptor.py:54-95), over the full-width
    XY-Tokenizer of xy_init.py. The merged vocabulary's speech range, pad
    and EOS ids are chosen inside it for the fixture.
  - BlueMagpie (VoxCPM-shaped): continuous_latent_cfm at
    bench_lm_init.py's write_cfm_gguf defaults (hidden 1024, h_vox 2048,
    LocEnc 12 and LocDiT 12 layers at 1024 with ffn 4096, RALM 8 layers at
    2048, 16 / 2 heads x 128, patch 4, latent 64, FSQ 9; after the
    reference's benchmarks/bluemagpie_cfm_baseline.json) over the
    full-width BlueMagpie AudioVAE of bluemagpie_init.py, with a backbone
    of hidden 1024 (MiniCPM4-0.5B's widths: 24 layers, 16 heads x 64, 2 KV
    heads, ffn 4096, vocabulary 73 448).

  - LFM2-Audio (LiquidAI/LFM2-Audio-1.5B, config.json): residual_depth_ar
    with per-position in_proj (and bias), per-head pre-norms, no output
    norm, qk-norm, interleaved RoPE theta 1e6 and c0 modality "none"
    (codec_tpu/convert/lm_adaptor.py:479-553): the depthformer at dim
    1024, 6 layers, 32 heads x 32, 8 KV heads (the converter's :486-487),
    its FFN width 4096 assumed (config.json omits it; the converter reads
    it from w1), 8 codebooks of 2048 + 1 (EOS) codes, the backbone-side
    compose table [8 x 2049, 2048], over lfm hidden 2048 and the
    full-width Mimi of mimi_init.py (its 8 first codebooks). Its backbone
    is llama-style at LFM2-1.2B's widths (LFM2_1_2B; codec_tpu's
    create_backbone runs llama decoders only, not LFM2's short-conv
    blocks): hidden 2048, 16 layers, 32 heads x 64, 8 KV heads, ffn 8192,
    vocabulary 65 536, qk-norm, RoPE theta 1e6.
  - MOSS-TTS-Realtime: residual_depth_ar with c0 modality "none"
    (lm_adaptor.py:559-620) over a Qwen3-1.7B-wide backbone (QWEN3_1_7B),
    16 codebooks of 1024 codes + pad (1024), BOS (1025) and EOS (1026)
    over the full-width MOSS-Audio-Tokenizer of moss_init.py, the compose
    table [16 x 1027, 2048]. The local transformer's widths are assumed
    (the repo holds no published config): 4 layers, 8 heads x 128, 2 KV
    heads, ffn 4096, qk-norm, RoPE theta 1e6, at the backbone's hidden 2048
    (the converter writes no in_proj, so the local hidden must be the
    backbone's).
  - Qwen3-MoE (Qwen/Qwen3-30B-A3B, config.json; QWEN3_30B_A3B): hidden
    2048, 48 layers, 32 heads x 128, 4 KV heads, 128 experts of which 8
    are used, moe_intermediate_size 768, norm_topk_prob, qk-norm, RoPE
    theta 1e6, vocabulary 151 936, untied head; written by
    lm_init.write_random_backbone_gguf. Its hidden equals MOSS-TTSD's.

Matrices are drawn at 1/sqrt(fan-in) (heads at 3/sqrt(fan-in), so their
logits are peaked), norm scales N(1, 0.02), biases N(0, 0.02); adaptor
tensors are written F16 (as the reference's converters write them), the
codecs F32. The CFM's rotate-half RoPE tables are baked from theta 10000,
as the reference's converter bakes them.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..io.gguf import GGUFWriter, encode_tensor
from ..lm.backbone import BackboneConfig
from .bluemagpie_init import BLUEMAGPIE, write_random_bm_gguf
from .lm_init import byte_fallback_vocab, spm_model_b64
from .mimi import MimiConfig
from .mimi_init import add_random_mimi
from .moss_audio import MossConfig
from .moss_init import MOSS_FULL, write_random_moss_gguf
from .pocket_init import POCKET_CHANNELS, POCKET_TTS, write_random_pocket_gguf
from .xy_init import write_random_xy_gguf

QWEN3_1_7B = BackboneConfig(
    hidden=2048, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    ffn_dim=6144, vocab_size=152697, rope_theta=1000000.0, rms_eps=1e-6,
    max_ctx=2048, has_qk_norm=True, tied_lm_head=True)
LFM2_1_2B = BackboneConfig(
    hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
    ffn_dim=8192, vocab_size=65536, rope_theta=1000000.0, rms_eps=1e-5,
    max_ctx=2048, has_qk_norm=True, tied_lm_head=True)
QWEN3_30B_A3B = BackboneConfig(
    hidden=2048, n_layers=48, n_heads=32, n_kv_heads=4, head_dim=128,
    ffn_dim=6144, vocab_size=151936, rope_theta=1000000.0, rms_eps=1e-6,
    max_ctx=2048, has_qk_norm=True, tied_lm_head=False, n_experts=128,
    n_experts_used=8, norm_topk_prob=True, moe_ffn_dim=768)
MINICPM4_0_5B = BackboneConfig(
    hidden=1024, n_layers=24, n_heads=16, n_kv_heads=2, head_dim=64,
    ffn_dim=4096, vocab_size=73448, rope_theta=10000.0, rms_eps=1e-5,
    max_ctx=2048, tied_lm_head=True)


@dataclass(frozen=True)
class FlowLmConfig:
    """A flow_lm adaptor's widths (Pocket-TTS's by default)."""
    d_model: int = 1024
    n_layers: int = 6
    n_heads: int = 16
    head_dim: int = 64
    ffn: int = 4096
    ldim: int = 32
    flow_dim: int = 512
    flow_depth: int = 6
    n_bins: int = 4000
    lsd_steps: int = 2


@dataclass(frozen=True)
class PhdConfig:
    """A parallel_heads_delay adaptor's widths and merged-vocabulary ids
    (MOSS-TTSD v0.5's widths by default)."""
    hidden: int = 2048
    n_codebook: int = 8
    text_vocab: int = 152697
    audio_vocab: int = 1025
    speech_start: int = 151665
    speech_end: int = 152689
    speech_pad: int = 1024
    eos_code_c0: int = 152694
    eos_min_step: int = 0


@dataclass(frozen=True)
class Lfm2Config:
    """An LFM2-Audio residual_depth_ar adaptor's widths and ids
    (LFM2-Audio-1.5B's; the FFN width is assumed). `audio_start_id`,
    `text_end_id` and `max_text_tokens` are the text phase's (codec.lm.*
    KVs the converter leaves to PromptInfo's defaults)."""
    hidden: int = 2048            # the backbone's (lfm hidden)
    depth_hidden: int = 1024
    layers: int = 6
    heads: int = 32
    kv_heads: int = 8
    ffn: int = 4096
    n_codebook: int = 8
    audio_vocab: int = 2049       # 2048 codes + EOS
    eos_min_step: int = 0
    audio_start_id: int = 128
    text_end_id: int = 7
    max_text_tokens: int = 64


@dataclass(frozen=True)
class RealtimeConfig:
    """A MOSS-TTS-Realtime residual_depth_ar adaptor's widths and ids (the
    local transformer's widths assumed)."""
    hidden: int = 2048            # the backbone's = the local transformer's
    layers: int = 4
    heads: int = 8
    kv_heads: int = 2
    head_dim: int = 128
    ffn: int = 4096
    n_codebook: int = 16
    audio_vocab: int = 1027       # 1024 codes, pad 1024, BOS 1025, EOS 1026
    audio_eos_token: Optional[int] = None     # None: audio_vocab - 1
    eos_min_step: int = 0
    prefill_text_len: int = 12
    text_pad: int = 151655


@dataclass(frozen=True)
class CfmConfig:
    """A continuous_latent_cfm adaptor's widths (BlueMagpie's by default)."""
    hidden: int = 1024           # the backbone's (h_barbet)
    h_vox: int = 2048
    h_enc: int = 1024
    h_dit: int = 1024
    latent_dim: int = 64
    patch_size: int = 4
    n_heads: int = 16
    n_kv: int = 2
    head_dim: int = 128
    n_locenc: int = 12
    n_locdit: int = 12
    n_ralm: int = 8
    ffn_mult: int = 4
    fsq_latent: int = 8
    fsq_scale: int = 9
    min_len: int = 0
    rope_rows: int = 4096


class _Draw:
    """Seeded draws for one writer: fan-in scaled matrices, norm scales and
    biases, each from its own child of the seed's SeedSequence (so the
    weights depend on the seed and the order of the calls only), drawn and
    encoded F16 on a pool of threads (NumPy leaves the GIL in its fills
    and casts) and added to the writer in call order."""

    def __init__(self, wr: GGUFWriter, seed: int):
        self.wr, self.seeds = wr, np.random.SeedSequence(seed)
        self.pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
        self.queue = []

    def __enter__(self) -> "_Draw":
        return self

    def __exit__(self, *exc) -> None:
        try:
            while self.queue and exc[0] is None:
                self._add_oldest()
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)

    def _normal(self, shape, scale: float, mean: float = 0.0):
        (child,) = self.seeds.spawn(1)
        return lambda: np.random.default_rng(child).standard_normal(
            shape, dtype=np.float32) * np.float32(scale) + np.float32(mean)

    def mat(self, out_d: int, in_d: int, gain: float = 1.0):
        return self._normal((out_d, in_d), gain / math.sqrt(in_d))

    def vec(self, shape, std: float = 0.02, mean: float = 0.0):
        return self._normal(shape, std, mean)

    def add(self, name: str, src) -> None:
        """Add tensor `name`: an array, or a draw from mat() / vec()."""
        make = src if callable(src) else (lambda: src)
        self.queue.append((name, self.pool.submit(
            lambda: encode_tensor(make(), "F16"))))
        while len(self.queue) > 32:
            self._add_oldest()

    def _add_oldest(self) -> None:
        name, fut = self.queue.pop(0)
        self.wr.add_encoded(name, fut.result())


def add_flow_lm(wr: GGUFWriter, seed: int = 0,
                cfg: FlowLmConfig = FlowLmConfig(), spm_b64: str = "") -> None:
    """Add a Pocket-TTS flow_lm adaptor (F16) to an open codec writer: the
    AR transformer, text LUT, LSD flow head, EOS head, latent stats and
    speaker projection; `spm_b64` bakes its tokenizer."""
    dm, fd, ld = cfg.d_model, cfg.flow_dim, cfg.ldim
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "flow_lm")
    for key, val in (("d_model", dm), ("n_layers", cfg.n_layers),
                     ("n_heads", cfg.n_heads), ("head_dim", cfg.head_dim),
                     ("ffn_dim", cfg.ffn), ("ldim", ld), ("flow_dim", fd),
                     ("flow_depth", cfg.flow_depth), ("n_txt_bins", cfg.n_bins),
                     ("lsd_decode_steps", cfg.lsd_steps)):
        wr.add_uint32(f"codec.lm.{key}", val)
    wr.add_bool("codec.lm.insert_bos_before_voice", True)
    wr.add_float32("codec.lm.eos_threshold", -4.0)
    if spm_b64:
        wr.add_string("codec.lm.tokenizer.spm_b64", spm_b64)

    with _Draw(wr, seed) as d:
        _flow_tensors(d, cfg)


def _flow_tensors(d: _Draw, cfg: FlowLmConfig) -> None:
    add = d.add
    dm, fd, ld = cfg.d_model, cfg.flow_dim, cfg.ldim
    qd = cfg.n_heads * cfg.head_dim
    add("lm.text.embed.w", d.vec((cfg.n_bins + 1, dm), std=1.0))
    add("lm.bos_before_voice", d.vec(dm, std=1.0))
    add("lm.bos_emb", d.vec(ld, std=1.0))
    add("lm.input_linear.w", d.mat(dm, ld))
    add("lm.out_norm.w", d.vec(dm, mean=1.0))
    add("lm.out_norm.b", d.vec(dm))
    add("lm.out_eos.w", d.mat(1, dm))
    add("lm.out_eos.b", d.vec(1))
    add("lm.emb_std", d.vec(ld, std=0.1, mean=1.0))
    add("lm.emb_mean", d.vec(ld, std=0.1))
    add("lm.speaker_proj.w", d.mat(dm, ld))
    for li in range(cfg.n_layers):
        p = f"lm.tf.l{li}"
        add(p + ".inln.w", d.vec(dm, mean=1.0))
        add(p + ".inln.b", d.vec(dm))
        add(p + ".paln.w", d.vec(dm, mean=1.0))
        add(p + ".paln.b", d.vec(dm))
        add(p + ".attn.q_proj.w", d.mat(qd, dm))
        add(p + ".attn.k_proj.w", d.mat(qd, dm))
        add(p + ".attn.v_proj.w", d.mat(qd, dm))
        add(p + ".attn.o_proj.w", d.mat(dm, qd))
        add(p + ".mlp.fc1.w", d.mat(cfg.ffn, dm))
        add(p + ".mlp.fc2.w", d.mat(dm, cfg.ffn))
    add("lm.flow.input_proj.w", d.mat(fd, ld))
    add("lm.flow.input_proj.b", d.vec(fd))
    add("lm.flow.cond_embed.w", d.mat(fd, dm))
    add("lm.flow.cond_embed.b", d.vec(fd))
    add("lm.flow.final.adaln.w", d.mat(2 * fd, fd))
    add("lm.flow.final.adaln.b", d.vec(2 * fd))
    add("lm.flow.final.linear.w", d.mat(ld, fd))
    add("lm.flow.final.linear.b", d.vec(ld))
    for i in range(2):
        p = f"lm.flow.time_embed.{i}"
        add(p + ".freqs", np.exp(-math.log(10000.0) * np.arange(fd // 2)
                                 / (fd // 2)).astype(np.float32))
        add(p + ".l1.w", d.mat(fd, fd))
        add(p + ".l1.b", d.vec(fd))
        add(p + ".l2.w", d.mat(fd, fd))
        add(p + ".l2.b", d.vec(fd))
        add(p + ".rms.alpha", d.vec(fd, mean=1.0))
    for b in range(cfg.flow_depth):
        p = f"lm.flow.res.{b}"
        add(p + ".adaln.w", d.mat(3 * fd, fd))
        add(p + ".adaln.b", d.vec(3 * fd))
        add(p + ".in_ln.w", d.vec(fd, mean=1.0))
        add(p + ".in_ln.b", d.vec(fd))
        add(p + ".mlp.l1.w", d.mat(2 * fd, fd))
        add(p + ".mlp.l1.b", d.vec(2 * fd))
        add(p + ".mlp.l2.w", d.mat(fd, 2 * fd))
        add(p + ".mlp.l2.b", d.vec(fd))


def add_phd(wr: GGUFWriter, seed: int = 0, cfg: PhdConfig = PhdConfig()) -> None:
    """Add a MOSS-TTSD parallel_heads_delay adaptor (F16) to an open codec
    writer: host_arch qwen3, heads tied to the per-codebook tables, delay
    pattern 0..N-1, the merged cb0 vocabulary's speech range, pad and EOS
    ids. The tables are drawn at 3/sqrt(hidden), so a tied head's logits
    over a unit-RMS hidden have a standard deviation near 3."""
    h, n_cb = cfg.hidden, cfg.n_codebook
    sizes = [cfg.text_vocab] + [cfg.audio_vocab] * (n_cb - 1)
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "parallel_heads_delay")
    wr.add_string("codec.lm.host_arch", "qwen3")
    wr.add_uint32("codec.lm.hidden_dim", h)
    wr.add_uint32("codec.lm.audio_embed_dim", h)
    wr.add_uint32("codec.lm.n_codebook", n_cb)
    wr.add_array("codec.lm.codebook_sizes", sizes)
    wr.add_array("codec.lm.delay_pattern", list(range(n_cb)))
    wr.add_bool("codec.lm.parallel.tied_heads_to_embd", True)
    wr.add_int32("codec.lm.eos_code_c0", cfg.eos_code_c0)
    wr.add_int32("codec.lm.eos_min_step", cfg.eos_min_step)
    wr.add_array("codec.lm.speech_token_range",
                 [cfg.speech_start, cfg.speech_end])
    wr.add_int32("codec.lm.cb0_speech_offset", cfg.speech_start)
    wr.add_int32("codec.lm.cb0_speech_range_end", cfg.speech_end)
    wr.add_uint32("codec.lm.speech_pad_token", cfg.speech_pad)
    with _Draw(wr, seed) as d:
        for i, v in enumerate(sizes):
            d.add(f"lm.audio_embd_{i}.weight", d.mat(v, h, gain=3.0))


def _depth_kvs(wr: GGUFWriter, layers, hidden, heads, kv_heads, head_dim,
               ffn, eps, **flags) -> None:
    """The residual_depth_ar depth KVs (lm_adaptor.py's _depth_meta)."""
    for key, val in (("depth_layers", layers), ("depth_hidden", hidden),
                     ("depth_n_heads", heads), ("depth_n_kv_heads", kv_heads),
                     ("depth_head_dim", head_dim),
                     ("depth_intermediate", ffn)):
        wr.add_uint32(f"codec.lm.residual.{key}", val)
    wr.add_float32("codec.lm.residual.depth_rms_norm_eps", eps)
    wr.add_float32("codec.lm.residual.depth_rope_theta", 1000000.0)
    for k, v in flags.items():
        if isinstance(v, bool):
            wr.add_bool(f"codec.lm.residual.{k}", v)
        else:
            wr.add_string(f"codec.lm.residual.{k}", v)


def _depth_layers(d: _Draw, layers, hidden, heads, kv_heads, head_dim,
                  ffn) -> None:
    for li in range(layers):
        p = f"lm.depth.blk_{li}"
        d.add(f"{p}.attn_norm.weight", d.vec(hidden, mean=1.0))
        d.add(f"{p}.q.weight", d.mat(heads * head_dim, hidden))
        d.add(f"{p}.k.weight", d.mat(kv_heads * head_dim, hidden))
        d.add(f"{p}.v.weight", d.mat(kv_heads * head_dim, hidden))
        d.add(f"{p}.o.weight", d.mat(hidden, heads * head_dim))
        d.add(f"{p}.q_norm.weight", d.vec(head_dim, mean=1.0))
        d.add(f"{p}.k_norm.weight", d.vec(head_dim, mean=1.0))
        d.add(f"{p}.ffn_norm.weight", d.vec(hidden, mean=1.0))
        d.add(f"{p}.ffn_gate.weight", d.mat(ffn, hidden))
        d.add(f"{p}.ffn_up.weight", d.mat(ffn, hidden))
        d.add(f"{p}.ffn_down.weight", d.mat(hidden, ffn))


def add_lfm2(wr: GGUFWriter, seed: int = 0, cfg: Lfm2Config = Lfm2Config()) -> None:
    """Add an LFM2-Audio residual_depth_ar adaptor (F16; biases and norms
    too) to an open codec writer: the KVs and tensor names of
    codec_tpu/convert/lm_adaptor.py::dump_lfm2_audio, plus the text
    phase's ids. The compose table is drawn at 0.5 / sqrt(n_codebook) a
    row, so a frame's sum has about the scale of a unit-RMS embedding."""
    n, v, dh, bh = cfg.n_codebook, cfg.audio_vocab, cfg.depth_hidden, cfg.hidden
    hd = dh // cfg.heads
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "residual_depth_ar")
    wr.add_string("codec.lm.host_arch", "lfm2")
    wr.add_uint32("codec.lm.hidden_dim", bh)
    wr.add_uint32("codec.lm.audio_embed_dim", dh)
    wr.add_uint32("codec.lm.n_codebook", n)
    wr.add_array("codec.lm.codebook_sizes", [v] * n)
    wr.add_array("codec.lm.delay_pattern", [0] * n)
    wr.add_bool("codec.lm.parallel.tied_heads_to_embd", False)
    wr.add_int32("codec.lm.eos_code_c0", v - 1)
    wr.add_int32("codec.lm.eos_min_step", cfg.eos_min_step)
    wr.add_int32("codec.lm.audio_start_id", cfg.audio_start_id)
    wr.add_int32("codec.lm.text_end_id", cfg.text_end_id)
    wr.add_int32("codec.lm.max_text_tokens", cfg.max_text_tokens)
    _depth_kvs(wr, cfg.layers, dh, cfg.heads, cfg.kv_heads, hd, cfg.ffn, 1e-5,
               depth_has_in_proj=True, depth_has_qk_norm=True,
               depth_has_output_norm=False, depth_use_rope=True,
               depth_rope_interleaved=True, depth_in_proj_per_pos=True,
               depth_in_proj_has_bias=True, depth_has_pre_head_norm=True,
               depth_emits_c0=True, weight_layout="shared",
               c0_input_modality="none")
    wr.add_uint32("codec.lm.residual.depth_max_position", 128000)
    wr.add_uint32("codec.lm.compose.audio_embed_dim", bh)
    wr.add_uint32("codec.lm.compose.codebook_stride", v)
    with _Draw(wr, seed) as d:
        d.add("lm.depth.in_proj.weight", d._normal((n, dh, bh),
                                                   1.0 / math.sqrt(bh)))
        d.add("lm.depth.in_proj.bias", d.vec((n, dh)))
        d.add("lm.compose.audio_embd.weight",
              d.vec((n * v, bh), std=0.5 / math.sqrt(n)))
        for i in range(n):
            d.add(f"lm.depth.audio_embd_{i}.weight", d.vec((v, dh), std=1.0))
            d.add(f"lm.depth.heads_{i}.weight", d.mat(v, dh, gain=3.0))
            d.add(f"lm.depth.heads_{i}_norm.weight", d.vec(dh, mean=1.0))
        _depth_layers(d, cfg.layers, dh, cfg.heads, cfg.kv_heads, hd, cfg.ffn)


def add_realtime(wr: GGUFWriter, seed: int = 0,
                 cfg: RealtimeConfig = RealtimeConfig()) -> None:
    """Add a MOSS-TTS-Realtime residual_depth_ar adaptor (F16) to an open
    codec writer: the KVs and tensor names of codec_tpu/convert/
    lm_adaptor.py::dump_moss_tts_realtime (the last depth table a copy of
    the one before it, the converter's placeholder), plus the streaming
    KVs PromptInfo reads (audio pad, text pad, prefill length)."""
    n, v, h = cfg.n_codebook, cfg.audio_vocab, cfg.hidden
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "residual_depth_ar")
    wr.add_string("codec.lm.host_arch", "qwen3")
    wr.add_uint32("codec.lm.hidden_dim", h)
    wr.add_uint32("codec.lm.audio_embed_dim", h)
    wr.add_uint32("codec.lm.n_codebook", n)
    wr.add_array("codec.lm.codebook_sizes", [v] * n)
    wr.add_array("codec.lm.delay_pattern", [0] * n)
    wr.add_bool("codec.lm.parallel.tied_heads_to_embd", False)
    wr.add_int32("codec.lm.eos_code_c0", v - 1 if cfg.audio_eos_token is None
                 else cfg.audio_eos_token)
    wr.add_int32("codec.lm.eos_min_step", cfg.eos_min_step)
    wr.add_int32("codec.lm.bos_code_c0", v - 2)
    wr.add_int32("codec.lm.audio_pad_token", v - 3)
    wr.add_int32("codec.lm.text_pad", cfg.text_pad)
    wr.add_int32("codec.lm.compose.prefill_text_len", cfg.prefill_text_len)
    _depth_kvs(wr, cfg.layers, h, cfg.heads, cfg.kv_heads, cfg.head_dim,
               cfg.ffn, 1e-6, depth_has_in_proj=False, depth_has_qk_norm=True,
               depth_use_rope=True, depth_emits_c0=True,
               weight_layout="shared", c0_input_modality="none")
    wr.add_uint32("codec.lm.residual.depth_max_position", 33)
    wr.add_string("codec.lm.depth.arch", "qwen3")
    wr.add_bool("codec.lm.compose.text_externally_added", True)
    wr.add_uint32("codec.lm.compose.audio_embed_dim", h)
    wr.add_uint32("codec.lm.compose.codebook_stride", v)
    with _Draw(wr, seed) as d:
        tables = [d.vec((v, h), std=1.0) for _ in range(n - 1)]
        for i in range(n):
            d.add(f"lm.depth.audio_embd_{i}.weight", tables[min(i, n - 2)])
        for i in range(n):
            d.add(f"lm.depth.heads_{i}.weight", d.mat(v, h, gain=3.0))
        _depth_layers(d, cfg.layers, h, cfg.heads, cfg.kv_heads, cfg.head_dim,
                      cfg.ffn)
        d.add("lm.depth.output_norm.weight", d.vec(h, mean=1.0))
        d.add("lm.compose.audio_embd.weight",
              d.vec((n * v, h), std=0.5 / math.sqrt(n)))


def add_cfm(wr: GGUFWriter, seed: int = 0, cfg: CfmConfig = CfmConfig()) -> None:
    """Add a BlueMagpie continuous_latent_cfm adaptor (F16) to an open codec
    writer: host_arch barbet, the TSLM adapter and FSQ, RALM, LocDiT and
    LocEnc (split q/k/v and gate/up), their projections, the stop head and
    the baked rotate-half RoPE tables."""
    hb, hv, he, hd = cfg.hidden, cfg.h_vox, cfg.h_enc, cfg.h_dit
    lat, nh, nkv, hdim = cfg.latent_dim, cfg.n_heads, cfg.n_kv, cfg.head_dim
    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "continuous_latent_cfm")
    wr.add_string("codec.lm.host_arch", "barbet")
    for key, val in (("hidden_dim", hb), ("h_vox", hv), ("h_enc", he),
                     ("h_dit", hd), ("latent_dim", lat),
                     ("patch_size", cfg.patch_size), ("n_locenc", cfg.n_locenc),
                     ("n_locdit", cfg.n_locdit), ("n_ralm", cfg.n_ralm),
                     ("n_heads", nh), ("n_kv", nkv), ("head_dim", hdim),
                     ("fsq_latent", cfg.fsq_latent),
                     ("fsq_scale", cfg.fsq_scale), ("min_len", cfg.min_len)):
        wr.add_uint32(f"codec.lm.{key}", val)

    with _Draw(wr, seed) as d:
        _cfm_tensors(d, cfg)


def _cfm_tensors(d: _Draw, cfg: CfmConfig) -> None:
    add = d.add
    hb, hv, he, hd = cfg.hidden, cfg.h_vox, cfg.h_enc, cfg.h_dit
    lat, nh, nkv, hdim = cfg.latent_dim, cfg.n_heads, cfg.n_kv, cfg.head_dim

    def lin(prefix, out_d, in_d, bias=True):
        add(prefix + ".w", d.mat(out_d, in_d))
        if bias:
            add(prefix + ".b", d.vec(out_d))

    add("lm.tslm_adapter.norm.w", d.vec(hb, mean=1.0))
    lin("lm.tslm_adapter.proj", hv, hb)
    add("lm.tslm_adapter.blk0.ln.w", d.vec(hv, mean=1.0))
    add("lm.tslm_adapter.blk0.gate.w", d.mat(cfg.ffn_mult * hv, hv))
    add("lm.tslm_adapter.blk0.up.w", d.mat(cfg.ffn_mult * hv, hv))
    add("lm.tslm_adapter.blk0.down.w", d.mat(hv, cfg.ffn_mult * hv))
    lin("lm.fsq.in_proj", cfg.fsq_latent, hv)
    lin("lm.fsq.out_proj", hv, cfg.fsq_latent)
    lin("lm.proj.fusion_concat", hv, 2 * hv)
    lin("lm.proj.lm_to_dit", hd, hv)
    lin("lm.proj.res_to_dit", hd, hv)
    lin("lm.proj.enc_to_tslm", hb, he)
    lin("lm.proj.enc_to_lm", hv, he)
    lin("lm.stop.proj", hv, hv)
    add("lm.stop.head.w", d.mat(2, hv))
    add("lm.ralm.norm.w", d.vec(hv, mean=1.0))
    add("lm.locdit.norm.w", d.vec(hd, mean=1.0))
    lin("lm.locdit.in_proj", hd, lat)
    lin("lm.locdit.cond_proj", hd, lat)
    lin("lm.locdit.out_proj", lat, hd)
    lin("lm.locenc.in_proj", he, lat)
    add("lm.locenc.special_token", d.vec(he, std=1.0))
    add("lm.locenc.norm.w", d.vec(he, mean=1.0))
    inv = 10000.0 ** (-np.arange(0, hdim, 2, dtype=np.float64) / hdim)
    ang = np.arange(cfg.rope_rows, dtype=np.float64)[:, None] * inv[None]
    ang = np.concatenate([ang, ang], axis=1)
    add("lm.rope.cos", np.cos(ang).astype(np.float32))
    add("lm.rope.sin", np.sin(ang).astype(np.float32))
    for mlp in ("time_mlp", "dtime_mlp"):
        lin(f"lm.locdit.{mlp}.l1", hd, hd)
        lin(f"lm.locdit.{mlp}.l2", hd, hd)

    def block(prefix, hidden):
        ffn = cfg.ffn_mult * hidden
        add(prefix + ".ln1.w", d.vec(hidden, mean=1.0))
        add(prefix + ".ln2.w", d.vec(hidden, mean=1.0))
        add(prefix + ".attn_q.w", d.mat(nh * hdim, hidden))
        add(prefix + ".attn_k.w", d.mat(nkv * hdim, hidden))
        add(prefix + ".attn_v.w", d.mat(nkv * hdim, hidden))
        add(prefix + ".attn_o.w", d.mat(hidden, nh * hdim))
        add(prefix + ".gate.w", d.mat(ffn, hidden))
        add(prefix + ".up.w", d.mat(ffn, hidden))
        add(prefix + ".down.w", d.mat(hidden, ffn))

    for i in range(cfg.n_ralm):
        block(f"lm.ralm.layers.{i}", hv)
    for i in range(cfg.n_locdit):
        block(f"lm.locdit.layers.{i}", hd)
    for i in range(cfg.n_locenc):
        block(f"lm.locenc.layers.{i}", he)


def write_pocket_tts_gguf(path: Union[str, Path], seed: int = 0,
                          flow: FlowLmConfig = FlowLmConfig(),
                          codec_cfg=POCKET_TTS, channels=POCKET_CHANNELS,
                          ffn: int = 2048) -> Path:
    """Pocket-TTS: the random Pocket-Mimi (with its encoder) and a flow_lm
    adaptor from seed + 1, with the byte-fallback SPM vocabulary baked
    (its ids must be under flow.n_bins + 1)."""
    write_random_pocket_gguf(path, seed, cfg=codec_cfg, channels=channels,
                             ffn=ffn, encoder=True, extra=lambda wr: add_flow_lm(
                                 wr, seed + 1, flow,
                                 spm_model_b64(byte_fallback_vocab())))
    return Path(path)


def write_moss_ttsd_gguf(path: Union[str, Path], seed: int = 0,
                         phd: PhdConfig = PhdConfig(), xy_cfg=None,
                         **xy_widths) -> Path:
    """MOSS-TTSD: the random XY-Tokenizer (decoder only; `xy_cfg` and
    `xy_widths` as write_random_xy_gguf takes them) and a
    parallel_heads_delay adaptor from seed + 1."""
    kw = {} if xy_cfg is None else {"cfg": xy_cfg}
    write_random_xy_gguf(path, seed, encoder=False,
                         extra=lambda wr: add_phd(wr, seed + 1, phd),
                         **kw, **xy_widths)
    return Path(path)


def write_bluemagpie_tts_gguf(path: Union[str, Path], seed: int = 0,
                              cfm: CfmConfig = CfmConfig(),
                              codec_cfg=BLUEMAGPIE,
                              decoder_dim: int = 2048) -> Path:
    """BlueMagpie: the random AudioVAE (decoder only) and a
    continuous_latent_cfm adaptor from seed + 1."""
    write_random_bm_gguf(path, seed, cfg=codec_cfg, decoder_dim=decoder_dim,
                         encoder=False,
                         extra=lambda wr: add_cfm(wr, seed + 1, cfm))
    return Path(path)



def write_lfm2_audio_gguf(path: Union[str, Path], seed: int = 0,
                          lfm2: Lfm2Config = Lfm2Config(),
                          mimi_cfg: MimiConfig = MimiConfig(),
                          num_filters: int = 64) -> Path:
    """LFM2-Audio: the random Mimi (decoder only, F32) and an LFM2
    residual_depth_ar adaptor from seed + 1."""
    wr = GGUFWriter(path, "mimi")
    wr.add_name("LFM2-Audio")
    add_random_mimi(wr, seed, mimi_cfg, num_filters)
    add_lfm2(wr, seed + 1, lfm2)
    wr.write()
    return Path(path)


def write_moss_realtime_gguf(path: Union[str, Path], seed: int = 0,
                             rt: RealtimeConfig = RealtimeConfig(),
                             moss_cfg: MossConfig = MOSS_FULL) -> Path:
    """MOSS-TTS-Realtime: the random MOSS-Audio-Tokenizer (decoder only,
    F32) and a realtime residual_depth_ar adaptor from seed + 1."""
    write_random_moss_gguf(path, seed, cfg=moss_cfg,
                           extra=lambda wr: add_realtime(wr, seed + 1, rt))
    return Path(path)
