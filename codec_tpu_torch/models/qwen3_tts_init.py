"""Random Qwen3-TTS-Tokenizer weights and GGUF files from a seed.

Shapes mirror Qwen3-TTS-Tokenizer-12Hz by default, the widths of
tests/test_qwen3_tts_parity.py's full-size gate (the reference converter's
defaults): 16 codebooks of 2048 x 1024 (the first semantic), latent 1024, a
pre-transformer of 1024 x 8 layers x 16 heads (16 KV heads) x 64 with
intermediate 3072 and q/k/v/o biases, one upsample stage of ratio 2 (its
ConvNeXt at the gate's intermediate 3072), a decoder of 1536 channels
halving over rates 8/6/5/4 (hop 1920), residual units of kernel 7 (the
DAC-style unit; no checkpoint here fixes it, the gate's tiny mirror uses
3), and a sliding window of 72 frames (0 writes full causal attention).
With `encoder=True` the file also holds the encoder, a Mimi (kyutai/mimi
widths: hidden 512, 8 layers of 8 heads, intermediate 2048, 16 codebooks of
2048 x 256) drawn by models/mimi_init.py and written under the Mimi wire
names with the `.cb.embed` codebook alias, as the converter writes it.
`write_random_q3t_gguf` writes them under the wire names and KVs both
packages' loaders read (those codec_tpu/convert/qwen3_tts_tokenizer.py
writes), so `load_model(path)` runs its real path with no download.

Weights are drawn fan-in scaled, std gain/sqrt(fan_in), as in dac_init.py
(at a flat scale a 1536-channel stack leaves f32's range); norm scales
N(1, 0.1), biases N(0, 0.01), layer scales N(0.1, 0.01), codebook rows
N(0, 1); snake-beta's α and 1/β as the converter bakes them, exp(N(0,
0.1)) and 1/(exp(N(0, 0.1)) + 1e-9); the final conv at gain 0.1
(`_FINAL_GAIN`) so the clamp to ±1 leaves the output unsaturated, the
residual units' 1x1 at 0.3 (`_UNIT_GAIN`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .mimi import MimiConfig
from .mimi_init import add_mimi_encoder, random_mimi_params
from .qwen3_tts import RES_DILATIONS, Q3TConfig

_BIAS_STD = 0.01
_FINAL_GAIN = 0.1
# the residual units' 1x1: at gain 1 each unit adds its input's variance
# again and twelve units grow the signal ~64x
_UNIT_GAIN = 0.3
# the residual units' dilated conv (the DAC-style unit; no checkpoint here
# fixes it, the gate's tiny mirror uses 3)
UNIT_KERNEL = 7
QWEN3_TTS_12HZ = Q3TConfig(window=72, upsampling_ratios=(2,),
                           upsample_rates=(8, 6, 5, 4))
QWEN3_ENCODER = MimiConfig(n_q=16, codebook_size=2048, codebook_dim=256,
                           hidden=512, n_layers=8, n_heads=8, head_dim=64,
                           intermediate=2048, has_encoder=True,
                           has_decoder=False)


def random_q3t_params(cfg: Q3TConfig = QWEN3_TTS_12HZ, seed: int = 0,
                      biases: bool = True) -> Dict[str, np.ndarray]:
    """Decoder weights by wire name, float32, PyTorch layouts."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def weight(name, shape, gain=1.0):
        p[name] = normal(shape, gain / np.sqrt(np.prod(shape[1:])))

    def wb(name, shape, gain=1.0):
        weight(name + ".w", shape, gain)
        p[name + ".b"] = normal((shape[0],), _BIAS_STD)

    def convtr(name, c_in, c_out, stride):
        """A ConvTranspose [C_in, C_out, 2·stride]: each output sums
        C_in·2 taps."""
        p[name + ".w"] = normal((c_in, c_out, 2 * stride),
                                1.0 / np.sqrt(2 * c_in))
        p[name + ".b"] = normal((c_out,), _BIAS_STD)

    def snake(name, c):
        p[name + ".a"] = np.exp(normal((c,), 0.1))
        p[name + ".binv"] = (1.0 / (np.exp(normal((c,), 0.1)) + 1e-9)
                             ).astype(np.float32)

    lat, hid, cbd = cfg.latent_dim, cfg.hidden, cfg.codebook_dim
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    for qi in range(cfg.n_q):
        p[f"q3t.dec.q.l{qi}.codebook"] = normal((cfg.codebook_size, cbd), 1.0)
    weight("q3t.dec.q.s.op.w", (lat, cbd))
    weight("q3t.dec.q.a.op.w", (lat, cbd))
    wb("q3t.dec.pre.conv", (lat, lat, 3))
    wb("q3t.dec.pt.in", (hid, lat))
    for li in range(cfg.n_layers):
        pre = f"q3t.dec.pt.l{li}"
        p[pre + ".inln.w"] = normal((hid,), 0.1, 1.0)
        p[pre + ".paln.w"] = normal((hid,), 0.1, 1.0)
        for n, shape in (("q", (hq, hid)), ("k", (hkv, hid)),
                         ("v", (hkv, hid)), ("o", (hid, hq))):
            weight(f"{pre}.attn.{n}.w", shape)
            if biases:
                p[f"{pre}.attn.{n}.b"] = normal((shape[0],), _BIAS_STD)
        weight(pre + ".mlp.gate.w", (cfg.intermediate, hid))
        weight(pre + ".mlp.up.w", (cfg.intermediate, hid))
        weight(pre + ".mlp.down.w", (hid, cfg.intermediate))
        p[pre + ".sa.scale"] = normal((hid,), 0.01, 0.1)
        p[pre + ".mlp.scale"] = normal((hid,), 0.01, 0.1)
    p["q3t.dec.pt.norm.w"] = normal((hid,), 0.1, 1.0)
    wb("q3t.dec.pt.out", (lat, hid))
    inter = cfg.intermediate                   # the gate's ConvNeXt width
    for ui, ratio in enumerate(cfg.upsampling_ratios):
        pre = f"q3t.dec.up{ui}"
        convtr(pre + ".tr", lat, lat, ratio)
        wb(pre + ".cnx.dw", (lat, 1, 7))
        p[pre + ".cnx.norm.w"] = normal((lat,), 0.1, 1.0)
        p[pre + ".cnx.norm.b"] = normal((lat,), _BIAS_STD)
        wb(pre + ".cnx.pw1", (inter, lat))
        wb(pre + ".cnx.pw2", (lat, inter))
        p[pre + ".cnx.gamma"] = normal((lat,), 0.01, 0.1)
    ch = cfg.decoder_dim
    wb("q3t.dec.d0", (ch, lat, 7))
    for bi, rate in enumerate(cfg.upsample_rates):
        pre = f"q3t.dec.b{bi}"
        snake(pre + ".s0", ch)
        convtr(pre + ".tr", ch, ch // 2, rate)
        ch //= 2
        for ri in range(len(RES_DILATIONS)):
            snake(f"{pre}.r{ri}.s1", ch)
            wb(f"{pre}.r{ri}.c1", (ch, ch, UNIT_KERNEL))
            snake(f"{pre}.r{ri}.s2", ch)
            wb(f"{pre}.r{ri}.c2", (ch, ch, 1), gain=_UNIT_GAIN)
    snake("q3t.dec.final.s", ch)
    wb("q3t.dec.final", (1, ch, 7), gain=_FINAL_GAIN)
    return p


def write_random_q3t_gguf(path: Union[str, Path], seed: int = 0,
                          cfg: Q3TConfig = QWEN3_TTS_12HZ,
                          encoder: bool = True,
                          enc_cfg: MimiConfig = QWEN3_ENCODER,
                          num_filters: int = 64,
                          biases: bool = True) -> None:
    """A Qwen3-TTS-Tokenizer GGUF (F32) with random weights from `seed`:
    the decoder, and with `encoder` the Mimi encoder (drawn from seed + 1,
    so a seed gives the same decoder with or without it)."""
    wr = GGUFWriter(path, "qwen3_tts_tokenizer")
    wr.add_name("Qwen3-TTS-Tokenizer")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.num_semantic_quantizers", cfg.n_sem),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.latent_dim),
                     ("qwen3.encoder.codebook_size", enc_cfg.codebook_size),
                     ("qwen3.encoder.codebook_dim", enc_cfg.codebook_dim),
                     ("qwen3.encoder.n_q", enc_cfg.n_q),
                     ("qwen3.encoder.hidden_size", enc_cfg.hidden),
                     ("qwen3.encoder.num_hidden_layers", enc_cfg.n_layers),
                     ("qwen3.encoder.num_attention_heads", enc_cfg.n_heads),
                     ("qwen3.encoder.head_dim", enc_cfg.head_dim),
                     ("qwen3.encoder.intermediate_size", enc_cfg.intermediate),
                     ("qwen3.decoder.hidden_size", cfg.hidden),
                     ("qwen3.decoder.num_hidden_layers", cfg.n_layers),
                     ("qwen3.decoder.num_attention_heads", cfg.n_heads),
                     ("qwen3.decoder.num_key_value_heads", cfg.n_kv_heads),
                     ("qwen3.decoder.head_dim", cfg.head_dim),
                     ("qwen3.decoder.intermediate_size", cfg.intermediate),
                     ("qwen3.decoder.sliding_window", cfg.window or 0),
                     ("qwen3.decoder.decoder_dim", cfg.decoder_dim)):
        wr.add_uint32(key, val)
    wr.add_float32("qwen3.encoder.rope_theta", enc_cfg.rope_theta)
    wr.add_float32("qwen3.encoder.rope_scaling_factor",
                   1.0 / enc_cfg.freq_scale)
    wr.add_float32("qwen3.decoder.rope_theta", cfg.rope_theta)
    wr.add_array("qwen3.decoder.upsample_rates", list(cfg.upsample_rates))
    wr.add_array("qwen3.decoder.upsampling_ratios",
                 list(cfg.upsampling_ratios))
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in random_q3t_params(cfg, seed, biases).items():
        wr.add_tensor(name, arr, "F32")
    if encoder:
        enc = dataclasses.replace(enc_cfg, has_encoder=True,
                                  has_decoder=False)
        ep = random_mimi_params(enc, num_filters, seed + 1)
        for group, key in (("s", "cb_sem"), ("a", "cb_acu")):
            for i, cb in enumerate(ep[key]):
                wr.add_tensor(f"q.{group}.layers.{i}.cb.embed",
                              cb.float().numpy(), "F32")
        add_mimi_encoder(wr, ep)
    wr.write()
