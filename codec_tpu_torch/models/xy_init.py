"""Random XY-Tokenizer weights and GGUF files from a seed.

Widths default to XY_Tokenizer_TTSD_V0's, those of
tests/test_xy_tokenizer_parity.py's full-size gate: 80-mel input (n_fft
400, hop 160, 16 kHz); two 768-wide Whisper encoders of 12 layers and 12
heads; semantic and pre-RVQ adapters of 4 layers (the pre-RVQ one projects
1536 → 768); ResidualDownConv over 4 frames to a 3072 latent; 8 codebooks
of 1024 x 512; a post-RVQ adapter of 4 layers (3072 → 768 → 3072); an
upsampling ConvTranspose of stride 4; a 12-layer acoustic decoder; Vocos of
width 512 with 30 ConvNeXt blocks; an iSTFT head of n_fft 960, hop 240, 24
kHz. The layers' MLPs are 4 x 768 = 3072 wide (Whisper's ratio), Vocos's
3 x 512 = 1536 (Vocos's ratio): the repo holds no checkpoint that fixes
them, and its mirror fixtures use 2x.

Positional tables cover 30 s at each module's frame rate: 1500 rows for
the encoders, both encoder adapters and the acoustic decoder (50 frames a
second), 375 for the post-RVQ adapter (12.5 codes a second), which makes a
decode window 375 codes (30 s).

`write_random_xy_gguf` writes them under the wire names and KVs both
packages' `load_xy_params` read (with the codebooks' squared norms, as the
reference runtime's files carry them), so `load_model(path)` runs its real
path with no download. The encoder is drawn after the rest, so a seed
gives the same decoder with or without it. All weights come from one
generator: fan-in scaled, std gain/sqrt(fan_in) (gain 0.5 on each
layer's attention output and second MLP product, so the residual stream
grows slowly over 12 layers, and on the iSTFT head, so the log-magnitudes'
lognormal tail keeps the PCM's peak well below 1); norm scales N(1, 0.1),
biases N(0, 0.01), positional rows N(0, 0.1), layer scales N(1/30, 0.01),
codebooks N(0, 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .xy_tokenizer import XyConfig

_BIAS_STD = 0.01


def random_xy_params(cfg: XyConfig = XyConfig(), seed: int = 0,
                     ffn_dim: int = 3072, vocos_dim: int = 512,
                     vocos_intermediate: int = 1536, enc_pos: int = 1500,
                     post_pos: int = 375, dec_pos: int = 1500,
                     encoder: bool = False) -> Dict[str, np.ndarray]:
    """Weights by wire name, float32, PyTorch layouts (linear [out, in],
    conv [C_out, C_in, K], conv-transpose [C_in, C_out, K])."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}
    d, lat = cfg.d_model, cfg.latent_dim

    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def weight(name, shape, gain=1.0, fan_in=None):
        p[name] = normal(shape, gain / np.sqrt(fan_in or np.prod(shape[1:])))

    def linear(name, shape, gain=1.0, bias=True):
        weight(name + ".w", shape, gain)
        if bias:
            p[name + ".b"] = normal((shape[0],), _BIAS_STD)

    def norm(name, c):
        p[name + ".w"] = normal((c,), 0.1, 1.0)
        p[name + ".b"] = normal((c,), _BIAS_STD)

    def module(base, n_layers, pos_rows, d_in=None, d_out=None):
        if d_in is not None:
            linear(base + ".proj", (d, d_in))
        p[base + ".pos_emb"] = normal((pos_rows, d), 0.1)
        for li in range(n_layers):
            lp = f"{base}.l{li}"
            norm(lp + ".norm1", d)
            linear(lp + ".attn.q", (d, d))
            linear(lp + ".attn.k", (d, d), bias=False)
            linear(lp + ".attn.v", (d, d))
            linear(lp + ".attn.out", (d, d), gain=0.5)
            norm(lp + ".norm2", d)
            linear(lp + ".mlp.fc1", (ffn_dim, d))
            linear(lp + ".mlp.fc2", (d, ffn_dim), gain=0.5)
        norm(base + ".layer_norm", d)
        if d_out is not None:
            linear(base + ".out_proj", (d_out, d))

    for qi in range(cfg.n_q):
        p[f"xy.q.{qi}.codebook"] = normal(
            (cfg.codebook_size, cfg.codebook_dim), 1.0)
        p[f"xy.q.{qi}.codebook_sq_norm"] = np.square(
            p[f"xy.q.{qi}.codebook"]).sum(-1)
    linear("xy.q.out_proj", (lat, cfg.codebook_dim, 1))
    module("xy.post_rvq_adapter", cfg.adapter_layers, post_pos, d_in=lat,
           d_out=lat)
    weight("xy.upsample.up_conv.w", (lat, d, cfg.upsample_stride),
           fan_in=lat)
    module("xy.acoust_dec", cfg.n_layers, dec_pos)
    weight("xy.acoust_dec.deconv1.w", (d, d, 3), fan_in=d * 2)
    p["xy.acoust_dec.deconv1.b"] = normal((d,), _BIAS_STD)
    weight("xy.acoust_dec.deconv2.w", (d, cfg.mel_n_mels, 1), fan_in=d)
    p["xy.acoust_dec.deconv2.b"] = normal((cfg.mel_n_mels,), _BIAS_STD)
    linear("xy.vocos.embed", (vocos_dim, cfg.mel_n_mels, 7))
    norm("xy.vocos.norm", vocos_dim)
    for bi in range(cfg.vocos_blocks):
        bp = f"xy.vocos.b{bi}"
        linear(bp + ".dwconv", (vocos_dim, 1, 7))
        norm(bp + ".norm", vocos_dim)
        linear(bp + ".pwconv1", (vocos_intermediate, vocos_dim))
        linear(bp + ".pwconv2", (vocos_dim, vocos_intermediate))
        p[bp + ".gamma"] = normal((vocos_dim,), 0.01, 1.0 / cfg.vocos_blocks)
    norm("xy.vocos.final_layer_norm", vocos_dim)
    linear("xy.vocos.head.out", (cfg.vocos_n_fft + 2, vocos_dim), gain=0.5)
    if not encoder:
        return p
    for enc in ("xy.sem_enc", "xy.acoust_enc"):
        linear(enc + ".conv1", (d, cfg.mel_n_mels, 3))
        linear(enc + ".conv2", (d, d, 3))
        module(enc, cfg.n_layers, enc_pos)
    module("xy.sem_enc_adapter", cfg.adapter_layers, enc_pos)
    module("xy.pre_rvq_adapter", cfg.adapter_layers, enc_pos, d_in=2 * d)
    weight("xy.downsample.gate.w", (lat, d, cfg.avg_pooler))
    weight("xy.downsample.up.w", (lat, d, cfg.avg_pooler))
    weight("xy.downsample.down.w", (lat, lat), gain=0.5)
    norm("xy.downsample.layer_norm", lat)
    linear("xy.q.in_proj", (cfg.codebook_dim, lat, 1))
    return p


def write_random_xy_gguf(path: Union[str, Path], seed: int = 0,
                         cfg: XyConfig = XyConfig(), encoder: bool = False,
                         extra=None, **widths) -> None:
    """An XY-Tokenizer GGUF (F32) with random weights from `seed`
    (`widths`: random_xy_params's keyword arguments), decode-only or with
    the encoder. `extra(writer)` adds more KVs and tensors (an LM adaptor)
    before the file is written."""
    params = random_xy_params(cfg, seed, encoder=encoder, **widths)
    wr = GGUFWriter(path, "xy_tokenizer")
    wr.add_name("XY-Tokenizer")
    for key, val in (
            ("codec.encode_sample_rate", cfg.encode_sample_rate),
            ("codec.sample_rate", cfg.sample_rate),
            ("xy.encoder_downsample_rate", cfg.encoder_downsample_rate),
            ("xy.decoder_upsample_rate", cfg.decoder_upsample_rate),
            ("codec.latent_dim", cfg.latent_dim),
            ("codec.codebook_dim", cfg.codebook_dim),
            ("codec.codebook_size", cfg.codebook_size),
            ("codec.n_q", cfg.n_q),
            ("xy.mel.n_mels", cfg.mel_n_mels),
            ("xy.mel.n_fft", cfg.mel_n_fft),
            ("xy.mel.hop_length", cfg.mel_hop),
            ("xy.sem_enc.n_layers", cfg.n_layers),
            ("xy.sem_enc.n_heads", cfg.n_heads),
            ("xy.sem_enc_adapter.n_layers", cfg.adapter_layers),
            ("xy.pre_rvq_adapter.n_layers", cfg.adapter_layers),
            ("xy.post_rvq_adapter.n_layers", cfg.adapter_layers),
            ("xy.downsample.avg_pooler", cfg.avg_pooler),
            ("xy.upsample.stride", cfg.upsample_stride),
            ("xy.vocos.n_blocks", cfg.vocos_blocks),
            ("xy.vocos.head.n_fft", cfg.vocos_n_fft),
            ("xy.vocos.head.hop_size", cfg.vocos_hop)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in params.items():
        wr.add_tensor(name, arr, "F32")
    if extra is not None:
        extra(wr)
    wr.write()
