"""Random MOSS-Audio-Tokenizer weights and GGUF files from a seed.

Widths default to tests/test_moss_audio_parity.py's full-size gate: 48 kHz
stereo interleaved into one stream (hop 3840 a channel, 7680 samples of
the stream a code), 16 levels of 1024 × 8 cosine LFQ, rvq_dim 512, latent
768. The per-module split is that gate's representative hierarchy (the
checkpoint's own module list lives in its config.json): encoder patch 16
→ d192 (3 heads, 3 layers) → patch 8 → d384 (6 heads, 6 layers) → patch 6
→ d768 (12 heads, 4 layers) → patch 10 → d768 (12 heads, 2 layers) → 768;
the decoder the mirror image (2, 4, 6 and 3 layers). Heads of 64, FFN 2 ×
d_model as in the gate, windows of 0.1 s and 10 s at the top stage, RoPE
period 10 000.

`write_random_moss_gguf` writes them under the wire names and KVs both
packages' loaders read (moss.*), so `load_model(path)` runs its real path
with no download. The decoder and the quantizer are drawn first, so a seed
gives the same decoder with or without the encoder. Linear weights are
fan-in scaled (std 1/sqrt(fan_in)), norm scales N(1, 0.1) and shifts
N(0, 0.01), LayerScales N(0.1, 0.02), quantizer biases N(0, 0.01),
codebooks N(0, 1) with their L2-normalised rows beside them; the
decoder's last output projection at gain 0.025, so random codes decode to
PCM with a standard deviation near 0.1.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .moss_audio import MossConfig, MossModuleCfg
from .neucodec_init import Draw


def _stage(dm, heads, layers, in_dim, out_dim, dur):
    return MossModuleCfg(1, 1, in_dim, out_dim, dm, heads, layers, dur,
                         10000.0)


def _patch(p):
    return MossModuleCfg(0, p)


MOSS_FULL = MossConfig(
    sample_rate=48000, hop_size=3840, n_q=16, codebook_size=1024,
    codebook_dim=8, latent_dim=768, rvq_dim=512, number_channels=2,
    channel_interleave=True,
    enc_modules=(_patch(16), _stage(192, 3, 3, 16, 192, 0.1), _patch(8),
                 _stage(384, 6, 6, 1536, 384, 0.1), _patch(6),
                 _stage(768, 12, 4, 2304, 768, 0.1), _patch(10),
                 _stage(768, 12, 2, 7680, 768, 10.0)),
    dec_modules=(_stage(768, 12, 2, 768, 7680, 10.0), _patch(10),
                 _stage(768, 12, 4, 768, 2304, 0.1), _patch(6),
                 _stage(384, 6, 6, 384, 1536, 0.1), _patch(8),
                 _stage(192, 3, 3, 192, 16, 0.1), _patch(16)))
FFN_MULT = 2


def _blocks(draw: Draw, side: str, mods: Tuple[MossModuleCfg, ...],
            out_gain: float = 1.0) -> None:
    last = max(mi for mi, m in enumerate(mods) if m.kind == 1)
    for mi, m in enumerate(mods):
        if m.kind != 1:
            continue
        base, dm = f"moss.{side}.b{mi}", m.d_model
        if m.in_dim != dm:
            draw.weight(base + ".input_proj.w", (dm, m.in_dim))
        for li in range(m.n_layers):
            lp = f"{base}.l{li}"
            draw.norm(lp + ".norm1", dm)
            draw.norm(lp + ".norm2", dm)
            draw.weight(lp + ".attn.qkv.w", (3 * dm, dm))
            draw.weight(lp + ".attn.out.w", (dm, dm))
            draw.weight(lp + ".ffn.fc1.w", (FFN_MULT * dm, dm))
            draw.weight(lp + ".ffn.fc2.w", (dm, FFN_MULT * dm))
            draw.normal(lp + ".ls1", (dm,), 0.02, 0.1)
            draw.normal(lp + ".ls2", (dm,), 0.02, 0.1)
        if m.out_dim != dm:
            draw.weight(base + ".output_proj.w", (m.out_dim, dm),
                        gain=out_gain if mi == last else 1.0)


def random_moss_params(draw: Draw, cfg: MossConfig, encoder: bool) -> None:
    """The weights under their wire names into draw.p: the quantizer and
    the decoder, then (encoder) the encoder and q.input_proj."""
    rvq, cbd = cfg.rvq_dim, cfg.codebook_dim
    for qi in range(cfg.n_q):
        base = f"moss.q.{qi}"
        draw.linear(base + ".in_proj", (cbd, rvq, 1))
        draw.linear(base + ".out_proj", (rvq, cbd, 1))
        draw.normal(base + ".codebook", (cfg.codebook_size, cbd), 1.0)
        cb = draw.p[base + ".codebook"]
        draw.p[base + ".codebook_norm"] = (cb / np.maximum(np.linalg.norm(
            cb, axis=1, keepdims=True), 1e-12)).astype(np.float32)
    draw.linear("moss.q.output_proj", (cfg.latent_dim, rvq, 1))
    _blocks(draw, "dec", cfg.dec_modules, out_gain=0.025)
    if encoder:
        _blocks(draw, "enc", cfg.enc_modules)
        draw.linear("moss.q.input_proj", (rvq, cfg.latent_dim, 1))


def write_random_moss_gguf(path: Union[str, Path], seed: int = 0,
                           cfg: MossConfig = MOSS_FULL,
                           encoder: bool = False, extra=None) -> None:
    """A MOSS-Audio-Tokenizer GGUF (F32) with random weights from `seed`,
    decode-only or with the encoder. `extra(writer)`, when given, adds to
    the open writer before it is written (an LM adaptor)."""
    draw = Draw(np.random.default_rng(seed))
    random_moss_params(draw, cfg, encoder)
    wr = GGUFWriter(path, "moss_audio_tokenizer")
    wr.add_name("MOSS-Audio-Tokenizer")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.latent_dim),
                     ("moss.number_channels", cfg.number_channels),
                     ("moss.rvq_dim", cfg.rvq_dim)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    wr.add_bool("moss.channel_interleave", cfg.channel_interleave)
    for side, mods in (("enc", cfg.enc_modules), ("dec", cfg.dec_modules)):
        wr.add_uint32(f"moss.{side}.n_modules", len(mods))
        for key, f in (("module_types", "kind"), ("patch_sizes", "patch"),
                       ("in_dims", "in_dim"), ("out_dims", "out_dim"),
                       ("d_models", "d_model"), ("n_heads", "n_heads"),
                       ("n_layers", "n_layers")):
            wr.add_array(f"moss.{side}.{key}",
                         [int(getattr(m, f)) for m in mods])
        wr.add_array(f"moss.{side}.context_durations",
                     [float(m.context_duration) for m in mods])
        wr.add_array(f"moss.{side}.max_periods",
                     [float(m.max_period) for m in mods])
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    if extra is not None:
        extra(wr)
    wr.write()
