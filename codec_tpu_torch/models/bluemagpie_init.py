"""Random BlueMagpie AudioVAE weights and GGUF files from a seed.

Widths default to tests/test_bluemagpie_parity.py's full-size gate
(BlueMagpie / VoxCPM2 AudioVAE V2): latent 64; the decoder 2048 channels
halving to 32 over rates (8, 6, 5, 2, 2, 2) (hop 1920, 48 kHz out); the
encoder 128 channels doubling to 2048 over rates (2, 5, 8, 8) (hop 640,
16 kHz in); depthwise k7 residual units at dilations 1 / 3 / 9, the
decoder's input conv a depthwise k7 then a 1x1, its output conv k7,
fc_mu k3.

`write_random_bm_gguf` writes them under the wire names and KVs both
packages' loaders read (bluemagpie.*), so `load_model(path)` runs its real
path with no download. The decoder is drawn first, so a seed gives the
same decoder with or without the encoder. Convs are fan-in scaled (std
gain/sqrt(C_in/groups·K)); the ConvTransposes at std 1/sqrt(2·C_in) (each
output sample meets two taps of every input channel); each unit's 1x1 at
gain 0.3; biases N(0, 0.01), snake alphas N(1, 0.1), the conditioning
scales N(1, 0.1) and biases N(0, 0.01); the decoder's output conv at gain
0.03, so random latents decode to PCM with a standard deviation near 0.1
(under the tanh).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ..io.gguf import GGUFWriter
from .bluemagpie import RES_DILATIONS, BmVaeConfig
from .neucodec_init import Draw

BLUEMAGPIE = BmVaeConfig(sample_rate=48000, encode_sample_rate=16000,
                         latent_dim=64, decode_hop=1920, encode_hop=640,
                         decoder_rates=(8, 6, 5, 2, 2, 2),
                         encoder_rates=(2, 5, 8, 8))


def _units(draw: Draw, base: str, c: int) -> None:
    for ri in range(len(RES_DILATIONS)):
        u = f"{base}.r{ri}"
        draw.normal(u + ".act1.alpha", (c,), 0.1, 1.0)
        draw.linear(u + ".conv1", (c, 1, 7))
        draw.normal(u + ".act2.alpha", (c,), 0.1, 1.0)
        draw.linear(u + ".conv2", (c, c, 1), gain=0.3)


def random_bm_params(draw: Draw, cfg: BmVaeConfig, decoder_dim: int,
                     encoder_dim: int, encoder: bool) -> None:
    """The weights under their wire names into draw.p: the decoder, then
    (encoder) the encoder."""
    lat, d = cfg.latent_dim, "bluemagpie.dec"
    draw.linear(d + ".conv_in_dw", (lat, 1, 7))
    draw.linear(d + ".conv_in_pw", (decoder_dim, lat, 1))
    c = decoder_dim
    for bi, s in enumerate(cfg.decoder_rates):
        base = f"{d}.b{bi}"
        draw.normal(base + ".cond.scale", (c,), 0.1, 1.0)
        draw.bias(base + ".cond.bias", c)
        draw.normal(base + ".act.alpha", (c,), 0.1, 1.0)
        draw.normal(base + ".convtr.w", (c, c // 2, 2 * s),
                    1.0 / np.sqrt(2 * c))
        draw.bias(base + ".convtr.b", c // 2)
        c //= 2
        _units(draw, base, c)
    draw.normal(d + ".act_final.alpha", (c,), 0.1, 1.0)
    draw.linear(d + ".conv_out", (1, c, 7), gain=0.03)
    if not encoder:
        return
    e, c = "bluemagpie.enc", encoder_dim
    draw.linear(e + ".conv0", (c, 1, 7))
    for bi, s in enumerate(cfg.encoder_rates, start=1):
        base = f"{e}.b{bi}"
        _units(draw, base, c)
        draw.normal(base + ".act.alpha", (c,), 0.1, 1.0)
        draw.linear(base + ".down", (2 * c, c, 2 * s))
        c *= 2
    draw.linear(e + ".fc_mu", (lat, c, 3))


def write_random_bm_gguf(path: Union[str, Path], seed: int = 0,
                         cfg: BmVaeConfig = BLUEMAGPIE,
                         decoder_dim: int = 2048, encoder_dim: int = 128,
                         encoder: bool = False, extra=None) -> None:
    """A BlueMagpie AudioVAE GGUF (F32) with random weights from `seed`,
    decode-only or with the encoder (the hops follow the rates).
    `extra(writer)` adds more KVs and tensors (an LM adaptor) before the
    file is written."""
    draw = Draw(np.random.default_rng(seed))
    random_bm_params(draw, cfg, decoder_dim, encoder_dim, encoder)
    wr = GGUFWriter(path, "bluemagpie_audiovae")
    wr.add_name("BlueMagpie-AudioVAE")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", cfg.encode_sample_rate),
                     ("codec.hop_size", int(np.prod(cfg.encoder_rates))),
                     ("codec.decode_hop_size", int(np.prod(cfg.decoder_rates))),
                     ("codec.latent_dim", cfg.latent_dim),
                     ("codec.n_q", 0),
                     ("bluemagpie.decoder_dim", decoder_dim),
                     ("bluemagpie.encoder_dim", encoder_dim)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    wr.add_bool("codec.continuous_latent", True)
    wr.add_array("bluemagpie.decoder_rates", list(cfg.decoder_rates))
    wr.add_array("bluemagpie.encoder_rates", list(cfg.encoder_rates))
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    if extra is not None:
        extra(wr)
    wr.write()
