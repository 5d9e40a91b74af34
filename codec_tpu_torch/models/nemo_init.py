"""Random NeMo nano codec weights and GGUF files from a seed.

Widths default to tests/test_nemo_parity.py's full-size gate
(nvidia/nemo-nano-codec-22khz-0.6kbps-12.5fps): 22.05 kHz, hop 1764 (12.5
codes a second), FSQ 4 groups × levels [9, 8, 8, 7] (4032 codes of
dimension 4, latent 16); the encoder 32 channels doubling over rates
(2, 3, 6, 7, 7) to 1024, the decoder 1024 halving to 32 over (7, 7, 6, 3,
2). The FSQ constants and per-group codebooks are the converter's
(codec_tpu/convert/nemo_nano.py), and each decoder upsample is the
converter's densified grouped ConvTranspose: [C, C/2, 2·stride] with input
channel i feeding only output channel i // 2.

`write_random_nemo_gguf` writes them under the wire names and KVs both
packages' loaders read (nemo.*), so `load_model(path)` runs its real path
with no download. Convs are fan-in scaled (std gain/sqrt(C_in·K)), the
upsamples at std 1/2 (two input channels × two taps reach each output
sample), each residual unit's second conv at gain 0.3 (nine units an
upsample would otherwise grow the stream about 3× a block), biases
N(0, 0.01), snake alphas N(1, 0.1); the decoder's last conv at gain 0.1,
so random codes decode to PCM with a standard deviation near 0.1, and
the encoder's at gain 20, so N(0, 0.3) noise gives a latent of standard
deviation near 1, spread over the FSQ levels (at gain 1 every digit
rounds to its middle level).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .nemo_nano import RES_DILATIONS, RES_KERNELS, NemoConfig
from .neucodec_init import Draw

NEMO_NANO = NemoConfig(sample_rate=22050, hop_size=1764, n_q=4,
                       codebook_size=4032, codebook_dim=4, latent_dim=16)
LEVELS = (9, 8, 8, 7)


def fsq_constants(levels: Sequence[int]) -> dict:
    """The converter's FSQ constants and implicit codebook [V, d] for
    `levels`."""
    lv = np.asarray(levels, np.float32)
    scale = (lv // 2).astype(np.float32)
    out_scale = ((lv - 1.0) / 2.0 * (1.0 - 1e-3)).astype(np.float32)
    out_offset = np.where(lv.astype(np.int32) % 2 == 0, 0.5, 0.0).astype(
        np.float32)
    in_shift = np.tan(out_offset / out_scale).astype(np.float32)
    dim_base = np.cumprod(np.concatenate([[1.0], lv[:-1]])).astype(np.float32)
    idx = np.arange(int(np.prod(levels)), dtype=np.int64)
    digits = (idx[:, None] // dim_base.astype(np.int64)) % np.asarray(
        levels, np.int64)
    cb = ((digits - scale) / scale).astype(np.float32)
    return {"scale": scale, "out_scale": out_scale, "out_offset": out_offset,
            "in_shift": in_shift, "dim_base": dim_base, "codebook": cb}


def _units(draw: Draw, base: str, ch: int, snake: bool) -> None:
    for bi, k in enumerate(RES_KERNELS):
        for ri in range(len(RES_DILATIONS)):
            u = f"{base}.b{bi}.r{ri}"
            draw.linear(u + ".in", (ch, ch, k))
            draw.linear(u + ".sk", (ch, ch, k), gain=0.3)
            if snake:
                draw.normal(u + ".in.a", (ch // 2,), 0.1, 1.0)
                draw.normal(u + ".sk.a", (ch // 2,), 0.1, 1.0)


def random_nemo_params(draw: Draw, cfg: NemoConfig, levels: Sequence[int],
                       enc_base: int, dec_base: int, encoder: bool) -> None:
    """The weights under their wire names into draw.p: the FSQ constants
    and the decoder, then (encoder) the encoder."""
    fsq = fsq_constants(levels)
    for k in ("scale", "out_scale", "out_offset", "in_shift", "dim_base"):
        draw.p[f"nemo.fsq.{k}"] = fsq[k]
    for g in range(cfg.n_q):
        draw.p[f"nemo.fsq.codebook.{g}"] = fsq["codebook"]
    latent = cfg.n_q * len(levels)
    draw.linear("nemo.dec.pre", (dec_base, latent, 7))
    ch = dec_base
    for li, s in enumerate(cfg.up_rates):
        draw.normal(f"nemo.dec.act.{li}.a", (ch // 2,), 0.1, 1.0)
        taps = draw.rng.standard_normal((ch, 2 * s), dtype=np.float32) * 0.5
        dense = np.zeros((ch, ch // 2, 2 * s), np.float32)
        dense[np.arange(ch), np.arange(ch) // 2] = taps
        draw.p[f"nemo.dec.up.{li}.w"] = dense
        draw.bias(f"nemo.dec.up.{li}.b", ch // 2)
        ch //= 2
        _units(draw, f"nemo.dec.res.l{li}", ch, snake=True)
    draw.normal("nemo.dec.post.a", (ch // 2,), 0.1, 1.0)
    draw.linear("nemo.dec.post", (1, ch, 7), gain=0.1)
    if not encoder:
        return
    draw.linear("nemo.enc.pre", (enc_base, 1, 7))
    ch = enc_base
    for li, s in enumerate(cfg.down_rates):
        _units(draw, f"nemo.enc.res.l{li}", ch, snake=False)
        draw.linear(f"nemo.enc.down.{li}", (2 * ch, ch, 2 * s))
        ch *= 2
    draw.linear("nemo.enc.post", (latent, ch, 7), gain=20.0)


def write_random_nemo_gguf(path: Union[str, Path], seed: int = 0,
                           cfg: NemoConfig = NEMO_NANO,
                           levels: Sequence[int] = LEVELS,
                           enc_base: int = 32, dec_base: int = 1024,
                           encoder: bool = False) -> None:
    """A NeMo nano codec GGUF (F32) with random weights from `seed`,
    decode-only or with the encoder (cfg's codebook_size, codebook_dim and
    latent_dim must agree with `levels`)."""
    draw = Draw(np.random.default_rng(seed))
    random_nemo_params(draw, cfg, levels, enc_base, dec_base, encoder)
    wr = GGUFWriter(path, "nemo_nano_codec")
    wr.add_name("NeMo-Nano-Codec")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", int(np.prod(levels))),
                     ("codec.codebook_dim", len(levels)),
                     ("codec.latent_dim", cfg.n_q * len(levels))):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    wr.add_array("nemo.down_rates", list(cfg.down_rates))
    wr.add_array("nemo.up_rates", list(cfg.up_rates))
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
