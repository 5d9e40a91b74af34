"""Random SNAC weights and GGUF files from a seed.

Shapes mirror hubertsiuzdak/snac_24khz by default: latent 768, decoder
width 1024 halving per block to 512/256/128/64, up rates 8/8/4/2, 3
codebooks of 4096 x 8 at strides 4/2/1, hop 512 (the widths of
codec_tpu/models/bench_init.py::random_snac_params), and, with
`encoder=True`, the encoder: width latent/16 (48) doubling per block over
the down rates 2/4/8/8 to the latent, depthwise residual units, a
depthwise k7 conv last.
`write_random_snac_gguf` writes them under the wire names, layouts and KVs
that both packages' `load_snac_params` read (those of
codec_tpu/convert/snac.py), so `load_model(path)` runs its real path with
no download. It also writes the quantizer's in_proj and normalised
codebooks, which both loaders read. The encoder is drawn after the rest,
so a seed gives the same decoder with or without it.

Each conv weight is drawn with std gain/sqrt(K * C_in / groups) and each
convtr weight with std gain/sqrt(2 * C_in) (k = 2s taps at stride s: two
overlap at each output). Every snake alpha is N(1, 0.5), as in
tests/test_snac_parity.py, so some are negative, as in trained SNAC. The
gains keep the f32 output out of the tanh's saturation (`_GAINS`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .snac import SnacConfig

_BIAS_STD = 0.01
# the residual units' 1x1 convs and the output conv. At gain 1 each unit
# doubles the variance and the snakes add a mean, and 99% of the output
# samples sit at |pcm| > 0.99; at these gains the activation std grows from
# 1.8 to 5.7 over the four blocks and the output has std 0.46 with 6e-5 of
# its samples above 0.99 (CPU, T = 64 frames, seed 0)
_GAINS = {"res": 0.4, "final": 0.1}


def _encoder_dim(cfg: SnacConfig) -> int:
    """The encoder's first width: it doubles at each down rate to the
    latent (48 for snac_24khz)."""
    return cfg.latent_dim >> len(cfg.encoder_rates)


def random_snac_params(cfg: SnacConfig = SnacConfig(), seed: int = 0,
                       decoder_dim: int = 1024,
                       encoder: bool = False) -> Dict[str, np.ndarray]:
    """Quantizer, decoder and (with `encoder`) encoder weights, float32, by
    wire name (PyTorch layouts: conv [C_out, C_in/groups, K], convtr
    [C_in, C_out, K], alpha [C])."""
    if int(np.prod(cfg.decoder_rates)) != cfg.hop_size:
        raise ValueError(f"decoder rates {cfg.decoder_rates} do not give hop "
                         f"{cfg.hop_size}")
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def conv(name, c_in, c_out, k, gain=1.0, depthwise=False):
        fan_in = k if depthwise else k * c_in
        p[f"{name}.w"] = normal((c_out, 1 if depthwise else c_in, k),
                                gain / np.sqrt(fan_in))
        p[f"{name}.b"] = normal((c_out,), _BIAS_STD)

    def alpha(name, c):
        p[f"{name}.alpha"] = (1.0 + 0.5 * rng.standard_normal(c)).astype(
            np.float32)

    lat, d = cfg.latent_dim, cfg.codebook_dim
    for q in range(cfg.n_q):
        cb = normal((cfg.codebook_size, d), 1.0)
        p[f"snac.q.{q}.codebook"] = cb
        p[f"snac.q.{q}.codebook_norm"] = cb / np.maximum(
            np.linalg.norm(cb, axis=1, keepdims=True), 1e-12)
        conv(f"snac.q.{q}.in_proj", lat, d, 1)
        conv(f"snac.q.{q}.out_proj", d, lat, 1)
    conv("snac.dec.conv_in_dw", lat, lat, 7, depthwise=True)
    conv("snac.dec.conv_in_pw", lat, decoder_dim, 1)
    c = decoder_dim
    for bi, s in enumerate(cfg.decoder_rates):
        pre = f"snac.dec.b{bi}"
        alpha(f"{pre}.act", c)
        p[f"{pre}.convtr.w"] = normal((c, c // 2, 2 * s), 1 / np.sqrt(2 * c))
        p[f"{pre}.convtr.b"] = normal((c // 2,), _BIAS_STD)
        c //= 2
        for ri in range(3):
            unit = f"{pre}.r{ri}"
            alpha(f"{unit}.act1", c)
            conv(f"{unit}.conv1", c, c, 7, depthwise=True)
            alpha(f"{unit}.act2", c)
            conv(f"{unit}.conv2", c, c, 1, gain=_GAINS["res"])
    alpha("snac.dec.act_final", c)
    conv("snac.dec.conv_final", c, 1, 7, gain=_GAINS["final"])
    if not encoder:
        return p
    c = _encoder_dim(cfg)
    conv("snac.enc.conv0", 1, c, 7)
    for bi, s in enumerate(cfg.encoder_rates, start=1):
        pre = f"snac.enc.b{bi}"
        for ri in range(3):
            unit = f"{pre}.r{ri}"
            alpha(f"{unit}.act1", c)
            conv(f"{unit}.conv1", c, c, 7, depthwise=True)
            alpha(f"{unit}.act2", c)
            conv(f"{unit}.conv2", c, c, 1, gain=_GAINS["res"])
        alpha(f"{pre}.act", c)
        conv(f"{pre}.down", c, 2 * c, 2 * s)
        c *= 2
    conv("snac.enc.conv_final", c, c, 7, depthwise=True)
    return p


def write_random_snac_gguf(path: Union[str, Path], seed: int = 0,
                           cfg: SnacConfig = SnacConfig(),
                           decoder_dim: int = 1024,
                           encoder: bool = False) -> None:
    """A SNAC GGUF (F32) with random weights from `seed`: decode-only, or
    with the encoder."""
    params = random_snac_params(cfg, seed, decoder_dim, encoder)
    wr = GGUFWriter(path, "snac")
    wr.add_name("SNAC")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.pad_to", cfg.pad_to),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.latent_dim),
                     # the encoder width, as the converter writes it
                     # (written whether or not the file holds the encoder)
                     ("snac.encoder_dim", _encoder_dim(cfg)),
                     ("snac.decoder_dim", decoder_dim)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    wr.add_array("snac.encoder_rates", list(cfg.encoder_rates))
    wr.add_array("snac.decoder_rates", list(cfg.decoder_rates))
    wr.add_array("snac.vq_strides", list(cfg.vq_strides))
    wr.add_bool("snac.depthwise", True)
    wr.add_bool("snac.noise", cfg.noise)
    for name, arr in params.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
