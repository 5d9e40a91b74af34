"""Random DAC weights and GGUF files from a seed.

Shapes mirror descript/dac_24khz by default: latent 1024, decoder width
1536 halving per block, up rates 8/5/4/2, 9 codebooks of 1024 x 8 (the
widths of codec_tpu/models/bench_init.py::random_dac_decode_params), and,
with `encoder=True`, the encoder: width latent/16 (64) doubling per block
over the down rates 2/4/5/8 to the latent width, then a k3 conv.
`write_random_dac_gguf` writes them under the wire names and layouts that
both packages' `load_dac_params` read (those of codec_tpu/convert/dac.py),
so `load_model(path)` runs its real path with no download. The encoder is
drawn after the rest, so a seed gives the same decoder with or without it.

Each conv weight is drawn with std gain/sqrt(K * C_in), and every snake
alpha is 1. The gain is 1, except 0.5 for the residual units' 1x1 convs
(at 1, each unit doubles the variance and the activation grows block by
block) and 0.3 for the output conv, so the signal before the output tanh
has an std below 0.5 and stays out of saturation (a flat 0.05 scale grows
activations about 4x per conv at C = 1536 and saturates the output to
+-1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .dac import DacConfig

_BIAS_STD = 0.01


def random_dac_params(cfg: DacConfig = DacConfig(), seed: int = 0,
                      decoder_dim: int = 1536,
                      rates: Sequence[int] = (8, 5, 4, 2),
                      encoder: bool = False) -> Dict[str, np.ndarray]:
    """Quantizer, decoder and (with `encoder`) encoder weights, float32, by
    wire name (PyTorch layouts: conv [C_out, C_in, K], convtr [C_in, C_out,
    K], alpha [1, C, 1]). The encoder's down rates are `rates` reversed."""
    if int(np.prod(rates)) != cfg.hop_size or len(rates) != cfg.n_blocks:
        raise ValueError(f"rates {tuple(rates)} do not give hop "
                         f"{cfg.hop_size} in {cfg.n_blocks} blocks")
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def conv(name, c_in, c_out, k, gain=1.0):
        p[f"{name}.weight"] = normal((c_out, c_in, k), gain / np.sqrt(k * c_in))
        p[f"{name}.bias"] = normal((c_out,), _BIAS_STD)

    def convtr(name, c_in, c_out, k):
        p[f"{name}.weight"] = normal((c_in, c_out, k), 1 / np.sqrt(k * c_in))
        p[f"{name}.bias"] = normal((c_out,), _BIAS_STD)

    def alpha(name, c):
        p[name] = np.ones((1, c, 1), np.float32)

    h, d = cfg.latent_dim, cfg.codebook_dim
    for q in range(cfg.n_q):
        p[f"vq.q{q}.codebook.weight"] = normal((cfg.codebook_size, d), 1.0)
        conv(f"vq.q{q}.in_proj", h, d, 1)
        conv(f"vq.q{q}.out_proj", d, h, 1)
    conv("dec.model.0", h, decoder_dim, 7)
    c = decoder_dim
    for bi, s in enumerate(rates, start=1):
        pre = f"dec.model.{bi}.block"
        alpha(f"{pre}.snake1.alpha", c)
        convtr(f"{pre}.conv_t1", c, c // 2, 2 * s)
        c //= 2
        for ri in (1, 2, 3):
            unit = f"{pre}.res_unit{ri}"
            alpha(f"{unit}.snake1.alpha", c)
            conv(f"{unit}.conv1", c, c, 7)
            alpha(f"{unit}.snake2.alpha", c)
            conv(f"{unit}.conv2", c, c, 1, gain=0.5)
    alpha(f"dec.model.{cfg.n_blocks + 1}.alpha", c)
    conv(f"dec.model.{cfg.n_blocks + 2}", c, 1, 7, gain=0.3)
    if not encoder:
        return p
    c = h >> cfg.n_blocks
    conv("enc.block.0", 1, c, 7)
    for bi, s in enumerate(reversed(rates), start=1):
        pre = f"enc.block.{bi}.block"
        for ri in (1, 2, 3):
            unit = f"{pre}.res_unit{ri}"
            alpha(f"{unit}.snake1.alpha", c)
            conv(f"{unit}.conv1", c, c, 7)
            alpha(f"{unit}.snake2.alpha", c)
            conv(f"{unit}.conv2", c, c, 1, gain=0.5)
        alpha(f"{pre}.snake1.alpha", c)
        conv(f"{pre}.conv1", c, 2 * c, 2 * s)
        c *= 2
    alpha(f"enc.block.{cfg.n_blocks + 1}.alpha", c)
    conv(f"enc.block.{cfg.n_blocks + 2}", c, h, 3)
    return p


def write_random_dac_gguf(path: Union[str, Path], seed: int = 0,
                          cfg: DacConfig = DacConfig(),
                          decoder_dim: int = 1536,
                          rates: Sequence[int] = (8, 5, 4, 2),
                          encoder: bool = False) -> None:
    """A DAC GGUF (F32) with random weights from `seed`: decode-only, or
    with the encoder."""
    params = random_dac_params(cfg, seed, decoder_dim, rates, encoder)
    wr = GGUFWriter(path, "dac")
    wr.add_name("DAC")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.latent_dim)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in params.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
