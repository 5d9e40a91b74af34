"""Random WavTokenizer weights and GGUF files from a seed.

Shapes mirror novateur/WavTokenizer-large-speech-75token by default: 24 kHz,
hop 320, one codebook of 4096 x 512, a Vocos backbone of width 768 with 12
ConvNeXt blocks of intermediate 2304, AdaLayerNorm (4 rows) and the
diffusion pos_net, an iSTFT head of n_fft 1280 (the widths of
tests/test_wavtokenizer_parity.py's full-size gate), and, with
`encoder=True`, the EnCodec encoder: 32 filters doubling over the strides
2/4/5/8 to 512, a 2-layer LSTM of 512, a k7 conv to the 512-wide latent.
`write_random_wt_gguf` writes them under the wire names both packages'
`load_wt_params` read (those codec_tpu/convert/wavtokenizer.py writes), so
`load_model(path)` runs its real path with no download. The encoder is
drawn after the rest, so a seed gives the same decoder with or without it.

Weights are drawn fan-in scaled, std gain/sqrt(fan_in), as in dac_init.py:
at a flat scale the encoder's latent reaches ~5e8 and the search turns into
rounding noise (tests/test_wavtokenizer_parity.py). Norm scales are N(1,
0.1), biases N(0, 0.01), the ConvNeXt layer scales N(1/n_blocks, 0.01) (as
Vocos initialises them), the codebook N(0, 0.25) (`_CODEBOOK_STD`), the
iSTFT head at gain 0.5 (`_HEAD_GAIN`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from ..io.gguf import GGUFWriter

_BIAS_STD = 0.01
# the encoder's latent has an std of about 0.25 on N(0, 0.3) PCM at these
# scales (CPU, 16-64 filters); codebook rows of that scale make the search
# pick many rows, where N(0, 1) rows leave the smallest-norm row the winner
_CODEBOOK_STD = 0.25
# the iSTFT head's: log-magnitudes of std ~0.5 keep the PCM's peak well
# below 1 (at gain 1 their lognormal tail reaches it)
_HEAD_GAIN = 0.5
ENC_STRIDES = (2, 4, 5, 8)


def random_wt_params(seed: int = 0, codebook_size: int = 4096,
                     codebook_dim: int = 512, dim: int = 768,
                     intermediate: int = 2304, n_convnext: int = 12,
                     n_fft: int = 1280, enc_filters: int = 32,
                     encoder: bool = False) -> Dict[str, np.ndarray]:
    """Weights by wire name, float32, PyTorch layouts (conv [C_out, C_in,
    K], linear [out, in], LSTM [4H, in]). The encoder's last stage gives
    enc_filters·16 channels, which must equal codebook_dim."""
    if encoder and enc_filters << len(ENC_STRIDES) != codebook_dim:
        raise ValueError(f"{enc_filters} filters doubling {len(ENC_STRIDES)} "
                         f"times do not reach codebook_dim {codebook_dim}")
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def weight(name, shape, gain=1.0):
        p[name] = normal(shape, gain / np.sqrt(np.prod(shape[1:])))

    def bias(name, n):
        p[name] = normal((n,), _BIAS_STD)

    def conv(name, c_in, c_out, k, gain=1.0):
        weight(name + ".weight", (c_out, c_in, k), gain)
        bias(name + ".bias", c_out)

    def norm(name, c):
        p[name + ".weight"] = normal((c,), 0.1, 1.0)
        bias(name + ".bias", c)

    def ada(name, c):
        p[name + ".scale.weight"] = normal((4, c), 0.1, 1.0)
        p[name + ".shift.weight"] = normal((4, c), _BIAS_STD)

    p["vq.vq.layers.0._codebook.embed"] = normal(
        (codebook_size, codebook_dim), _CODEBOOK_STD)
    conv("dec.bb.embed", codebook_dim, dim, 7)
    for li in (0, 1, 3, 4):
        pre = f"dec.bb.pos_net.{li}"
        norm(f"{pre}.norm1", dim)
        conv(f"{pre}.conv1", dim, dim, 3)
        norm(f"{pre}.norm2", dim)
        conv(f"{pre}.conv2", dim, dim, 3, gain=0.5)
    norm("dec.bb.pos_net.2.norm", dim)
    for n in ("q", "k", "v", "proj_out"):
        conv(f"dec.bb.pos_net.2.{n}", dim, dim, 1,
             gain=0.5 if n == "proj_out" else 1.0)
    p["dec.bb.pos_net.5.weight"] = normal((dim,), 0.1, 1.0)
    bias("dec.bb.pos_net.5.bias", dim)
    ada("dec.bb.norm", dim)
    for li in range(n_convnext):
        pre = f"dec.bb.cnx.{li}"
        conv(f"{pre}.dwconv", 1, dim, 7)
        ada(f"{pre}.norm", dim)
        weight(f"{pre}.pwconv1.weight", (intermediate, dim))
        bias(f"{pre}.pwconv1.bias", intermediate)
        weight(f"{pre}.pwconv2.weight", (dim, intermediate))
        bias(f"{pre}.pwconv2.bias", dim)
        p[f"{pre}.gamma"] = normal((dim,), 0.01, 1.0 / n_convnext)
    norm("dec.bb.fln", dim)
    weight("dec.head.out.weight", (n_fft + 2, dim), gain=_HEAD_GAIN)
    bias("dec.head.out.bias", n_fft + 2)
    if not encoder:
        return p
    c = enc_filters
    conv("enc.model.0.conv.conv", 1, c, 7)
    for mi, s in zip((1, 4, 7, 10), ENC_STRIDES):
        conv(f"enc.model.{mi}.block.1.conv.conv", c, c // 2, 3)
        conv(f"enc.model.{mi}.block.3.conv.conv", c // 2, c, 1, gain=0.5)
        conv(f"enc.model.{mi}.shortcut.conv.conv", c, c, 1)
        conv(f"enc.model.{mi + 2}.conv.conv", c, 2 * c, 2 * s)
        c *= 2
    for li in range(2):
        pre = "enc.model.13.lstm"
        weight(f"{pre}.weight_ih_l{li}", (4 * c, c))
        weight(f"{pre}.weight_hh_l{li}", (4 * c, c))
        bias(f"{pre}.bias_ih_l{li}", 4 * c)
        bias(f"{pre}.bias_hh_l{li}", 4 * c)
    conv("enc.model.15.conv.conv", c, codebook_dim, 7)
    return p


def write_random_wt_gguf(path: Union[str, Path], seed: int = 0,
                         encoder: bool = False, sample_rate: int = 24000,
                         hop_size: int = 320, **widths) -> None:
    """A WavTokenizer GGUF (F32) with random weights from `seed`
    (`widths`: random_wt_params's keyword arguments), decode-only or with
    the encoder; the architecture string is the converter's."""
    params = random_wt_params(seed, encoder=encoder, **widths)
    wr = GGUFWriter(path, "wavtokenizer_large")
    wr.add_name("WavTokenizer")
    wr.add_uint32("codec.sample_rate", sample_rate)
    wr.add_uint32("codec.hop_size", hop_size)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in params.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
