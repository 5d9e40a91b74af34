"""Random Pocket-Mimi weights and GGUF files from a seed.

Shapes mirror kyutai/pocket-tts's codec by default, the widths of
tests/test_pocket_mimi_parity.py's full-size gate (the reference
converter's layout notes): latent 32, outer width 512, two transformer
layers of 8 heads x 64 with ffn 2048 and a 250-frame context, the SEANet
decoder 512 → 256 → 128 → 64 over ConvTranspose strides 6, 5, 4 and the
encoder mirrored (strides 4, 5, 6), the depthwise k32 stride-16 upsample
(stored dense, as the converter writes it: zeros off the diagonal) and the
stride-16 downsample, hop 1920. `write_random_pocket_gguf` writes them
under the wire names and KVs both packages' `load_pocket_params` read
(those codec_tpu/convert/pocket_tts.py writes), so `load_model(path)` runs
its real path with no download.

Weights are drawn fan-in scaled, std gain/sqrt(fan_in), as in dac_init.py
(a ConvTranspose's fan-in is C_in·K/stride); the residual blocks' second
conv at gain 0.5 and the last conv at 0.3 (`_LAST_GAIN`), as dac_init.py
does; norm scales N(1, 0.1), biases N(0, 0.01), layer scales N(0.1, 0.01).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .mimi import _LAYER_KEYS
from .pocket_mimi import PocketMimiConfig

_BIAS_STD = 0.01
_LAST_GAIN = 0.3
POCKET_TTS = PocketMimiConfig()
POCKET_CHANNELS = (512, 256, 128, 64)


def random_pocket_params(cfg: PocketMimiConfig = POCKET_TTS, seed: int = 0,
                         channels: Sequence[int] = POCKET_CHANNELS,
                         ffn: int = 2048, encoder: bool = True
                         ) -> Dict[str, np.ndarray]:
    """Weights by wire name, float32, PyTorch layouts. channels[0] is the
    outer width; the decoder's stages go down the list, the encoder's up.
    The encoder is drawn after the decoder, so a seed gives the same
    decoder with or without it."""
    if channels[0] != cfg.outer_dim or len(channels) != len(
            cfg.decoder_ratios) + 1:
        raise ValueError(f"channels {tuple(channels)} do not start at "
                         f"outer_dim {cfg.outer_dim} with one width a stage")
    if cfg.hop_size != cfg.resample_stride * int(np.prod(cfg.decoder_ratios)):
        raise ValueError(f"hop_size {cfg.hop_size} is not resample_stride x "
                         f"the decoder ratios {cfg.decoder_ratios}")
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}
    pre = "pocket_mimi."

    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def conv(name, c_in, c_out, k, gain=1.0, bias=True):
        p[f"{pre}{name}.w"] = normal((c_out, c_in, k), gain / np.sqrt(c_in * k))
        if bias:
            p[f"{pre}{name}.b"] = normal((c_out,), _BIAS_STD)

    def convtr(name, c_in, c_out, stride):
        p[f"{pre}{name}.w"] = normal((c_in, c_out, 2 * stride),
                                     1.0 / np.sqrt(2 * c_in))
        p[f"{pre}{name}.b"] = normal((c_out,), _BIAS_STD)

    def transformer(prefix):
        d, n = cfg.outer_dim, cfg.tf_heads * cfg.tf_head_dim
        shapes = {"q_w": (n, d), "k_w": (n, d), "v_w": (n, d), "o_w": (d, n),
                  "fc1_w": (ffn, d), "fc2_w": (d, ffn)}
        for li in range(cfg.tf_layers):
            for key, suffix in _LAYER_KEYS.items():
                name = f"{pre}{prefix}.l{li}.{suffix}"
                if key in shapes:
                    p[name] = normal(shapes[key], 1.0 / np.sqrt(shapes[key][1]))
                elif key.endswith("_scale"):
                    p[name] = normal((d,), 0.01, 0.1)
                elif key.endswith("_w"):
                    p[name] = normal((d,), 0.1, 1.0)
                else:
                    p[name] = normal((d,), _BIAS_STD)

    def resblock(name, c):
        conv(name + ".c1", c, c // 2, 3)
        conv(name + ".c2", c // 2, c, 1, gain=0.5)

    outer, lat, rs = cfg.outer_dim, cfg.latent_dim, cfg.resample_stride
    conv("quant.out_proj", lat, outer, 1, bias=False)
    up = np.zeros((outer, outer, 2 * rs), np.float32)     # depthwise, dense
    up[np.arange(outer), np.arange(outer)] = normal((outer, 2 * rs),
                                                    1.0 / np.sqrt(2))
    p[pre + "upsample.w"] = up
    transformer("dtr")
    conv("dec.l0", outer, outer, 7)
    for si, (li, stride) in enumerate(zip((2, 5, 8), cfg.decoder_ratios)):
        convtr(f"dec.l{li}", channels[si], channels[si + 1], stride)
        resblock(f"dec.r{si}", channels[si + 1])
    conv("dec.l11", channels[-1], 1, 3, gain=_LAST_GAIN)
    if not encoder:
        return p
    conv("enc.l0", 1, channels[-1], 7)
    for si, (li, stride) in enumerate(zip((3, 6, 9), cfg.encoder_ratios)):
        c = channels[-1 - si]
        resblock(f"enc.r{si}", c)
        conv(f"enc.l{li}", c, channels[-2 - si], 2 * stride)
    conv("enc.l11", outer, outer, 3)
    transformer("etr")
    conv("downsample", outer, lat, 2 * rs, bias=False)
    return p


def write_random_pocket_gguf(path: Union[str, Path], seed: int = 0,
                             cfg: PocketMimiConfig = POCKET_TTS,
                             channels: Sequence[int] = POCKET_CHANNELS,
                             ffn: int = 2048, encoder: bool = True,
                             extra=None) -> None:
    """A Pocket-Mimi GGUF (F32) with random weights from `seed`: the
    decoder, and with `encoder` the encoder. `extra(writer)` adds more KVs
    and tensors (an LM adaptor) before the file is written."""
    wr = GGUFWriter(path, "pocket_mimi")
    wr.add_name("Pocket-Mimi")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.decode_hop_size", cfg.hop_size),
                     ("codec.latent_dim", cfg.latent_dim),
                     ("codec.n_q", 0),
                     ("pocket_mimi.outer_dim", cfg.outer_dim),
                     ("pocket_mimi.tf_layers", cfg.tf_layers),
                     ("pocket_mimi.tf_heads", cfg.tf_heads),
                     ("pocket_mimi.tf_head_dim", cfg.tf_head_dim),
                     ("pocket_mimi.tf_context", cfg.tf_context)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    wr.add_float32("codec.frame_rate", cfg.sample_rate / cfg.hop_size)
    wr.add_float32("pocket_mimi.tf_max_period", cfg.tf_max_period)
    wr.add_array("pocket_mimi.decoder_ratios", list(cfg.decoder_ratios))
    wr.add_array("pocket_mimi.encoder_ratios", list(cfg.encoder_ratios))
    for name, arr in random_pocket_params(cfg, seed, channels, ffn,
                                          encoder).items():
        wr.add_tensor(name, arr, "F32")
    if extra is not None:
        extra(wr)
    wr.write()
