"""Random Soprano decoder weights and GGUF files from a seed.

Shapes mirror Soprano 1.1 by default, the widths the reference converter
fixes (tests/test_soprano_parity.py's full-size gate): latent 512, width
768, intermediate 2304, 8 ConvNeXt layers of depthwise kernel 3, upscale
4, hop 512, n_fft 2048, 32 kHz, and a symmetric Hann window tensor.
`write_random_soprano_gguf` writes them under the wire names and KVs both
packages' `load_soprano_params` read (those codec_tpu/convert/soprano.py
writes), so `load_model(path).decode_latent(z)` runs its real path with no
download.

Weights are drawn fan-in scaled, std gain/sqrt(fan_in), as in dac_init.py;
norm scales N(1, 0.1), biases N(0, 0.01), layer scales N(1/n_layers,
0.01); the iSTFT head at gain 0.5, so the log-magnitudes' lognormal tail
keeps the PCM's peak well below 1.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import numpy as np

from ..dsp.audio import hann_symmetric
from ..io.gguf import GGUFWriter
from .soprano import SopranoConfig

_BIAS_STD = 0.01
SOPRANO_1_1 = SopranoConfig(sample_rate=32000, hop_size=512, n_fft=2048,
                            latent_dim=512, decoder_dim=768,
                            intermediate_dim=2304, num_layers=8, upscale=4,
                            dw_kernel=3)


def random_soprano_params(cfg: SopranoConfig = SOPRANO_1_1, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Weights by wire name, float32, PyTorch layouts."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def normal(shape, std, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def linear(name, shape, gain=1.0):
        p[name + ".w"] = normal(shape, gain / np.sqrt(np.prod(shape[1:])))
        p[name + ".b"] = normal((shape[0],), _BIAS_STD)

    def norm(name, c):
        p[name + ".w"] = normal((c,), 0.1, 1.0)
        p[name + ".b"] = normal((c,), _BIAS_STD)

    d, i = cfg.decoder_dim, cfg.intermediate_dim
    linear("sop.decode.embed", (d, cfg.latent_dim, 1))
    norm("sop.decode.norm", d)
    for li in range(cfg.num_layers):
        pre = f"sop.decode.cnx.{li}"
        linear(f"{pre}.dw", (d, 1, cfg.dw_kernel))
        norm(f"{pre}.ln", d)
        linear(f"{pre}.pw1", (i, d))
        linear(f"{pre}.pw2", (d, i))
        p[f"{pre}.gamma"] = normal((d,), 0.01, 1.0 / cfg.num_layers)
    norm("sop.decode.fln", d)
    linear("sop.decode.head.out", (cfg.n_fft + 2, d), gain=0.5)
    p["sop.decode.istft.window"] = hann_symmetric(cfg.n_fft)
    return p


def write_random_soprano_gguf(path: Union[str, Path], seed: int = 0,
                              cfg: SopranoConfig = SOPRANO_1_1) -> None:
    """A Soprano GGUF (F32) with random weights from `seed`."""
    params = random_soprano_params(cfg, seed)
    wr = GGUFWriter(path, "soprano")
    wr.add_name("Soprano")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_fft", cfg.n_fft),
                     ("codec.win_length", cfg.n_fft),
                     ("codec.latent_dim", cfg.latent_dim),
                     ("soprano.decoder_dim", cfg.decoder_dim),
                     ("soprano.intermediate_dim", cfg.intermediate_dim),
                     ("soprano.num_layers", cfg.num_layers),
                     ("soprano.upscale", cfg.upscale),
                     ("soprano.dw_kernel", cfg.dw_kernel)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", False)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in params.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
