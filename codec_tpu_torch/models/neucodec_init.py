"""Random NeuCodec and DistillNeuCodec weights and GGUF files from a seed.

Widths default to the JAX package's full-size gates. The decoder is
neuphonic/neucodec's (tests/test_neucodec_parity.py's gate): hidden 1024,
12 RoFormer layers of 16 heads × 64, vq_dim 2048, FSQ 4^8 (65 536 codes of
dimension 8, the implicit codebook the converter writes), an iSTFT head of
n_fft 1920, hop 480, 24 kHz. Its MLP is 4 × hidden = 4096 wide, the
published model's ratio (the repo's mirror fixtures use 2×, which fixes
nothing about the real width). The distill encoder
(tests/test_neucodec_encode_parity.py's gate): width 512 with 6 heads of
128, first-block branches of 32 and a first conv of 256, position-bias MLP
128 wide, fc_sq_prior 512 → 768; HuBERT-base 768 × 12 layers × 12 heads,
FFN 3072, positional conv 128 in 16 groups, seven 512-wide feature convs
(kernels 10, 3, 3, 3, 3, 2, 2, strides 5, 2, 2, 2, 2, 2, 2); the semantic
convs 768 wide; fc_prior 1536; `down_window` / `local_window` 3000 / 600
(the loaders' defaults, written as KVs); `codec.encode_sample_rate` 16000
as the converter writes it.

`write_random_neu_gguf` writes the decoder under its plain wire names and
the encoder under the hashed ones (`neucodec.neu_encode_name`), with the
KVs both packages' loaders read, so `load_model(path)` runs its real path
with no download. The decoder is drawn first, so a seed gives the same
decoder in a base file and in a distill file. All weights come from one
generator: fan-in scaled, std gain/sqrt(fan_in), gain 0.5 on each residual
branch's last product (attention output, second MLP product, the ResNets'
second conv) and 0.3 on the distill units' (so the residual streams grow
slowly), 1 elsewhere, which leaves the iSTFT head's log-magnitudes about
N(0, 1) and the PCM's std near 0.05; norm scales N(1, 0.1), biases
N(0, 0.01), snake alphas N(1, 0.1), GRN scales and shifts N(0, 0.1) and
N(0, 0.01). The position-bias MLP's first layer reads raw distances up to
the window (3000), so its weight is N(0, (2 / window)²), which keeps its
input in about [−2, 2]. Random weights fed stationary noise give a latent
that moves little from frame to frame: a 20 s encode of N(0, 0.3) PCM
gives one to two hundred distinct codes over its 1000 frames. A larger
project_in gain pushes whole digits against the bound instead (gain 3 gave
fewer distinct codes), so it stays at 1.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .neucodec import (ENC, POOL_KERNELS, NeuConfig, NeuEncConfig,
                       neu_encode_name)

NEUCODEC = NeuConfig(sample_rate=24000, hop_size=480, n_q=1,
                     codebook_size=65536, codebook_dim=8, vq_dim=2048,
                     hidden_dim=1024, num_layers=12, num_heads=16, head_dim=64)
NEU_N_FFT = 1920
_BIAS_STD = 0.01
_DC = ENC + ".distill.codec_encoder"


def fsq_codebook(codebook_dim: int, level: int = 4) -> np.ndarray:
    """The implicit FSQ codebook [level^d, d] the converters write: digit
    i of code c is (c // level^i) % level, mapped to (digit − level/2) /
    (level/2)."""
    idx = np.arange(level ** codebook_dim, dtype=np.int64)
    digits = (idx[:, None] // level ** np.arange(codebook_dim)) % level
    half = level // 2
    return ((digits - half) / half).astype(np.float32)


class Draw:
    """One generator's draws by name: `weight` fan-in scaled, `norm` (scale
    N(1, 0.1), shift N(0, 0.01)), `bias`."""

    def __init__(self, rng: np.random.Generator,
                 rename: Callable[[str], str] = lambda n: n):
        self.rng, self.rename = rng, rename
        self.p: Dict[str, np.ndarray] = {}

    def normal(self, name, shape, std, mean=0.0):
        self.p[self.rename(name)] = (
            self.rng.standard_normal(shape, dtype=np.float32) * std
            + mean).astype(np.float32)

    def weight(self, name, shape, gain=1.0):
        self.normal(name, shape, gain / np.sqrt(np.prod(shape[1:])))

    def bias(self, name, c):
        self.normal(name, (c,), _BIAS_STD)

    def linear(self, name, shape, gain=1.0, bias=True, w="w", b="b"):
        self.weight(f"{name}.{w}", shape, gain)
        if bias:
            self.bias(f"{name}.{b}", shape[0])

    def norm(self, name, c, w="w", b="b"):
        self.normal(f"{name}.{w}", (c,), 0.1, 1.0)
        self.bias(f"{name}.{b}", c)


def random_decoder_params(draw: Draw, cfg: NeuConfig, n_fft: int,
                          mlp: int, prefix: str = "neucodec") -> None:
    """The decoder's weights under `{prefix}.decode.*` into draw.p."""
    d = f"{prefix}.decode"
    c, vq = cfg.hidden_dim, cfg.vq_dim
    draw.p[f"{d}.codebook"] = fsq_codebook(cfg.codebook_dim)
    draw.linear(f"{d}.quant.project_out", (vq, cfg.codebook_dim))
    draw.linear(f"{d}.fc_post_a", (c, vq))
    draw.linear(f"{d}.embed", (c, c, 7))
    for group in ("prior", "post"):
        for li in range(2):
            pre = f"{d}.{group}.{li}"
            draw.norm(pre + ".norm1", c)
            draw.linear(pre + ".conv1", (c, c, 3))
            draw.norm(pre + ".norm2", c)
            draw.linear(pre + ".conv2", (c, c, 3), gain=0.5)
    for li in range(cfg.num_layers):
        pre = f"{d}.transformer.{li}"
        draw.normal(pre + ".att_norm.w", (c,), 0.1, 1.0)
        draw.normal(pre + ".ffn_norm.w", (c,), 0.1, 1.0)
        draw.weight(pre + ".att.c_attn.w", (3 * c, c))
        draw.weight(pre + ".att.c_proj.w", (c, c), gain=0.5)
        draw.weight(pre + ".mlp.fc1.w", (mlp, c))
        draw.weight(pre + ".mlp.fc2.w", (c, mlp), gain=0.5)
    draw.norm(f"{d}.final_ln", c)
    draw.linear(f"{d}.head.out", (n_fft + 2, c))


def random_distill_params(draw: Draw, enc: NeuEncConfig, codebook_dim: int,
                          dim: int = 512, branch: int = 32, first: int = 256,
                          dpb: int = 128, fsq_out: int = 768,
                          sem_out: int = 768) -> None:
    """The distill encoder's weights under their logical names (draw.rename
    maps them to the wire names)."""
    for i in range(len(POOL_KERNELS)):
        draw.linear(f"{_DC}.encoder.blocks.0.blocks.{i}.1", (branch, 1, 7),
                    w="weight", b="bias")
    draw.linear(f"{_DC}.encoder.blocks.0.conv_1",
                (first, len(POOL_KERNELS) * branch, 1), w="weight", b="bias")
    draw.linear(f"{_DC}.encoder.blocks.0.conv_2", (dim, first + 1, 1),
                w="weight", b="bias")

    def unit(prefix):
        draw.linear(prefix + ".dw_conv", (dim, 1, 7), w="weight", b="bias")
        draw.linear(prefix + ".pw_conv1", (2 * dim, dim), w="weight",
                    b="bias")
        draw.normal(prefix + ".act.alpha", (2 * dim,), 0.1, 1.0)
        draw.normal(prefix + ".grn.gamma", (1, 1, 2 * dim), 0.1)
        draw.normal(prefix + ".grn.beta", (1, 1, 2 * dim), _BIAS_STD)
        draw.linear(prefix + ".pw_conv2", (dim, 2 * dim), gain=0.3,
                    w="weight", b="bias")

    for b in (1, 3, 5, 7):
        unit(f"{_DC}.encoder.blocks.{b}.0.module")
        if b < 7:
            draw.linear(f"{_DC}.encoder.blocks.{b + 1}.0", (dim, dim, 4),
                        w="weight", b="bias")
    unit(f"{_DC}.encoder.blocks.7.1.module")
    draw.linear(f"{_DC}.encoder.blocks.8", (dim, dim, 3), w="weight",
                b="bias")

    heads, hd = enc.distill_heads, dim // 4
    inner, ffi = heads * hd, dim * 4 * 2 // 3

    def trans(prefix, depth, window):
        m = prefix + ".dynamic_pos_bias.mlp"
        draw.normal(m + ".0.weight", (dpb, 1), 2.0 / window)
        draw.bias(m + ".0.bias", dpb)
        draw.linear(m + ".2", (dpb, dpb), w="weight", b="bias")
        draw.linear(m + ".4", (heads, dpb), w="weight", b="bias")
        for li in range(depth):
            lp = f"{prefix}.layers.{li}"
            draw.norm(lp + ".0.norm", dim, w="weight", b="bias")
            draw.weight(lp + ".0.to_qkv.weight", (3 * inner, dim))
            draw.weight(lp + ".0.to_out.weight", (dim, inner), gain=0.5)
            draw.norm(lp + ".1.0", dim, w="weight", b="bias")
            draw.weight(lp + ".1.1.weight", (2 * ffi, dim))
            draw.weight(lp + ".1.4.weight", (dim, ffi), gain=0.5)

    en = f"{_DC}.en_encoder"
    trans(f"{en}.down_trans.trans", 2, enc.down_window)
    draw.linear(f"{en}.down_trans.down_layer", (dim, dim, 5), w="weight",
                b="bias")
    trans(f"{en}.local_trans", 3, enc.local_window)
    draw.linear(ENC + ".fc_sq_prior", (fsq_out, dim))

    h = f"{ENC}.hubert"
    cin = 1
    for li, (c, k) in enumerate(zip(enc.hubert_conv_dim,
                                    enc.hubert_conv_kernel)):
        draw.weight(f"{h}.feat.conv.{li}.w", (c, cin, k))
        cin = c
    draw.norm(f"{h}.feat.conv.0.gn", enc.hubert_conv_dim[0])
    hh = enc.hubert_hidden
    draw.linear(f"{h}.feature_projection", (hh, cin))
    draw.linear(f"{h}.encoder.pos_conv",
                (hh, hh // enc.hubert_pos_groups, enc.hubert_pos_k))
    draw.norm(f"{h}.encoder.layer_norm", hh)
    for li in range(enc.hubert_layers):
        lp = f"{h}.encoder.layers.{li}"
        for n in "qkv":
            draw.linear(f"{lp}.att.{n}", (hh, hh))
        draw.linear(f"{lp}.att.o", (hh, hh), gain=0.5)
        draw.norm(lp + ".ln", hh)
        draw.linear(lp + ".ffn.fc1", (enc.hubert_intermediate, hh))
        draw.linear(lp + ".ffn.fc2", (hh, enc.hubert_intermediate), gain=0.5)
        draw.norm(lp + ".ffn_ln", hh)
    s = ENC + ".semantic_encoder"
    draw.weight(s + ".initial_conv.w", (sem_out, hh, 3))
    draw.linear(s + ".residual.1", (sem_out, sem_out, 3))
    draw.linear(s + ".residual.3", (sem_out, sem_out, 3), gain=0.5)
    draw.weight(s + ".final_conv.w", (sem_out, sem_out, 3))
    draw.linear(ENC + ".fc_prior", (sem_out + fsq_out, sem_out + fsq_out))
    draw.linear(ENC + ".quant.project_in", (codebook_dim, sem_out + fsq_out))


def write_random_neu_gguf(path: Union[str, Path], seed: int = 0,
                          cfg: NeuConfig = NEUCODEC, n_fft: int = NEU_N_FFT,
                          mlp: Optional[int] = None, encoder: bool = False,
                          enc_cfg: NeuEncConfig = NeuEncConfig(),
                          **widths) -> None:
    """A NeuCodec GGUF (F32) with random weights from `seed`: decode-only
    (arch "neucodec") or, with `encoder`, a DistillNeuCodec (arch
    "distill_neucodec", encoder_type "distill"). mlp: the decoder's MLP
    width (default 4 × hidden); widths: random_distill_params's keyword
    arguments. The encoder goes under its hashed wire names."""
    draw = Draw(np.random.default_rng(seed), neu_encode_name)
    random_decoder_params(draw, cfg, n_fft, mlp or 4 * cfg.hidden_dim)
    if encoder:
        random_distill_params(draw, enc_cfg, cfg.codebook_dim, **widths)
    arch = "distill_neucodec" if encoder else "neucodec"
    wr = GGUFWriter(path, arch)
    wr.add_name("DistillNeuCodec" if encoder else "NeuCodec")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", 16000),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_fft", n_fft), ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.hidden_dim),
                     ("neucodec.hidden_dim", cfg.hidden_dim),
                     ("neucodec.vq_dim", cfg.vq_dim),
                     ("neucodec.num_layers", cfg.num_layers),
                     ("neucodec.num_heads", cfg.num_heads),
                     ("neucodec.head_dim", cfg.head_dim)):
        wr.add_uint32(key, val)
    wr.add_float32("neucodec.rope_theta", cfg.rope_theta)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    if encoder:
        e = enc_cfg
        wr.add_string("neucodec.encoder_type", "distill")
        for key, val in (
                ("hubert.hidden_size", e.hubert_hidden),
                ("hubert.num_heads", e.hubert_heads),
                ("hubert.intermediate_size", e.hubert_intermediate),
                ("hubert.num_layers", e.hubert_layers),
                ("hubert.num_conv_pos_embeddings", e.hubert_pos_k),
                ("hubert.num_conv_pos_embedding_groups", e.hubert_pos_groups),
                ("distill.heads", e.distill_heads),
                ("distill.down_window", e.down_window),
                ("distill.local_window", e.local_window)):
            wr.add_uint32(f"neucodec.{key}", val)
        wr.add_float32("neucodec.hubert.layer_norm_eps", e.hubert_ln_eps)
        for key, val in (("conv_dim", e.hubert_conv_dim),
                         ("conv_kernel", e.hubert_conv_kernel),
                         ("conv_stride", e.hubert_conv_stride)):
            wr.add_array(f"neucodec.hubert.{key}", list(val))
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
