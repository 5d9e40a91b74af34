"""Random XCodec2 weights and GGUF files from a seed.

Widths default to HKUSTAudio/xcodec2's, those of
tests/test_xcodec2_parity.py's full-size gates. The decoder is NeuCodec's
(models/neucodec_init.py::random_decoder_params) under the prefix
"xcodec2": hidden 1024, 12 RoFormer layers of 16 heads × 64, vq_dim 2048,
FSQ 4^8, an iSTFT head of n_fft 1280, hop 320, 16 kHz; its MLP is 4 ×
hidden = 4096 wide, as in the published xcodec2 code (the repo's mirror
fixtures use 2×, which fixes nothing about the real width). The encoder:
BigCodec with ngf 48 (48 → 1536 channels over strides 2, 2, 4, 4, 5, then
conv k3 to 1024) and the 12-tap Kaiser-windowed sinc (BigVGAN's
kaiser_sinc_filter1d, cutoff 0.25, half-width 0.3); W2V-BERT 2.0's first
16 conformer layers at 1024 (16 heads × 64, FFN 4096, relative keys 64
left / 8 right, depthwise k31), over 80 mels × stride 2 (160 features;
n_fft 512, window 400 (Povey), hop 160, the Kaldi mel filters the
converter writes); the semantic convs at 1024, fc_prior 2048, project_in
to 8.

`write_random_x2_gguf` writes them under the wire names and KVs both
packages' loaders read, so `load_model(path)` runs its real path with no
download. The decoder is drawn first, so a seed gives the same decoder with
or without the encoder. Gains as models/neucodec_init.py's (fan-in scaled,
0.5 on each transformer's residual branches' last products); the BigCodec
units' second conv (k1) at 0.3, since fifteen residual units in a row
would otherwise grow the signal ~180×; relative-key embeddings N(0, 1) (an
nn.Embedding's init); snake alphas and inverse betas N(1, 0.1); project_in
at gain 1, as NeuCodec's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..dsp.audio import mel_filter_bank, povey_window
from ..io.gguf import GGUFWriter
from .neucodec import NeuConfig
from .neucodec_init import Draw, random_decoder_params
from .xcodec2 import DILATIONS, UP_RATIOS, X2EncConfig

XCODEC2 = NeuConfig(sample_rate=16000, hop_size=320, n_q=1,
                    codebook_size=65536, codebook_dim=8, vq_dim=2048,
                    hidden_dim=1024, num_layers=12, num_heads=16, head_dim=64)
X2_N_FFT = 1280


def kaiser_sinc_filter(kernel_size: int = 12, cutoff: float = 0.25,
                       half_width: float = 0.3) -> np.ndarray:
    """BigVGAN's kaiser_sinc_filter1d (even kernel): a Kaiser-windowed sinc
    lowpass normalised to sum 1; symmetric."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * np.pi * 4 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50 else
            0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a >= 21 else 0.0)
    t = np.arange(-half, half) + 0.5
    f = 2 * cutoff * np.kaiser(kernel_size, beta) * np.sinc(2 * cutoff * t)
    return (f / f.sum()).astype(np.float32)


def random_x2_encoder_params(draw: Draw, enc: X2EncConfig, codebook_dim: int,
                             ngf: int = 48, w2v_ffn: int = 4096,
                             biases: bool = True) -> None:
    """The encoder's weights under their wire names into draw.p (biases:
    whether the BigCodec convs carry biases, which the loaders take as
    optional)."""
    x = "xcodec2"
    draw.p[f"{x}.enc.alias.filter"] = kaiser_sinc_filter()

    def snake(name, c):
        draw.normal(name + ".alpha", (c,), 0.1, 1.0)
        draw.normal(name + ".inv_beta", (c,), 0.1, 1.0)

    draw.linear(f"{x}.enc.codec.conv0", (ngf, 1, 7), bias=biases)
    ch = ngf
    for bi, stride in enumerate(UP_RATIOS, start=1):
        base = f"{x}.enc.codec.b{bi}"
        for ri in range(len(DILATIONS)):
            rb = f"{base}.r{ri}"
            snake(rb + ".act1", ch)
            draw.linear(rb + ".conv1", (ch, ch, 7), bias=biases)
            snake(rb + ".act2", ch)
            draw.linear(rb + ".conv2", (ch, ch, 1), gain=0.3, bias=biases)
        snake(base + ".act", ch)
        draw.linear(base + ".down", (2 * ch, ch, 2 * stride), bias=biases)
        ch *= 2
    hid = enc.w2v_hidden
    snake(f"{x}.enc.codec.final.act", ch)
    draw.linear(f"{x}.enc.codec.final.conv", (hid, ch, 3), bias=biases)

    draw.norm(f"{x}.w2v.feat_ln", enc.w2v_input_dim)
    draw.linear(f"{x}.w2v.feat_proj", (hid, enc.w2v_input_dim))
    for li in range(enc.w2v_layers):
        lb = f"{x}.w2v.l{li}"
        for n in ("ffn1", "ffn2"):
            draw.norm(f"{lb}.{n}_ln", hid)
            draw.linear(f"{lb}.{n}.fc1", (w2v_ffn, hid))
            draw.linear(f"{lb}.{n}.fc2", (hid, w2v_ffn), gain=0.5)
        draw.norm(lb + ".attn_ln", hid)
        for n in "qkv":
            draw.linear(f"{lb}.attn.{n}", (hid, hid))
        draw.linear(lb + ".attn.o", (hid, hid), gain=0.5)
        draw.normal(lb + ".attn.dist.w",
                    (enc.w2v_left_max + enc.w2v_right_max + 1,
                     enc.w2v_head_dim), 1.0)
        draw.norm(lb + ".conv.ln", hid)
        draw.weight(lb + ".conv.pw1.w", (2 * hid, hid, 1))
        draw.weight(lb + ".conv.dw.w", (hid, 1, enc.w2v_dw_kernel))
        draw.norm(lb + ".conv.dw_ln", hid)
        draw.weight(lb + ".conv.pw2.w", (hid, hid, 1), gain=0.5)
        draw.norm(lb + ".final_ln", hid)
    draw.weight(f"{x}.sem.initial.w", (hid, hid, 3))
    draw.linear(f"{x}.sem.r1", (hid, hid, 3))
    draw.linear(f"{x}.sem.r3", (hid, hid, 3), gain=0.5)
    draw.weight(f"{x}.sem.final.w", (hid, hid, 3))
    draw.linear(f"{x}.enc.fc_prior", (2 * hid, 2 * hid))
    draw.linear(f"{x}.enc.quant.project_in", (codebook_dim, 2 * hid))
    draw.p[f"{x}.enc.mel.filters"] = mel_filter_bank(
        enc.mel_n_fft // 2 + 1, enc.mel_n_mels, min_frequency=20.0,
        max_frequency=8000.0, sampling_rate=16000, norm=None,
        mel_scale="kaldi", triangularize_in_mel_space=True).astype(np.float32)
    draw.p[f"{x}.enc.mel.window"] = povey_window(enc.mel_win)


def write_random_x2_gguf(path: Union[str, Path], seed: int = 0,
                         cfg: NeuConfig = XCODEC2, n_fft: int = X2_N_FFT,
                         mlp: Optional[int] = None, encoder: bool = False,
                         enc_cfg: X2EncConfig = X2EncConfig(),
                         **widths) -> None:
    """An XCodec2 GGUF (F32) with random weights from `seed`, decode-only or
    with the encoder (mlp: the decoder's MLP width, default 4 × hidden;
    widths: random_x2_encoder_params's keyword arguments)."""
    draw = Draw(np.random.default_rng(seed))
    random_decoder_params(draw, cfg, n_fft, mlp or 4 * cfg.hidden_dim,
                          prefix="xcodec2")
    if encoder:
        random_x2_encoder_params(draw, enc_cfg, cfg.codebook_dim, **widths)
    wr = GGUFWriter(path, "xcodec2")
    wr.add_name("XCodec2")
    e = enc_cfg
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_fft", n_fft), ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.hidden_dim),
                     ("xcodec2.hidden_dim", cfg.hidden_dim),
                     ("xcodec2.vq_dim", cfg.vq_dim),
                     ("xcodec2.num_layers", cfg.num_layers),
                     ("xcodec2.num_heads", cfg.num_heads),
                     ("xcodec2.head_dim", cfg.head_dim),
                     ("xcodec2.w2v.layers", e.w2v_layers),
                     ("xcodec2.w2v.hidden", e.w2v_hidden),
                     ("xcodec2.w2v.heads", e.w2v_heads),
                     ("xcodec2.w2v.head_dim", e.w2v_head_dim),
                     ("xcodec2.w2v.left_max_pos", e.w2v_left_max),
                     ("xcodec2.w2v.right_max_pos", e.w2v_right_max),
                     ("xcodec2.w2v.dw_kernel", e.w2v_dw_kernel),
                     ("xcodec2.w2v.input_dim", e.w2v_input_dim),
                     ("codec.mel.n_mels", e.mel_n_mels),
                     ("codec.mel.n_fft", e.mel_n_fft),
                     ("codec.mel.win_length", e.mel_win),
                     ("codec.mel.hop_length", e.mel_hop),
                     ("codec.mel.stride", e.mel_stride)):
        wr.add_uint32(key, val)
    for key, val in (("xcodec2.rope_theta", cfg.rope_theta),
                     ("xcodec2.w2v.layer_norm_eps", e.w2v_eps),
                     ("codec.mel.preemphasis", e.mel_preemphasis),
                     ("codec.mel.mel_floor", e.mel_floor)):
        wr.add_float32(key, val)
    wr.add_bool("codec.has_encoder", encoder)
    wr.add_bool("codec.has_decoder", True)
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
