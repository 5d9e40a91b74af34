"""Random Chatterbox S3Tokenizer weights and GGUF files from a seed.

Widths default to tests/test_chatterbox_s3t_parity.py's full-size gate
(the chatterbox S3Tokenizer): 128 mels (n_fft and window 400), audio_state
1280, 20 heads of 64, 6 FSMN/RoPE layers with FSMN kernel 31, MLP 4 ×
1280, ternary FSQ over 8 dims (6561 codes), 16 kHz in, hop 960 at 24 kHz.
The mel filters are Whisper's (librosa's slaney mel of 201 bins × 128,
0-8 kHz) and the window torch.hann_window(400), as the checkpoint carries
them.

`write_random_s3t_gguf` writes them under the wire names and KVs both
packages' loaders read (s3t.*, chatterbox_s3t.*), so `load_model(path)`
runs its real path with no download. Linear and conv weights are fan-in
scaled (std gain/sqrt(fan_in)), each block's o, fc2 and FSMN at gain 0.5;
norm scales N(1, 0.1), biases N(0, 0.01); the quantizer's projection at
gain 0.25. The random stack's output carries a large part common to every
frame: at gain 1 the tanh pins most digits at ±1 and 1 s of N(0, 0.3)
noise gives 4 distinct tokens in 100 frames, at 0.25 it gives 17.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ..dsp.audio import hann_periodic, mel_filter_bank
from ..io.gguf import GGUFWriter
from .chatterbox_s3t import S3TConfig
from .neucodec_init import Draw

S3T = S3TConfig()


def random_s3t_params(draw: Draw, cfg: S3TConfig) -> None:
    """The weights under their wire names into draw.p (the MLP 4 × hidden,
    as the checkpoint's)."""
    c, mlp = cfg.hidden, 4 * cfg.hidden
    draw.linear("s3t.enc.conv1", (c, cfg.n_mels, 3))
    draw.linear("s3t.enc.conv2", (c, c, 3))
    for li in range(cfg.n_layers):
        b = f"s3t.enc.blk.{li}"
        draw.norm(b + ".attn_ln", c)
        draw.linear(b + ".attn.q", (c, c))
        draw.weight(b + ".attn.k.w", (c, c))
        draw.linear(b + ".attn.v", (c, c))
        draw.linear(b + ".attn.o", (c, c), gain=0.5)
        draw.weight(b + ".attn.fsmn.w", (c, 1, cfg.fsmn_kernel), gain=0.5)
        draw.norm(b + ".mlp_ln", c)
        draw.linear(b + ".mlp.fc1", (mlp, c))
        draw.linear(b + ".mlp.fc2", (c, mlp), gain=0.5)
    draw.linear("s3t.q.proj", (8, c), gain=0.25)
    draw.p["s3t.mel_filters"] = mel_filter_bank(
        cfg.n_fft // 2 + 1, cfg.n_mels, min_frequency=0.0,
        max_frequency=cfg.encode_sample_rate / 2.0,
        sampling_rate=cfg.encode_sample_rate, norm="slaney",
        mel_scale="slaney").T.astype(np.float32)        # [n_mels, n_bins]
    draw.p["s3t.window"] = hann_periodic(cfg.win_length)


def write_random_s3t_gguf(path: Union[str, Path], seed: int = 0,
                          cfg: S3TConfig = S3T) -> None:
    """A Chatterbox S3T GGUF (F32) with random weights from `seed`."""
    draw = Draw(np.random.default_rng(seed))
    random_s3t_params(draw, cfg)
    wr = GGUFWriter(path, "chatterbox_s3t")
    wr.add_name("Chatterbox-S3T")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.encode_sample_rate", cfg.encode_sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.n_fft", cfg.n_fft),
                     ("codec.win_length", cfg.win_length),
                     ("codec.n_mels", cfg.n_mels),
                     ("codec.token_rate_hz", 25),
                     ("chatterbox_s3t.audio_state", cfg.hidden),
                     ("chatterbox_s3t.audio_head", cfg.n_heads),
                     ("chatterbox_s3t.audio_layer", cfg.n_layers),
                     ("chatterbox_s3t.fsmn_kernel_size", cfg.fsmn_kernel)):
        wr.add_uint32(key, val)
    wr.add_float32("chatterbox_s3t.rope_theta", cfg.rope_theta)
    wr.add_bool("codec.has_encoder", True)
    wr.add_bool("codec.has_decoder", False)
    for name, arr in draw.p.items():
        wr.add_tensor(name, arr, "F32")
    wr.write()
