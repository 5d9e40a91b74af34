"""Random Chatterbox S3Gen weights and GGUF files from a seed.

Widths default to tests/test_chatterbox_s3g_parity.py's full-size gate
(FULL_S3G, the CosyVoice2-style S3Gen that Chatterbox ships): 80 mels,
speaker dim 192; the flow encoder's conformer 512 wide, 6 + 4 layers of 8
heads × 64, feed-forward 2048; the CFM UNet 256 channels, time embedding
1024, 12 mid stages × 4 transformers (feed-forward 1024); vocab 6561; HiFT
512 → 256 → 128 → 64 with ups (8, 5, 3), n_fft 16, hop 4.

The builtin conditioning is a prompt of `prompt_tokens` speech tokens and
2 × as many mel frames (a 10 s prompt by default: 250 tokens, 500 frames;
upstream Chatterbox conditions S3Gen on up to 10 s of reference audio,
its DEC_COND_LEN), a random speaker embedding and random prompt mels.

The draws are those of the JAX test's Mirror(fan_scale=True): std s /
sqrt(fan_in) for each tensor of two or more dims (s 0.2, convs 0.1, the
HiFT convs 0.15, the token embedding 0.3, the prompt mels 0.4), norm scales
N(1, 0.1), other vectors N(0, s); the f0 head's bias N(150, 10²) Hz, so
the NSF source is voiced, as speech mostly is (the Mirror's f0 stays under
the 10 Hz voicing threshold, which leaves the harmonic sines out of its
output). As that test's full-size fixture does,
the HiFT resblocks' convs are N(0, 0.1² / (C·K)) and their snake alphas
N(1, 0.1) clamped to ≥ 0.5: drawn at 0.1 without the 1/√(C·K), each conv
amplifies about 4× at 256-512 channels and the nine resblocks reach about
1e10, which overflows exp() in the iSTFT head.

`write_random_s3g_gguf` writes them under the wire names and KVs both
packages' loaders read (s3g.*, chatterbox_s3g.*), so `load_model(path)`
runs its real path with no download.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from ..io.gguf import GGUFWriter
from .chatterbox_s3g import (HIFT_F0_LAYERS, HIFT_N_FFT, HIFT_NB_HARMONICS,
                             HIFT_RB_KERNELS, HIFT_SRC_RB_KERNELS,
                             HIFT_SRC_STRIDES, HIFT_UP_KERNELS, HIFT_UPS,
                             S3GConfig)

S3G = S3GConfig()
PROMPT_TOKENS = 250          # a 10 s prompt at 25 tokens a second


class _Draws:
    """Mirror(fan_scale=True)'s draws by name from one NumPy generator."""

    def __init__(self, rng: np.random.Generator):
        self.rng, self.p = rng, {}

    def __call__(self, name: str, *shape: int, s: float = 0.2,
                 off: float = 0.0) -> np.ndarray:
        if len(shape) >= 2 and off == 0.0:
            s = s / math.sqrt(math.prod(shape[1:]))
        v = (self.rng.standard_normal(shape, dtype=np.float32) * s
             + off).astype(np.float32)
        self.p[name] = v
        return v


def random_s3g_params(P: _Draws, cfg: S3GConfig, ff: int, cfm_ch: int,
                      ted: int, cfm_ff: int, hift_ch: Sequence[int],
                      prompt_frames: int) -> None:
    """The weights under their wire names into P.p."""
    eh, mel, nh, hd = cfg.enc_hidden, cfg.mel_dim, cfg.attn_heads, \
        cfg.attn_head_dim
    P("s3g.flow.input_emb.w", cfg.codebook_size, eh, s=0.3)
    P("s3g.flow.enc.embed.lin.w", eh, eh)
    P("s3g.flow.enc.embed.lin.b", eh)

    def norm(base, c):
        P(base + ".w", c, s=0.1, off=1.0)
        P(base + ".b", c)

    norm("s3g.flow.enc.embed.ln", eh)
    P("s3g.flow.enc.pre.cv1.w", eh, eh, 4, s=0.1)
    P("s3g.flow.enc.pre.cv1.b", eh)
    P("s3g.flow.enc.pre.cv2.w", eh, eh, 3, s=0.1)
    P("s3g.flow.enc.pre.cv2.b", eh)

    def conformer(base):
        norm(base + ".norm_mha", eh)
        norm(base + ".norm_ff", eh)
        for n in ("q", "k", "v", "o"):
            P(f"{base}.attn.{n}.w", eh, eh)
            P(f"{base}.attn.{n}.b", eh)
        P(base + ".attn.pos.w", eh, eh)
        P(base + ".attn.pbu", nh, hd)
        P(base + ".attn.pbv", nh, hd)
        P(base + ".ff.w1.w", ff, eh)
        P(base + ".ff.w1.b", ff)
        P(base + ".ff.w2.w", eh, ff)
        P(base + ".ff.w2.b", eh)

    for i in range(cfg.enc_layers):
        conformer(f"s3g.flow.enc.blk.{i}")
    P("s3g.flow.enc.up.w", eh, eh, 5, s=0.1)
    P("s3g.flow.enc.up.b", eh)
    P("s3g.flow.enc.up_embed.lin.w", eh, eh)
    P("s3g.flow.enc.up_embed.lin.b", eh)
    norm("s3g.flow.enc.up_embed.ln", eh)
    for i in range(cfg.enc_up_layers):
        conformer(f"s3g.flow.enc.up_blk.{i}")
    norm("s3g.flow.enc.after_norm", eh)
    P("s3g.flow.proj.w", mel, eh)
    P("s3g.flow.proj.b", mel)
    P("s3g.flow.spk_aff.w", mel, cfg.spk_dim)
    P("s3g.flow.spk_aff.b", mel)
    P("s3g.cond.embedding", cfg.spk_dim, s=0.5)
    P("s3g.cond.prompt_feat", prompt_frames, mel, s=0.4)

    # the CFM UNet
    in_ch = 4 * mel
    P("s3g.cfm.t.l1.w", ted, in_ch)
    P("s3g.cfm.t.l1.b", ted)
    P("s3g.cfm.t.l2.w", ted, ted)
    P("s3g.cfm.t.l2.b", ted)

    def causal_block(base, cin, cout):
        P(base + ".cv.w", cout, cin, 3, s=0.1)
        P(base + ".cv.b", cout)
        norm(base + ".ln", cout)

    def stage(base, cin, cout):
        causal_block(base + ".r.b1", cin, cout)
        causal_block(base + ".r.b2", cout, cout)
        P(base + ".r.mlp.w", cout, ted)
        P(base + ".r.mlp.b", cout)
        P(base + ".r.res.w", cout, cin, 1)
        P(base + ".r.res.b", cout)
        inner = nh * hd
        for ti in range(cfg.cfm_transformers):
            t = f"{base}.t.{ti}"
            norm(t + ".norm1", cout)
            for n in ("q", "k", "v"):
                P(f"{t}.attn.{n}.w", inner, cout)
            P(t + ".attn.o.w", cout, inner)
            P(t + ".attn.o.b", cout)
            norm(t + ".norm3", cout)
            P(t + ".ff.w1.w", cfm_ff, cout)
            P(t + ".ff.w1.b", cfm_ff)
            P(t + ".ff.w2.w", cout, cfm_ff)
            P(t + ".ff.w2.b", cout)

    stage("s3g.cfm.dn.0", in_ch, cfm_ch)
    P("s3g.cfm.dn.0.x.w", cfm_ch, cfm_ch, 3, s=0.1)
    P("s3g.cfm.dn.0.x.b", cfm_ch)
    for i in range(cfg.cfm_mid_blocks):
        stage(f"s3g.cfm.md.{i}", cfm_ch, cfm_ch)
    stage("s3g.cfm.up.0", 2 * cfm_ch, cfm_ch)
    P("s3g.cfm.up.0.x.w", cfm_ch, cfm_ch, 3, s=0.1)
    P("s3g.cfm.up.0.x.b", cfm_ch)
    causal_block("s3g.cfm.final", cfm_ch, cfm_ch)
    P("s3g.cfm.proj.w", mel, cfm_ch, 1)
    P("s3g.cfm.proj.b", mel)

    # HiFT
    for i in range(HIFT_F0_LAYERS):
        P(f"s3g.hift.f0.cn.{i}.w", mel, mel, 3, s=0.15)
        P(f"s3g.hift.f0.cn.{i}.b", mel)
    # f0 in Hz: a bias near a speaking voice's 150, so the frames are
    # voiced (> 10 Hz) and the NSF sines reach the output
    P("s3g.hift.f0.cls.w", 1, mel, s=30.0)
    P("s3g.hift.f0.cls.b", 1, s=10.0, off=150.0)
    P("s3g.hift.src.lin.w", 1, HIFT_NB_HARMONICS + 1)
    P("s3g.hift.src.lin.b", 1)
    P("s3g.hift.conv_pre.w", hift_ch[0], mel, 7, s=0.15)
    P("s3g.hift.conv_pre.b", hift_ch[0])
    for i, stride in enumerate(HIFT_SRC_STRIDES):
        P(f"s3g.hift.up.{i}.w", hift_ch[i], hift_ch[i + 1],
          HIFT_UP_KERNELS[i], s=0.15)
        P(f"s3g.hift.up.{i}.b", hift_ch[i + 1])
        # src_dn takes the source STFT's n_fft + 2 channels
        P(f"s3g.hift.src_dn.{i}.w", hift_ch[i + 1], HIFT_N_FFT + 2,
          2 * stride if stride > 1 else 1, s=0.15)
        P(f"s3g.hift.src_dn.{i}.b", hift_ch[i + 1])

    def resblock(base, ch, k):
        for j in range(3):
            for a in ("a1", "a2"):
                P.p[f"{base}.{a}.{j}"] = np.maximum(
                    P.rng.standard_normal(ch, dtype=np.float32) * 0.1 + 1.0,
                    0.5).astype(np.float32)
            for cv in ("cv1", "cv2"):
                P(f"{base}.{cv}.{j}.w", ch, ch, k, s=0.1)
                P(f"{base}.{cv}.{j}.b", ch, s=0.1)

    for i in range(len(HIFT_UPS)):
        resblock(f"s3g.hift.src_rb.{i}", hift_ch[i + 1],
                 HIFT_SRC_RB_KERNELS[i])
        for j, k in enumerate(HIFT_RB_KERNELS):
            resblock(f"s3g.hift.rb.{i * 3 + j}", hift_ch[i + 1], k)
    P("s3g.hift.conv_post.w", HIFT_N_FFT + 2, hift_ch[3], 7, s=0.1)
    P("s3g.hift.conv_post.b", HIFT_N_FFT + 2)


def write_random_s3g_gguf(path: Union[str, Path], seed: int = 0,
                          cfg: S3GConfig = S3G, ff: int = 2048,
                          cfm_ch: int = 256, ted: int = 1024,
                          cfm_ff: int = 1024,
                          hift_ch: Sequence[int] = (512, 256, 128, 64),
                          prompt_tokens: int = PROMPT_TOKENS,
                          extra=None) -> None:
    """A Chatterbox S3Gen GGUF (F32, decoder only, builtin conditioning)
    with random weights from `seed`; the prompt is `prompt_tokens` random
    speech tokens and 2 × as many mel frames. `extra(writer)` adds more
    KVs and tensors (the T3 section: chatterbox_init.py) before the
    file is written."""
    rng = np.random.default_rng(seed)
    P = _Draws(rng)
    prompt = rng.integers(0, cfg.codebook_size, prompt_tokens)
    prompt_frames = 2 * prompt_tokens
    random_s3g_params(P, cfg, ff, cfm_ch, ted, cfm_ff, hift_ch, prompt_frames)
    wr = GGUFWriter(path, "chatterbox_s3g")
    wr.add_name("Chatterbox-S3G")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("chatterbox_s3g.cond.prompt_token_len", prompt_tokens),
                     ("chatterbox_s3g.cond.prompt_feat_frames", prompt_frames),
                     ("chatterbox_s3g.cond.prompt_feat_dim", cfg.mel_dim),
                     ("chatterbox_s3g.cond.embedding_dim", cfg.spk_dim),
                     ("chatterbox_s3g.mel_dim", cfg.mel_dim),
                     ("chatterbox_s3g.spk_dim", cfg.spk_dim),
                     ("chatterbox_s3g.enc_hidden", cfg.enc_hidden),
                     ("chatterbox_s3g.enc_layers", cfg.enc_layers),
                     ("chatterbox_s3g.enc_up_layers", cfg.enc_up_layers),
                     ("chatterbox_s3g.attn_heads", cfg.attn_heads),
                     ("chatterbox_s3g.attn_head_dim", cfg.attn_head_dim),
                     ("chatterbox_s3g.cfm_mid_blocks", cfg.cfm_mid_blocks),
                     ("chatterbox_s3g.cfm_transformers",
                      cfg.cfm_transformers)):
        wr.add_uint32(key, val)
    wr.add_bool("codec.has_encoder", False)
    wr.add_bool("codec.has_decoder", True)
    wr.add_bool("chatterbox_s3g.has_builtin_conditioning", True)
    wr.add_array("chatterbox_s3g.cond.prompt_token", [int(t) for t in prompt])
    for name, arr in P.p.items():
        wr.add_tensor(name, arr, "F32")
    if extra is not None:
        extra(wr)
    wr.write()
