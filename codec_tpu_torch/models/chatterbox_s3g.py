"""Chatterbox S3Gen (25 Hz speech tokens → 24 kHz PCM), in PyTorch.

Counterpart of codec_tpu/models/chatterbox_s3g.py, three stages:
  flow encoder: token embedding → Linear + LayerNorm · √d → pre-lookahead
      (pad right 3, conv k4, leaky 0.01, pad left 2, conv k3, + x) → 6
      ESPnet rel-pos conformer blocks (LayerNorm eps 1e-12) → ×2 nearest
      upsample + pad left 4 + conv k5 → Linear + LayerNorm · √d → 4
      conformer blocks → LayerNorm → projection to 80 mels = mu [B, 2T, 80]
  CFM: a UNet estimator (causal conv k3 → LayerNorm → Mish blocks in a
      ResNet with a time-embedding MLP, each stage followed by 4 unmasked
      transformer blocks without q/k/v biases; 1 down, 12 mid and 1 up
      stage, the down stage's output concatenated before the up stage),
      integrated by 10 Euler steps over the cosine schedule with
      classifier-free guidance 0.7, the conditional and unconditional rows
      batched as [x; x] against [mu; 0], [spks; 0], [cond; 0]
  HiFT: f0 predictor → NSF harmonic source (9 harmonics, the phase a
      cumulative sum over every output sample) → source STFT (n_fft 16,
      hop 4) → three upsamples (8, 5, 3), each fused with the downsampled
      source and three snake resblocks → (log-magnitude, sin-phase) head →
      the double-window iSTFT → clip ±0.99; then the trim-fade (zero 20 ms,
      cosine fade-in over the next 20 ms) on the host.

The conditioning is built in: the GGUF carries the prompt tokens, the
prompt mels and the speaker embedding. A decode prepends the prompt tokens
to the codes, and returns the PCM of the frames past the prompt's mels.

No kernel of the port lies on this path (codec_tpu has no Pallas kernel
for it): the conformer's attention is `ops/attn.py::sdpa_rel_pos`, the
transformers' the plain unmasked `sdpa`.

The noise is codec_tpu's: the CFM noise, the NSF phases and the NSF noise
come from np.random.default_rng(0) in that order, drawn on the host and
uploaded. The NSF phase θ = 2π·cumsum(f0·h / sr) reaches 1e5-1e6 rad at
20 s, where a float32 ulp is 0.01-0.1 rad, so a float32 running sum (the
card's, the CPU's and XLA's each add in another order) drifts by whole
radians; the port sums in float64 and rounds θ once to float32, which is
within half an ulp of the exact sum on any device.

Parameters (`load_s3g_params`, `params_from_jax`): codec_tpu's tree and
names, linear weights [out, in]; conv weights in PyTorch's Conv1d layout
[C_out, C_in, K], the HiFT upsamples' in ConvTranspose1d's [C_in, C_out,
K]. Activations are channels-last [B, T, C] as in codec_tpu, except inside
HiFT's conv stack, which runs channels-first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import conv, norms
from ..ops.act import elu, gelu_erf, leaky_relu, mish, silu, snake
from ..ops.attn import espnet_rel_pos_emb, sdpa, sdpa_rel_pos
from ..ops.istft import overlap_add
from ..runtime.model import CodecError, CodecModel
from ..runtime.perf_log import perf_scope

# HiFT's structure (codec_tpu/models/chatterbox_s3g.py:40-62)
HIFT_N_FFT = 16
HIFT_HOP = 4
HIFT_N_BINS = HIFT_N_FFT // 2 + 1
HIFT_UPS = (8, 5, 3)
HIFT_UP_KERNELS = (16, 11, 7)
HIFT_SRC_STRIDES = (15, 3, 1)
HIFT_SRC_PADS = (7, 1, 0)
HIFT_RB_KERNELS = (3, 7, 11)
HIFT_SRC_RB_KERNELS = (7, 7, 11)
HIFT_RB_DILATIONS = (1, 3, 5)
HIFT_NB_HARMONICS = 8
HIFT_NSF_ALPHA = 0.1
HIFT_NSF_SIGMA = 0.003
HIFT_NSF_VOICED_THRESHOLD = 10.0
HIFT_LRELU = 0.1
HIFT_LRELU_DEFAULT = 0.01
HIFT_AUDIO_LIMIT = 0.99
HIFT_F0_LAYERS = 5
HIFT_SOURCE_UPSAMPLE = 480
CFM_N_TIMESTEPS = 10
CFM_CFG_RATE = 0.7


@dataclass(frozen=True)
class S3GConfig:
    sample_rate: int = 24000
    hop_size: int = 960
    n_q: int = 1
    codebook_size: int = 6561
    mel_dim: int = 80
    spk_dim: int = 192
    enc_hidden: int = 512
    enc_layers: int = 6
    enc_up_layers: int = 4
    attn_heads: int = 8
    attn_head_dim: int = 64
    cfm_mid_blocks: int = 12
    cfm_transformers: int = 4
    time_embed_scale: float = 1000.0

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "S3GConfig":
        d = cls()

        def g(k, v):
            return r.get_i32(f"chatterbox_s3g.{k}", v)

        return cls(
            sample_rate=r.get_i32("codec.sample_rate", d.sample_rate),
            hop_size=r.get_i32("codec.hop_size", d.hop_size),
            n_q=r.get_i32("codec.n_q", d.n_q),
            codebook_size=r.get_i32("codec.codebook_size", d.codebook_size),
            mel_dim=g("mel_dim", d.mel_dim),
            spk_dim=g("spk_dim", d.spk_dim),
            enc_hidden=g("enc_hidden", d.enc_hidden),
            enc_layers=g("enc_layers", d.enc_layers),
            enc_up_layers=g("enc_up_layers", d.enc_up_layers),
            attn_heads=g("attn_heads", d.attn_heads),
            attn_head_dim=g("attn_head_dim", d.attn_head_dim),
            cfm_mid_blocks=g("cfm_mid_blocks", d.cfm_mid_blocks),
            cfm_transformers=g("cfm_transformers", d.cfm_transformers),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def _tree(g, cfg: S3GConfig) -> Dict[str, Any]:
    """codec_tpu's parameter tree, each leaf g(its wire name)."""
    gc = gtr = g

    def conformer(base):
        return {
            "norm_mha_w": g(base + ".norm_mha.w"),
            "norm_mha_b": g(base + ".norm_mha.b"),
            "norm_ff_w": g(base + ".norm_ff.w"),
            "norm_ff_b": g(base + ".norm_ff.b"),
            "q_w": g(base + ".attn.q.w"), "q_b": g(base + ".attn.q.b"),
            "k_w": g(base + ".attn.k.w"), "k_b": g(base + ".attn.k.b"),
            "v_w": g(base + ".attn.v.w"), "v_b": g(base + ".attn.v.b"),
            "o_w": g(base + ".attn.o.w"), "o_b": g(base + ".attn.o.b"),
            "pos_w": g(base + ".attn.pos.w"),
            "pbu": g(base + ".attn.pbu"), "pbv": g(base + ".attn.pbv"),
            "ff1_w": g(base + ".ff.w1.w"), "ff1_b": g(base + ".ff.w1.b"),
            "ff2_w": g(base + ".ff.w2.w"), "ff2_b": g(base + ".ff.w2.b"),
        }

    def causal_block(base):
        return {"cv_w": gc(base + ".cv.w"), "cv_b": g(base + ".cv.b"),
                "ln_w": g(base + ".ln.w"), "ln_b": g(base + ".ln.b")}

    def cfm_resnet(base):
        return {"b1": causal_block(base + ".b1"),
                "b2": causal_block(base + ".b2"),
                "mlp_w": g(base + ".mlp.w"), "mlp_b": g(base + ".mlp.b"),
                "res_w": gc(base + ".res.w"), "res_b": g(base + ".res.b")}

    def basic_transformer(base):
        return {
            "n1_w": g(base + ".norm1.w"), "n1_b": g(base + ".norm1.b"),
            "q_w": g(base + ".attn.q.w"), "k_w": g(base + ".attn.k.w"),
            "v_w": g(base + ".attn.v.w"),
            "o_w": g(base + ".attn.o.w"), "o_b": g(base + ".attn.o.b"),
            "n3_w": g(base + ".norm3.w"), "n3_b": g(base + ".norm3.b"),
            "ff1_w": g(base + ".ff.w1.w"), "ff1_b": g(base + ".ff.w1.b"),
            "ff2_w": g(base + ".ff.w2.w"), "ff2_b": g(base + ".ff.w2.b"),
        }

    def cfm_stage(base):
        return {"r": cfm_resnet(base + ".r"),
                "t": [basic_transformer(f"{base}.t.{ti}")
                      for ti in range(cfg.cfm_transformers)]}

    def resblock(base):
        return [{
            "a1": g(f"{base}.a1.{i}"), "a2": g(f"{base}.a2.{i}"),
            "c1_w": gc(f"{base}.cv1.{i}.w"), "c1_b": g(f"{base}.cv1.{i}.b"),
            "c2_w": gc(f"{base}.cv2.{i}.w"), "c2_b": g(f"{base}.cv2.{i}.b"),
        } for i in range(3)]

    n_up = len(HIFT_UPS)
    return {
        # flow encoder
        "emb": g("s3g.flow.input_emb.w"),
        "embed_lin_w": g("s3g.flow.enc.embed.lin.w"),
        "embed_lin_b": g("s3g.flow.enc.embed.lin.b"),
        "embed_ln_w": g("s3g.flow.enc.embed.ln.w"),
        "embed_ln_b": g("s3g.flow.enc.embed.ln.b"),
        "pre_cv1_w": gc("s3g.flow.enc.pre.cv1.w"),
        "pre_cv1_b": g("s3g.flow.enc.pre.cv1.b"),
        "pre_cv2_w": gc("s3g.flow.enc.pre.cv2.w"),
        "pre_cv2_b": g("s3g.flow.enc.pre.cv2.b"),
        "blk": [conformer(f"s3g.flow.enc.blk.{i}")
                for i in range(cfg.enc_layers)],
        "up_w": gc("s3g.flow.enc.up.w"), "up_b": g("s3g.flow.enc.up.b"),
        "up_embed_lin_w": g("s3g.flow.enc.up_embed.lin.w"),
        "up_embed_lin_b": g("s3g.flow.enc.up_embed.lin.b"),
        "up_embed_ln_w": g("s3g.flow.enc.up_embed.ln.w"),
        "up_embed_ln_b": g("s3g.flow.enc.up_embed.ln.b"),
        "up_blk": [conformer(f"s3g.flow.enc.up_blk.{i}")
                   for i in range(cfg.enc_up_layers)],
        "after_norm_w": g("s3g.flow.enc.after_norm.w"),
        "after_norm_b": g("s3g.flow.enc.after_norm.b"),
        "proj_w": g("s3g.flow.proj.w"), "proj_b": g("s3g.flow.proj.b"),
        "spk_aff_w": g("s3g.flow.spk_aff.w"),
        "spk_aff_b": g("s3g.flow.spk_aff.b"),
        # builtin conditioning
        "cond_embedding": g("s3g.cond.embedding").reshape(-1),
        "cond_prompt_feat": g("s3g.cond.prompt_feat").reshape(
            -1, cfg.mel_dim),
        # CFM
        "t_l1_w": g("s3g.cfm.t.l1.w"), "t_l1_b": g("s3g.cfm.t.l1.b"),
        "t_l2_w": g("s3g.cfm.t.l2.w"), "t_l2_b": g("s3g.cfm.t.l2.b"),
        "dn": cfm_stage("s3g.cfm.dn.0"),
        "dn_x_w": gc("s3g.cfm.dn.0.x.w"), "dn_x_b": g("s3g.cfm.dn.0.x.b"),
        "md": [cfm_stage(f"s3g.cfm.md.{i}")
               for i in range(cfg.cfm_mid_blocks)],
        "up": cfm_stage("s3g.cfm.up.0"),
        "up_x_w": gc("s3g.cfm.up.0.x.w"), "up_x_b": g("s3g.cfm.up.0.x.b"),
        "final": causal_block("s3g.cfm.final"),
        "cfm_proj_w": gc("s3g.cfm.proj.w"),
        "cfm_proj_b": g("s3g.cfm.proj.b"),
        # HiFT
        "f0_cn": [{"w": gc(f"s3g.hift.f0.cn.{i}.w"),
                   "b": g(f"s3g.hift.f0.cn.{i}.b")}
                  for i in range(HIFT_F0_LAYERS)],
        "f0_cls_w": g("s3g.hift.f0.cls.w"), "f0_cls_b": g("s3g.hift.f0.cls.b"),
        "src_lin_w": g("s3g.hift.src.lin.w"),
        "src_lin_b": g("s3g.hift.src.lin.b"),
        "conv_pre_w": gc("s3g.hift.conv_pre.w"),
        "conv_pre_b": g("s3g.hift.conv_pre.b"),
        "ups": [{"w": gtr(f"s3g.hift.up.{i}.w"), "b": g(f"s3g.hift.up.{i}.b")}
                for i in range(n_up)],
        "src_dn": [{"w": gc(f"s3g.hift.src_dn.{i}.w"),
                    "b": g(f"s3g.hift.src_dn.{i}.b")} for i in range(n_up)],
        "src_rb": [resblock(f"s3g.hift.src_rb.{i}") for i in range(n_up)],
        "rb": [resblock(f"s3g.hift.rb.{i}") for i in range(3 * n_up)],
        "conv_post_w": gc("s3g.hift.conv_post.w"),
        "conv_post_b": g("s3g.hift.conv_post.b"),
    }


def load_s3g_params(r: GGUFReader, cfg: S3GConfig, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Parameters from a Chatterbox S3Gen GGUF (s3g.* names); the conv
    weights stay in the file's PyTorch layouts."""
    return _tree(lambda n: _to(r.get(n), dtype, device), cfg)


# the keys of codec_tpu's tree that hold conv weights (WIO [K, C_in, C_out])
_CONV_KEYS = {"pre_cv1_w", "pre_cv2_w", "up_w", "cv_w", "res_w", "dn_x_w",
              "up_x_w", "cfm_proj_w", "conv_pre_w", "conv_post_w", "c1_w",
              "c2_w"}


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu S3Gen tree (from its `load_s3g_params`; leaves as NumPy
    arrays or anything np.asarray takes) → this module's parameters: conv
    weights from WIO back to [C_out, C_in, K], the upsamples' pre-flipped
    WIO back to [C_in, C_out, K]."""
    t = partial(_to, dtype=dtype, device=device)

    def walk(node, top, key):
        if isinstance(node, dict):
            return {k: walk(v, top or k, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, top, key) for v in node]
        a = np.asarray(node, np.float32)
        if top == "ups" and key == "w":
            return t(a[::-1].transpose(1, 2, 0))
        if key in _CONV_KEYS or (top in ("f0_cn", "src_dn") and key == "w"):
            return t(a.transpose(2, 1, 0))
        return t(a)

    return walk(tree, None, None)


# ---------------------------------------------------------------------------
# Flow encoder
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, b=None, **kw) -> torch.Tensor:
    """conv1d of channels-last x [B, T, C_in] with w [C_out, C_in, K]."""
    return F.conv1d(x.transpose(1, 2), w, b, **kw).transpose(1, 2)


def _heads(z: torch.Tensor, nh: int) -> torch.Tensor:
    b, t, _ = z.shape
    return z.reshape(b, t, nh, -1).transpose(1, 2)


def _conformer_block(x: torch.Tensor, lw: Dict[str, torch.Tensor],
                     pos: torch.Tensor, cfg: S3GConfig) -> torch.Tensor:
    b, t, c = x.shape
    nh = cfg.attn_heads
    h = norms.layer_norm(x, lw["norm_mha_w"], lw["norm_mha_b"], 1e-12)
    q = _heads(F.linear(h, lw["q_w"], lw["q_b"]), nh)
    k = _heads(F.linear(h, lw["k_w"], lw["k_b"]), nh)
    v = _heads(F.linear(h, lw["v_w"], lw["v_b"]), nh)
    p = _heads(F.linear(pos, lw["pos_w"])[None], nh)       # [1, H, 2T-1, D]
    a = sdpa_rel_pos(q, k, v, p, lw["pbu"], lw["pbv"])
    x = x + F.linear(a.transpose(1, 2).reshape(b, t, c), lw["o_w"], lw["o_b"])
    f = norms.layer_norm(x, lw["norm_ff_w"], lw["norm_ff_b"], 1e-12)
    f = silu(F.linear(f, lw["ff1_w"], lw["ff1_b"]))
    return x + F.linear(f, lw["ff2_w"], lw["ff2_b"])


def s3g_flow_encode_fn(params: Dict[str, Any], tokens: torch.Tensor,
                       cfg: S3GConfig) -> torch.Tensor:
    """tokens [B, T] int → mu [B, 2T, mel_dim]."""
    t = tokens.shape[1]
    scale = math.sqrt(cfg.enc_hidden)
    x = F.embedding(tokens, params["emb"])                 # [B, T, hidden]
    x = F.linear(x, params["embed_lin_w"], params["embed_lin_b"])
    x = norms.layer_norm(x, params["embed_ln_w"], params["embed_ln_b"],
                         1e-5) * scale
    # the pre-lookahead: pad right 3 → conv k4 → leaky 0.01 → pad left 2 →
    # conv k3 → + x
    h = _conv(F.pad(x, (0, 0, 0, 3)), params["pre_cv1_w"], params["pre_cv1_b"])
    h = leaky_relu(h, HIFT_LRELU_DEFAULT)
    h = _conv(F.pad(h, (0, 0, 2, 0)), params["pre_cv2_w"], params["pre_cv2_b"])
    x = x + h
    pos1 = espnet_rel_pos_emb(t, cfg.enc_hidden, x.device).to(x.dtype)
    for lw in params["blk"]:
        x = _conformer_block(x, lw, pos1, cfg)
    # up: ×2 nearest, pad left 4, conv k5
    x = torch.repeat_interleave(x, 2, dim=1)
    x = _conv(F.pad(x, (0, 0, 4, 0)), params["up_w"], params["up_b"])
    x = F.linear(x, params["up_embed_lin_w"], params["up_embed_lin_b"])
    x = norms.layer_norm(x, params["up_embed_ln_w"], params["up_embed_ln_b"],
                         1e-5) * scale
    pos2 = espnet_rel_pos_emb(2 * t, cfg.enc_hidden, x.device).to(x.dtype)
    for lw in params["up_blk"]:
        x = _conformer_block(x, lw, pos2, cfg)
    x = norms.layer_norm(x, params["after_norm_w"], params["after_norm_b"],
                         1e-5)
    return F.linear(x, params["proj_w"], params["proj_b"])


# ---------------------------------------------------------------------------
# CFM estimator
# ---------------------------------------------------------------------------

def _causal_block1d(x: torch.Tensor, blk: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
    """Causal conv k3 → LayerNorm → Mish."""
    y = conv.conv1d_causal_cf(x.transpose(1, 2), blk["cv_w"],
                              blk["cv_b"]).transpose(1, 2)
    return mish(norms.layer_norm(y, blk["ln_w"], blk["ln_b"], 1e-5))


def _cfm_resnet(x: torch.Tensor, t_emb: torch.Tensor,
                blk: Dict[str, Any]) -> torch.Tensor:
    h = _causal_block1d(x, blk["b1"])
    h = h + F.linear(mish(t_emb), blk["mlp_w"], blk["mlp_b"])[:, None, :]
    h = _causal_block1d(h, blk["b2"])
    return h + _conv(x, blk["res_w"], blk["res_b"])


def _basic_transformer(x: torch.Tensor, lw: Dict[str, torch.Tensor],
                       cfg: S3GConfig) -> torch.Tensor:
    b, t, _ = x.shape
    nh = cfg.attn_heads
    h = norms.layer_norm(x, lw["n1_w"], lw["n1_b"], 1e-5)
    a = sdpa(_heads(F.linear(h, lw["q_w"]), nh),
             _heads(F.linear(h, lw["k_w"]), nh),
             _heads(F.linear(h, lw["v_w"]), nh))
    x = x + F.linear(a.transpose(1, 2).reshape(b, t, -1), lw["o_w"],
                     lw["o_b"])
    f = norms.layer_norm(x, lw["n3_w"], lw["n3_b"], 1e-5)
    f = gelu_erf(F.linear(f, lw["ff1_w"], lw["ff1_b"]))
    return x + F.linear(f, lw["ff2_w"], lw["ff2_b"])


def _cfm_stage(x, t_emb, stage, cfg: S3GConfig) -> torch.Tensor:
    x = _cfm_resnet(x, t_emb, stage["r"])
    for lw in stage["t"]:
        x = _basic_transformer(x, lw, cfg)
    return x


def _sinusoidal_time_emb(t_v: float, dim: int, scale: float,
                         device=None) -> torch.Tensor:
    """[dim] float32: sin ‖ cos of t_v·scale over `dim // 2` frequencies
    10000^(-i / (half - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                      * (-math.log(10000.0) / (half - 1)))
    e = freqs * t_v * scale
    return torch.cat([torch.sin(e), torch.cos(e)])


def _cfm_time_emb(params: Dict[str, Any], t_v: float, in_channels: int,
                  scale: float) -> torch.Tensor:
    """The time embedding [time_embed_dim] in the parameters' dtype."""
    w = params["t_l1_w"]
    te = _sinusoidal_time_emb(t_v, in_channels, scale, w.device).to(w.dtype)
    te = silu(F.linear(te, w, params["t_l1_b"]))
    return F.linear(te, params["t_l2_w"], params["t_l2_b"])


def s3g_cfm_estimator_fn(params: Dict[str, Any], x: torch.Tensor,
                         mu: torch.Tensor, spks: torch.Tensor,
                         cond: torch.Tensor, t_emb: torch.Tensor,
                         cfg: S3GConfig) -> torch.Tensor:
    """x, mu, cond [B, T, mel], spks [B, mel], t_emb [time_embed] → dx/dt
    [B, T, mel]."""
    b = x.shape[0]
    h = torch.cat([x, mu, spks[:, None, :].expand(x.shape), cond], dim=-1)
    te = t_emb[None].expand(b, -1)
    h = _cfm_stage(h, te, params["dn"], cfg)
    skip = h
    h = conv.conv1d_causal_cf(h.transpose(1, 2), params["dn_x_w"],
                              params["dn_x_b"]).transpose(1, 2)
    for stage in params["md"]:
        h = _cfm_stage(h, te, stage, cfg)
    h = _cfm_stage(torch.cat([h, skip], dim=-1), te, params["up"], cfg)
    h = conv.conv1d_causal_cf(h.transpose(1, 2), params["up_x_w"],
                              params["up_x_b"]).transpose(1, 2)
    h = _causal_block1d(h, params["final"])
    return _conv(h, params["cfm_proj_w"], params["cfm_proj_b"])


# ---------------------------------------------------------------------------
# HiFT
# ---------------------------------------------------------------------------

def _hift_f0(params: Dict[str, Any], mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, mel_dim] → f0 [B, T]."""
    x = mel
    for lw in params["f0_cn"]:
        x = elu(_conv(x, lw["w"], lw["b"], padding=1))
    f0 = F.linear(x, params["f0_cls_w"], params["f0_cls_b"])
    return torch.abs(f0[..., 0])


def nsf_phase(f_harm: torch.Tensor) -> torch.Tensor:
    """θ = 2π·cumsum(f_harm) over time (dim 1 of [B, T, H]) in float32:
    summed in float64 and rounded once (the module docstring says why),
    each harmonic's samples contiguous (a scan along the outer dim of [B, T,
    H] took 169 ms on an H100 at 20 s)."""
    f = f_harm.double().transpose(1, 2).contiguous()         # [B, H, T]
    return (2.0 * math.pi * torch.cumsum(f, dim=-1)).float().transpose(1, 2)


def _nsf_source(f0: torch.Tensor, phase: torch.Tensor,
                nsf_noise: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """f0 [B, T_mel] → the NSF excitation [B, T_pcm, H+1] float32 (phase
    [H+1], nsf_noise [B, T_pcm, H+1])."""
    n_harm = HIFT_NB_HARMONICS + 1
    f0_pcm = torch.repeat_interleave(f0.float(), HIFT_SOURCE_UPSAMPLE,
                                     dim=-1)[..., None]       # [B, Tp, 1]
    scales = torch.arange(1, n_harm + 1, dtype=torch.float32,
                          device=f0.device) / sample_rate
    sine = HIFT_NSF_ALPHA * torch.sin(nsf_phase(f0_pcm * scales)
                                      + phase[None, None, :])
    uv = (f0_pcm > HIFT_NSF_VOICED_THRESHOLD).float()
    noise_amp = uv * (HIFT_NSF_SIGMA - HIFT_NSF_ALPHA / 3.0) \
        + HIFT_NSF_ALPHA / 3.0
    return sine * uv + noise_amp * nsf_noise


def _hann(device) -> torch.Tensor:
    n = np.arange(HIFT_N_FFT)
    return torch.from_numpy(0.5 - 0.5 * np.cos(2.0 * np.pi * n / HIFT_N_FFT)
                            ).float().to(device)


def _source_stft(s: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """s [B, T_pcm] float32 → [B, T_pcm/hop + 1, n_fft + 2] (real ‖ imag):
    the windowed STFT of s zero-padded n_fft/2 a side (not torch.stft's
    reflection pad)."""
    pad = HIFT_N_FFT // 2
    t_frames = s.shape[1] // HIFT_HOP + 1
    frames = F.pad(s, (pad, pad)).unfold(-1, HIFT_N_FFT, HIFT_HOP)
    spec = torch.fft.rfft(frames[:, :t_frames] * window, dim=-1)
    return torch.cat([spec.real, spec.imag], dim=-1)


def _hift_istft(head: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """head [B, T, n_fft + 2] → pcm [B, (T-1)·hop] float32: log-magnitude
    clipped at 100 then exp, phase sin(head) (CosyVoice's sin-phase), the
    window applied twice (win² in the numerator, OLA(win²) the envelope,
    floored at 1e-11), n_fft/2 trimmed a side."""
    head = head.float()
    mag = torch.exp(torch.clamp(head[..., :HIFT_N_BINS], max=1e2))
    phase = torch.sin(head[..., HIFT_N_BINS:])
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, n=HIFT_N_FFT, dim=-1) * (window * window)
    y = overlap_add(frames, HIFT_HOP)
    env = overlap_add((window * window).expand(1, head.shape[1], -1),
                      HIFT_HOP)
    pad = HIFT_N_FFT // 2
    return (y / torch.clamp(env, min=1e-11))[:, pad:-pad]


def _snake_resblock(x: torch.Tensor, branches, kernel: int) -> torch.Tensor:
    """HiFT's snake resblock on channels-first x [B, C, T]: the three
    dilation branches chained."""
    for br, d in zip(branches, HIFT_RB_DILATIONS):
        h = snake(x, br["a1"][:, None])
        h = F.conv1d(h, br["c1_w"], br["c1_b"], dilation=d,
                     padding=(kernel * d - d) // 2)
        h = snake(h, br["a2"][:, None])
        x = x + F.conv1d(h, br["c2_w"], br["c2_b"], padding=(kernel - 1) // 2)
    return x


def s3g_hift_fn(params: Dict[str, Any], mel: torch.Tensor,
                phase: torch.Tensor, nsf_noise: torch.Tensor,
                cfg: S3GConfig) -> torch.Tensor:
    """mel [B, T, mel_dim] → pcm [B, T·480] float32, clipped to ±0.99.
    phase [H+1] and nsf_noise [B, T·480, H+1] are float32."""
    dtype = mel.dtype
    f0 = _hift_f0(params, mel)
    waves = _nsf_source(f0, phase, nsf_noise, cfg.sample_rate).to(dtype)
    merge = torch.tanh(F.linear(waves, params["src_lin_w"],
                                params["src_lin_b"]))[..., 0]
    window = _hann(mel.device)
    s_stft = _source_stft(merge.float(), window).to(dtype).transpose(1, 2)

    x = F.conv1d(mel.transpose(1, 2), params["conv_pre_w"],
                 params["conv_pre_b"], padding=3)            # [B, C, T]
    for i, (u, k) in enumerate(zip(HIFT_UPS, HIFT_UP_KERNELS)):
        x = leaky_relu(x, HIFT_LRELU)
        x = F.conv_transpose1d(x, params["ups"][i]["w"], params["ups"][i]["b"],
                               stride=u, padding=(k - u) // 2)
        if i == len(HIFT_UPS) - 1:
            x = torch.cat([x[..., 1:2], x], dim=-1)  # ReflectionPad1d((1, 0))
        si = F.conv1d(s_stft, params["src_dn"][i]["w"],
                      params["src_dn"][i]["b"], stride=HIFT_SRC_STRIDES[i],
                      padding=HIFT_SRC_PADS[i])
        si = _snake_resblock(si, params["src_rb"][i], HIFT_SRC_RB_KERNELS[i])
        common = min(si.shape[-1], x.shape[-1])
        x = x[..., :common] + si[..., :common]
        acc = None
        for j, kj in enumerate(HIFT_RB_KERNELS):
            br = _snake_resblock(x, params["rb"][i * 3 + j], kj)
            acc = br if acc is None else acc + br
        x = acc / 3.0
    x = leaky_relu(x, HIFT_LRELU_DEFAULT)
    head = F.conv1d(x, params["conv_post_w"], params["conv_post_b"],
                    padding=3).transpose(1, 2)
    pcm = _hift_istft(head, window)
    return torch.clamp(pcm, -HIFT_AUDIO_LIMIT, HIFT_AUDIO_LIMIT)


# ---------------------------------------------------------------------------
# Full decode
# ---------------------------------------------------------------------------

def s3g_mel_fn(params: Dict[str, Any], tokens: torch.Tensor,
               noise_z: torch.Tensor, mel_len1: int,
               cfg: S3GConfig) -> torch.Tensor:
    """tokens [B, T_tok] (prompt + speech) → the mels past the prompt
    [B, 2·T_tok - mel_len1, mel_dim]: the flow encoder, then 10 Euler steps
    from noise_z [B, 2·T_tok, mel_dim] with the CFG pair as batch rows."""
    mu = s3g_flow_encode_fn(params, tokens, cfg)          # [B, 2T, mel]
    b, t_total, _ = mu.shape
    spk = params["cond_embedding"]
    spk = spk / torch.sqrt(torch.sum(spk * spk) + 1e-12)  # F.normalize
    spks = F.linear(spk, params["spk_aff_w"], params["spk_aff_b"])[None]
    spks = spks.expand(b, cfg.mel_dim)
    pf = params["cond_prompt_feat"][:mel_len1]
    cond = torch.cat([pf[None].expand(b, *pf.shape),
                      mu.new_zeros((b, t_total - mel_len1, cfg.mel_dim))],
                     dim=1)
    mu_p = torch.cat([mu, torch.zeros_like(mu)])
    spks_p = torch.cat([spks, torch.zeros_like(spks)])
    cond_p = torch.cat([cond, torch.zeros_like(cond)])
    in_ch = 4 * cfg.mel_dim
    sched = np.asarray([1.0 - math.cos(i / CFM_N_TIMESTEPS * 0.5 * math.pi)
                        for i in range(CFM_N_TIMESTEPS + 1)], np.float32)
    x = noise_z.to(mu.dtype)
    for t_v, dt in zip(sched[:-1], sched[1:] - sched[:-1]):
        t_emb = _cfm_time_emb(params, float(t_v), in_ch,
                              cfg.time_embed_scale)
        dx = s3g_cfm_estimator_fn(params, torch.cat([x, x]), mu_p, spks_p,
                                  cond_p, t_emb, cfg)
        dxdt = (1.0 + CFM_CFG_RATE) * dx[:b] - CFM_CFG_RATE * dx[b:]
        x = x + float(dt) * dxdt
    return x[:, mel_len1:]


def s3g_decode_fn(params: Dict[str, Any], tokens: torch.Tensor,
                  noise_z: torch.Tensor, phase: torch.Tensor,
                  nsf_noise: torch.Tensor, mel_len1: int,
                  cfg: S3GConfig) -> torch.Tensor:
    """tokens [B, T_tok] (prompt + speech) → pcm [B, T_speech·480] float32,
    T_speech = 2·T_tok - mel_len1 (before the trim-fade)."""
    mel = s3g_mel_fn(params, tokens, noise_z, mel_len1, cfg)
    return s3g_hift_fn(params, mel, phase, nsf_noise, cfg)


def trim_fade(pcm: np.ndarray, sample_rate: int) -> np.ndarray:
    """Zero the first 20 ms and fade in over the next 20 ms (a raised
    cosine), in place on the host → pcm."""
    n_trim = sample_rate // 50
    pcm[:n_trim] = 0.0
    i = np.arange(min(n_trim, max(0, len(pcm) - n_trim)))
    ang = np.pi * (1.0 - i / n_trim)
    pcm[n_trim:n_trim + len(i)] *= 0.5 * (np.cos(ang) + 1.0)
    return pcm


def decode_noise(t_total: int, t_pcm: int, mel_dim: int):
    """codec_tpu's host draws, in its order: the CFM noise [1, t_total,
    mel_dim], the NSF phases [H+1] (0 for the fundamental) and the NSF noise
    [1, t_pcm, H+1], float32, from np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    noise_z = rng.standard_normal((1, t_total, mel_dim)).astype(np.float32)
    phase = np.concatenate([[0.0], rng.uniform(-np.pi, np.pi,
                                               HIFT_NB_HARMONICS)]
                           ).astype(np.float32)
    nsf_noise = rng.standard_normal(
        (1, t_pcm, HIFT_NB_HARMONICS + 1)).astype(np.float32)
    return noise_z, phase, nsf_noise


class ChatterboxS3G(CodecModel):
    arch = "chatterbox_s3g"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = S3GConfig.from_gguf(reader)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = -1
        self.has_encoder = reader.get_bool("codec.has_encoder", False)
        self.has_decoder = reader.get_bool("codec.has_decoder", True)
        if reader.get_bool("chatterbox_s3g.meanflow", False):
            raise CodecError("Chatterbox-S3G meanflow path not implemented")
        if not reader.get_bool("chatterbox_s3g.has_builtin_conditioning",
                               False):
            raise CodecError("Chatterbox-S3G decode requires builtin "
                             "conditioning")
        self.prompt_token = np.asarray(
            reader.get_arr("chatterbox_s3g.cond.prompt_token"), np.int32)
        self.prompt_token_len = reader.get_i32(
            "chatterbox_s3g.cond.prompt_token_len", len(self.prompt_token))
        self.prompt_feat_frames = reader.get_i32(
            "chatterbox_s3g.cond.prompt_feat_frames", 0)
        self.params = load_s3g_params(reader, self.cfg,
                                      dtype=self.compute_dtype,
                                      device=self.device)

    def tokens(self, codes) -> np.ndarray:
        """The prompt tokens followed by the codes in range, as codec_tpu
        takes them: flattened, ids outside [0, codebook_size) dropped. A
        batch of more than one row raises (codec_tpu would run its rows as
        one sequence)."""
        codes = np.asarray(codes)
        if codes.ndim == 3 and codes.shape[0] > 1:
            raise CodecError(f"{self.arch}: one sequence a decode, got a "
                             f"batch of {codes.shape[0]}")
        codes = codes.reshape(-1)
        codes = codes[(codes >= 0) & (codes < self.codebook_size)]
        return np.concatenate([self.prompt_token[:self.prompt_token_len],
                               codes.astype(np.int32)])

    def decode(self, codes, n_q: int = 0, pcm_format: str = "f32"):
        """Speech tokens [T] / [T, 1] / [1, T, 1] → 24 kHz PCM [(2·(P + T)
        - prompt_feat_frames)·480] on the host, P the prompt's tokens;
        float32, or int16 with pcm_format="i16". The noise is codec_tpu's
        (decode_noise)."""
        if pcm_format not in ("f32", "i16"):
            raise CodecError(f"unknown pcm_format {pcm_format!r}")
        tok = self.tokens(codes)
        if len(tok) == 0:
            raise CodecError("empty token sequence")
        mel_len1 = self.prompt_feat_frames
        t_total = 2 * len(tok)
        if mel_len1 > t_total:
            raise CodecError("prompt_feat_frames exceeds encoder output "
                             "length")
        t_pcm = (t_total - mel_len1) * HIFT_SOURCE_UPSAMPLE
        if t_pcm == 0:          # the prompt alone: no speech frames
            return self._fmt_out(torch.zeros(0), pcm_format).numpy()
        noise_z, phase, nsf_noise = decode_noise(t_total, t_pcm,
                                                 self.cfg.mel_dim)
        dev = self.device
        with perf_scope("decode_total", self.arch), self._decoding():
            with perf_scope("graph_compute", "decode"):
                pcm = s3g_decode_fn(
                    self.params, torch.from_numpy(tok.astype(np.int64))[None]
                    .to(dev), torch.from_numpy(noise_z).to(dev),
                    torch.from_numpy(phase).to(dev),
                    torch.from_numpy(nsf_noise).to(dev), mel_len1,
                    self.cfg)[0].cpu().numpy()
        pcm = trim_fade(pcm, self.sample_rate)
        return self._fmt_out(torch.from_numpy(pcm), pcm_format).numpy()
