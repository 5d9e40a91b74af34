"""NeuCodec and DistillNeuCodec (neuphonic/neucodec, neuphonic/distill-
neucodec: the codec of NeuTTS-Air), decode and distill encode, in PyTorch.

Counterpart of codec_tpu/models/neucodec.py:

decode: one FSQ codebook lookup → project_out → fc_post_a → embed conv
        k7 → 2 prior ResNet blocks (GroupNorm 32, eps 1e-6, SiLU, conv k3)
        → N RoFormer blocks (RMSNorm eps 1e-6, fused QKV without bias,
        RoPE NORMAL, non-causal attention with float32 softmax, SiLU MLP)
        → 2 post ResNet blocks → final LN → iSTFT head (optional baked
        window) → 24 kHz PCM. XCodec2 (models/xcodec2.py) runs the same
        decoder under the prefix "xcodec2".
encode (the distill encoder only, as in codec_tpu: the base encoder_type
        raises): 16 kHz PCM, padded up to the next multiple of 320 (a whole
        320 when aligned), row by row →
          acoustic: multi-scale |x| → max → avg pool first block (kernels
            1, 5, 11, 21, 45) → ConvNeXt-like units (depthwise k7, snake
            with eps 1.1920929e-7, GRN) and three stride-4 convs → two
            block-local transformers (dynamic position bias, GEGLU FF) →
            stride-5 conv → three local transformers → fc_sq_prior
          semantic: the PCM with 160 zeros a side → HuBERT (conv feature
            stack, group norm on the first conv, positional conv, post-LN
            transformer) → the semantic conv encoder
        concat (semantic first) → fc_prior → project_in → FSQ (levels
        [4]^8, models/xcodec2.py::fsq_quantize_x2) → codes [T, 1].

Every attention here is the plain `ops/attn.py::sdpa` (the decoder's and
HuBERT's full attention, the local transformers' with their bias and
block-causal mask as an additive [H, T, T] term): codec_tpu computes them
as einsum + softmax, outside any Pallas kernel, and no kernel of the port
covers an attention with a bias. So a NeuCodec request launches none of
the port's kernels. Float16 depthwise convs run without cuDNN on the card
(ops/conv.py::no_cudnn_for_f16): the distill units' k7 runs at the PCM
rate, 320 000 frames a 20 s request.

Parameters (`load_neu_params`, `load_neu_encode_params`,
`params_from_jax`) keep PyTorch layouts: linear [out, in], conv [C_out,
C_in/groups, K].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, blocks, norms, rope
from ..ops.attn import sdpa
from ..ops.istft import istft_from_head
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.perf_log import perf_scope


@dataclass(frozen=True)
class NeuConfig:
    sample_rate: int = 24000
    hop_size: int = 480
    n_q: int = 1
    codebook_size: int = 65536
    codebook_dim: int = 8
    vq_dim: int = 1024
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    rope_theta: float = 10000.0

    @classmethod
    def from_gguf(cls, r: GGUFReader, prefix: str = "neucodec",
                  **overrides) -> "NeuConfig":
        d = cls(**overrides)
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", d.sample_rate),
            hop_size=r.get_i32("codec.hop_size", d.hop_size),
            n_q=r.get_i32("codec.n_q", d.n_q),
            codebook_size=r.get_i32("codec.codebook_size", d.codebook_size),
            codebook_dim=r.get_i32("codec.codebook_dim", d.codebook_dim),
            vq_dim=r.get_i32(f"{prefix}.vq_dim", d.vq_dim),
            hidden_dim=r.get_i32(f"{prefix}.hidden_dim", d.hidden_dim),
            num_layers=r.get_i32(f"{prefix}.num_layers", d.num_layers),
            num_heads=r.get_i32(f"{prefix}.num_heads", d.num_heads),
            head_dim=r.get_i32(f"{prefix}.head_dim", d.head_dim),
            rope_theta=r.get_f32(f"{prefix}.rope_theta", d.rope_theta),
        )


# ---------------------------------------------------------------------------
# Decoder parameters
# ---------------------------------------------------------------------------

_DEC_FLAT = (("cb", "codebook"), ("qp_w", "quant.project_out.w"),
             ("qp_b", "quant.project_out.b"), ("fc_w", "fc_post_a.w"),
             ("fc_b", "fc_post_a.b"), ("embed_w", "embed.w"),
             ("embed_b", "embed.b"), ("fln_w", "final_ln.w"),
             ("fln_b", "final_ln.b"), ("head_w", "head.out.w"),
             ("head_b", "head.out.b"))
_RESNET = (("n1_w", "norm1.w"), ("n1_b", "norm1.b"), ("c1_w", "conv1.w"),
           ("c1_b", "conv1.b"), ("n2_w", "norm2.w"), ("n2_b", "norm2.b"),
           ("c2_w", "conv2.w"), ("c2_b", "conv2.b"))
_ROFORMER = (("att_norm", "att_norm.w"), ("ffn_norm", "ffn_norm.w"),
             ("c_attn", "att.c_attn.w"), ("c_proj", "att.c_proj.w"),
             ("fc1", "mlp.fc1.w"), ("fc2", "mlp.fc2.w"))
_DEC_CONV = {"embed_w", "c1_w", "c2_w"}


def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_neu_params(r: GGUFReader, cfg: NeuConfig, dtype=torch.float32,
                    device="cpu", prefix: str = "neucodec") -> Dict[str, Any]:
    """The decoder's parameters from `{prefix}.decode.*` (the iSTFT window
    is optional: None when the file has none)."""
    t = partial(_to, dtype=dtype, device=device)
    d = f"{prefix}.decode"
    p: Dict[str, Any] = {k: t(r.get(f"{d}.{n}")) for k, n in _DEC_FLAT}
    win = r.get_or_none(f"{d}.istft.window")
    p["window"] = t(win.reshape(-1)) if win is not None else None
    for group in ("prior", "post"):
        p[group] = [{k: t(r.get(f"{d}.{group}.{li}.{n}")) for k, n in _RESNET}
                    for li in range(2)]
    p["layers"] = [{k: t(r.get(f"{d}.transformer.{li}.{n}"))
                    for k, n in _ROFORMER} for li in range(cfg.num_layers)]
    return p


def _conv_from_jax(w, t) -> torch.Tensor:
    """codec_tpu's WIO conv weight [K, C_in, C_out] → [C_out, C_in, K]."""
    return t(np.asarray(w, np.float32).transpose(2, 1, 0))


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu NeuCodec / XCodec2 decoder tree (its `load_neu_params`;
    leaves as NumPy arrays or anything np.asarray takes) → this module's
    decoder parameters."""
    t = partial(_to, dtype=dtype, device=device)

    def leaf(k, v):
        return _conv_from_jax(v, t) if k in _DEC_CONV else t(v)

    p: Dict[str, Any] = {k: leaf(k, tree[k]) for k, _ in _DEC_FLAT}
    p["window"] = t(tree["window"]) if tree["window"] is not None else None
    for group in ("prior", "post"):
        p[group] = [{k: leaf(k, b[k]) for k, _ in _RESNET}
                    for b in tree[group]]
    p["layers"] = [{k: t(lw[k]) for k, _ in _ROFORMER}
                   for lw in tree["layers"]]
    return p


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def neu_decode_head_fn(params: Dict[str, Any], codes: torch.Tensor,
                       cfg: NeuConfig) -> torch.Tensor:
    """codes [B, T, 1] → the iSTFT head's input [B, T, n_fft + 2]."""
    codes = codes[..., 0].clamp(0, cfg.codebook_size - 1)
    x = F.embedding(codes, params["cb"])                       # [B, T, cb_dim]
    x = F.linear(x, params["qp_w"], params["qp_b"])
    x = F.linear(x, params["fc_w"], params["fc_b"])
    x = blocks.conv_tc(x, params["embed_w"], params["embed_b"], padding=3)
    for b in params["prior"]:
        x = blocks.diffusion_resblock(x, b)
    bsz, t, c = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    cos, sin = rope.rope_cos_sin(torch.arange(t, device=x.device), hd,
                                 cfg.rope_theta)
    for lw in params["layers"]:
        h = norms.rms_norm(x, lw["att_norm"], 1e-6)
        q, k, v = F.linear(h, lw["c_attn"]).reshape(
            bsz, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q = rope.rotate(q, cos, sin, neox=False)
        k = rope.rotate(k, cos, sin, neox=False)
        ctx = sdpa(q, k, v).transpose(1, 2).reshape(bsz, t, c)
        x = x + F.linear(ctx, lw["c_proj"])
        m = norms.rms_norm(x, lw["ffn_norm"], 1e-6)
        x = x + F.linear(act.silu(F.linear(m, lw["fc1"])), lw["fc2"])
    for b in params["post"]:
        x = blocks.diffusion_resblock(x, b)
    x = norms.layer_norm(x, params["fln_w"], params["fln_b"], 1e-6)
    return F.linear(x, params["head_w"], params["head_b"])


def neu_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                  cfg: NeuConfig) -> torch.Tensor:
    """codes [B, T, 1] → pcm [B, T·hop] float32."""
    return istft_from_head(neu_decode_head_fn(params, codes, cfg),
                           cfg.hop_size, window=params["window"])


# ---------------------------------------------------------------------------
# Distill encoder: configuration and parameters
# ---------------------------------------------------------------------------

POOL_KERNELS = (1, 5, 11, 21, 45)
ENCODE_HOP = 320          # 16 kHz PCM a code (the encode pads to a multiple)
HUBERT_DEFAULT_DIM = (512, 512, 512, 512, 512, 512, 512)
HUBERT_DEFAULT_KERNEL = (10, 3, 3, 3, 3, 2, 2)
HUBERT_DEFAULT_STRIDE = (5, 2, 2, 2, 2, 2, 2)


def neu_encode_name(name: str) -> str:
    """Encode-side tensors are stored under FNV-1a-64 digests (`nce.<hex>`)
    to fit GGUF's 63-character tensor names (the converter's rule)."""
    if not name.startswith("neucodec.encode."):
        return name
    h = 1469598103934665603
    for b in name.encode("utf-8"):
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return f"nce.{h:016x}"


def _neu_get(r: GGUFReader, name: str) -> np.ndarray:
    """A logical encode tensor: the plain name first (small test files),
    else its hashed wire name (converted files)."""
    if r.has_tensor(name):
        return r.get(name)
    return r.get(neu_encode_name(name))


@dataclass(frozen=True)
class NeuEncConfig:
    hubert_hidden: int = 768
    hubert_heads: int = 12
    hubert_intermediate: int = 3072
    hubert_layers: int = 12
    hubert_pos_k: int = 128
    hubert_pos_groups: int = 16
    hubert_ln_eps: float = 1e-5
    hubert_conv_dim: tuple = HUBERT_DEFAULT_DIM
    hubert_conv_kernel: tuple = HUBERT_DEFAULT_KERNEL
    hubert_conv_stride: tuple = HUBERT_DEFAULT_STRIDE
    distill_heads: int = 6
    down_window: int = 3000
    local_window: int = 600

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "NeuEncConfig":
        d = cls()

        def arr(k, v):
            return tuple(r.get_arr(f"neucodec.hubert.{k}") or v)

        return cls(
            hubert_hidden=r.get_i32("neucodec.hubert.hidden_size",
                                    d.hubert_hidden),
            hubert_heads=r.get_i32("neucodec.hubert.num_heads",
                                   d.hubert_heads),
            hubert_intermediate=r.get_i32("neucodec.hubert.intermediate_size",
                                          d.hubert_intermediate),
            hubert_layers=r.get_i32("neucodec.hubert.num_layers",
                                    d.hubert_layers),
            hubert_pos_k=r.get_i32("neucodec.hubert.num_conv_pos_embeddings",
                                   d.hubert_pos_k),
            hubert_pos_groups=r.get_i32(
                "neucodec.hubert.num_conv_pos_embedding_groups",
                d.hubert_pos_groups),
            hubert_ln_eps=r.get_f32("neucodec.hubert.layer_norm_eps",
                                    d.hubert_ln_eps),
            hubert_conv_dim=arr("conv_dim", d.hubert_conv_dim),
            hubert_conv_kernel=arr("conv_kernel", d.hubert_conv_kernel),
            hubert_conv_stride=arr("conv_stride", d.hubert_conv_stride),
            distill_heads=r.get_i32("neucodec.distill.heads", d.distill_heads),
            down_window=r.get_i32("neucodec.distill.down_window",
                                  d.down_window),
            local_window=r.get_i32("neucodec.distill.local_window",
                                   d.local_window),
        )


ENC = "neucodec.encode"
_DC = ENC + ".distill.codec_encoder"
_UNIT = (("dw_w", "dw_conv.weight"), ("dw_b", "dw_conv.bias"),
         ("pw1_w", "pw_conv1.weight"), ("pw1_b", "pw_conv1.bias"),
         ("alpha", "act.alpha"), ("grn_g", "grn.gamma"), ("grn_b", "grn.beta"),
         ("pw2_w", "pw_conv2.weight"), ("pw2_b", "pw_conv2.bias"))
_LOCAL = (("ln_w", "0.norm.weight"), ("ln_b", "0.norm.bias"),
          ("qkv_w", "0.to_qkv.weight"), ("out_w", "0.to_out.weight"),
          ("ff_ln_w", "1.0.weight"), ("ff_ln_b", "1.0.bias"),
          ("ff_w1", "1.1.weight"), ("ff_w2", "1.4.weight"))
_DPB = (("w0", "mlp.0.weight"), ("b0", "mlp.0.bias"), ("w1", "mlp.2.weight"),
        ("b1", "mlp.2.bias"), ("w2", "mlp.4.weight"), ("b2", "mlp.4.bias"))
_HUBERT_LAYER = (("q_w", "att.q.w"), ("q_b", "att.q.b"), ("k_w", "att.k.w"),
                 ("k_b", "att.k.b"), ("v_w", "att.v.w"), ("v_b", "att.v.b"),
                 ("o_w", "att.o.w"), ("o_b", "att.o.b"), ("ln_w", "ln.w"),
                 ("ln_b", "ln.b"), ("ff1_w", "ffn.fc1.w"),
                 ("ff1_b", "ffn.fc1.b"), ("ff2_w", "ffn.fc2.w"),
                 ("ff2_b", "ffn.fc2.b"), ("ffn_ln_w", "ffn_ln.w"),
                 ("ffn_ln_b", "ffn_ln.b"))
# the flat tensors: key → logical name
_ENC_FLAT = {
    "first_conv1_w": f"{_DC}.encoder.blocks.0.conv_1.weight",
    "first_conv1_b": f"{_DC}.encoder.blocks.0.conv_1.bias",
    "first_conv2_w": f"{_DC}.encoder.blocks.0.conv_2.weight",
    "first_conv2_b": f"{_DC}.encoder.blocks.0.conv_2.bias",
    "final_w": f"{_DC}.encoder.blocks.8.weight",
    "final_b": f"{_DC}.encoder.blocks.8.bias",
    "down_layer_w": f"{_DC}.en_encoder.down_trans.down_layer.weight",
    "down_layer_b": f"{_DC}.en_encoder.down_trans.down_layer.bias",
    "fc_sq_w": ENC + ".fc_sq_prior.w", "fc_sq_b": ENC + ".fc_sq_prior.b",
    "hubert_gn_w": ENC + ".hubert.feat.conv.0.gn.w",
    "hubert_gn_b": ENC + ".hubert.feat.conv.0.gn.b",
    "hubert_proj_w": ENC + ".hubert.feature_projection.w",
    "hubert_proj_b": ENC + ".hubert.feature_projection.b",
    "hubert_pos_w": ENC + ".hubert.encoder.pos_conv.w",
    "hubert_pos_b": ENC + ".hubert.encoder.pos_conv.b",
    "hubert_enc_ln_w": ENC + ".hubert.encoder.layer_norm.w",
    "hubert_enc_ln_b": ENC + ".hubert.encoder.layer_norm.b",
    "sem_init_w": ENC + ".semantic_encoder.initial_conv.w",
    "sem_r1_w": ENC + ".semantic_encoder.residual.1.w",
    "sem_r1_b": ENC + ".semantic_encoder.residual.1.b",
    "sem_r3_w": ENC + ".semantic_encoder.residual.3.w",
    "sem_r3_b": ENC + ".semantic_encoder.residual.3.b",
    "sem_out_w": ENC + ".semantic_encoder.final_conv.w",
    "fc_prior_w": ENC + ".fc_prior.w", "fc_prior_b": ENC + ".fc_prior.b",
    "proj_in_w": ENC + ".quant.project_in.w",
    "proj_in_b": ENC + ".quant.project_in.b",
}
# conv weights among them (codec_tpu keeps these WIO)
_ENC_CONV = {"first_conv1_w", "first_conv2_w", "final_w", "down_layer_w",
             "hubert_pos_w", "sem_init_w", "sem_r1_w", "sem_r3_w",
             "sem_out_w", "dw_w"}


def load_neu_encode_params(r: GGUFReader, cfg: NeuEncConfig,
                           dtype=torch.float32,
                           device="cpu") -> Dict[str, Any]:
    """The distill encoder's parameters (plain or hashed wire names)."""
    t = partial(_to, dtype=dtype, device=device)

    def g(name):
        return t(_neu_get(r, name))

    def unit(prefix):
        u = {k: g(f"{prefix}.{n}") for k, n in _UNIT}
        u["grn_g"], u["grn_b"] = u["grn_g"].reshape(-1), u["grn_b"].reshape(-1)
        return u

    def local_trans(prefix, depth):
        return [{k: g(f"{prefix}.layers.{li}.{n}") for k, n in _LOCAL}
                for li in range(depth)]

    def dpb(prefix):
        return {k: g(f"{prefix}.dynamic_pos_bias.{n}") for k, n in _DPB}

    en = f"{_DC}.en_encoder"
    p: Dict[str, Any] = {k: g(n) for k, n in _ENC_FLAT.items()}
    p.update({
        "first_branches": [
            {"w": g(f"{_DC}.encoder.blocks.0.blocks.{i}.1.weight"),
             "b": g(f"{_DC}.encoder.blocks.0.blocks.{i}.1.bias")}
            for i in range(len(POOL_KERNELS))],
        "units": [unit(f"{_DC}.encoder.blocks.{b}.0.module")
                  for b in (1, 3, 5, 7)],
        "unit_7_1": unit(f"{_DC}.encoder.blocks.7.1.module"),
        "downs": [{"w": g(f"{_DC}.encoder.blocks.{b}.0.weight"),
                   "b": g(f"{_DC}.encoder.blocks.{b}.0.bias")}
                  for b in (2, 4, 6)],
        "down_trans": local_trans(f"{en}.down_trans.trans", 2),
        "down_dpb": dpb(f"{en}.down_trans.trans"),
        "local_trans": local_trans(f"{en}.local_trans", 3),
        "local_dpb": dpb(f"{en}.local_trans"),
        "hubert_feat": [{"w": g(f"{ENC}.hubert.feat.conv.{li}.w")}
                        for li in range(len(cfg.hubert_conv_stride))],
        "hubert_layers": [
            {k: g(f"{ENC}.hubert.encoder.layers.{li}.{n}")
             for k, n in _HUBERT_LAYER} for li in range(cfg.hubert_layers)],
    })
    return p


def encode_params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                           device="cpu") -> Dict[str, Any]:
    """A codec_tpu distill encoder tree (its `load_neu_encode_params`) →
    this module's encoder parameters."""
    t = partial(_to, dtype=dtype, device=device)

    def conv(w):
        return _conv_from_jax(w, t)

    def leaf(k, v):
        return conv(v) if k in _ENC_CONV else t(v)

    def layers(ls):
        return [{k: t(v) for k, v in lw.items()} for lw in ls]

    p: Dict[str, Any] = {k: leaf(k, tree[k]) for k in _ENC_FLAT}
    p.update({
        "first_branches": [{"w": conv(b["w"]), "b": t(b["b"])}
                           for b in tree["first_branches"]],
        "units": [{k: leaf(k, v) for k, v in u.items()}
                  for u in tree["units"]],
        "unit_7_1": {k: leaf(k, v) for k, v in tree["unit_7_1"].items()},
        "downs": [{"w": conv(d["w"]), "b": t(d["b"])} for d in tree["downs"]],
        "down_trans": layers(tree["down_trans"]),
        "down_dpb": {k: t(v) for k, v in tree["down_dpb"].items()},
        "local_trans": layers(tree["local_trans"]),
        "local_dpb": {k: t(v) for k, v in tree["local_dpb"].items()},
        "hubert_feat": [{"w": conv(f["w"])} for f in tree["hubert_feat"]],
        "hubert_layers": layers(tree["hubert_layers"]),
    })
    return p


# ---------------------------------------------------------------------------
# Distill encoder: forward
# ---------------------------------------------------------------------------

def _pool1d_same(x: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """Stride-1 max ("max") or average pool with zero pad k // 2, as
    PyTorch's MaxPool1d / AvgPool1d(count_include_pad=True) over x [B, T,
    C] → [B, T - (1 - k % 2), C]. max_pool1d pads with −inf where
    codec_tpu pads with zeros: the encoder pools |x| ≥ 0, where the two
    agree."""
    if k == 1:
        return x
    xc = x.transpose(1, 2)
    if op == "max":
        y = F.max_pool1d(xc, k, stride=1, padding=k // 2)
    else:
        y = F.avg_pool1d(xc, k, stride=1, padding=k // 2,
                         count_include_pad=True)
    return y.transpose(1, 2)


def _grn(x: torch.Tensor, gamma: torch.Tensor,
         beta: torch.Tensor) -> torch.Tensor:
    """The distill units' GRN: its norm runs over a length-1 axis, so it is
    x + γ·x + β."""
    return x + gamma * x + beta


def dynamic_pos_bias(p: Dict[str, torch.Tensor],
                     max_dist: int) -> torch.Tensor:
    """The dynamic position bias: a 3-layer SiLU MLP over the distances
    0 .. max_dist-1 → [heads, max_dist], in float32."""
    w = {k: v.float() for k, v in p.items()}
    d = torch.arange(max_dist, dtype=torch.float32, device=w["w0"].device)
    h = act.silu(d[:, None] * w["w0"][:, 0] + w["b0"])
    h = act.silu(F.linear(h, w["w1"], w["b1"]))
    return F.linear(h, w["w2"], w["b2"]).t()


def local_attn_bias(bias_hd: torch.Tensor, t: int,
                    window: int) -> torch.Tensor:
    """The block-causal window and the position bias as one additive term
    [heads, T_q, T_k]: key k is visible to query q iff q − (q % W + W) <=
    k <= q with W = window / 2, and then adds bias_hd[:, q − k] (0 from
    max_dist on); hidden keys get −inf (query q always sees itself)."""
    heads, max_dist = bias_hd.shape
    w_blk = max(1, max(2, window) // 2)
    pos = torch.arange(t, device=bias_hd.device)
    q, k = pos[:, None], pos[None, :]
    d = q - k
    ok = (k <= q) & (k >= q - (q % w_blk + w_blk))
    bias = bias_hd[:, d.clamp(0, max_dist - 1)]
    bias = torch.where(d < max_dist, bias, torch.zeros((), device=d.device))
    return torch.where(ok, bias, torch.full((), -math.inf, device=d.device))


def _base_unit_fwd(x: torch.Tensor, u: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """A distill unit on [B, T, C]: depthwise k7 → pw1 → snake (eps
    1.1920929e-7) → GRN → pw2 → +x."""
    h = blocks.depthwise_conv(x, u["dw_w"], u["dw_b"])
    h = F.linear(h, u["pw1_w"], u["pw1_b"])
    h = act.snake(h, u["alpha"], eps=1.1920929e-7)
    h = _grn(h, u["grn_g"], u["grn_b"])
    return x + F.linear(h, u["pw2_w"], u["pw2_b"])


def _local_trans_fwd(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
                     bias_hd: torch.Tensor, window: int,
                     heads: int) -> torch.Tensor:
    """A LocalTransformer stage on [B, T, dim]: pre-LN block-local attention
    (fused QKV without bias, head dim dim / 4, local_attn_bias) and a GEGLU
    feed-forward (inner dim·4·2/3)."""
    b, t, dim = x.shape
    hd = dim // 4
    ff_inner = dim * 4 * 2 // 3
    bias = local_attn_bias(bias_hd, t, window)               # [H, T, T]
    for lw in layers:
        h = norms.layer_norm(x, lw["ln_w"], lw["ln_b"], 1e-5)
        q, k, v = F.linear(h, lw["qkv_w"]).reshape(
            b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = sdpa(q, k, v, bias=bias).transpose(1, 2).reshape(b, t, heads * hd)
        x = x + F.linear(a, lw["out_w"])
        f = F.linear(norms.layer_norm(x, lw["ff_ln_w"], lw["ff_ln_b"], 1e-5),
                     lw["ff_w1"])
        x = x + F.linear(f[..., :ff_inner] * act.gelu_erf(f[..., ff_inner:]),
                         lw["ff_w2"])
    return x


def neu_distill_acoustic_fn(params: Dict[str, Any], pcm: torch.Tensor,
                            cfg: NeuEncConfig) -> torch.Tensor:
    """pcm [B, n] (n a multiple of 320) → the acoustic branch [B, n/320,
    fc_sq_out]."""
    x = pcm[..., None]                                          # [B, n, 1]
    a = torch.abs(x)
    branches = []
    for k, br in zip(POOL_KERNELS, params["first_branches"]):
        h = _pool1d_same(_pool1d_same(a, k, "max"), k, "avg")
        branches.append(blocks.conv_tc(h, br["w"], br["b"], padding=3))
    h = blocks.conv_tc(torch.cat(branches, dim=-1), params["first_conv1_w"],
                       params["first_conv1_b"])
    h = torch.cat([act.gelu_erf(h), x], dim=-1)
    x = blocks.conv_tc(h, params["first_conv2_w"], params["first_conv2_b"])
    for unit, down in zip(params["units"], params["downs"]):
        x = blocks.conv_tc(_base_unit_fwd(x, unit), down["w"], down["b"],
                           stride=4)
    x = _base_unit_fwd(x, params["units"][3])
    x = _base_unit_fwd(x, params["unit_7_1"])
    x = blocks.conv_tc(x, params["final_w"], params["final_b"], padding=1)
    heads = cfg.distill_heads
    x = _local_trans_fwd(x, params["down_trans"],
                         dynamic_pos_bias(params["down_dpb"], cfg.down_window),
                         cfg.down_window, heads)
    x = blocks.conv_tc(x, params["down_layer_w"], params["down_layer_b"],
                       stride=5)
    x = _local_trans_fwd(x, params["local_trans"],
                         dynamic_pos_bias(params["local_dpb"],
                                          cfg.local_window),
                         cfg.local_window, heads)
    return F.linear(x, params["fc_sq_w"], params["fc_sq_b"])


def neu_hubert_fn(params: Dict[str, Any], sem_pcm: torch.Tensor,
                  cfg: NeuEncConfig) -> torch.Tensor:
    """sem_pcm [B, n_sem] → HuBERT's hidden states [B, T_sem, hidden]."""
    h = sem_pcm[:, None]                                         # [B, 1, n]
    for li, (lw, stride) in enumerate(zip(params["hubert_feat"],
                                          cfg.hubert_conv_stride)):
        h = F.conv1d(h, lw["w"], stride=stride)
        if li == 0:
            h = torch.group_norm(h, cfg.hubert_conv_dim[0],
                                 params["hubert_gn_w"], params["hubert_gn_b"],
                                 cfg.hubert_ln_eps)
        h = act.gelu_erf(h)
    h = F.linear(h.transpose(1, 2), params["hubert_proj_w"],
                 params["hubert_proj_b"])
    pos = F.conv1d(h.transpose(1, 2), params["hubert_pos_w"],
                   params["hubert_pos_b"], padding=cfg.hubert_pos_k // 2,
                   groups=cfg.hubert_pos_groups).transpose(1, 2)
    if cfg.hubert_pos_k % 2 == 0:
        pos = pos[:, :-1]
    eps = cfg.hubert_ln_eps
    h = norms.layer_norm(h + act.gelu_erf(pos), params["hubert_enc_ln_w"],
                         params["hubert_enc_ln_b"], eps)
    b, t, c = h.shape
    nh = cfg.hubert_heads
    hd = c // nh
    for lw in params["hubert_layers"]:
        q, k, v = (F.linear(h, lw[f"{n}_w"], lw[f"{n}_b"]).reshape(
            b, t, nh, hd).transpose(1, 2) for n in "qkv")
        a = sdpa(q, k, v).transpose(1, 2).reshape(b, t, c)
        h = norms.layer_norm(h + F.linear(a, lw["o_w"], lw["o_b"]),
                             lw["ln_w"], lw["ln_b"], eps)
        f = act.gelu_erf(F.linear(h, lw["ff1_w"], lw["ff1_b"]))
        h = norms.layer_norm(h + F.linear(f, lw["ff2_w"], lw["ff2_b"]),
                             lw["ffn_ln_w"], lw["ffn_ln_b"], eps)
    return h


def semantic_convs(h: torch.Tensor, w_init: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                   w_out: torch.Tensor) -> torch.Tensor:
    """The SemanticEncoder conv stack on [B, T, C] (all k3, pad 1): conv →
    ReLU → (ReLU(conv) → conv) + the post-ReLU value → conv. The residual
    taps the value after the first ReLU (upstream's ReLU is in place),
    as in codec_tpu; XCodec2 runs the same stack."""
    h = torch.relu(blocks.conv_tc(h, w_init, padding=1))
    r = torch.relu(blocks.conv_tc(h, w1, b1, padding=1))
    h = blocks.conv_tc(r, w3, b3, padding=1) + h
    return blocks.conv_tc(h, w_out, padding=1)


def neu_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                         sem_pcm: torch.Tensor,
                         cfg: NeuEncConfig) -> torch.Tensor:
    """pcm [B, n_pad], sem_pcm [B, n_pad + 320] → the FSQ latent [B, T,
    codebook_dim] (before the bound)."""
    ac = neu_distill_acoustic_fn(params, pcm, cfg)
    s = semantic_convs(neu_hubert_fn(params, sem_pcm, cfg),
                       params["sem_init_w"], params["sem_r1_w"],
                       params["sem_r1_b"], params["sem_r3_w"],
                       params["sem_r3_b"], params["sem_out_w"])
    n = min(s.shape[1], ac.shape[1])
    h = torch.cat([s[:, :n], ac[:, :n]], dim=-1)
    h = F.linear(h, params["fc_prior_w"], params["fc_prior_b"])
    return F.linear(h, params["proj_in_w"], params["proj_in_b"])


def neu_encode_fn(params: Dict[str, Any], pcm: torch.Tensor,
                  sem_pcm: torch.Tensor, cfg_enc: NeuEncConfig,
                  codebook_dim: int) -> torch.Tensor:
    """Distill encode: pcm [B, n_pad], sem_pcm [B, n_pad + 320] → codes
    [B, T, 1] int32."""
    from .xcodec2 import fsq_quantize_x2

    z = neu_encode_latent_fn(params, pcm, sem_pcm, cfg_enc)
    return fsq_quantize_x2(z, codebook_dim)[..., None]


def encode_rows(pcm: np.ndarray):
    """The host padding of a distill encode, one row of [B, n] at a time →
    (pcm padded up to the next multiple of 320, a whole 320 when aligned;
    the same with 160 zeros a side for HuBERT)."""
    for row in pcm:
        row_pad = np.pad(row, (0, ENCODE_HOP - len(row) % ENCODE_HOP))
        yield row_pad, np.pad(row_pad, (ENCODE_HOP // 2, ENCODE_HOP // 2))


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

class NeuCodec(CodecModel):
    arch = "neucodec"
    causal_time = False

    encoder_type = 0

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = NeuConfig.from_gguf(reader)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.vq_dim
        self.has_decoder = reader.get_bool("codec.has_decoder", True)
        if self.has_decoder:
            self.params = load_neu_params(reader, self.cfg,
                                          dtype=self.compute_dtype,
                                          device=self.device)
        et = reader.get_str("neucodec.encoder_type", "")
        if et:
            self.encoder_type = 1 if et == "distill" else 0
        # as codec_tpu (and its reference): only the distill encoder encodes.
        # Like codec_tpu it leaves codec.encode_sample_rate unread, so the
        # CLI checks an encode's WAV against sample_rate
        self.has_encoder = (reader.get_bool("codec.has_encoder", False)
                            and self.encoder_type == 1)
        if self.has_encoder:
            self.enc_cfg = NeuEncConfig.from_gguf(reader)
            self.enc_params = load_neu_encode_params(
                reader, self.enc_cfg, dtype=self.compute_dtype,
                device=self.device)

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return neu_decode_fn(self.params, codes, self.cfg)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] / [B, n] at 16 kHz (float32, or int16) → codes int32
        [T, 1] / [B, T, 1], T = n // 320 + 1. Each row is padded on the
        host (`encode_rows`) and encoded on its own."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder"
                             if self.encoder_type == 1 else
                             "NeuCodec encoder_type not supported "
                             "(only distill implemented)")
        if n_q not in (0, 1):
            raise CodecError("NeuCodec encode n_q must be 0 or 1")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        outs = []
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            for row_pad, sem in encode_rows(pcm):
                x, s = (torch.from_numpy(np.ascontiguousarray(a[None])).to(
                    self.device, self.compute_dtype) for a in (row_pad, sem))
                with perf_scope("graph_compute", "encode"):
                    codes = neu_encode_fn(self.enc_params, x, s, self.enc_cfg,
                                          self.cfg.codebook_dim)
                    outs.append(codes[0].clamp(0, self.codebook_size - 1)
                                .to(torch.int32).cpu().numpy())
        return outs[0] if squeeze else np.stack(outs)


class DistillNeuCodec(NeuCodec):
    arch = "distill_neucodec"
    encoder_type = 1
