"""Qwen3-TTS-Tokenizer codec (12.5 Hz, 16 codebooks), encode and decode, in
PyTorch.

Counterpart of codec_tpu/models/qwen3_tts.py:

decode: a codebook gather per level; the first n_sem levels sum into the
        semantic part, the rest into the acoustic part, each through its
        own output projection → causal k3 pre-conv → a Qwen3-style
        pre-transformer (RMSNorm, grouped KV heads with optional q/k/v/o
        biases, RoPE-NEOX, causal attention over an optional sliding
        window, SwiGLU, LayerScale) → output projection → upsample stages
        (causal ConvTranspose + causal ConvNeXt) → a BigVGAN-style decoder
        (snake-beta with its α and 1/β baked by the converter, causal
        convs and ConvTransposes, residual units at dilations 1/3/9) →
        clamp(-1, 1)
encode: the Mimi encoder (models/mimi.py::mimi_encode_fn) on the file's
        encoder half, read under the qwen3.encoder.* keys

The transformer runs channels-last [B, T, C]; the conv stacks run
channels-first [B, C, T] on PyTorch's weight layouts.

Parameters (`load_q3t_params`, `params_from_jax`), linear weights [out,
in], conv weights [C_out, C_in/groups, K], convtr weights [C_in, C_out, K]:
  cb [n_q, V, codebook_dim]; sem_op [latent, codebook_dim]; acu_op (or None)
  pre: {"w", "b"}; pt_in_w, pt_in_b, pt_out_w, pt_out_b, pt_norm
  pt_layers: per layer inln, paln, q_w, k_w, v_w, o_w, q_b, k_b, v_b, o_b
      (each bias or None), gate, up, down, sa_scale, mlp_scale
  ups: per stage tr {"w", "b"}, dw {"w" [C, 1, K], "b"}, ln_w, ln_b, pw1_w,
      pw1_b, pw2_w, pw2_b, gamma
  d0, final: {"w", "b"}; final_s_a, final_s_binv
  blocks: per block s0_a, s0_binv, tr, units: per unit s1_a, s1_binv, c1,
      s2_a, s2_binv, c2
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, attn, conv, norms, rope, rvq
from ..runtime.model import CodecModel
from .mimi import MimiConfig, load_mimi_params, mimi_encode_fn

RES_DILATIONS = (1, 3, 9)


@dataclass(frozen=True)
class Q3TConfig:
    sample_rate: int = 24000
    hop_size: int = 1920
    n_q: int = 16
    n_sem: int = 1
    codebook_size: int = 2048
    codebook_dim: int = 1024
    latent_dim: int = 1024
    hidden: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 64
    intermediate: int = 3072
    rope_theta: float = 10000.0
    window: Optional[int] = None
    decoder_dim: int = 1536
    upsampling_ratios: Tuple[int, ...] = ()
    upsample_rates: Tuple[int, ...] = ()

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "Q3TConfig":
        win = r.get_i32("qwen3.decoder.sliding_window", 0)
        heads = r.get_i32("qwen3.decoder.num_attention_heads", 16)
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=r.get_i32("codec.hop_size", 1920),
            n_q=r.get_i32("codec.n_q", 16),
            codebook_size=r.get_i32("codec.codebook_size", 2048),
            codebook_dim=r.get_i32("codec.codebook_dim", 1024),
            latent_dim=r.get_i32("codec.latent_dim", 1024),
            hidden=r.get_i32("qwen3.decoder.hidden_size", 1024),
            n_layers=r.get_i32("qwen3.decoder.num_hidden_layers", 8),
            n_heads=heads,
            n_kv_heads=r.get_i32("qwen3.decoder.num_key_value_heads", heads),
            head_dim=r.get_i32("qwen3.decoder.head_dim", 64),
            intermediate=r.get_i32("qwen3.decoder.intermediate_size", 3072),
            rope_theta=r.get_f32("qwen3.decoder.rope_theta", 10000.0),
            window=win if win > 0 else None,
            decoder_dim=r.get_i32("qwen3.decoder.decoder_dim", 1536),
            upsampling_ratios=tuple(
                int(v) for v in r.get_arr("qwen3.decoder.upsampling_ratios", [])),
            upsample_rates=tuple(
                int(v) for v in r.get_arr("qwen3.decoder.upsample_rates", [])),
        )


def _mimi_encoder_config(r: GGUFReader, q3: Q3TConfig) -> MimiConfig:
    """The Mimi config of the encoder half, from the qwen3.encoder.* keys
    (its own n_q, codebook size and dim; RoPE frequencies scaled by
    1/rope_scaling_factor)."""
    scaling = r.get_f32("qwen3.encoder.rope_scaling_factor", 1.0)
    return MimiConfig(
        sample_rate=q3.sample_rate,
        hop_size=q3.hop_size,
        n_q=r.get_i32("qwen3.encoder.n_q", q3.n_q),
        n_sem=r.get_i32("codec.num_semantic_quantizers", 1),
        codebook_size=r.get_i32("qwen3.encoder.codebook_size", q3.codebook_size),
        codebook_dim=r.get_i32("qwen3.encoder.codebook_dim", q3.codebook_dim),
        hidden=r.get_i32("qwen3.encoder.hidden_size", 512),
        n_layers=r.get_i32("qwen3.encoder.num_hidden_layers", 8),
        n_heads=r.get_i32("qwen3.encoder.num_attention_heads", 8),
        head_dim=r.get_i32("qwen3.encoder.head_dim", 64),
        intermediate=r.get_i32("qwen3.encoder.intermediate_size", 2048),
        rope_theta=r.get_f32("qwen3.encoder.rope_theta", 10000.0),
        freq_scale=1.0 / scaling if scaling > 0 else 1.0,
        has_encoder=True,
        has_decoder=False,
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


_LAYER = {"inln": "inln.w", "paln": "paln.w", "q_w": "attn.q.w",
          "k_w": "attn.k.w", "v_w": "attn.v.w", "o_w": "attn.o.w",
          "gate": "mlp.gate.w", "up": "mlp.up.w", "down": "mlp.down.w",
          "sa_scale": "sa.scale", "mlp_scale": "mlp.scale"}
_LAYER_BIASES = {"q_b": "attn.q.b", "k_b": "attn.k.b", "v_b": "attn.v.b",
                 "o_b": "attn.o.b"}
_CNX = {"ln_w": "cnx.norm.w", "ln_b": "cnx.norm.b", "pw1_w": "cnx.pw1.w",
        "pw1_b": "cnx.pw1.b", "pw2_w": "cnx.pw2.w", "pw2_b": "cnx.pw2.b",
        "gamma": "cnx.gamma"}
_SNAKES = (("s1_a", "s1.a"), ("s1_binv", "s1.binv"), ("s2_a", "s2.a"),
           ("s2_binv", "s2.binv"))


def load_q3t_params(r: GGUFReader, cfg: Q3TConfig, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Parameters of the decoder half from a Qwen3-TTS-Tokenizer GGUF
    (q3t.dec.* names, PyTorch layouts)."""
    t = partial(_to, dtype=dtype, device=device)

    def g(name):
        return t(r.get(name))

    def gopt(name):
        a = r.get_or_none(name)
        return t(a) if a is not None else None

    def wb(base):
        return {"w": g(base + ".w"), "b": g(base + ".b")}

    p: Dict[str, Any] = {
        "cb": t(np.stack([r.get(f"q3t.dec.q.l{qi}.codebook")
                          for qi in range(cfg.n_q)])),
        "sem_op": g("q3t.dec.q.s.op.w"),
        "acu_op": gopt("q3t.dec.q.a.op.w"),
        "pre": wb("q3t.dec.pre.conv"),
        "pt_in_w": g("q3t.dec.pt.in.w"), "pt_in_b": g("q3t.dec.pt.in.b"),
        "pt_out_w": g("q3t.dec.pt.out.w"), "pt_out_b": g("q3t.dec.pt.out.b"),
        "pt_norm": g("q3t.dec.pt.norm.w"),
    }
    p["pt_layers"] = [
        {**{k: g(f"q3t.dec.pt.l{li}.{n}") for k, n in _LAYER.items()},
         **{k: gopt(f"q3t.dec.pt.l{li}.{n}") for k, n in _LAYER_BIASES.items()}}
        for li in range(cfg.n_layers)]
    p["ups"] = [{"tr": wb(f"q3t.dec.up{ui}.tr"), "dw": wb(f"q3t.dec.up{ui}.cnx.dw"),
                 **{k: g(f"q3t.dec.up{ui}.{n}") for k, n in _CNX.items()}}
                for ui in range(len(cfg.upsampling_ratios))]
    p["d0"] = wb("q3t.dec.d0")
    p["blocks"] = [{
        "s0_a": g(f"q3t.dec.b{bi}.s0.a"), "s0_binv": g(f"q3t.dec.b{bi}.s0.binv"),
        "tr": wb(f"q3t.dec.b{bi}.tr"),
        "units": [{"c1": wb(f"q3t.dec.b{bi}.r{ri}.c1"),
                   "c2": wb(f"q3t.dec.b{bi}.r{ri}.c2"),
                   **{k: g(f"q3t.dec.b{bi}.r{ri}.{n}") for k, n in _SNAKES}}
                  for ri in range(len(RES_DILATIONS))],
    } for bi in range(len(cfg.upsample_rates))]
    p["final_s_a"] = g("q3t.dec.final.s.a")
    p["final_s_binv"] = g("q3t.dec.final.s.binv")
    p["final"] = wb("q3t.dec.final")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu Qwen3-TTS-Tokenizer decoder tree (from its
    `load_q3t_params`; leaves as NumPy arrays or anything np.asarray takes)
    → this module's parameters: conv weights from WIO [K, C_in/groups,
    C_out] and convtr weights from pre-flipped WIO [K, C_in, C_out] back to
    PyTorch's layouts, the codebook list stacked."""
    t = partial(_to, dtype=dtype, device=device)

    def opt(a):
        return t(a) if a is not None else None

    def cv(layer):
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": t(layer["b"])}

    def tr(layer):
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(layer["b"])}

    p: Dict[str, Any] = {
        "cb": t(np.stack([np.asarray(c) for c in tree["cb"]])),
        "sem_op": t(tree["sem_op"]), "acu_op": opt(tree["acu_op"]),
        "pre": cv(tree["pre"]),
        **{k: t(tree[k]) for k in ("pt_in_w", "pt_in_b", "pt_out_w",
                                   "pt_out_b", "pt_norm")},
    }
    p["pt_layers"] = [{**{k: t(lw[k]) for k in _LAYER},
                       **{k: opt(lw[k]) for k in _LAYER_BIASES}}
                      for lw in tree["pt_layers"]]
    p["ups"] = [{"tr": tr(u["tr"]), "dw": cv(u["dw"]),
                 **{k: t(u[k]) for k in _CNX}} for u in tree["ups"]]
    p["d0"] = cv(tree["d0"])
    p["blocks"] = [{"s0_a": t(b["s0_a"]), "s0_binv": t(b["s0_binv"]),
                    "tr": tr(b["tr"]),
                    "units": [{"c1": cv(u["c1"]), "c2": cv(u["c2"]),
                               **{k: t(u[k]) for k, _ in _SNAKES}}
                              for u in b["units"]]}
                   for b in tree["blocks"]]
    p["final_s_a"] = t(tree["final_s_a"])
    p["final_s_binv"] = t(tree["final_s_binv"])
    p["final"] = cv(tree["final"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               inv_beta: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x + sin²(max(α, eps)·x)·β⁻¹ over channels-first x [B, C, T]; α and
    β⁻¹ [C] as the converter baked them (α = exp(α_raw), β⁻¹ =
    1/(exp(β_raw) + 1e-9)): no exp here. Not DAC's snake."""
    a = torch.clamp(alpha, min=eps)[:, None]
    return x + torch.sin(a * x) ** 2 * inv_beta[:, None]


def _pre_transformer(x: torch.Tensor, params: Dict[str, Any],
                     cfg: Q3TConfig,
                     attention: Optional[Callable] = None) -> torch.Tensor:
    """[B, T, latent] → [B, T, latent]: input projection, the layers, the
    final RMSNorm and the output projection."""
    h = F.linear(x, params["pt_in_w"], params["pt_in_b"])
    cos, sin = rope.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                 cfg.head_dim, cfg.rope_theta)

    def rope_fn(z):
        return rope.rotate(z, cos, sin, neox=True)

    for lw in params["pt_layers"]:
        a = attn.mha(norms.rms_norm(h, lw["inln"], 1e-5), lw["q_w"],
                     lw["k_w"], lw["v_w"], lw["o_w"], n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads, rope_fn=rope_fn, causal=True,
                     window=cfg.window, attention=attention, bq=lw["q_b"],
                     bk=lw["k_b"], bv=lw["v_b"], bo=lw["o_b"])
        h = h + a * lw["sa_scale"]
        m = norms.rms_norm(h, lw["paln"], 1e-5)
        m = F.linear(act.silu(F.linear(m, lw["gate"])) * F.linear(m, lw["up"]),
                     lw["down"])
        h = h + m * lw["mlp_scale"]
    h = norms.rms_norm(h, params["pt_norm"], 1e-5)
    return F.linear(h, params["pt_out_w"], params["pt_out_b"])


def _causal_convnext(x: torch.Tensor, up: Dict[str, Any]) -> torch.Tensor:
    """The upsample stage's causal ConvNeXt on channels-first x [B, C, T]:
    a depthwise conv with left padding only (float16 on the card without
    cuDNN: conv.no_cudnn_for_f16) → LayerNorm (eps 1e-6) → pw1 → GELU(erf)
    → pw2 → γ → +x."""
    with conv.no_cudnn_for_f16(x):
        h = conv.conv1d_causal_cf(x, up["dw"]["w"], up["dw"]["b"],
                                  groups=x.shape[1])
    h = norms.layer_norm(h.transpose(1, 2), up["ln_w"], up["ln_b"], 1e-6)
    h = act.gelu_erf(F.linear(h, up["pw1_w"], up["pw1_b"]))
    h = F.linear(h, up["pw2_w"], up["pw2_b"]) * up["gamma"]
    return x + h.transpose(1, 2)


def q3t_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                  cfg: Q3TConfig, n_q: Optional[int] = None,
                  attention: Optional[Callable] = None) -> torch.Tensor:
    """codes [B, T, Q] int on the parameters' device → pcm [B, T*hop] in
    [-1, 1]. `attention` replaces the pre-transformer's causal attention
    function (default: the CUDA kernel's wrapper; see ops/attn.mha)."""
    if n_q is None:
        n_q = codes.shape[-1]
    codes = codes.clamp(0, cfg.codebook_size - 1)
    n_sem = min(cfg.n_sem, n_q)
    x = F.linear(rvq.rvq_decode_sum(codes[..., :n_sem],
                                    params["cb"][:n_sem]), params["sem_op"])
    if n_q > n_sem:
        x = x + F.linear(rvq.rvq_decode_sum(codes[..., n_sem:n_q],
                                            params["cb"][n_sem:n_q]),
                         params["acu_op"])

    x = conv.conv1d_causal_cf(x.transpose(1, 2), params["pre"]["w"],
                              params["pre"]["b"])
    x = _pre_transformer(x.transpose(1, 2), params, cfg, attention)
    x = x.transpose(1, 2).contiguous()                       # [B, C, T]

    for up, ratio in zip(params["ups"], cfg.upsampling_ratios):
        x = conv.convtr1d_causal_cf(x, up["tr"]["w"], up["tr"]["b"],
                                    stride=ratio)
        x = _causal_convnext(x, up)

    x = conv.conv1d_causal_cf(x, params["d0"]["w"], params["d0"]["b"])
    for blk, rate in zip(params["blocks"], cfg.upsample_rates):
        x = snake_beta(x, blk["s0_a"], blk["s0_binv"])
        x = conv.convtr1d_causal_cf(x, blk["tr"]["w"], blk["tr"]["b"],
                                    stride=rate)
        for u, d in zip(blk["units"], RES_DILATIONS):
            h = snake_beta(x, u["s1_a"], u["s1_binv"])
            h = conv.conv1d_causal_cf(h, u["c1"]["w"], u["c1"]["b"],
                                      dilation=d)
            h = snake_beta(h, u["s2_a"], u["s2_binv"])
            x = x + conv.conv1d_causal_cf(h, u["c2"]["w"], u["c2"]["b"])
    x = snake_beta(x, params["final_s_a"], params["final_s_binv"])
    x = conv.conv1d_causal_cf(x, params["final"]["w"], params["final"]["b"])
    return torch.clamp(x[:, 0], -1.0, 1.0)                  # [B, T*hop]


class Qwen3TTSTokenizerCodec(CodecModel):
    arch = "qwen3_tts_tokenizer"

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = Q3TConfig.from_gguf(reader)
        self.params = load_q3t_params(reader, self.cfg,
                                      dtype=self.compute_dtype,
                                      device=self.device)
        cfg = self.cfg
        self.sample_rate = cfg.sample_rate
        self.hop_size = cfg.hop_size
        self.n_q = cfg.n_q
        self.codebook_size = cfg.codebook_size
        self.latent_dim = cfg.latent_dim
        self.has_encoder = (reader.get_bool("codec.has_encoder", True)
                            and reader.has_tensor("enc.l0.conv.w"))
        self.has_decoder = reader.get_bool("codec.has_decoder", True)
        if self.has_encoder:
            self.enc_cfg = _mimi_encoder_config(reader, cfg)
            self.enc_params = load_mimi_params(reader, self.enc_cfg,
                                               dtype=self.compute_dtype,
                                               device=self.device)

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return q3t_decode_fn(self.params, codes, self.cfg, n_q=n_q)

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        return mimi_encode_fn(self.enc_params, pcm, self.enc_cfg, n_q=n_q)
