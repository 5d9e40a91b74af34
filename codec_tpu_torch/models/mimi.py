"""Mimi neural audio codec (kyutai/mimi), decode path, in PyTorch.

Counterpart of codec_tpu/models/mimi.py:

decode: per-group codebook gather-sum + output projections → causal
        ConvTranspose ×2 upsample → decoder transformer (LayerNorm,
        RoPE-NEOX, causal attention over a sliding window, GELU-erf MLP,
        LayerScale) → mirrored SEANet decoder (ELU + causal convs /
        convtrs) → PCM

The transformer runs channels-last [B, T, C]; the upsample and the SEANet
stack run channels-first [B, C, T] on PyTorch's weight layouts.

Parameters (`load_mimi_params`, `params_from_jax`) are a dict of tensors:
  cb_sem [n_sem, V, d], sem_op [h, d], cb_acu [n_q - n_sem, V, d], acu_op
  up, dec_l0, dec_l14, dec_stages[i].{tr, r1, r2}: {"w", "b"} with conv
      weights [C_out, C_in, K] and convtr weights [C_in, C_out, K]
  dtr: one dict per transformer layer, linear weights [out, in]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, attn, conv, norms, rope, rvq

DEC_UP_STRIDES = (8, 6, 5, 4)
_LAYER_KEYS = {
    "inln_w": "inln.w", "inln_b": "inln.b",
    "paln_w": "paln.w", "paln_b": "paln.b",
    "q_w": "attn.q_proj.w", "k_w": "attn.k_proj.w",
    "v_w": "attn.v_proj.w", "o_w": "attn.o_proj.w",
    "fc1_w": "mlp.fc1.w", "fc2_w": "mlp.fc2.w",
    "sa_scale": "sa_ls.scale", "mlp_scale": "mlp_ls.scale",
}


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24000
    hop_size: int = 1920
    n_q: int = 32
    n_sem: int = 1
    codebook_size: int = 2048
    codebook_dim: int = 256
    hidden: int = 512
    n_layers: int = 8
    n_heads: int = 8
    head_dim: int = 64
    intermediate: int = 2048
    rope_theta: float = 10000.0
    freq_scale: float = 1.0
    norm_eps: float = 1e-5
    window: Optional[int] = 250
    has_encoder: bool = True
    has_decoder: bool = True

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "MimiConfig":
        scaling = r.get_f32("codec.rope_scaling_factor", 1.0)
        # Converters may write codec.n_q=32 whatever the checkpoint's
        # quantizer count: clamp n_q to the codebook layers in the file.
        n_q = r.get_i32("codec.n_q", 32)
        layers = {name.rsplit(".", 2)[0]
                  for name in r.tensors
                  if (name.startswith(("q.s.layers.", "q.a.layers."))
                      and name.endswith((".codebook.embed", ".cb.embed")))}
        if 0 < len(layers) < n_q:
            n_q = len(layers)
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=r.get_i32("codec.hop_size", 1920),
            n_q=n_q,
            n_sem=r.get_i32("codec.num_semantic_quantizers", 1),
            codebook_size=r.get_i32("codec.codebook_size", 2048),
            codebook_dim=r.get_i32("codec.codebook_dim", 256),
            hidden=r.get_i32("codec.latent_dim", 512),
            n_layers=r.get_i32("codec.num_hidden_layers", 8),
            n_heads=r.get_i32("codec.num_attention_heads", 8),
            head_dim=r.get_i32("codec.head_dim", 64),
            intermediate=r.get_i32("codec.intermediate_size", 2048),
            rope_theta=r.get_f32("codec.rope_theta", 10000.0),
            freq_scale=1.0 / scaling if scaling > 0 else 1.0,
            window=r.get_i32("codec.attn_window", 250) or None,
            has_encoder=r.get_bool("codec.has_encoder", False),
            has_decoder=r.get_bool("codec.has_decoder", True),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)


def load_mimi_params(r: GGUFReader, cfg: MimiConfig, dtype=torch.float32,
                     device="cpu") -> Dict[str, Any]:
    """Decoder-half parameters from a Mimi GGUF (wire layouts are already
    PyTorch's)."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(name):
        b = r.get_or_none(f"{name}.b")
        return {"w": t(r.get(f"{name}.w")),
                "b": t(b) if b is not None else None}

    def codebook(group, i):
        cb = r.get_or_none(f"q.{group}.layers.{i}.codebook.embed")
        return cb if cb is not None else r.get(f"q.{group}.layers.{i}.cb.embed")

    def codebooks(group, n):
        return t(np.stack([codebook(group, i) for i in range(n)]))

    p: Dict[str, Any] = {"cb_sem": codebooks("s", cfg.n_sem)}
    if cfg.n_q > cfg.n_sem:
        p["cb_acu"] = codebooks("a", cfg.n_q - cfg.n_sem)
    if cfg.has_decoder:
        p["sem_op"] = t(r.get("q.s.op.w"))
        if cfg.n_q > cfg.n_sem:
            p["acu_op"] = t(r.get("q.a.op.w"))
        p["up"] = wb("up.cv")
        p["dtr"] = [{key: t(r.get(f"dtr.l{li}.{suffix}"))
                     for key, suffix in _LAYER_KEYS.items()}
                    for li in range(cfg.n_layers)]
        p["dec_l0"] = wb("dec.l0.conv")
        p["dec_stages"] = [{"tr": wb(f"dec.l{li}.conv"),
                            "r1": wb(f"dec.l{li + 1}.block.1.conv"),
                            "r2": wb(f"dec.l{li + 1}.block.3.conv")}
                           for li in (2, 5, 8, 11)]
        p["dec_l14"] = wb("dec.l14.conv")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """The decoder half of a codec_tpu Mimi parameter tree (from its
    `load_mimi_params` or `random_mimi_params`, leaves as NumPy arrays or
    anything np.asarray takes) → this module's parameters.

    codec_tpu keeps conv weights WIO [K, C_in, C_out], convtr weights WIO
    pre-flipped along K, and the transformer layers stacked on a leading
    dim; this undoes all three."""
    t = partial(_to, dtype=dtype, device=device)

    def cv(layer):
        b = layer["b"]
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": t(b) if b is not None else None}

    def tr(layer):
        b = layer["b"]
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(b) if b is not None else None}

    p: Dict[str, Any] = {"cb_sem": t(tree["cb_sem"]),
                         "sem_op": t(tree["sem_op"])}
    if "cb_acu" in tree:
        p["cb_acu"] = t(tree["cb_acu"])
        p["acu_op"] = t(tree["acu_op"])
    stacked = {k: np.asarray(v) for k, v in tree["dtr"].items()}
    n_layers = stacked["q_w"].shape[0]
    p["up"] = tr(tree["up"])
    p["dtr"] = [{k: t(v[li]) for k, v in stacked.items()}
                for li in range(n_layers)]
    p["dec_l0"] = cv(tree["dec_l0"])
    p["dec_stages"] = [{"tr": tr(s["tr"]), "r1": cv(s["r1"]),
                        "r2": cv(s["r2"])} for s in tree["dec_stages"]]
    p["dec_l14"] = cv(tree["dec_l14"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _resblock(x: torch.Tensor, r1: Dict, r2: Dict) -> torch.Tensor:
    """SEANet residual block, channels-first: x + conv2(elu(conv1(elu(x))))."""
    h = conv.conv1d_causal_cf(act.elu(x), r1["w"], r1["b"])
    h = conv.conv1d_causal_cf(act.elu(h), r2["w"], r2["b"])
    return x + h


def _transformer(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
                 cfg: MimiConfig,
                 attention: Optional[Callable] = None) -> torch.Tensor:
    """x: [B, T, C] through the layers in order."""
    rope_fn = partial(rope.apply_rope, theta=cfg.rope_theta,
                      freq_scale=cfg.freq_scale)
    for lw in layers:
        h = norms.layer_norm(x, lw["inln_w"], lw["inln_b"], cfg.norm_eps)
        a = attn.mha(h, lw["q_w"], lw["k_w"], lw["v_w"], lw["o_w"],
                     n_heads=cfg.n_heads, rope_fn=rope_fn, causal=True,
                     window=cfg.window, attention=attention)
        x = x + a * lw["sa_scale"]
        m = norms.layer_norm(x, lw["paln_w"], lw["paln_b"], cfg.norm_eps)
        m = F.linear(act.gelu_erf(F.linear(m, lw["fc1_w"])), lw["fc2_w"])
        x = x + m * lw["mlp_scale"]
    return x


def mimi_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                   cfg: MimiConfig, n_q: Optional[int] = None,
                   attention: Optional[Callable] = None) -> torch.Tensor:
    """codes: [B, T, Q] int on the parameters' device → pcm [B, T*hop].

    `attention` replaces the transformer's causal attention function
    (default: the CUDA kernel's wrapper; see ops/attn.mha)."""
    if n_q is None:
        n_q = codes.shape[-1]
    codes = codes.clamp(0, cfg.codebook_size - 1)
    n_sem = min(cfg.n_sem, n_q)
    x = rvq.rvq_decode_sum(codes[..., :n_sem], params["cb_sem"], n_q=n_sem)
    x = F.linear(x, params["sem_op"])
    if n_q > n_sem:
        a = rvq.rvq_decode_sum(codes[..., n_sem:n_q], params["cb_acu"],
                               n_q=n_q - n_sem)
        x = x + F.linear(a, params["acu_op"])

    x = conv.convtr1d_causal_cf(x.transpose(1, 2), params["up"]["w"], None,
                                stride=2)
    x = _transformer(x.transpose(1, 2), params["dtr"], cfg, attention)
    x = x.transpose(1, 2).contiguous()                      # [B, C, T]

    x = conv.conv1d_causal_cf(x, params["dec_l0"]["w"], params["dec_l0"]["b"])
    for stage, stride in zip(params["dec_stages"], DEC_UP_STRIDES):
        x = conv.convtr1d_causal_cf(act.elu(x), stage["tr"]["w"],
                                    stage["tr"]["b"], stride=stride)
        x = _resblock(x, stage["r1"], stage["r2"])
    x = conv.conv1d_causal_cf(act.elu(x), params["dec_l14"]["w"],
                              params["dec_l14"]["b"])
    return x[:, 0]                                          # [B, T*hop]
