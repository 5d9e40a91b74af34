"""Mimi neural audio codec (kyutai/mimi), encode and decode, whole or in
streamed chunks, in PyTorch.

Counterpart of codec_tpu/models/mimi.py:

encode: causal SEANet encoder (conv k7, then per stride 4/5/6/8 a residual
        block and an ELU + strided conv) → ELU + conv k3 → encoder
        transformer → stride-2 causal downsample with replicate padding →
        semantic and acoustic RVQ with input projections (the fused search
        of ops/rvq_cuda.py)
decode: per-group codebook gather-sum + output projections → causal
        ConvTranspose ×2 upsample → decoder transformer (LayerNorm,
        RoPE-NEOX, causal attention over a sliding window, GELU-erf MLP,
        LayerScale) → mirrored SEANet decoder (ELU + causal convs /
        convtrs) → PCM

The transformers run channels-last [B, T, C]; the conv stacks run
channels-first [B, C, T] on PyTorch's weight layouts.

Parameters (`load_mimi_params`, `params_from_jax`) are a dict of tensors:
  cb_sem [n_sem, V, d], sem_op [h, d], cb_acu [n_q - n_sem, V, d], acu_op
  up, dec_l0, dec_l14, dec_stages[i].{tr, r1, r2}: {"w", "b"} with conv
      weights [C_out, C_in, K] and convtr weights [C_in, C_out, K]
  dtr: one dict per transformer layer, linear weights [out, in]
  with an encoder: enc_l0, enc_l14, enc_stages[i].{r1, r2, dn}, dn (no
      bias) as convs; etr as dtr; sem_ip, acu_ip [d, h]; sem_search,
      acu_search: {"cb": f32 codebooks, "norms": [n, V] f32}, built at load
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, attn, conv, norms, rope, rvq, rvq_cuda

DEC_UP_STRIDES = (8, 6, 5, 4)
ENC_STRIDES = (4, 5, 6, 8)
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
    """Parameters from a Mimi GGUF: the codebooks, the decoder half and,
    where the file has one, the encoder half (wire layouts are already
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
    if cfg.has_encoder:
        p["enc_l0"] = wb("enc.l0.conv")
        p["enc_stages"] = [{"r1": wb(f"enc.l{li}.block.1.conv"),
                            "r2": wb(f"enc.l{li}.block.3.conv"),
                            "dn": wb(f"enc.l{li + 2}.conv")}
                           for li in (1, 4, 7, 10)]
        p["enc_l14"] = wb("enc.l14.conv")
        p["etr"] = [{key: t(r.get(f"etr.l{li}.{suffix}"))
                     for key, suffix in _LAYER_KEYS.items()}
                    for li in range(cfg.n_layers)]
        p["dn"] = {"w": t(r.get("dn.cv.w")), "b": None}
        p["sem_ip"] = t(r.get("q.s.ip.w"))
        if cfg.n_q > cfg.n_sem:
            p["acu_ip"] = t(r.get("q.a.ip.w"))
        _search_state(p)
    return p


def _search_state(p: Dict[str, Any]) -> None:
    """The encoder's RVQ searches take f32 codebooks and their norms: built
    once here, per group ("sem_search", "acu_search": {"cb", "norms"}),
    rather than on every encode. An f32 model's "cb" is its codebooks
    tensor itself; a bf16 model keeps an f32 copy."""
    for group in ("sem", "acu"):
        if f"cb_{group}" in p:
            p[f"{group}_search"] = rvq.search_state(p[f"cb_{group}"])


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu Mimi parameter tree (from its `load_mimi_params` or
    `random_mimi_params`, leaves as NumPy arrays or anything np.asarray
    takes): the codebooks, the decoder half and, where the tree has one,
    the encoder half → this module's parameters.

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
    def layers(stack):
        stacked = {k: np.asarray(v) for k, v in stack.items()}
        return [{k: t(v[li]) for k, v in stacked.items()}
                for li in range(stacked["q_w"].shape[0])]

    p["up"] = tr(tree["up"])
    p["dtr"] = layers(tree["dtr"])
    p["dec_l0"] = cv(tree["dec_l0"])
    p["dec_stages"] = [{"tr": tr(s["tr"]), "r1": cv(s["r1"]),
                        "r2": cv(s["r2"])} for s in tree["dec_stages"]]
    p["dec_l14"] = cv(tree["dec_l14"])
    if "enc_l0" in tree:
        p["enc_l0"] = cv(tree["enc_l0"])
        p["enc_stages"] = [{k: cv(s[k]) for k in ("r1", "r2", "dn")}
                           for s in tree["enc_stages"]]
        p["enc_l14"] = cv(tree["enc_l14"])
        p["etr"] = layers(tree["etr"])
        p["dn"] = cv(tree["dn"])
        p["sem_ip"] = t(tree["sem_ip"])
        if "cb_acu" in tree:
            p["acu_ip"] = t(tree["acu_ip"])
        _search_state(p)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _resblock(x: torch.Tensor, r1: Dict, r2: Dict) -> torch.Tensor:
    """SEANet residual block, channels-first: x + conv2(elu(conv1(elu(x))))."""
    h = conv.conv1d_causal_cf(act.elu(x), r1["w"], r1["b"])
    h = conv.conv1d_causal_cf(act.elu(h), r2["w"], r2["b"])
    return x + h


def _layer_rest(x: torch.Tensor, a: torch.Tensor, lw: Dict[str, torch.Tensor],
                cfg: MimiConfig) -> torch.Tensor:
    """A transformer layer after its attention a: the scaled residual, then
    the LayerNorm'd GELU-erf MLP and its scaled residual."""
    x = x + a * lw["sa_scale"]
    m = norms.layer_norm(x, lw["paln_w"], lw["paln_b"], cfg.norm_eps)
    m = F.linear(act.gelu_erf(F.linear(m, lw["fc1_w"])), lw["fc2_w"])
    return x + m * lw["mlp_scale"]


def _transformer(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
                 cfg: MimiConfig,
                 attention: Optional[Callable] = None,
                 neox: bool = True) -> torch.Tensor:
    """x: [B, T, C] through the layers in order (RoPE NEOX, or NORMAL with
    neox=False, as Pocket-Mimi's)."""
    rope_fn = partial(rope.apply_rope, theta=cfg.rope_theta,
                      freq_scale=cfg.freq_scale, neox=neox)
    for lw in layers:
        h = norms.layer_norm(x, lw["inln_w"], lw["inln_b"], cfg.norm_eps)
        a = attn.mha(h, lw["q_w"], lw["k_w"], lw["v_w"], lw["o_w"],
                     n_heads=cfg.n_heads, rope_fn=rope_fn, causal=True,
                     window=cfg.window, attention=attention)
        x = _layer_rest(x, a, lw, cfg)
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


def mimi_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                          cfg: MimiConfig,
                          attention: Optional[Callable] = None
                          ) -> torch.Tensor:
    """pcm [B, n] on the parameters' device → the latent before the RVQ
    [B, ceil(n/hop), hidden].

    Each strided conv right-pads its input with zeros to a stride multiple
    (ops/conv.py), as the reference's per-layer re-mask does, and the
    final stride-2 downsample replicates the edge frames. `attention`
    replaces the encoder transformer's attention function (default: the
    CUDA kernel's wrapper; see ops/attn.mha)."""
    x = conv.conv1d_causal_cf(pcm[:, None, :], params["enc_l0"]["w"],
                              params["enc_l0"]["b"])
    for stage, stride in zip(params["enc_stages"], ENC_STRIDES):
        x = _resblock(x, stage["r1"], stage["r2"])
        x = conv.conv1d_causal_cf(act.elu(x), stage["dn"]["w"],
                                  stage["dn"]["b"], stride=stride)
    x = conv.conv1d_causal_cf(act.elu(x), params["enc_l14"]["w"],
                              params["enc_l14"]["b"])
    x = _transformer(x.transpose(1, 2), params["etr"], cfg, attention)
    x = conv.conv1d_causal_cf(x.transpose(1, 2), params["dn"]["w"], None,
                              stride=2, pad_mode="replicate")
    return x.transpose(1, 2)                                # [B, T, h]


def mimi_encode_fn(params: Dict[str, Any], pcm: torch.Tensor, cfg: MimiConfig,
                   n_q: Optional[int] = None,
                   attention: Optional[Callable] = None,
                   quantize: Optional[Callable] = None) -> torch.Tensor:
    """pcm [B, n] → codes [B, ceil(n/hop), n_q] int32 (reference:
    codec_tpu/models/mimi.py::mimi_encode_fn).

    The semantic and acoustic searches run in f32 through `quantize(x,
    codebooks, norms=...)` (default: `rvq_cuda.rvq_encode_fused`, the CUDA
    kernel on the card; `rvq.rvq_encode` is its plain version), on the f32
    codebooks and norms the parameters keep from load."""
    latent = mimi_encode_latent_fn(params, pcm, cfg, attention)
    return mimi_quantize(params, latent, cfg, n_q, quantize)


def mimi_quantize(params: Dict[str, Any], latent: torch.Tensor,
                  cfg: MimiConfig, n_q: Optional[int] = None,
                  quantize: Optional[Callable] = None) -> torch.Tensor:
    """latent [B, T, hidden] → codes [B, T, n_q] int32: the semantic and
    acoustic input projections, then each group's search (`quantize` as
    in `mimi_encode_fn`)."""
    quantize = quantize or rvq_cuda.rvq_encode_fused
    if n_q is None:
        n_q = cfg.n_q
    n_sem = min(cfg.n_sem, n_q)

    def search(group: str, levels: int) -> torch.Tensor:
        state = params[f"{group}_search"]
        z = F.linear(latent, params[f"{group}_ip"]).float().contiguous()
        return quantize(z, state["cb"][:levels], norms=state["norms"][:levels])

    parts = [search("sem", n_sem)]
    if n_q > n_sem:
        parts.append(search("acu", n_q - n_sem))
    return torch.cat(parts, dim=-1)                         # [B, T, n_q]


# ---------------------------------------------------------------------------
# Streaming (chunked) decode and encode
# ---------------------------------------------------------------------------
# Counterparts of codec_tpu/models/mimi.py's mimi_{decode,encode}_stream_*:
# carried causal-conv tails (ops/conv.py's stream forms) and a sliding
# window of post-RoPE keys and values make chunked decode and encode give
# what one full call gives. A session's state is a dict of tensors on the
# parameters' device plus "pos", the transformer frames seen so far, a host
# int, so a step never reads back from the device.

def _transformer_stream(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
                        cfg: MimiConfig, kv: List[torch.Tensor], pos0: int,
                        attention: Optional[Callable] = None,
                        neox: bool = True):
    """x: [B, Tc, C] at absolute positions pos0 + arange(Tc); kv: per layer
    [2, B, H, W-1, D], the post-RoPE keys and values of the W-1 positions
    before pos0 (slots for positions before 0 are masked) → (y [B, Tc, C],
    the new kv).

    Each layer attends the chunk's queries to the carried keys and its own
    through `attention(q, k, v, window=, k_start=)` (default the CUDA
    kernel's wrapper, attn_cuda.flash_sdpa_window; k and v are W-1 + Tc
    long, query i at key position W-1 + i). RoPE as in _transformer."""
    from ..ops.attn_cuda import flash_sdpa_window

    attention = attention or flash_sdpa_window
    b, tc, _ = x.shape
    h, d = cfg.n_heads, cfg.head_dim
    w1 = kv[0].shape[3] if kv else 0
    cos, sin = rope.rope_cos_sin(
        torch.arange(pos0, pos0 + tc, device=x.device), d, cfg.rope_theta,
        cfg.freq_scale)
    k_start = max(0, w1 - pos0)
    new_kv = []
    for lw, kv_l in zip(layers, kv):
        hn = norms.layer_norm(x, lw["inln_w"], lw["inln_b"], cfg.norm_eps)

        def heads(w):
            return F.linear(hn, w).reshape(b, tc, h, d).transpose(1, 2)

        q = rope.rotate(heads(lw["q_w"]), cos, sin, neox)
        # the carried keys and values, then the chunk's: [2, B, H, W-1+Tc, D]
        ctx = torch.empty((2, b, h, w1 + tc, d), dtype=kv_l.dtype,
                          device=x.device)
        ctx[:, :, :, :w1] = kv_l
        ctx[0, :, :, w1:] = rope.rotate(heads(lw["k_w"]), cos, sin, neox)
        ctx[1, :, :, w1:] = heads(lw["v_w"])
        a = attention(q.contiguous(), ctx[0], ctx[1], window=cfg.window,
                      k_start=k_start)
        a = F.linear(a.transpose(1, 2).reshape(b, tc, h * d), lw["o_w"])
        x = _layer_rest(x, a, lw, cfg)
        new_kv.append(ctx[:, :, :, tc:])
    return x, new_kv


def _conv_carry(layer: Dict, batch: int, stride: int = 1):
    """The zero carry of a conv ([C_out, C_in, K] weight)."""
    w = layer["w"]
    return conv.conv1d_causal_stream_init_cf(batch, w.shape[1], w.shape[-1],
                                             stride, dtype=w.dtype,
                                             device=w.device)


def _convtr_carry(layer: Dict, batch: int, stride: int):
    """The zero carry of a convtr ([C_in, C_out, K] weight)."""
    w = layer["w"]
    return conv.convtr1d_causal_stream_init_cf(batch, w.shape[1], w.shape[-1],
                                               stride, dtype=w.dtype,
                                               device=w.device)


def _kv_carry(layers: List[Dict], cfg: MimiConfig, batch: int):
    w1 = (cfg.window or 1) - 1
    w = layers[0]["q_w"]
    return [torch.zeros((2, batch, cfg.n_heads, w1, cfg.head_dim),
                        dtype=w.dtype, device=w.device) for _ in layers]


def _resblock_stream(x: torch.Tensor, r1: Dict, r2: Dict, st: Dict):
    """_resblock on a chunk → (y, the new r1 and r2 carries)."""
    h, c1 = conv.conv1d_causal_stream_cf(act.elu(x), r1["w"], r1["b"],
                                         st["r1"])
    h, c2 = conv.conv1d_causal_stream_cf(act.elu(h), r2["w"], r2["b"],
                                         st["r2"])
    return x + h, {"r1": c1, "r2": c2}


def mimi_decode_stream_init(params: Dict[str, Any], cfg: MimiConfig,
                            batch: int = 1) -> Dict[str, Any]:
    """The zero state of a chunked decode, on the parameters' device in
    their dtype."""
    return {
        "pos": 0,
        "up": _convtr_carry(params["up"], batch, 2),
        "kv": _kv_carry(params["dtr"], cfg, batch),
        "l0": _conv_carry(params["dec_l0"], batch),
        "stages": [{"tr": _convtr_carry(s["tr"], batch, st),
                    "r1": _conv_carry(s["r1"], batch),
                    "r2": _conv_carry(s["r2"], batch)}
                   for s, st in zip(params["dec_stages"], DEC_UP_STRIDES)],
        "l14": _conv_carry(params["dec_l14"], batch),
    }


def mimi_decode_stream_step(params: Dict[str, Any], state: Dict[str, Any],
                            codes: torch.Tensor, cfg: MimiConfig,
                            n_q: Optional[int] = None,
                            attention: Optional[Callable] = None):
    """codes [B, Tc, Q] int on the parameters' device → (pcm [B, Tc*hop],
    the new state). Concatenated over a stream, the chunks' pcm is
    mimi_decode_fn's on the whole stream. `attention` as in
    _transformer_stream."""
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

    ns: Dict[str, Any] = {"stages": []}
    x, ns["up"] = conv.convtr1d_causal_stream_cf(
        x.transpose(1, 2), params["up"]["w"], None, state["up"], stride=2)
    x, ns["kv"] = _transformer_stream(x.transpose(1, 2), params["dtr"], cfg,
                                      state["kv"], state["pos"], attention)
    ns["pos"] = state["pos"] + x.shape[1]
    x = x.transpose(1, 2).contiguous()                      # [B, C, T]
    x, ns["l0"] = conv.conv1d_causal_stream_cf(
        x, params["dec_l0"]["w"], params["dec_l0"]["b"], state["l0"])
    for st, stage, stride in zip(state["stages"], params["dec_stages"],
                                 DEC_UP_STRIDES):
        x, tr = conv.convtr1d_causal_stream_cf(
            act.elu(x), stage["tr"]["w"], stage["tr"]["b"], st["tr"],
            stride=stride)
        x, nst = _resblock_stream(x, stage["r1"], stage["r2"], st)
        ns["stages"].append({"tr": tr, **nst})
    x, ns["l14"] = conv.conv1d_causal_stream_cf(
        act.elu(x), params["dec_l14"]["w"], params["dec_l14"]["b"],
        state["l14"])
    return x[:, 0], ns


def mimi_encode_stream_init(params: Dict[str, Any], cfg: MimiConfig,
                            batch: int = 1) -> Dict[str, Any]:
    """The zero state of a chunked encode (chunks a multiple of hop)."""
    return {
        "pos": 0,
        "l0": _conv_carry(params["enc_l0"], batch),
        "stages": [{"r1": _conv_carry(s["r1"], batch),
                    "r2": _conv_carry(s["r2"], batch),
                    "dn": _conv_carry(s["dn"], batch, st)}
                   for s, st in zip(params["enc_stages"], ENC_STRIDES)],
        "l14": _conv_carry(params["enc_l14"], batch),
        "kv": _kv_carry(params["etr"], cfg, batch),
        "dn": _conv_carry(params["dn"], batch, 2),
    }


def mimi_encode_stream_step(params: Dict[str, Any], state: Dict[str, Any],
                            pcm: torch.Tensor, cfg: MimiConfig,
                            n_q: Optional[int] = None,
                            attention: Optional[Callable] = None,
                            quantize: Optional[Callable] = None):
    """pcm [B, n] (n a multiple of hop) in the parameters' dtype and device
    → (codes [B, n/hop, n_q] int32, the new state). Over a stream, the
    chunks' codes are mimi_encode_fn's on the whole stream. The searches
    run through mimi_quantize (`quantize` as in mimi_encode_fn, default
    the CUDA kernel's wrapper); `attention` as in _transformer_stream."""
    ns: Dict[str, Any] = {"stages": []}
    x, ns["l0"] = conv.conv1d_causal_stream_cf(
        pcm[:, None, :], params["enc_l0"]["w"], params["enc_l0"]["b"],
        state["l0"])
    for st, stage, stride in zip(state["stages"], params["enc_stages"],
                                 ENC_STRIDES):
        x, nst = _resblock_stream(x, stage["r1"], stage["r2"], st)
        x, nst["dn"] = conv.conv1d_causal_stream_cf(
            act.elu(x), stage["dn"]["w"], stage["dn"]["b"], st["dn"],
            stride=stride)
        ns["stages"].append(nst)
    x, ns["l14"] = conv.conv1d_causal_stream_cf(
        act.elu(x), params["enc_l14"]["w"], params["enc_l14"]["b"],
        state["l14"])
    x, ns["kv"] = _transformer_stream(x.transpose(1, 2), params["etr"], cfg,
                                      state["kv"], state["pos"], attention)
    ns["pos"] = state["pos"] + x.shape[1]
    x, ns["dn"] = conv.conv1d_causal_stream_replicate_cf(
        x.transpose(1, 2), params["dn"]["w"], None, state["dn"],
        state["pos"] == 0, stride=2)
    return mimi_quantize(params, x.transpose(1, 2), cfg, n_q, quantize), ns
