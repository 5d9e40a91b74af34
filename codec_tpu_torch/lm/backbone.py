"""Llama-family backbone — the host LLM of codebook-AR TTS flows
(counterpart of codec_tpu/lm/backbone.py, eager).

Loaded from a backbone GGUF (codec_tpu/convert/backbone.py's `backbone.*`
schema). Covers Llama 3.x (CSM: llama3 rope scaling through baked freq
factors), Qwen3 (per-head q/k RMS norm, optional attention bias),
Qwen3-MoE (the sparse FFN of `_moe_ffn`: a softmax router, top-k experts,
their SwiGLUs summed with the routing weights) and plain Llama/Qwen2.

Layer matrices are dense [out, in] tensors, or with `quantized=True` the
Q8_0/Q4_K blocks of the GGUF packed for ops/qmat.py and multiplied by the
dequantizing CUDA kernels (csrc/qmat.cu) without ever being dequantized
in device memory. Norms, embeddings, the MoE router and the stacked
experts stay dense (codec_tpu's packed products cover 2-D matrices only).

The KV cache is one preallocated [L, 2, n_kv, max_ctx, D] tensor that the
forward updates in place at the new positions; attention reads keys
[0, pos + T) only, which equals the reference's masked attention over
the whole cache (its -1e30 logits give exp = 0 exactly).

On a device mesh (`set_mesh` tensor-parallel, `set_mesh_ep`
expert-parallel, `set_mesh_pp` pipeline-parallel over
parallel/pipeline.py) one process drives every device: each holds its share
of the layers and of the cache, and `step` / `prefill` return one hidden
as unsharded.

`backbone_step` is codec_tpu's form of one decode step for B streams: the
positions are device tensors, the new keys are written at them by a
scatter, and attention reads a fixed number of cache rows under the mask
key_pos <= position. It has no host read and no shape that depends on a
position, so lm/fused_gen.py can capture it in a CUDA graph; `step` and
`prefill` stay the host path's. `backbone_step_split` is the same step
over a TP or EP backbone's shares, and `StepGroup` says which form a
batch of streams runs and on which devices.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import norms, qmat, rope
from ..parallel.mesh import physical, place

NEG_INF = -1e30
_ATTN = ("q", "k", "v", "o")
_FFN = ("gate", "up", "down")
_EXPERTS = ("router", "gate_exps", "up_exps", "down_exps")


@dataclass
class BackboneConfig:
    hidden: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    vocab_size: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_ctx: int = 4096
    has_qk_norm: bool = False
    has_attn_bias: bool = False
    tied_lm_head: bool = True
    # MoE (Qwen3-MoE-style sparse FFN): n_experts == 0 means dense
    n_experts: int = 0
    n_experts_used: int = 0
    norm_topk_prob: bool = True
    moe_ffn_dim: int = 0

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "BackboneConfig":
        return cls(
            n_experts=r.get_i32("backbone.n_experts", 0),
            n_experts_used=r.get_i32("backbone.n_experts_used", 0),
            norm_topk_prob=r.get_bool("backbone.norm_topk_prob", True),
            moe_ffn_dim=r.get_i32("backbone.moe_ffn_dim", 0),
            hidden=r.get_i32("backbone.hidden_dim"),
            n_layers=r.get_i32("backbone.n_layers"),
            n_heads=r.get_i32("backbone.n_heads"),
            n_kv_heads=r.get_i32("backbone.n_kv_heads"),
            head_dim=r.get_i32("backbone.head_dim"),
            ffn_dim=r.get_i32("backbone.ffn_dim"),
            vocab_size=r.get_i32("backbone.vocab_size"),
            rope_theta=r.get_f32("backbone.rope_theta", 10000.0),
            rms_eps=r.get_f32("backbone.rms_eps", 1e-5),
            max_ctx=r.get_i32("backbone.max_ctx", 4096),
            has_qk_norm=r.get_bool("backbone.qk_norm", False),
            has_attn_bias=r.get_bool("backbone.attn_bias", False),
            tied_lm_head=r.get_bool("backbone.tied_lm_head", True),
        )


def load_backbone_params(r: GGUFReader, cfg: BackboneConfig,
                         dtype=torch.float32, quantized: bool = False,
                         device="cuda") -> Dict[str, Any]:
    """Parameters on `device`: {"tok_embd", "out_norm", "freq_factors"
    (f32 or None), "lm_head" (untied only), "layers": one dict per layer}.
    quantized=True keeps Q8_0/Q4_K layer matrices packed (dicts of
    ops/qmat.py); F16/F32 matrices load dense in `dtype` either way. A MoE
    layer has the router [E, hidden] and the stacked experts gate_exps /
    up_exps [E, moe_ffn, hidden] and down_exps [E, hidden, moe_ffn], dense
    in `dtype`, in place of gate / up / down."""

    def get(name, required=True):
        if not r.has_tensor(name):
            if required:
                raise KeyError(f"backbone tensor missing: {name}")
            return None
        return torch.from_numpy(np.array(r.get(name), np.float32)).to(device, dtype)

    def get_mat(name):
        if quantized and r.tensors[name].type_name in ("Q8_0", "Q4_K"):
            return qmat.to_device(qmat.pack_tensor(r, name), device)
        return get(name)

    ff = get("backbone.rope_freq_factors", required=False)
    p: Dict[str, Any] = {"tok_embd": get("backbone.tok_embd"),
                         "out_norm": get("backbone.out_norm.w"),
                         "freq_factors": None if ff is None else ff.float()}
    if not cfg.tied_lm_head:
        p["lm_head"] = get("backbone.lm_head.w")
    p["layers"] = []
    for i in range(cfg.n_layers):
        pre = f"backbone.l{i}."
        lw = {k: get_mat(f"{pre}{k}.w") for k in _ATTN}
        if cfg.n_experts:
            lw.update({k: get(f"{pre}{k}.w") for k in _EXPERTS})
        else:
            lw.update({k: get_mat(f"{pre}{k}.w") for k in _FFN})
        lw["attn_norm"] = get(pre + "attn_norm.w")
        lw["ffn_norm"] = get(pre + "ffn_norm.w")
        if cfg.has_attn_bias:
            for k in ("q", "k", "v"):
                lw[f"{k}_b"] = get(f"{pre}{k}.b")
        if cfg.has_qk_norm:
            lw["q_norm"] = get(pre + "q_norm.w")
            lw["k_norm"] = get(pre + "k_norm.w")
        p["layers"].append(lw)
    return p


def params_from_reference(cfg: BackboneConfig, tree: Dict[str, Any],
                          dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """codec_tpu's `load_backbone_params` tree as NumPy arrays (layers
    stacked [L, ...]; packed matrices as dicts in its group-minor column
    order) → this package's parameters, packed matrices repacked into the
    natural order bit for bit (ops/qmat.natural_order); a MoE tree's
    stacked experts [L, E, ...] split per layer."""

    def dense(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device, dtype)

    stacked = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        lw = {}
        for k, v in stacked.items():
            if isinstance(v, dict):
                qt = qmat.natural_order({n: np.asarray(a)[i] for n, a in v.items()})
                lw[k] = qmat.to_device(qt, device)
            else:
                lw[k] = dense(np.asarray(v)[i])
        layers.append(lw)
    ff = tree.get("freq_factors")
    p = {"tok_embd": dense(tree["tok_embd"]), "out_norm": dense(tree["out_norm"]),
         "freq_factors": None if ff is None else dense(ff).float(),
         "layers": layers}
    if "lm_head" in tree:
        p["lm_head"] = dense(tree["lm_head"])
    return p


def _mm(h: torch.Tensor, w, qmm: Callable) -> torch.Tensor:
    """h @ w.T for a dense [out, in] weight or a packed dict (through `qmm`;
    its f32 result is cast back to h's dtype)."""
    if isinstance(w, dict):
        return qmm(h, w).to(h.dtype)
    return F.linear(h, w)


def _moe_ffn(h: torch.Tensor, lw: Dict[str, Any], cfg: BackboneConfig,
             e0: int = 0) -> torch.Tensor:
    """Qwen3-MoE sparse FFN over h [T, hidden] (codec_tpu/lm/backbone.py::
    _moe_ffn; HF Qwen3MoeSparseMoeBlock): the router's softmax in f32 →
    the n_experts_used most probable experts (equal probabilities: the
    lower expert index first, as lax.top_k; a stable sort gives that) →
    their weights renormalized to sum 1 when norm_topk_prob → the weighted
    sum of the chosen experts' SwiGLUs.

    codec_tpu computes every expert and contracts with a routing matrix
    that is zero off the chosen ones. Where the chosen (token, expert)
    pairs are fewer than the experts (a decode step: T · k < E) this form
    gathers the chosen experts' matrices and runs those alone, the same
    sum over the same terms (k of E experts' bytes a token); else it runs
    codec_tpu's dense form.

    An expert-parallel shard holds experts e0.. of them (fewer than E
    stacked): it returns their share of the sum. Where the form gathers,
    it gathers all k chosen slots, each clamped into the shard, and
    zeroes the weights of those outside it: a gather of the shard's own
    chosen experts alone would have a length that depends on the routing
    (a host read, which a CUDA graph cannot capture and which cost the
    host step more than the clamped slots' bytes on the card)."""
    t, k = h.shape[0], cfg.n_experts_used
    probs = torch.softmax(F.linear(h, lw["router"]).float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    n_loc = lw["gate_exps"].shape[0]
    if t * k < cfg.n_experts:
        if n_loc < cfg.n_experts:             # an EP shard's chosen slots
            mine = (topi >= e0) & (topi < e0 + n_loc)
            topv = torch.where(mine, topv, 0.0)
            topi = (topi - e0).clamp(0, n_loc - 1)
        g = torch.einsum("th,tkfh->tkf", h, lw["gate_exps"][topi])
        u = torch.einsum("th,tkfh->tkf", h, lw["up_exps"][topi])
        y = torch.einsum("tkf,tkhf->tkh", F.silu(g) * u, lw["down_exps"][topi])
        return torch.einsum("tk,tkh->th", topv.to(y.dtype), y)
    w = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                    device=h.device).scatter(1, topi, topv)[:, e0:e0 + n_loc]
    g = torch.einsum("th,efh->tef", h, lw["gate_exps"])
    u = torch.einsum("th,efh->tef", h, lw["up_exps"])
    y = torch.einsum("tef,ehf->teh", F.silu(g) * u, lw["down_exps"])
    return torch.einsum("te,teh->th", w.to(y.dtype), y)


def _ffn(h: torch.Tensor, lw: Dict[str, Any], cfg: BackboneConfig,
         qmm: Callable, e0: int = 0) -> torch.Tensor:
    """The layer's FFN over h [T, hidden]: SwiGLU, or the MoE's (from
    expert e0 on an expert-parallel shard)."""
    if cfg.n_experts:
        return _moe_ffn(h, lw, cfg, e0)
    g = F.silu(_mm(h, lw["gate"], qmm)) * _mm(h, lw["up"], qmm)
    return _mm(g, lw["down"], qmm)


def _attn_out(xb: torch.Tensor, lw: Dict[str, Any], kv_l: torch.Tensor,
              pos0: int, cfg: BackboneConfig, rope_cs, mask,
              qmm: Callable) -> torch.Tensor:
    """A layer's attention over xb [T, hidden] (its o product, before the
    residual): the new keys and values are written into kv_l
    [2, n_kv, max_ctx, D] at pos0.. in place. With a tensor-parallel
    shard's config and weights (its heads, its kv heads) this is the
    shard's partial o product."""
    t = xb.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = norms.rms_norm(xb, lw["attn_norm"], cfg.rms_eps)
    q, k, v = (_mm(h, lw[n], qmm) for n in ("q", "k", "v"))
    if cfg.has_attn_bias:
        q, k, v = q + lw["q_b"], k + lw["k_b"], v + lw["v_b"]
    q = q.reshape(t, nh, hd).transpose(0, 1)
    k = k.reshape(t, nkv, hd).transpose(0, 1)
    v = v.reshape(t, nkv, hd).transpose(0, 1)
    if cfg.has_qk_norm:                       # per-head RMS over head_dim
        q = norms.rms_norm(q, lw["q_norm"], cfg.rms_eps)
        k = norms.rms_norm(k, lw["k_norm"], cfg.rms_eps)
    q = rope.rotate(q[None], *rope_cs)[0]
    k = rope.rotate(k[None], *rope_cs)[0]

    s = pos0 + t
    kv_l[0, :, pos0:s] = k
    kv_l[1, :, pos0:s] = v
    keys, vals = kv_l[0, :, None, :s], kv_l[1, :, None, :s]   # [n_kv, 1, S, D]
    # query head j reads kv head j // (nh / nkv), as jnp.repeat does
    qg = q.reshape(nkv, nh // nkv, t, hd)
    logits = torch.matmul(qg.float(), keys.float().transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    ctx = torch.matmul(w, vals).reshape(nh, t, hd).transpose(0, 1)
    return _mm(ctx.reshape(t, nh * hd), lw["o"], qmm)


def layer_block(xb: torch.Tensor, lw: Dict[str, Any], kv_l: torch.Tensor,
                pos0: int, cfg: BackboneConfig, rope_cs, mask,
                qmm: Callable = qmat.qmatmul) -> torch.Tensor:
    """One decoder layer over xb [T, hidden] at positions pos0..pos0+T-1:
    attention against this layer's cache kv_l [2, n_kv, max_ctx, D] (the
    new keys and values are written into it in place) + the FFN (SwiGLU,
    or the MoE's). rope_cs: (cos, sin) of the positions; mask: additive [T, pos0+T] or
    None (one query sees every key)."""
    xb = xb + _attn_out(xb, lw, kv_l, pos0, cfg, rope_cs, mask, qmm)
    return xb + _ffn(norms.rms_norm(xb, lw["ffn_norm"], cfg.rms_eps), lw, cfg,
                     qmm)


def positions_rope_mask(pos0: int, t: int, cfg: BackboneConfig,
                        freq_factors, device):
    """(cos, sin) of positions pos0..pos0+T-1 on `device`, and the additive
    causal mask [T, pos0+T] (None for one row: a query at p sees keys
    <= p)."""
    positions = torch.arange(pos0, pos0 + t, device=device)
    rope_cs = rope.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                freq_factors=freq_factors)
    mask = None
    if t > 1:
        key_pos = torch.arange(pos0 + t, device=device)
        mask = torch.where(key_pos[None, :] <= positions[:, None], 0.0, NEG_INF)
    return rope_cs, mask


def run_layers(layers, kv: torch.Tensor, pos0: int, x: torch.Tensor,
               cfg: BackboneConfig, freq_factors,
               qmm: Callable = qmat.qmatmul) -> torch.Tensor:
    """`layers` (a list of layer dicts, whole or one pipeline stage's) over
    x [T, hidden] at positions pos0..; kv [len(layers), 2, n_kv, max_ctx,
    D] their caches, updated in place → x after the last of them."""
    rope_cs, mask = positions_rope_mask(pos0, x.shape[0], cfg, freq_factors,
                                        x.device)
    for li, lw in enumerate(layers):
        x = layer_block(x, lw, kv[li], pos0, cfg, rope_cs, mask, qmm)
    return x


def backbone_forward(params: Dict[str, Any], kv: torch.Tensor, pos0: int,
                     x: torch.Tensor, cfg: BackboneConfig,
                     qmm: Callable = qmat.qmatmul) -> torch.Tensor:
    """x: [T, hidden] new-token embeddings at positions pos0..pos0+T-1;
    kv [L, 2, n_kv, max_ctx, D] is updated in place → hiddens [T, hidden]
    after the output norm."""
    x = run_layers(params["layers"], kv, pos0, x, cfg, params["freq_factors"],
                   qmm)
    return norms.rms_norm(x, params["out_norm"], cfg.rms_eps)


def _step_inputs(pos: torch.Tensor, ctx: int, cfg: BackboneConfig,
                 freq_factors) -> tuple:
    """What every layer of a batched step reads: (cos, sin) of the
    positions pos [B], the additive mask [B, ctx] key_pos <= pos, the rows
    0..B-1 and the cache row each stream writes (min(pos, ctx - 1))."""
    rope_cs = rope.rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta,
                                freq_factors=freq_factors)
    key_pos = torch.arange(ctx, device=pos.device)
    mask = torch.where(key_pos[None, :] <= pos[:, None], 0.0, NEG_INF)
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rope_cs, mask, rows, pos.clamp(max=ctx - 1)


def _step_attn(x: torch.Tensor, lw: Dict[str, Any], kv_l: torch.Tensor,
               cfg: BackboneConfig, inputs: tuple, ctx: int,
               qmm: Callable) -> torch.Tensor:
    """One layer's attention in a batched step (its o product, before the
    residual): x [B, hidden], kv_l [B, 2, n_kv, >= ctx, D] this layer's
    caches, written in place at the streams' rows; `inputs` from
    _step_inputs. With a tensor-parallel share's config and weights (its
    heads, its kv heads) this is the share's partial o product."""
    rope_cs, mask, rows, w_pos = inputs
    b = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = norms.rms_norm(x, lw["attn_norm"], cfg.rms_eps)
    q, k, v = (_mm(h, lw[n], qmm) for n in ("q", "k", "v"))
    if cfg.has_attn_bias:
        q, k, v = q + lw["q_b"], k + lw["k_b"], v + lw["v_b"]
    q = q.reshape(b, nh, 1, hd)
    k = k.reshape(b, nkv, 1, hd)
    v = v.reshape(b, nkv, hd)
    if cfg.has_qk_norm:                       # per-head RMS over head_dim
        q = norms.rms_norm(q, lw["q_norm"], cfg.rms_eps)
        k = norms.rms_norm(k, lw["k_norm"], cfg.rms_eps)
    q = rope.rotate(q, *rope_cs)
    k = rope.rotate(k, *rope_cs)[:, :, 0]
    keys, vals = kv_l[:, 0], kv_l[:, 1]         # [B, n_kv, max_ctx, D]
    keys[rows, :, w_pos] = k
    vals[rows, :, w_pos] = v
    keys, vals = keys[:, :, None, :ctx], vals[:, :, None, :ctx]
    # query head j reads kv head j // (nh / nkv), as jnp.repeat does
    qg = q.reshape(b, nkv, nh // nkv, 1, hd)
    logits = torch.matmul(qg.float(), keys.float().transpose(-1, -2))
    logits = logits * hd ** -0.5 + mask[:, None, None, None, :]
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    att = torch.matmul(w, vals).reshape(b, nh * hd)
    return _mm(att, lw["o"], qmm)


def backbone_step(params: Dict[str, Any], kv: torch.Tensor, pos: torch.Tensor,
                  x: torch.Tensor, cfg: BackboneConfig, ctx: int,
                  qmm: Callable = qmat.qmatmul) -> torch.Tensor:
    """One decode step of B streams: x [B, hidden] at positions pos [B]
    (int64, on the device); kv [B, L, 2, n_kv, >= ctx, D], each stream's
    cache, updated in place: stream b's new key and value land at row
    min(pos[b], ctx - 1), and its query attends rows [0, ctx) under the
    mask key_pos <= pos[b] (codec_tpu/lm/backbone.py's mask over the whole
    static cache, cut to the ctx rows a request can reach). The products
    run at m = B. → hiddens [B, hidden] after the output norm."""
    inputs = _step_inputs(pos, ctx, cfg, params["freq_factors"])
    for li, lw in enumerate(params["layers"]):
        x = x + _step_attn(x, lw, kv[:, li], cfg, inputs, ctx, qmm)
        x = x + _ffn(norms.rms_norm(x, lw["ffn_norm"], cfg.rms_eps), lw, cfg,
                     qmm)
    return norms.rms_norm(x, params["out_norm"], cfg.rms_eps)


def backbone_step_split(bb: "LlamaBackbone", row: int, kvs, pos: torch.Tensor,
                        x: torch.Tensor, ctx: int,
                        out_norm: torch.Tensor) -> torch.Tensor:
    """backbone_step over row `row` of a TP or EP backbone's shares, as
    _split_forward runs a prefill or host step: the residual stream on
    each share's device, each share's attention (its heads and kv heads
    under TP, all of them under EP) and FFN share computed there with its
    own weights, the partial sums reduced in mesh order on the row's first
    device (LlamaBackbone._reduce). kvs: one cache a share, [B, L, 2, n_kv
    of the share, >= ctx, D]; out_norm on the row's first device. →
    hiddens [B, hidden] there. No step reads the host (the MoE's gather
    has a fixed length), so the step can be captured; `bb.reductions` then counts the reductions of the
    capture's runs, not of the replays."""
    c, sc = bb.cfg, bb.shard_cfg
    tp = bb.mesh_kind == "tp"
    shards, devs = bb.share_rows[row], bb.row_devices[row]
    xs = [x.to(d, non_blocking=True) for d in devs]
    inputs = [_step_inputs(pos.to(d, non_blocking=True), ctx, sc,
                           sh["freq_factors"]) for sh, d in zip(shards, devs)]
    e0 = bb.expert0 if not tp else [0] * len(devs)
    for li in range(c.n_layers):
        lws = [sh["layers"][li] for sh in shards]
        att = [_step_attn(xd, lw, kv[:, li], sc, inp, ctx, bb.qmm)
               for xd, lw, kv, inp in zip(xs, lws, kvs, inputs)]
        xs = [xd + a for xd, a in zip(xs, bb._reduce(att, devs) if tp
                                      else att)]
        ffn = [_ffn(norms.rms_norm(xd, lw["ffn_norm"], c.rms_eps), lw, sc,
                    bb.qmm, e)
               for xd, lw, e in zip(xs, lws, e0)]
        xs = [xd + f for xd, f in zip(xs, bb._reduce(ffn, devs))]
    return norms.rms_norm(xs[0], out_norm, c.rms_eps)


def _part(t: torch.Tensor, dim: int, i: int, n: int,
          device) -> torch.Tensor:
    """Part i of n of t along dim, as its own tensor on `device`."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).to(device, copy=True)


class LlamaBackbone:
    """A backbone GGUF on `device`, with the tts_runner Backbone protocol
    (`step`) plus `prefill`, `embed_tokens` and `text_logits`, and the
    device mesh (`set_mesh`, `set_mesh_ep`, `set_mesh_pp`).

    `quantized` keeps Q8_0/Q4_K matrices packed (default False: they are
    dequantized at load). `qmm` is the packed product (default
    ops/qmat.qmatmul, the kernels on CUDA); ops/qmat.qmatmul_plain runs the
    same weights through the plain version."""

    def __init__(self, path_or_reader, dtype=torch.float32, max_ctx: int = 0,
                 quantized: bool = False, device="cuda",
                 qmm: Callable = qmat.qmatmul):
        r = path_or_reader if isinstance(path_or_reader, GGUFReader) \
            else GGUFReader(path_or_reader)
        if r.architecture != "llama_backbone":
            raise ValueError(f"not a backbone GGUF: {r.architecture!r}")
        cfg = BackboneConfig.from_gguf(r)
        if max_ctx:
            cfg.max_ctx = max_ctx
        self._init(cfg, load_backbone_params(r, cfg, dtype, quantized, device),
                   dtype, qmm)

    @classmethod
    def from_params(cls, cfg: BackboneConfig, params: Dict[str, Any],
                    dtype=torch.float32,
                    qmm: Callable = qmat.qmatmul) -> "LlamaBackbone":
        """A backbone over parameters already in memory (the
        `load_backbone_params` layout, on their device); `dtype` is the KV
        cache's."""
        bb = cls.__new__(cls)
        bb._init(cfg, params, dtype, qmm)
        return bb

    def _init(self, cfg, params, dtype, qmm) -> None:
        self.cfg = cfg
        self.params = params
        self.dtype = dtype
        self.device = params["tok_embd"].device
        self.qmm = qmm
        self.kv: Optional[torch.Tensor] = None
        # a mesh (set_mesh, set_mesh_ep, set_mesh_pp): "tp" | "ep" | "pp"
        self.mesh_kind: Optional[str] = None
        self.reset()

    # -- state -------------------------------------------------------------
    def reset(self) -> None:
        """Empty context; the KV cache is allocated once and reused (on a
        mesh, every device's share stays where it was placed)."""
        c = self.cfg
        shape = (c.n_layers, 2, c.n_kv_heads, c.max_ctx, c.head_dim)
        if self.mesh_kind is None and (self.kv is None
                                       or tuple(self.kv.shape) != shape):
            self.kv = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.pos = 0

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pos + x.shape[0] > self.cfg.max_ctx:
            raise ValueError(f"backbone context full: {self.pos} + "
                             f"{x.shape[0]} > max_ctx {self.cfg.max_ctx}")
        with torch.inference_mode():
            if self.mesh_kind is None:
                return backbone_forward(self.params, self.kv, self.pos, x,
                                        self.cfg, self.qmm)
            if self.mesh_kind == "pp":
                return self._pp(self.shards, self.kvs, self.params["out_norm"],
                                self.pos, x, self.qmm)
            return self._split_forward(x)

    # -- the device mesh (codec_tpu/lm/backbone.py:317-452) -----------------
    # One process drives every device: the layer weights and KV caches are
    # split into per-device shares (`shards`, `kvs`, one a mesh device);
    # the embedding, output norm and LM head (`params`, no "layers" left)
    # stay on the mesh's first device, where the hiddens come back. The
    # generation chunks (lm/fused_gen.py) step a TP or EP backbone through
    # StepGroup (backbone_step_split); a PP one runs the host path.
    def set_mesh(self, mesh, axis: str = "tp") -> None:
        """Tensor parallelism over mesh[axis] (Megatron): q/k/v/gate/up
        split by output rows with their biases, o/down by input columns;
        the attention heads and the KV cache split on the kv-head axis, so
        a GQA group stays on one device; a MoE's experts split on their
        ffn dim, the router replicated. Each device's partial o and down
        products are summed explicitly, in mesh order, on the first device
        and the sum copied back to every device (`reductions` counts the
        sums). On a 2-D mesh (dp x tp) every row of the other axis gets
        the same shares on its own devices (`share_rows`, `row_devices`,
        placed with `place`, so a device named twice holds one copy); the
        host path runs row 0, a data-parallel share of the batch runners
        its own row. Requires n_heads, n_kv_heads and ffn_dim (moe_ffn_dim for a
        MoE) divisible by the mesh size; packed weights (quantized=True)
        are refused, as codec_tpu refuses them."""
        c = self.cfg
        devs = mesh.axis_devices(axis)
        n = len(devs)
        checks = [("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads)]
        # only the ffn dims that exist as tensors constrain the split
        checks.append(("moe_ffn_dim", c.moe_ffn_dim) if c.n_experts
                      else ("ffn_dim", c.ffn_dim))
        for name, dim in checks:
            if dim % n:
                raise ValueError(f"backbone TP: {name}={dim} not divisible "
                                 f"by mesh size {n}")
        self._check_unplaced()
        if any(isinstance(lw.get(k), dict) for lw in self.params["layers"]
               for k in _ATTN + _FFN):
            raise ValueError("backbone TP: packed-quantized weights are "
                             "not supported; load with quantized=False")
        # the dim each split tensor splits on; the rest replicate
        split = {"q": 0, "k": 0, "v": 0, "gate": 0, "up": 0, "o": 1, "down": 1,
                 "q_b": 0, "k_b": 0, "v_b": 0,
                 "gate_exps": 1, "up_exps": 1, "down_exps": 2}

        def share(lw, i, d):
            return {k: (place(v, d) if k not in split else
                        _part(v, split[k], i, n, d)) for k, v in lw.items()}

        self._place("tp", devs, [[share(lw, i, d) for lw in self.params["layers"]]
                                 for i, d in enumerate(devs)],
                    kv_heads=c.n_kv_heads // n)
        # every row of the other axes (a 2-D mesh's dp rows) holds the same
        # shares on its own devices; `place` shares a tensor already there
        rows = np.moveaxis(mesh.devices, mesh.axis_names.index(axis),
                           -1).reshape(-1, n)
        self.row_devices = [list(r) for r in rows]
        self.share_rows = [self.shards] + [
            [place(sh, d) for sh, d in zip(self.shards, r)] for r in rows[1:]]
        self.mesh = mesh
        self.shard_cfg = replace(c, n_heads=c.n_heads // n,
                                 n_kv_heads=c.n_kv_heads // n,
                                 ffn_dim=c.ffn_dim // n,
                                 moe_ffn_dim=c.moe_ffn_dim // n)

    def set_mesh_ep(self, mesh, axis: str = "ep") -> None:
        """Expert parallelism over mesh[axis] for a MoE backbone: device i
        holds experts [i E/n, (i+1) E/n) of every layer; the attention,
        router, norms and KV cache are replicated. Each device computes its
        experts' share of the MoE sum for every token (gathering only its
        own chosen experts where the form gathers) and the shares are
        summed as TP's partial products are. Requires n_experts divisible
        by the mesh size; a dense backbone is refused."""
        c = self.cfg
        devs = mesh.axis_devices(axis)
        n = len(devs)
        if not c.n_experts:
            raise ValueError("backbone EP: not a MoE backbone "
                             "(backbone.n_experts == 0)")
        if c.n_experts % n:
            raise ValueError(f"backbone EP: n_experts={c.n_experts} not "
                             f"divisible by mesh size {n}")
        self._check_unplaced()

        def share(lw, i, d):
            return {k: (_part(v, 0, i, n, d) if k in _EXPERTS[1:]
                        else place(v, d)) for k, v in lw.items()}

        self._place("ep", devs, [[share(lw, i, d) for lw in self.params["layers"]]
                                 for i, d in enumerate(devs)],
                    kv_heads=c.n_kv_heads)
        self.shard_cfg = c
        self.expert0 = [i * (c.n_experts // n) for i in range(n)]

    def set_mesh_pp(self, mesh, axis: str = "pp",
                    microbatches: int = 4) -> None:
        """Pipeline parallelism over mesh[axis]: stage s holds layers
        [s L/S, (s+1) L/S) whole, with their KV caches, on device s, and
        prefill and step run parallel/pipeline.py's GPipe schedule
        (`microbatches` caps the split of a prefill's rows). Packed
        Q8_0/Q4_K layers stay packed, so each stage's products run the
        packed kernels (PP × Q4_K is the largest backbone a set of cards
        holds). Requires n_layers divisible by the mesh size."""
        from ..parallel.pipeline import build_pp_forward

        c = self.cfg
        devs = mesh.axis_devices(axis)
        n = len(devs)
        if c.n_layers % n:
            raise ValueError(f"backbone PP: n_layers={c.n_layers} not "
                             f"divisible by mesh size {n}")
        self._check_unplaced()
        per = c.n_layers // n
        layers = self.params["layers"]
        self._place("pp", devs, [[place(lw, d) for lw in layers[i * per:
                                                              (i + 1) * per]]
                                 for i, d in enumerate(devs)],
                    kv_heads=c.n_kv_heads, n_layers=per)
        self._pp = build_pp_forward(c, mesh, axis, int(microbatches))

    def _check_unplaced(self) -> None:
        if self.mesh_kind is not None:
            raise ValueError(f"backbone already sharded ({self.mesh_kind}); "
                             f"load it again to place it another way")

    def _place(self, kind: str, devs, layer_shares, kv_heads: int,
               n_layers: int = 0) -> None:
        """Record the shares: `shards[i]` = {"layers", "freq_factors"} on
        devs[i], `kvs[i]` its caches; the head stays on devs[0]."""
        c = self.cfg
        ff = self.params["freq_factors"]
        self.shards = [{"layers": ls, "freq_factors": place(ff, d)}
                       for ls, d in zip(layer_shares, devs)]
        self.kvs = [torch.zeros((n_layers or c.n_layers, 2, kv_heads,
                                 c.max_ctx, c.head_dim), dtype=self.dtype,
                                device=d) for d in devs]
        self.params = {k: place(v, devs[0]) for k, v in self.params.items()
                       if k != "layers"}
        self.mesh_kind, self.mesh_devices = kind, list(devs)
        self.mesh = None
        self.__dict__.pop("_replicas", None)
        self.share_rows, self.row_devices = [self.shards], [list(devs)]
        self.device = torch.device(devs[0])
        self.kv = None
        self.reductions = 0

    def _reduce(self, parts, devices=None):
        """The devices' partial sums added in mesh order on the first
        device; the sum copied back to each device (of `devices`, a row of
        the mesh; the host path's by default)."""
        self.reductions += 1
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device, non_blocking=True)
        return [total.to(d, non_blocking=True)
                for d in devices or self.mesh_devices]

    def _split_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of a TP or EP backbone: the residual stream on every
        device, each device's attention (its heads under TP, all of them
        under EP) and FFN share computed there, the partial sums reduced."""
        c, sc, pos0 = self.cfg, self.shard_cfg, self.pos
        tp = self.mesh_kind == "tp"
        devs = self.mesh_devices
        xs = [x.to(d, non_blocking=True) for d in devs]
        rms = [positions_rope_mask(pos0, x.shape[0], c, sh["freq_factors"], d)
               for sh, d in zip(self.shards, devs)]
        e0 = self.expert0 if not tp else [0] * len(devs)
        for li in range(c.n_layers):
            lws = [sh["layers"][li] for sh in self.shards]
            att = [_attn_out(xd, lw, kv[li], pos0, sc, *rm, self.qmm)
                   for xd, lw, kv, rm in zip(xs, lws, self.kvs, rms)]
            xs = [xd + a for xd, a in zip(xs, self._reduce(att) if tp else att)]
            ffn = [_ffn(norms.rms_norm(xd, lw["ffn_norm"], c.rms_eps), lw, sc,
                        self.qmm, e)
                   for xd, lw, e in zip(xs, lws, e0)]
            xs = [xd + f for xd, f in zip(xs, self._reduce(ffn))]
        return norms.rms_norm(xs[0], self.params["out_norm"], c.rms_eps)

    def params_on(self, device) -> Dict[str, Any]:
        """The parameter tree (every layer on an unsharded backbone; the
        embedding, output norm and head on a mesh) on `device`: `params`
        where it already sits on that card, else a copy placed there once
        and kept, which every runner of a data-parallel share on that card
        reads, as do this backbone's lanes."""
        if physical(device) == physical(self.device):
            return self.params
        reps = self.__dict__.setdefault("_replicas", {})
        key = str(physical(device))
        if key not in reps:
            reps[key] = place(self.params, device)
        return reps[key]

    def lane(self) -> "LlamaBackbone":
        """A backbone over these weights (and, on a mesh, these shares)
        with a cache of its own: another stream's state that shares the
        weights, such as a server's engine beside its serialized path."""
        if self.mesh_kind is None:
            bb = LlamaBackbone.from_params(self.cfg, self.params, self.dtype,
                                           self.qmm)
        elif self.mesh_kind == "pp":
            raise ValueError("a pipeline-staged backbone has no lane: its "
                             "stages run one stream")
        else:
            bb = LlamaBackbone.__new__(LlamaBackbone)
            bb.__dict__.update({k: v for k, v in self.__dict__.items()
                                if not k.startswith("_")})
            bb.kvs = [torch.zeros_like(k) for k in self.kvs]
            bb.reductions = 0
            bb.pos = 0
        bb._replicas = self.__dict__.setdefault("_replicas", {})
        return bb

    # -- Backbone protocol + helpers ----------------------------------------
    def step(self, embed: np.ndarray) -> np.ndarray:
        """One input embedding [hidden] → the hidden [hidden] (f32, host)."""
        x = torch.as_tensor(np.asarray(embed, np.float32)).to(self.device,
                                                               self.dtype)
        h = self._forward(x[None])
        self.pos += 1
        return h[0].float().cpu().numpy()

    def prefill(self, embeds: np.ndarray, bucket: int = 0) -> np.ndarray:
        """Feed [T, hidden] prompt embeddings in one forward; returns the
        LAST hidden. `bucket > 0` right-pads the rows to the next multiple
        of `bucket` (clamped to max_ctx), as the reference does to bound
        its compiled shapes: the padded rows' keys land past `pos`, where
        no real row attends them and later writes replace them."""
        x = torch.as_tensor(np.asarray(embeds, np.float32)).to(self.device,
                                                               self.dtype)
        t = int(x.shape[0])
        if bucket > 0:
            pad = min(-t % int(bucket), self.cfg.max_ctx - self.pos - t)
            if pad > 0:
                x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        h = self._forward(x)
        self.pos += t
        return h[t - 1].float().cpu().numpy()

    def embed_tokens(self, ids) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return self.params["tok_embd"][ids].float().cpu().numpy()

    def text_logits(self, hidden: np.ndarray) -> np.ndarray:
        h = torch.as_tensor(np.asarray(hidden, np.float32)).to(self.device,
                                                               self.dtype)
        w = self.params["tok_embd"] if self.cfg.tied_lm_head \
            else self.params["lm_head"]
        return (h @ w.T).float().cpu().numpy()


class StepGroup:
    """Where a batch of streams runs its decode steps (the counterpart of
    the sharding annotations jit propagates into codec_tpu's chunks): a
    whole backbone on one device (`device`, its own by default: a
    data-parallel share's, where its weights are the backbone's one copy on
    that card, `params_on`), or row `row` of a TP or EP backbone's shares (a 2-D mesh's
    dp row; row 0 is the host path's), each share's layers and kv heads on
    its own device.

    `devices` are the group's, `device` the first, where the hiddens come
    back; `params` the embedding, output norm and head there.
    `new_kv(lead, ctx)` makes a batch's caches and `own_kv()` gives the
    backbone's own (a single stream's): one tensor a share, each [*lead,
    L, 2, n_kv of the share, ctx, D]. `__call__(kvs, pos, x, ctx)` is one
    step (backbone_step, or backbone_step_split) → hiddens [B, hidden] on
    `device`."""

    def __init__(self, bb: LlamaBackbone, row: int = 0, device=None):
        self.bb, self.cfg, self.dtype, self.qmm = bb, bb.cfg, bb.dtype, bb.qmm
        self.row = int(row)
        if bb.mesh_kind is None:
            self.devices = [torch.device(device) if device is not None
                            else bb.device]
        elif bb.mesh_kind in ("tp", "ep"):
            self.devices = list(bb.row_devices[self.row])
        else:
            raise ValueError(f"no batched step over a {bb.mesh_kind} "
                             f"backbone")
        self.device = self.devices[0]
        self.params = bb.params_on(self.device)
        self.kv_heads = (bb.shard_cfg.n_kv_heads if bb.mesh_kind
                         else bb.cfg.n_kv_heads)

    def new_kv(self, lead, ctx: int):
        c = self.cfg
        return [torch.zeros((*lead, c.n_layers, 2, self.kv_heads, ctx,
                             c.head_dim), dtype=self.dtype, device=d)
                for d in self.devices]

    def own_kv(self):
        bb = self.bb
        return [bb.kv[None]] if bb.mesh_kind is None else \
            [k[None] for k in bb.kvs]

    def __call__(self, kvs, pos: torch.Tensor, x: torch.Tensor,
                 ctx: int) -> torch.Tensor:
        if self.bb.mesh_kind is None:
            return backbone_step(self.params, kvs[0], pos, x, self.cfg, ctx,
                                 self.qmm)
        return backbone_step_split(self.bb, self.row, kvs, pos, x, ctx,
                                   self.params["out_norm"])


def create_backbone(path, dtype=torch.float32, max_ctx: int = 0,
                    quantized: bool = False, device="cuda") -> LlamaBackbone:
    return LlamaBackbone(path, dtype=dtype, max_ctx=max_ctx,
                         quantized=quantized, device=device)


def apply_backbone_mesh(bb: LlamaBackbone, kind: str, n: int,
                        devices=None) -> None:
    """The --tp/--pp/--ep surfaces' shared dispatch: shard `bb` over an
    n-device mesh of the given kind (the first n cards, or `devices`)."""
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(n, axis=kind, devices=devices)
    if kind == "tp":
        bb.set_mesh(mesh, axis="tp")
    elif kind == "pp":
        bb.set_mesh_pp(mesh, axis="pp")
    elif kind == "ep":
        bb.set_mesh_ep(mesh, axis="ep")
    else:
        raise ValueError(f"unknown backbone mesh kind {kind!r}")
