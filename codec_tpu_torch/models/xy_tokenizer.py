"""XY-Tokenizer (OpenMOSS XY_Tokenizer_TTSD_V0, the MOSS-TTSD v0.5 codec),
encode and decode, in PyTorch.

Counterpart of codec_tpu/models/xy_tokenizer.py:

encode: 16 kHz PCM → Whisper log-mel on the host (dsp/audio.py::
        whisper_mel_padded) → semantic and acoustic Whisper encoders (conv
        k3, conv k3 stride 2, layers with an n_valid key mask and query-row
        zeroing) → semantic adapter → channel concat → pre-RVQ adapter →
        ResidualDownConv (gate/up k4 s4 convs, fold, down linear, LN) →
        input projection → 8-level Euclidean RVQ → codes [T, 8], one row at
        a time
decode: codebook sum → output projection → post-RVQ adapter →
        ConvTranspose k4 s4 → 12-layer Whisper decoder → ConvTranspose k3
        s2 and k1 (GELU each) → 80 mel → Vocos (embed conv, ConvNeXt
        stack, LN) → iSTFT head (n_fft 960, hop 240) → 24 kHz PCM, in
        windows of `chunk_codes` codes (the post-RVQ positional rows)

Attention is non-causal: it runs the plain `ops/attn.py::sdpa`, since no
Pallas kernel of codec_tpu covers it. The RVQ search runs through
`rvq_cuda.rvq_encode_fused` on f32 codebooks and norms kept from load.

Parameters (`load_xy_params`, `params_from_jax`), PyTorch layouts (linear
[out, in], conv [C_out, C_in, K], conv-transpose [C_in, C_out, K]):
  cb [n_q, V, d]; out_proj_w [latent, d], out_proj_b; post_rvq,
  acoust_dec: Whisper modules {pos, ln_w, ln_b, proj_w/b, out_w/b (or
  None), layers}; up_conv_w; deconv1_w/b, deconv2_w/b; vocos_embed_w/b,
  vocos_norm_w/b, vocos_blocks (ConvNeXt dicts), vocos_fln_w/b, head_w/b
  with an encoder: in_proj_w [d, latent], in_proj_b; sem_enc, acoust_enc
  (Whisper modules with conv1_w/b, conv2_w/b), sem_adapter, pre_rvq;
  dn_gate_w, dn_up_w, dn_down_w, dn_ln_w/b; search {"cb", "norms"} (f32)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.audio import whisper_mel_padded
from ..io.gguf import GGUFReader
from ..ops import act, blocks, norms, rvq, rvq_cuda
from ..ops.attn import NEG_INF, sdpa
from ..ops.istft import istft_from_head
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.perf_log import perf_scope


@dataclass(frozen=True)
class XyConfig:
    encode_sample_rate: int = 16000
    sample_rate: int = 24000
    encoder_downsample_rate: int = 1280
    decoder_upsample_rate: int = 1920
    latent_dim: int = 3072
    codebook_dim: int = 512
    codebook_size: int = 1024
    n_q: int = 8
    mel_n_mels: int = 80
    mel_n_fft: int = 400
    mel_hop: int = 160
    n_layers: int = 12
    adapter_layers: int = 4
    d_model: int = 768
    n_heads: int = 12
    avg_pooler: int = 4
    upsample_stride: int = 4
    vocos_blocks: int = 30
    vocos_n_fft: int = 960
    vocos_hop: int = 240

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "XyConfig":
        d_model = 768
        if r.has_tensor("xy.sem_enc.l0.attn.q.w"):
            d_model = int(r.tensors["xy.sem_enc.l0.attn.q.w"].shape[0])
        return cls(
            encode_sample_rate=r.get_i32("codec.encode_sample_rate", 16000),
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            encoder_downsample_rate=r.get_i32("xy.encoder_downsample_rate",
                                              1280),
            decoder_upsample_rate=r.get_i32("xy.decoder_upsample_rate", 1920),
            latent_dim=r.get_i32("codec.latent_dim", 3072),
            codebook_dim=r.get_i32("codec.codebook_dim", 512),
            codebook_size=r.get_i32("codec.codebook_size", 1024),
            n_q=r.get_i32("codec.n_q", 8),
            mel_n_mels=r.get_i32("xy.mel.n_mels", 80),
            mel_n_fft=r.get_i32("xy.mel.n_fft", 400),
            mel_hop=r.get_i32("xy.mel.hop_length", 160),
            n_layers=r.get_i32("xy.sem_enc.n_layers", 12),
            adapter_layers=r.get_i32("xy.sem_enc_adapter.n_layers", 4),
            d_model=d_model,
            n_heads=r.get_i32("xy.sem_enc.n_heads", 12),
            avg_pooler=r.get_i32("xy.downsample.avg_pooler", 4),
            upsample_stride=r.get_i32("xy.upsample.stride", 4),
            vocos_blocks=r.get_i32("xy.vocos.n_blocks", 30),
            vocos_n_fft=r.get_i32("xy.vocos.head.n_fft", 960),
            vocos_hop=r.get_i32("xy.vocos.head.hop_size", 240),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_LAYER = (("n1w", "norm1.w"), ("n1b", "norm1.b"), ("qw", "attn.q.w"),
          ("qb", "attn.q.b"), ("kw", "attn.k.w"), ("vw", "attn.v.w"),
          ("vb", "attn.v.b"), ("ow", "attn.out.w"), ("ob", "attn.out.b"),
          ("n2w", "norm2.w"), ("n2b", "norm2.b"), ("f1w", "mlp.fc1.w"),
          ("f1b", "mlp.fc1.b"), ("f2w", "mlp.fc2.w"), ("f2b", "mlp.fc2.b"))
_MODULE = (("pos", "pos_emb"), ("ln_w", "layer_norm.w"),
           ("ln_b", "layer_norm.b"))
_MODULE_OPT = (("proj_w", "proj.w"), ("proj_b", "proj.b"),
               ("out_w", "out_proj.w"), ("out_b", "out_proj.b"))
_CNX = (("dw_w", "dwconv.w"), ("dw_b", "dwconv.b"), ("ln_w", "norm.w"),
        ("ln_b", "norm.b"), ("pw1_w", "pwconv1.w"), ("pw1_b", "pwconv1.b"),
        ("pw2_w", "pwconv2.w"), ("pw2_b", "pwconv2.b"), ("gamma", "gamma"))
_DEC_FLAT = (("up_conv_w", "upsample.up_conv.w"),
             ("deconv1_w", "acoust_dec.deconv1.w"),
             ("deconv1_b", "acoust_dec.deconv1.b"),
             ("deconv2_w", "acoust_dec.deconv2.w"),
             ("deconv2_b", "acoust_dec.deconv2.b"),
             ("vocos_embed_w", "vocos.embed.w"),
             ("vocos_embed_b", "vocos.embed.b"),
             ("vocos_norm_w", "vocos.norm.w"), ("vocos_norm_b", "vocos.norm.b"),
             ("vocos_fln_w", "vocos.final_layer_norm.w"),
             ("vocos_fln_b", "vocos.final_layer_norm.b"),
             ("head_w", "vocos.head.out.w"), ("head_b", "vocos.head.out.b"))
_ENC_FLAT = (("dn_gate_w", "downsample.gate.w"), ("dn_up_w", "downsample.up.w"),
             ("dn_down_w", "downsample.down.w"),
             ("dn_ln_w", "downsample.layer_norm.w"),
             ("dn_ln_b", "downsample.layer_norm.b"))
_ENC_MODULES = (("sem_enc", "xy.sem_enc"), ("acoust_enc", "xy.acoust_enc"),
                ("sem_adapter", "xy.sem_enc_adapter"),
                ("pre_rvq", "xy.pre_rvq_adapter"))


def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_xy_params(r: GGUFReader, cfg: XyConfig, dtype=torch.float32,
                   device="cpu") -> Dict[str, Any]:
    """Parameters from an XY-Tokenizer GGUF (xy.* names)."""
    t = partial(_to, dtype=dtype, device=device)

    def g(name):
        return t(r.get(name))

    def module(base, n_layers):
        m: Dict[str, Any] = {k: g(f"{base}.{n}") for k, n in _MODULE}
        for k, n in _MODULE_OPT:
            a = r.get_or_none(f"{base}.{n}")
            m[k] = t(a) if a is not None else None
        m["layers"] = [{k: g(f"{base}.l{li}.{n}") for k, n in _LAYER}
                       for li in range(n_layers)]
        return m

    p: Dict[str, Any] = {
        "cb": t(np.stack([r.get(f"xy.q.{qi}.codebook")
                          for qi in range(cfg.n_q)])),
        "out_proj_w": t(r.get("xy.q.out_proj.w")[:, :, 0]),
        "out_proj_b": g("xy.q.out_proj.b"),
        "post_rvq": module("xy.post_rvq_adapter", cfg.adapter_layers),
        "acoust_dec": module("xy.acoust_dec", cfg.n_layers),
        "vocos_blocks": [{k: g(f"xy.vocos.b{bi}.{n}") for k, n in _CNX}
                         for bi in range(cfg.vocos_blocks)],
    }
    p.update({k: g(f"xy.{n}") for k, n in _DEC_FLAT})
    if r.has_tensor("xy.sem_enc.l0.attn.q.w"):
        p["in_proj_w"] = t(r.get("xy.q.in_proj.w")[:, :, 0])
        p["in_proj_b"] = g("xy.q.in_proj.b")
        for name, base in _ENC_MODULES:
            n = cfg.n_layers if name in ("sem_enc", "acoust_enc") \
                else cfg.adapter_layers
            p[name] = module(base, n)
        for name, base in _ENC_MODULES[:2]:
            for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b"):
                p[name][k] = g(f"{base}.{k[:5]}.{k[-1]}")
        p.update({k: g(f"xy.{n}") for k, n in _ENC_FLAT})
        p["search"] = rvq.search_state(p["cb"])
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu XY-Tokenizer parameter tree (from its `load_xy_params`;
    leaves as NumPy arrays or anything np.asarray takes) → this module's
    parameters. codec_tpu keeps conv weights WIO [K, C_in, C_out],
    conv-transpose weights WIO pre-flipped along K, and the RVQ
    projections as [out, in, 1]; this turns them back."""
    t = partial(_to, dtype=dtype, device=device)

    def conv(w):
        return t(np.asarray(w).transpose(2, 1, 0))

    def convtr(w):
        return t(np.asarray(w)[::-1].transpose(1, 2, 0))

    def opt(a):
        return t(a) if a is not None else None

    def module(m):
        out = {k: t(m[k]) for k, _ in _MODULE}
        out.update({k: opt(m[k]) for k, _ in _MODULE_OPT})
        out["layers"] = [{k: t(lw[k]) for k, _ in _LAYER}
                         for lw in m["layers"]]
        for k in ("conv1_w", "conv2_w"):
            if k in m:
                out[k] = conv(m[k])
                out[k[:-1] + "b"] = t(m[k[:-1] + "b"])
        return out

    conv_keys = {"vocos_embed_w", "dn_gate_w", "dn_up_w"}
    convtr_keys = {"up_conv_w", "deconv1_w", "deconv2_w"}

    def flat(k):
        if k in conv_keys:
            return conv(tree[k])
        if k in convtr_keys:
            return convtr(tree[k])
        return t(tree[k])

    p: Dict[str, Any] = {
        "cb": t(tree["cb"]),
        "out_proj_w": t(np.asarray(tree["out_proj_w"])[:, :, 0]),
        "out_proj_b": t(tree["out_proj_b"]),
        "post_rvq": module(tree["post_rvq"]),
        "acoust_dec": module(tree["acoust_dec"]),
        "vocos_blocks": [{k: conv(b[k]) if k == "dw_w" else t(b[k])
                          for k, _ in _CNX} for b in tree["vocos_blocks"]],
    }
    p.update({k: flat(k) for k, _ in _DEC_FLAT})
    if "in_proj_w" in tree:
        p["in_proj_w"] = t(np.asarray(tree["in_proj_w"])[:, :, 0])
        p["in_proj_b"] = t(tree["in_proj_b"])
        for name, _ in _ENC_MODULES:
            p[name] = module(tree[name])
        p.update({k: flat(k) for k, _ in _ENC_FLAT})
        p["search"] = rvq.search_state(p["cb"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def whisper_layer(x: torch.Tensor, lw: Dict[str, torch.Tensor], n_heads: int,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """Pre-LN Whisper encoder layer on [B, T, C]: q, v and out biased, k
    not; the scale applied to q; non-causal attention. With n_valid, keys
    from n_valid on are masked and the attention's and the MLP's outputs
    at query rows from n_valid on are zeroed."""
    b, t, c = x.shape
    d = c // n_heads
    h = norms.layer_norm(x, lw["n1w"], lw["n1b"], 1e-5)

    def heads(y):
        return y.reshape(b, t, n_heads, d).transpose(1, 2)

    q = heads(F.linear(h, lw["qw"], lw["qb"]) * (d ** -0.5))
    k = heads(F.linear(h, lw["kw"]))
    v = heads(F.linear(h, lw["vw"], lw["vb"]))
    mask = rows = None
    if n_valid is not None:
        kj = torch.arange(t, device=x.device)
        mask = torch.where(kj < n_valid, 0.0, NEG_INF).expand(t, t)
        rows = (kj < n_valid)[None, :, None]
    ctx = sdpa(q, k, v, scale=1.0, mask=mask)
    a = F.linear(ctx.transpose(1, 2).reshape(b, t, c), lw["ow"], lw["ob"])
    if rows is not None:
        a = torch.where(rows, a, torch.zeros_like(a))
    x = x + a
    m = norms.layer_norm(x, lw["n2w"], lw["n2b"], 1e-5)
    m = F.linear(act.gelu_erf(F.linear(m, lw["f1w"], lw["f1b"])), lw["f2w"],
                 lw["f2b"])
    if rows is not None:
        m = torch.where(rows, m, torch.zeros_like(m))
    return x + m


def whisper_module(x: torch.Tensor, m: Dict[str, Any], n_heads: int,
                   n_valid: Optional[int] = None) -> torch.Tensor:
    """Optional input projection, positional rows, the layers, LN, optional
    output projection."""
    if m["proj_w"] is not None:
        x = F.linear(x, m["proj_w"], m["proj_b"])
    x = x + m["pos"][: x.shape[1]]
    for lw in m["layers"]:
        x = whisper_layer(x, lw, n_heads, n_valid)
    x = norms.layer_norm(x, m["ln_w"], m["ln_b"], 1e-5)
    if m["out_w"] is not None:
        x = F.linear(x, m["out_w"], m["out_b"])
    return x


def xy_encode_latent_fn(params: Dict[str, Any], mel: torch.Tensor,
                        cfg: XyConfig, n_valid_mel: int) -> torch.Tensor:
    """mel [B, T_mel, n_mels] → the latent before the RVQ [B, T_mel/2/avg,
    codebook_dim]; mel frames from n_valid_mel on are padding."""
    n_valid = n_valid_mel // 2

    def omni(m):
        x = blocks.conv_tc(mel, m["conv1_w"], m["conv1_b"], padding=1)
        x = blocks.conv_tc(act.gelu_erf(x), m["conv2_w"], m["conv2_b"],
                           stride=2, padding=1)
        return whisper_module(act.gelu_erf(x), m, cfg.n_heads, n_valid)

    sem = omni(params["sem_enc"])
    aco = omni(params["acoust_enc"])
    sem = whisper_module(sem, params["sem_adapter"], cfg.n_heads, n_valid)
    cat = whisper_module(torch.cat([sem, aco], dim=-1), params["pre_rvq"],
                         cfg.n_heads, n_valid)
    # ResidualDownConv
    avg = cfg.avg_pooler
    gate = blocks.conv_tc(cat, params["dn_gate_w"], stride=avg)
    up = blocks.conv_tc(cat, params["dn_up_w"], stride=avg)
    b, t, d = cat.shape
    fold = cat.reshape(b, t // avg, avg * d)
    y = F.linear(act.silu(gate) * up, params["dn_down_w"]) + fold
    y = norms.layer_norm(y, params["dn_ln_w"], params["dn_ln_b"], 1e-5)
    return F.linear(y, params["in_proj_w"], params["in_proj_b"])


def xy_encode_fn(params: Dict[str, Any], mel: torch.Tensor, cfg: XyConfig,
                 n_valid_mel: int) -> torch.Tensor:
    """mel [B, T_mel, n_mels] → codes [B, T_mel/2/avg, n_q] int32. The
    search runs in f32 through `rvq_cuda.rvq_encode_fused` on the
    codebooks and norms kept from load."""
    z = xy_encode_latent_fn(params, mel, cfg, n_valid_mel)
    s = params["search"]
    return rvq_cuda.rvq_encode_fused(z.float().contiguous(), s["cb"],
                                     norms=s["norms"])


def xy_decode_head_fn(params: Dict[str, Any], codes: torch.Tensor,
                      cfg: XyConfig) -> torch.Tensor:
    """codes [B, T, Q] → the iSTFT head's input [B, 8T+1, n_fft+2] (at
    upsample stride 4)."""
    codes = codes.clamp(0, cfg.codebook_size - 1)
    z = rvq.rvq_decode_sum(codes, params["cb"])                 # [B, T, d]
    x = F.linear(z, params["out_proj_w"], params["out_proj_b"])
    x = whisper_module(x, params["post_rvq"], cfg.n_heads)

    def convtr(x, w, b=None, stride=1):
        return F.conv_transpose1d(x.transpose(1, 2), w, b,
                                  stride=stride).transpose(1, 2)

    x = convtr(x, params["up_conv_w"], stride=cfg.upsample_stride)
    x = whisper_module(x, params["acoust_dec"], cfg.n_heads)
    x = act.gelu_erf(convtr(x, params["deconv1_w"], params["deconv1_b"], 2))
    x = act.gelu_erf(convtr(x, params["deconv2_w"], params["deconv2_b"]))
    x = blocks.conv_tc(x, params["vocos_embed_w"], params["vocos_embed_b"],
                       padding=3)
    x = norms.layer_norm(x, params["vocos_norm_w"], params["vocos_norm_b"],
                         1e-6)
    for blk in params["vocos_blocks"]:
        x = blocks.convnext_block(x, blk)
    x = norms.layer_norm(x, params["vocos_fln_w"], params["vocos_fln_b"], 1e-6)
    return F.linear(x, params["head_w"], params["head_b"])


def xy_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                 cfg: XyConfig) -> torch.Tensor:
    """codes [B, T, Q] (T at most the post-RVQ positional rows) → pcm
    [B, hop·T + vocos_hop] float32."""
    return istft_from_head(xy_decode_head_fn(params, codes, cfg),
                           cfg.vocos_hop)


class XyTokenizerCodec(CodecModel):
    arch = "xy_tokenizer"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = XyConfig.from_gguf(reader)
        self.params = load_xy_params(reader, self.cfg,
                                     dtype=self.compute_dtype,
                                     device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.encode_sample_rate = self.cfg.encode_sample_rate
        self.hop_size = self.cfg.decoder_upsample_rate
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.latent_dim
        self.has_encoder = "in_proj_w" in self.params
        self.has_decoder = True
        # a decode runs in windows of at most the post-RVQ positional rows
        self.chunk_codes = int(self.params["post_rvq"]["pos"].shape[0])

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        """Each window of chunk_codes codes decodes on its own; the windows'
        PCM is concatenated (what codec_tpu's chunked decode returns)."""
        return torch.cat([xy_decode_fn(self.params, codes[:, s:s + self.chunk_codes],
                                       self.cfg)
                          for s in range(0, codes.shape[1], self.chunk_codes)],
                         dim=1)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] / [B, n] at encode_sample_rate (float32, or int16) →
        codes int32 [T, n_q] / [B, T, n_q]. Each row's mel is computed on
        the host and encoded on its own (one search launch per row), and
        its codes cut to the frames its samples cover."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        if pcm.ndim != 2 or pcm.shape[1] == 0:
            raise CodecError(f"bad pcm shape {pcm.shape}")
        cfg, outs = self.cfg, []
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            for row in pcm:
                mel, n_frames = whisper_mel_padded(
                    row, cfg.encode_sample_rate, cfg.mel_n_fft, cfg.mel_hop,
                    cfg.mel_n_mels, cfg.encoder_downsample_rate)
                n_valid = min(n_frames, len(row) // cfg.mel_hop)
                x = torch.from_numpy(np.ascontiguousarray(mel.T[None])).to(
                    self.device, self.compute_dtype)
                with perf_scope("graph_compute", "encode"):
                    codes = xy_encode_fn(self.params, x, cfg, n_valid)
                    codes = codes[0].cpu().numpy()
                outs.append(codes[: (n_valid // 2) // cfg.avg_pooler])
        return outs[0] if squeeze else np.stack(outs)
