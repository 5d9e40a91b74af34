"""XCodec2 (HKUSTAudio/xcodec2: the codec of the Llasa TTS models), encode
and decode, in PyTorch.

Counterpart of codec_tpu/models/xcodec2.py:

decode: NeuCodec's decoder (models/neucodec.py::neu_decode_fn) under the
        prefix "xcodec2": FSQ codebook lookup → project_out → fc_post_a →
        embed conv k7 → 2 prior ResNets → 12 RoFormer blocks (RoPE NORMAL)
        → 2 post ResNets → final LN → iSTFT head → 16 kHz PCM.
encode: 16 kHz PCM, row by row →
          acoustic: the BigCodec encoder, channels-first (conv k7 → 5
            blocks of 3 residual units with alias-free snake-beta
            (ops/alias_act.py) at dilations 1, 3, 9, then alias-free
            snake-beta and a strided conv, strides 2·2·4·4·5 = hop 320 →
            alias-free snake-beta and conv k3)
          semantic: SeamlessM4T mel features on the host
            (dsp/audio.py::w2v_bert_features, the file's filters and
            window) → feature LN and projection → W2V-BERT conformer
            layers (Shaw relative-key attention, a GLU conv module with a
            causal depthwise k31) → the semantic conv encoder
        concat (semantic first) → fc_prior → project_in → FSQ (levels
        [4]^8, the bound applied twice) → codes [T, 1].

Attention runs through the plain `ops/attn.py::sdpa` (the decoder) and
`sdpa_rel_key` (the conformer): codec_tpu computes both as einsum +
softmax, outside any Pallas kernel, so an XCodec2 request launches none of
the port's kernels (and must not go to `flash_sdpa_window`, which is
causal, windowed and has no relative keys). Float16 depthwise convs (the
FIR's, the conformer's k31) run without cuDNN on the card.

Encoder parameters (`load_x2_encode_params`, `params_from_jax`) keep
PyTorch layouts (linear [out, in], conv [C_out, C_in/groups, K]); a conv
bias the file lacks is None.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.audio import w2v_bert_features
from ..io.gguf import GGUFReader
from ..ops import act, conv, norms
from ..ops.alias_act import alias_free_snake_beta_cf, polyphase_up_taps
from ..ops.attn import sdpa_rel_key
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.perf_log import perf_scope
from . import neucodec
from .neucodec import (NeuConfig, load_neu_params, neu_decode_fn,
                       semantic_convs)

UP_RATIOS = (2, 2, 4, 4, 5)
DILATIONS = (1, 3, 9)
FSQ_LEVEL = 4                        # levels = [4]^codebook_dim


@dataclass(frozen=True)
class X2EncConfig:
    w2v_layers: int = 16
    w2v_hidden: int = 1024
    w2v_heads: int = 16
    w2v_head_dim: int = 64
    w2v_left_max: int = 64
    w2v_right_max: int = 8
    w2v_dw_kernel: int = 31
    w2v_input_dim: int = 160
    w2v_eps: float = 1e-5
    mel_n_fft: int = 512
    mel_win: int = 400
    mel_hop: int = 160
    mel_n_mels: int = 80
    mel_stride: int = 2
    mel_preemphasis: float = 0.97
    mel_floor: float = 1.192092955078125e-7

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "X2EncConfig":
        d = cls()
        return cls(
            w2v_layers=r.get_i32("xcodec2.w2v.layers", d.w2v_layers),
            w2v_hidden=r.get_i32("xcodec2.w2v.hidden", d.w2v_hidden),
            w2v_heads=r.get_i32("xcodec2.w2v.heads", d.w2v_heads),
            w2v_head_dim=r.get_i32("xcodec2.w2v.head_dim", d.w2v_head_dim),
            w2v_left_max=r.get_i32("xcodec2.w2v.left_max_pos", d.w2v_left_max),
            w2v_right_max=r.get_i32("xcodec2.w2v.right_max_pos",
                                    d.w2v_right_max),
            w2v_dw_kernel=r.get_i32("xcodec2.w2v.dw_kernel", d.w2v_dw_kernel),
            w2v_input_dim=r.get_i32("xcodec2.w2v.input_dim", d.w2v_input_dim),
            w2v_eps=r.get_f32("xcodec2.w2v.layer_norm_eps", d.w2v_eps),
            mel_n_fft=r.get_i32("codec.mel.n_fft", d.mel_n_fft),
            mel_win=r.get_i32("codec.mel.win_length", d.mel_win),
            mel_hop=r.get_i32("codec.mel.hop_length", d.mel_hop),
            mel_n_mels=r.get_i32("codec.mel.n_mels", d.mel_n_mels),
            mel_stride=r.get_i32("codec.mel.stride", d.mel_stride),
            mel_preemphasis=r.get_f32("codec.mel.preemphasis",
                                      d.mel_preemphasis),
            mel_floor=r.get_f32("codec.mel.mel_floor", d.mel_floor),
        )


# ---------------------------------------------------------------------------
# Encoder parameters
# ---------------------------------------------------------------------------

_FLAT = (("alias", "enc.alias.filter"), ("conv0_w", "enc.codec.conv0.w"),
         ("final_act_a", "enc.codec.final.act.alpha"),
         ("final_act_ib", "enc.codec.final.act.inv_beta"),
         ("final_w", "enc.codec.final.conv.w"),
         ("fc_prior_w", "enc.fc_prior.w"), ("fc_prior_b", "enc.fc_prior.b"),
         ("proj_in_w", "enc.quant.project_in.w"),
         ("proj_in_b", "enc.quant.project_in.b"),
         ("feat_ln_w", "w2v.feat_ln.w"), ("feat_ln_b", "w2v.feat_ln.b"),
         ("feat_proj_w", "w2v.feat_proj.w"),
         ("feat_proj_b", "w2v.feat_proj.b"),
         ("sem_initial_w", "sem.initial.w"), ("sem_r1_w", "sem.r1.w"),
         ("sem_r1_b", "sem.r1.b"), ("sem_r3_w", "sem.r3.w"),
         ("sem_r3_b", "sem.r3.b"), ("sem_final_w", "sem.final.w"))
_FLAT_OPT = (("conv0_b", "enc.codec.conv0.b"),
             ("final_b", "enc.codec.final.conv.b"))
_UNIT = (("a1_a", "act1.alpha"), ("a1_ib", "act1.inv_beta"),
         ("c1_w", "conv1.w"), ("a2_a", "act2.alpha"),
         ("a2_ib", "act2.inv_beta"), ("c2_w", "conv2.w"))
_UNIT_OPT = (("c1_b", "conv1.b"), ("c2_b", "conv2.b"))
_LN = (("ffn1_ln", "ffn1_ln"), ("attn_ln", "attn_ln"), ("dw_ln", "conv.dw_ln"),
       ("conv_ln", "conv.ln"), ("ffn2_ln", "ffn2_ln"),
       ("final_ln", "final_ln"))
_LIN = (("ffn1_fc1", "ffn1.fc1"), ("ffn1_fc2", "ffn1.fc2"), ("q", "attn.q"),
        ("k", "attn.k"), ("v", "attn.v"), ("o", "attn.o"),
        ("ffn2_fc1", "ffn2.fc1"), ("ffn2_fc2", "ffn2.fc2"))
_CONV = {"conv0_w", "final_w", "sem_initial_w", "sem_r1_w", "sem_r3_w",
         "sem_final_w", "c1_w", "c2_w", "down_w", "pw1_w", "dw_w", "pw2_w"}


def _layer_names():
    """(key, name) of a conformer layer's tensors under xcodec2.w2v.l{i}."""
    out = [("dist", "attn.dist.w")]
    for key, name in _LN + _LIN:
        out += [(key + "_w", name + ".w"), (key + "_b", name + ".b")]
    return out + [("pw1_w", "conv.pw1.w"), ("dw_w", "conv.dw.w"),
                  ("pw2_w", "conv.pw2.w")]


def load_x2_encode_params(r: GGUFReader, cfg: X2EncConfig,
                          dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """The encoder's parameters (xcodec2.enc.*, xcodec2.w2v.*,
    xcodec2.sem.*)."""
    t = partial(neucodec._to, dtype=dtype, device=device)

    def g(n):
        return t(r.get(f"xcodec2.{n}"))

    def gb(n):
        a = r.get_or_none(f"xcodec2.{n}")
        return t(a) if a is not None else None

    p: Dict[str, Any] = {k: g(n) for k, n in _FLAT}
    p.update({k: gb(n) for k, n in _FLAT_OPT})
    p["alias"] = p["alias"].reshape(-1)
    blocks = []
    for bi in range(1, len(UP_RATIOS) + 1):
        base = f"enc.codec.b{bi}"
        units = []
        for ri in range(len(DILATIONS)):
            u = {k: g(f"{base}.r{ri}.{n}") for k, n in _UNIT}
            u.update({k: gb(f"{base}.r{ri}.{n}") for k, n in _UNIT_OPT})
            units.append(u)
        blocks.append({"units": units, "act_a": g(base + ".act.alpha"),
                       "act_ib": g(base + ".act.inv_beta"),
                       "down_w": g(base + ".down.w"),
                       "down_b": gb(base + ".down.b")})
    p["enc_blocks"] = blocks
    p["w2v_layers"] = [{k: g(f"w2v.l{li}.{n}") for k, n in _layer_names()}
                       for li in range(cfg.w2v_layers)]
    p["alias_up"] = polyphase_up_taps(p["alias"])
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu XCodec2 encoder tree (its `load_x2_encode_params`) →
    this module's encoder parameters (its decoder tree goes through
    neucodec.params_from_jax)."""
    t = partial(neucodec._to, dtype=dtype, device=device)

    def leaf(k, v):
        if v is None:
            return None
        return neucodec._conv_from_jax(v, t) if k in _CONV else t(v)

    def tree_map(d):
        return {k: leaf(k, v) for k, v in d.items()}

    p = {k: leaf(k, tree[k]) for k, _ in _FLAT + _FLAT_OPT}
    p["enc_blocks"] = [{**tree_map({k: v for k, v in b.items()
                                    if k != "units"}),
                        "units": [tree_map(u) for u in b["units"]]}
                       for b in tree["enc_blocks"]]
    p["w2v_layers"] = [tree_map(lw) for lw in tree["w2v_layers"]]
    p["alias_up"] = polyphase_up_taps(p["alias"])
    return p


# ---------------------------------------------------------------------------
# Encoder forward
# ---------------------------------------------------------------------------

def _conformer_layer(x: torch.Tensor, lw: Dict[str, torch.Tensor],
                     cfg: X2EncConfig) -> torch.Tensor:
    """A W2V-BERT conformer layer on [B, T, C]: half-step FFN → relative-key
    attention → conv module (LN → pw1 → GLU → causal depthwise k (pad k−1
    on the left) → LN → SiLU → pw2) → half-step FFN → final LN."""
    eps = cfg.w2v_eps

    def ln(v, n):
        return norms.layer_norm(v, lw[n + "_w"], lw[n + "_b"], eps)

    def ffn(v, n):
        h = act.silu(F.linear(ln(v, n + "_ln"), lw[n + "_fc1_w"],
                              lw[n + "_fc1_b"]))
        return F.linear(h, lw[n + "_fc2_w"], lw[n + "_fc2_b"])

    x = x + 0.5 * ffn(x, "ffn1")
    b, t, c = x.shape
    nh, hd = cfg.w2v_heads, cfg.w2v_head_dim
    h = ln(x, "attn_ln")
    q, k, v = (F.linear(h, lw[f"{n}_w"], lw[f"{n}_b"]).reshape(
        b, t, nh, hd).transpose(1, 2) for n in "qkv")
    a = sdpa_rel_key(q, k, v, lw["dist"], cfg.w2v_left_max,
                     cfg.w2v_right_max).transpose(1, 2).reshape(b, t, c)
    x = x + F.linear(a, lw["o_w"], lw["o_b"])
    h = F.glu(F.linear(ln(x, "conv_ln"), lw["pw1_w"][..., 0]), dim=-1)
    hc = F.pad(h.transpose(1, 2), (cfg.w2v_dw_kernel - 1, 0))
    with conv.no_cudnn_for_f16(hc):
        h = F.conv1d(hc, lw["dw_w"], groups=hc.shape[1]).transpose(1, 2)
    h = act.silu(ln(h, "dw_ln"))
    x = x + F.linear(h, lw["pw2_w"][..., 0])
    x = x + 0.5 * ffn(x, "ffn2")
    return ln(x, "final_ln")


def _residual_unit(x: torch.Tensor, u: Dict[str, torch.Tensor],
                   alias: torch.Tensor, up: torch.Tensor,
                   dilation: int) -> torch.Tensor:
    """A BigCodec residual unit, channels-first [B, C, T]: alias-free
    snake-beta → conv k7 at `dilation` → alias-free snake-beta → conv k1 →
    +x."""
    h = alias_free_snake_beta_cf(x, u["a1_a"], u["a1_ib"], alias, up)
    h = F.conv1d(h, u["c1_w"], u["c1_b"], dilation=dilation,
                 padding=3 * dilation)
    h = alias_free_snake_beta_cf(h, u["a2_a"], u["a2_ib"], alias, up)
    return x + F.conv1d(h, u["c2_w"], u["c2_b"])


def x2_acoustic_fn(params: Dict[str, Any], pcm: torch.Tensor) -> torch.Tensor:
    """The BigCodec encoder: pcm [B, n] → [B, n // 320, hidden]."""
    alias, up = params["alias"], params["alias_up"]
    x = F.conv1d(pcm[:, None], params["conv0_w"], params["conv0_b"],
                 padding=3)
    for blk, stride in zip(params["enc_blocks"], UP_RATIOS):
        for u, d in zip(blk["units"], DILATIONS):
            x = _residual_unit(x, u, alias, up, d)
        x = alias_free_snake_beta_cf(x, blk["act_a"], blk["act_ib"], alias,
                                     up)
        x = F.conv1d(x, blk["down_w"], blk["down_b"], stride=stride,
                     padding=stride // 2 + stride % 2)
    x = alias_free_snake_beta_cf(x, params["final_act_a"],
                                 params["final_act_ib"], alias, up)
    return F.conv1d(x, params["final_w"], params["final_b"],
                    padding=1).transpose(1, 2)


def x2_semantic_fn(params: Dict[str, Any], mel: torch.Tensor,
                   cfg: X2EncConfig) -> torch.Tensor:
    """mel [B, T_sem, input_dim] → [B, T_sem, hidden]."""
    h = norms.layer_norm(mel, params["feat_ln_w"], params["feat_ln_b"],
                         cfg.w2v_eps)
    h = F.linear(h, params["feat_proj_w"], params["feat_proj_b"])
    for lw in params["w2v_layers"]:
        h = _conformer_layer(h, lw, cfg)
    return semantic_convs(h, params["sem_initial_w"], params["sem_r1_w"],
                          params["sem_r1_b"], params["sem_r3_w"],
                          params["sem_r3_b"], params["sem_final_w"])


def fsq_bounded(z: torch.Tensor) -> torch.Tensor:
    """vector_quantize_pytorch FSQ's bound for levels [4]^d, applied twice
    (as the reference does), in float32: values in (−2, 1.5)."""
    half_l = (FSQ_LEVEL - 1) * (1.0 + 1e-3) / 2.0
    offset = 0.5
    shift = math.atanh(offset / half_l)

    def bound(x):
        return half_l * torch.tanh(x + shift) - offset

    return bound(bound(z.float()))


def fsq_quantize_x2(z: torch.Tensor, codebook_dim: int) -> torch.Tensor:
    """z [..., d] → int32 mixed-radix codes [...] in [0, 4^d): each bounded
    digit rounded (half to even, as jnp.round), shifted by 2, weighted by
    4^i. Float32 whatever z's dtype (codec_tpu's f32 path; its bf16 one
    bounds in bf16)."""
    zq = torch.round(fsq_bounded(z))
    basis = torch.pow(float(FSQ_LEVEL), torch.arange(
        codebook_dim, dtype=torch.float32, device=z.device))
    return ((zq + FSQ_LEVEL // 2) * basis).sum(-1).to(torch.int32)


def x2_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                        mel: torch.Tensor, n_codes: int,
                        cfg: X2EncConfig) -> torch.Tensor:
    """pcm [B, n], mel [B, T_sem, input_dim] → the FSQ latent [B, n_codes,
    codebook_dim] (before the bound)."""
    ac = x2_acoustic_fn(params, pcm)[:, :n_codes]
    sem = x2_semantic_fn(params, mel, cfg)[:, :n_codes]
    h = F.linear(torch.cat([sem, ac], dim=-1), params["fc_prior_w"],
                 params["fc_prior_b"])
    return F.linear(h, params["proj_in_w"], params["proj_in_b"])


def x2_encode_fn(params: Dict[str, Any], pcm: torch.Tensor, mel: torch.Tensor,
                 n_codes: int, cfg: X2EncConfig,
                 codebook_dim: int) -> torch.Tensor:
    """pcm [B, n], mel [B, T_sem, input_dim] → codes [B, n_codes, 1]
    int32."""
    z = x2_encode_latent_fn(params, pcm, mel, n_codes, cfg)
    return fsq_quantize_x2(z, codebook_dim)[..., None]


class XCodec2(CodecModel):
    arch = "xcodec2"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = NeuConfig.from_gguf(
            reader, prefix="xcodec2",
            sample_rate=16000, hop_size=320, codebook_size=65536,
            codebook_dim=8, vq_dim=2048, hidden_dim=1024, num_layers=12,
            num_heads=16, head_dim=64)
        self.sample_rate = self.cfg.sample_rate
        self.encode_sample_rate = reader.get_i32("codec.encode_sample_rate",
                                                 self.cfg.sample_rate)
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = reader.get_i32("codec.latent_dim", 1024)
        self.has_encoder = reader.get_bool("codec.has_encoder", False)
        self.has_decoder = reader.get_bool("codec.has_decoder", True)
        if self.has_decoder:
            self.params = load_neu_params(reader, self.cfg,
                                          dtype=self.compute_dtype,
                                          device=self.device, prefix="xcodec2")
        if self.has_encoder:
            self.enc_cfg = X2EncConfig.from_gguf(reader)
            self.enc_params = load_x2_encode_params(
                reader, self.enc_cfg, dtype=self.compute_dtype,
                device=self.device)
            self._mel_filters = np.asarray(
                reader.get("xcodec2.enc.mel.filters"), np.float64)
            self._mel_window = np.asarray(
                reader.get("xcodec2.enc.mel.window"), np.float64)

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return neu_decode_fn(self.params, codes, self.cfg)

    def mel(self, row: np.ndarray) -> np.ndarray:
        """One row's SeamlessM4T features on the host [T_sem, input_dim]."""
        ec = self.enc_cfg
        return w2v_bert_features(
            row, n_mels=ec.mel_n_mels, n_fft=ec.mel_n_fft, win=ec.mel_win,
            hop=ec.mel_hop, sr=self.encode_sample_rate,
            preemphasis=ec.mel_preemphasis, mel_floor=ec.mel_floor,
            stride=ec.mel_stride, mel_filters=self._mel_filters,
            window=self._mel_window)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] / [B, n] at encode_sample_rate (float32, or int16) →
        codes int32 [T, 1] / [B, T, 1], T = min(n // 320, the mel frames).
        Each row's mel is computed on the host and encoded on its own."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        if n_q not in (0, 1):
            raise CodecError("xcodec2 encode n_q must be 0 or 1")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        outs = []
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            for row in pcm:
                mel = self.mel(row)
                n_codes = min(len(row) // self.hop_size, mel.shape[0])
                if n_codes <= 0:
                    raise CodecError("xcodec2 encode produced no frames")
                x, m = (torch.from_numpy(np.ascontiguousarray(a[None])).to(
                    self.device, self.compute_dtype) for a in (row, mel))
                with perf_scope("graph_compute", "encode"):
                    codes = x2_encode_fn(self.enc_params, x, m, n_codes,
                                         self.enc_cfg, self.cfg.codebook_dim)
                    outs.append(codes[0].clamp(0, self.codebook_size - 1)
                                .to(torch.int32).cpu().numpy())
        return outs[0] if squeeze else np.stack(outs)
