"""Pocket-Mimi (the continuous-latent Mimi of Pocket-TTS), latent decode and
encode, whole or streamed, in PyTorch.

Counterpart of codec_tpu/models/pocket_mimi.py: a 32-dim latent at 12.5 Hz
↔ 24 kHz PCM.

decode: 1x1 out_proj (32 → 512, no bias) → the k32 stride-16 causal
        ConvTranspose (depthwise, stored dense, no bias) → a 2-layer
        transformer at 200 Hz (LayerNorm, RoPE NORMAL, causal attention over
        a 250-frame window, GELU-erf MLP, LayerScale) → the causal SEANet
        decoder (ConvTranspose strides 6, 5, 4) → PCM, not clamped
encode: the causal SEANet encoder (strides 4, 5, 6), frames past the true
        length zeroed before each strided conv → transformer → frames past
        it replaced by the last true one → the stride-16 causal downsample
        (replicate padding, no bias) → latent mu

The transformers are Mimi's with RoPE NORMAL (models/mimi.py::_transformer
and _transformer_stream, `neox=False`), so every layer launches
`flash_sdpa_window` on the card. Chunked decode (`PocketStreamingDecoder`,
the realtime-TTS vocoder) gives what decode_latent gives for the whole
stream.

Parameters (`load_pocket_params`, `params_from_jax`; conv weights [C_out,
C_in, K], convtr weights [C_in, C_out, K], linear weights [out, in]):
  decoder: out_proj, upsample, dec {l0, stages[i] {tr, c1, c2}, l11}, each
      {"w", "b" (or None)}; dtr: per layer Mimi's keys (mimi._LAYER_KEYS)
  encoder: enc {l0, stages[i] {c1, c2, dn}, l11}; etr; downsample
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, conv
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.session import StreamSession
from .mimi import (_LAYER_KEYS, MimiConfig, _conv_carry, _convtr_carry,
                   _kv_carry, _resblock, _resblock_stream, _transformer,
                   _transformer_stream)

_NO_CODES_DECODE = "Pocket-Mimi is a continuous-latent codec; use decode_latent"
_NO_CODES_ENCODE = ("Pocket-Mimi encode produces a continuous latent; use "
                    "encode_latent")
_DEC_LAYERS = (2, 5, 8)          # wire names of the decoder's ConvTransposes
_ENC_LAYERS = (3, 6, 9)          # and of the encoder's strided convs
# codec_tpu's per-layer transformer keys → Mimi's (models/mimi.py)
_JAX_LAYER_KEYS = {"fc1": "fc1_w", "fc2": "fc2_w", "sa": "sa_scale",
                   "mlp": "mlp_scale"}


@dataclass(frozen=True)
class PocketMimiConfig:
    sample_rate: int = 24000
    hop_size: int = 1920
    latent_dim: int = 32
    outer_dim: int = 512
    tf_layers: int = 2
    tf_heads: int = 8
    tf_head_dim: int = 64
    tf_context: int = 250
    tf_max_period: float = 10000.0
    decoder_ratios: Tuple[int, ...] = (6, 5, 4)
    encoder_ratios: Tuple[int, ...] = (4, 5, 6)
    resample_stride: int = 16
    has_encoder: bool = True
    has_decoder: bool = True

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "PocketMimiConfig":
        hop = r.get_i32("codec.hop_size", 1920)
        dec_ratios = tuple(int(v) for v in
                           r.get_arr("pocket_mimi.decoder_ratios", [6, 5, 4]))
        prod = int(np.prod(dec_ratios)) if dec_ratios else 0
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=hop,
            latent_dim=r.get_i32("codec.latent_dim", 32),
            outer_dim=r.get_i32("pocket_mimi.outer_dim", 512),
            tf_layers=r.get_i32("pocket_mimi.tf_layers", 2),
            tf_heads=r.get_i32("pocket_mimi.tf_heads", 8),
            tf_head_dim=r.get_i32("pocket_mimi.tf_head_dim", 64),
            tf_context=r.get_i32("pocket_mimi.tf_context", 250),
            tf_max_period=r.get_f32("pocket_mimi.tf_max_period", 10000.0),
            decoder_ratios=dec_ratios,
            encoder_ratios=tuple(int(v) for v in r.get_arr(
                "pocket_mimi.encoder_ratios", [4, 5, 6])),
            resample_stride=hop // prod if prod > 0 else 16,
            has_encoder=r.get_bool("codec.has_encoder", True),
            has_decoder=r.get_bool("codec.has_decoder", True),
        )

    def transformer(self) -> MimiConfig:
        """The transformers' config as models/mimi.py reads it."""
        return MimiConfig(hidden=self.outer_dim, n_layers=self.tf_layers,
                          n_heads=self.tf_heads, head_dim=self.tf_head_dim,
                          rope_theta=self.tf_max_period, norm_eps=1e-5,
                          window=self.tf_context if self.tf_context > 0
                          else None)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_pocket_params(r: GGUFReader, cfg: PocketMimiConfig,
                       dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Parameters from a Pocket-Mimi GGUF (pocket_mimi.* names, PyTorch
    layouts): the decoder half where cfg.has_decoder, the encoder half
    where cfg.has_encoder and the file holds it."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(name):
        b = r.get_or_none(f"pocket_mimi.{name}.b")
        return {"w": t(r.get(f"pocket_mimi.{name}.w")),
                "b": t(b) if b is not None else None}

    def layers(prefix):
        return [{key: t(r.get(f"pocket_mimi.{prefix}.l{li}.{suffix}"))
                 for key, suffix in _LAYER_KEYS.items()}
                for li in range(cfg.tf_layers)]

    p: Dict[str, Any] = {}
    if cfg.has_decoder:
        p["out_proj"] = wb("quant.out_proj")
        p["upsample"] = wb("upsample")
        p["dtr"] = layers("dtr")
        p["dec"] = {"l0": wb("dec.l0"),
                    "stages": [{"tr": wb(f"dec.l{li}"),
                                "c1": wb(f"dec.r{si}.c1"),
                                "c2": wb(f"dec.r{si}.c2")}
                               for si, li in enumerate(_DEC_LAYERS)],
                    "l11": wb("dec.l11")}
    if cfg.has_encoder and r.has_tensor("pocket_mimi.enc.l0.w"):
        p["enc"] = {"l0": wb("enc.l0"),
                    "stages": [{"c1": wb(f"enc.r{si}.c1"),
                                "c2": wb(f"enc.r{si}.c2"),
                                "dn": wb(f"enc.l{li}")}
                               for si, li in enumerate(_ENC_LAYERS)],
                    "l11": wb("enc.l11")}
        p["etr"] = layers("etr")
        p["downsample"] = {"w": t(r.get("pocket_mimi.downsample.w")),
                           "b": None}
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu Pocket-Mimi parameter tree (from its
    `load_pocket_params`; leaves as NumPy arrays or anything np.asarray
    takes) → this module's parameters: conv weights from WIO [K, C_in,
    C_out] and convtr weights from pre-flipped WIO back to PyTorch's
    layouts, the transformer layers under Mimi's keys."""
    t = partial(_to, dtype=dtype, device=device)

    def cv(layer):
        b = layer["b"]
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": t(b) if b is not None else None}

    def tr(layer):
        b = layer["b"]
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(b) if b is not None else None}

    def layers(stack):
        return [{_JAX_LAYER_KEYS.get(k, k): t(v) for k, v in lw.items()}
                for lw in stack]

    p: Dict[str, Any] = {}
    if "dec" in tree:
        d = tree["dec"]
        p["out_proj"] = cv(tree["out_proj"])
        p["upsample"] = tr(tree["upsample"])
        p["dtr"] = layers(tree["dtr"])
        p["dec"] = {"l0": cv(d["l0"]),
                    "stages": [{"tr": tr(s["tr"]), "c1": cv(s["c1"]),
                                "c2": cv(s["c2"])} for s in d["stages"]],
                    "l11": cv(d["l11"])}
    if "enc" in tree:
        e = tree["enc"]
        p["enc"] = {"l0": cv(e["l0"]),
                    "stages": [{k: cv(s[k]) for k in ("c1", "c2", "dn")}
                               for s in e["stages"]],
                    "l11": cv(e["l11"])}
        p["etr"] = layers(tree["etr"])
        p["downsample"] = cv(tree["downsample"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def pocket_decode_latent_fn(params: Dict[str, Any], latent: torch.Tensor,
                            cfg: PocketMimiConfig,
                            attention: Optional[Callable] = None
                            ) -> torch.Tensor:
    """latent [B, T, latent_dim] on the parameters' device → pcm [B,
    T*hop]. `attention` replaces the transformer's causal attention
    function (default: the CUDA kernel's wrapper; see ops/attn.mha)."""
    x = F.linear(latent, params["out_proj"]["w"][:, :, 0])
    x = conv.convtr1d_causal_cf(x.transpose(1, 2), params["upsample"]["w"],
                                None, stride=cfg.resample_stride)
    x = _transformer(x.transpose(1, 2), params["dtr"], cfg.transformer(),
                     attention, neox=False)
    x = x.transpose(1, 2).contiguous()                       # [B, C, T]
    d = params["dec"]
    x = conv.conv1d_causal_cf(x, d["l0"]["w"], d["l0"]["b"])
    for stage, stride in zip(d["stages"], cfg.decoder_ratios):
        x = conv.convtr1d_causal_cf(act.elu(x), stage["tr"]["w"],
                                    stage["tr"]["b"], stride=stride)
        x = _resblock(x, stage["c1"], stage["c2"])
    x = conv.conv1d_causal_cf(act.elu(x), d["l11"]["w"], d["l11"]["b"])
    return x[:, 0]


def pocket_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                            cfg: PocketMimiConfig,
                            n_valid: Optional[int] = None,
                            attention: Optional[Callable] = None
                            ) -> torch.Tensor:
    """pcm [B, n] (n a hop multiple, zero-padded past the n_valid true
    samples) → latent mu [B, n/hop, latent_dim].

    The valid length v is carried stage by stage (v = ceil(v / stride)):
    before each strided conv the frames t >= v are zeroed, and after the
    transformer they are replaced by frame v - 1, before the downsample
    (replicate padding). `attention` as in pocket_decode_latent_fn."""
    v = pcm.shape[-1] if n_valid is None else n_valid
    e = params["enc"]
    x = conv.conv1d_causal_cf(pcm[:, None, :], e["l0"]["w"], e["l0"]["b"])
    for stage, stride in zip(e["stages"], cfg.encoder_ratios):
        x = act.elu(_resblock(x, stage["c1"], stage["c2"]))
        x[..., v:] = 0
        x = conv.conv1d_causal_cf(x, stage["dn"]["w"], stage["dn"]["b"],
                                  stride=stride)
        v = -(-v // stride)
    x = conv.conv1d_causal_cf(act.elu(x), e["l11"]["w"], e["l11"]["b"])
    x = _transformer(x.transpose(1, 2), params["etr"], cfg.transformer(),
                     attention, neox=False)
    if v < x.shape[1]:
        x = torch.cat([x[:, :v], x[:, v - 1:v].expand(
            -1, x.shape[1] - v, -1)], dim=1)
    x = conv.conv1d_causal_cf(x.transpose(1, 2), params["downsample"]["w"],
                              None, stride=cfg.resample_stride,
                              pad_mode="replicate")
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# Streaming (chunked) latent decode: the realtime-TTS vocoder direction. A
# FlowLM emits one latent frame per 80 ms; pushing each through this path
# gives first audio after one step. The state is a dict of tensors on the
# parameters' device (the conv carries of ops/conv.py's stream forms, a KV
# carry per layer [2, B, H, W-1, D]) plus "pos", the transformer frames
# seen so far, a host int.
# ---------------------------------------------------------------------------

def pocket_decode_stream_init(params: Dict[str, Any], cfg: PocketMimiConfig,
                              batch: int = 1) -> Dict[str, Any]:
    """The zero state of a chunked decode, on the parameters' device in
    their dtype."""
    d = params["dec"]
    return {
        "pos": 0,
        "up": _convtr_carry(params["upsample"], batch, cfg.resample_stride),
        "kv": _kv_carry(params["dtr"], cfg.transformer(), batch),
        "l0": _conv_carry(d["l0"], batch),
        "stages": [{"tr": _convtr_carry(s["tr"], batch, st),
                    "r1": _conv_carry(s["c1"], batch),
                    "r2": _conv_carry(s["c2"], batch)}
                   for s, st in zip(d["stages"], cfg.decoder_ratios)],
        "l11": _conv_carry(d["l11"], batch),
    }


def pocket_decode_stream_step(params: Dict[str, Any], state: Dict[str, Any],
                              latent: torch.Tensor, cfg: PocketMimiConfig,
                              attention: Optional[Callable] = None):
    """latent [B, Tc, latent_dim] on the parameters' device → (pcm [B,
    Tc*hop], the new state). Each layer attends its 16·Tc queries to the
    W-1 carried keys and its own through `attention(q, k, v, window=,
    k_start=)` (default `flash_sdpa_window`; models/mimi.py::
    _transformer_stream)."""
    d = params["dec"]
    x = F.linear(latent, params["out_proj"]["w"][:, :, 0])
    ns: Dict[str, Any] = {"stages": []}
    x, ns["up"] = conv.convtr1d_causal_stream_cf(
        x.transpose(1, 2), params["upsample"]["w"], None, state["up"],
        stride=cfg.resample_stride)
    x, ns["kv"] = _transformer_stream(x.transpose(1, 2), params["dtr"],
                                      cfg.transformer(), state["kv"],
                                      state["pos"], attention, neox=False)
    ns["pos"] = state["pos"] + x.shape[1]
    x = x.transpose(1, 2).contiguous()                       # [B, C, T]
    x, ns["l0"] = conv.conv1d_causal_stream_cf(x, d["l0"]["w"], d["l0"]["b"],
                                               state["l0"])
    for st, stage, stride in zip(state["stages"], d["stages"],
                                 cfg.decoder_ratios):
        x, tr = conv.convtr1d_causal_stream_cf(
            act.elu(x), stage["tr"]["w"], stage["tr"]["b"], st["tr"],
            stride=stride)
        x, nst = _resblock_stream(x, stage["c1"], stage["c2"], st)
        ns["stages"].append({"tr": tr, **nst})
    x, ns["l11"] = conv.conv1d_causal_stream_cf(
        act.elu(x), d["l11"]["w"], d["l11"]["b"], state["l11"])
    return x[:, 0], ns


class PocketMimiCodec(CodecModel):
    arch = "pocket_mimi"

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = PocketMimiConfig.from_gguf(reader)
        self.params = load_pocket_params(reader, self.cfg,
                                         dtype=self.compute_dtype,
                                         device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.latent_dim = self.cfg.latent_dim
        self.n_q = 0
        self.has_encoder = "enc" in self.params
        self.has_decoder = "dec" in self.params

    def decode(self, codes, n_q: int = 0, pcm_format: str = "f32"):
        raise CodecError(_NO_CODES_DECODE)

    def encode(self, pcm, n_q: int = 0):
        raise CodecError(_NO_CODES_ENCODE)

    def decode_latent(self, latent, pcm_format: str = "f32") -> np.ndarray:
        """latent [T, latent_dim] or [B, T, latent_dim] → pcm [T*hop] or
        [B, T*hop] on the host; float32, or int16 with pcm_format="i16"."""
        if not self.has_decoder:
            raise CodecError("pocket_mimi: model has no decoder")
        latent = np.asarray(latent, dtype=np.float32)
        squeeze = latent.ndim == 2
        if squeeze:
            latent = latent[None]
        if latent.ndim != 3 or latent.shape[1] == 0:
            raise CodecError(f"bad latent shape {latent.shape}: want [T, "
                             f"{self.latent_dim}] or [B, T, "
                             f"{self.latent_dim}]")
        if latent.shape[-1] != self.cfg.latent_dim:
            raise CodecError(f"latent_dim mismatch: {latent.shape[-1]} != "
                             f"{self.cfg.latent_dim}")
        z = torch.from_numpy(latent).to(self.device, self.compute_dtype)
        out = self._run_on_device(
            lambda: pocket_decode_latent_fn(self.params, z, self.cfg),
            pcm_format)
        return out[0] if squeeze else out

    def encode_latent(self, pcm) -> np.ndarray:
        """pcm [n] or [B, n], float in [-1, 1] or int16 → latent mu
        [ceil(n/hop), latent_dim] or [B, ...] float32 on the host. The PCM
        is zero-padded to a hop multiple here; the encoder masks past the
        n true samples. TF32 off when the model encodes exactly."""
        if not self.has_encoder:
            raise CodecError("pocket_mimi: model has no encoder")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        if pcm.ndim != 2 or pcm.shape[1] == 0:
            raise CodecError(f"bad pcm shape {pcm.shape}")
        n = pcm.shape[1]
        pad = -(-n // self.hop_size) * self.hop_size - n
        x = torch.from_numpy(np.ascontiguousarray(
            np.pad(pcm, ((0, 0), (0, pad))) if pad else pcm))
        with torch.inference_mode(), f32_precision(self.exact_encode):
            mu = pocket_encode_latent_fn(
                self.params, x.to(self.device, self.compute_dtype), self.cfg,
                n_valid=n)
            mu = self._host(mu.float())
        return mu[0] if squeeze else mu

    def streaming_decoder(self, batch: int = 1) -> "PocketStreamingDecoder":
        """Open a latent-streaming vocoder session (its chunks' PCM is what
        decode_latent gives for the whole stream)."""
        if not self.has_decoder:
            raise CodecError("pocket_mimi: model has no decoder")
        return PocketStreamingDecoder(self, batch=batch)


class PocketStreamingDecoder(StreamSession):
    """Push latent frames, receive their PCM at once. Each push is one step
    of pocket_decode_stream_step on the model's device (2 launches of the
    attention kernel at full width), under inference mode with TF32 off
    for f32."""

    def __init__(self, model: PocketMimiCodec, batch: int = 1):
        super().__init__(model, batch, pocket_decode_stream_init)

    def push(self, latent) -> np.ndarray:
        """latent [Tc, latent_dim] or [B, Tc, latent_dim] → pcm [Tc*hop] or
        [B, Tc*hop] float32 on the host."""
        m = self.model
        latent, squeeze = self._batched(np.asarray(latent, np.float32), 3,
                                        "latent")
        if latent.shape[1] == 0 or latent.shape[2] != m.latent_dim:
            raise CodecError(f"bad latent shape {latent.shape}: want "
                             f"[B, Tc >= 1, {m.latent_dim}]")
        z = torch.from_numpy(np.ascontiguousarray(latent))
        with torch.inference_mode(), \
                f32_precision(m.compute_dtype == torch.float32):
            pcm, self.state = pocket_decode_stream_step(
                m.params, self.state, z.to(m.device, m.compute_dtype), m.cfg)
            pcm = pcm.float().cpu().numpy()
        return pcm[0] if squeeze else pcm
