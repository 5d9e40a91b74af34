"""NeMo Nano Codec (NVIDIA's FSQ codec with HiFi-GAN stacks), encode and
decode, in PyTorch.

Counterpart of codec_tpu/models/nemo_nano.py:

encode: replicate-padded symmetric convs; 5 layers of 3 parallel HiFi-GAN
        residual blocks (kernels 3 / 7 / 11, each 3 units at dilations
        1 / 3 / 5, leaky ReLU 0.01), averaged, then a strided downsample
        (rates 2, 3, 6, 7, 7); FSQ per group (tanh compression, round,
        the mixed-radix index of the digits)
decode: a codebook gather per group; causal convs and ConvTransposes with
        "half-snake" activations (snake on the first half of the channels,
        α clamped at 1e-9; leaky ReLU 0.01 on the rest); the same three
        blocks averaged after each upsample; the output clamped to [-1, 1]

The conv stacks run channels-first [B, C, T] on PyTorch's weight layouts.
The encoder's symmetric padding makes the arch non-causal (`causal_time =
False`): a decode keeps its whole output, an encode of n samples gives
the frames its strided convs give (floor semantics), as codec_tpu's.

Parameters (`load_nemo_params`, `params_from_jax`), conv weights [C_out,
C_in, K], convtr weights [C_in, C_out, K]:
  fsq: scale, out_scale, out_offset, in_shift, dim_base (float32 [d]);
      fsq_cb [n_q, V, d]
  enc_pre, enc_post, enc_down[i]: {"w", "b"}; enc_res[l][b][u]: in, sk
  dec_pre, dec_post: {"w", "b"}; dec_post_a; dec_up[i]: {"w", "b"};
      dec_act[i]; dec_res[l][b][u]: in, sk ({"w", "b"}), in_a, sk_a
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, conv
from ..runtime.model import CodecError, CodecModel

DOWN_RATES = (2, 3, 6, 7, 7)
UP_RATES = (7, 7, 6, 3, 2)
RES_KERNELS = (3, 7, 11)
RES_DILATIONS = (1, 3, 5)
FSQ_KEYS = ("scale", "out_scale", "out_offset", "in_shift", "dim_base")


@dataclass(frozen=True)
class NemoConfig:
    sample_rate: int = 22050
    hop_size: int = 1764
    n_q: int = 4
    codebook_size: int = 4032
    codebook_dim: int = 4
    latent_dim: int = 16
    down_rates: Tuple[int, ...] = DOWN_RATES
    up_rates: Tuple[int, ...] = UP_RATES

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "NemoConfig":
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 22050),
            hop_size=r.get_i32("codec.hop_size", 1764),
            n_q=r.get_i32("codec.n_q", 4),
            codebook_size=r.get_i32("codec.codebook_size", 4032),
            codebook_dim=r.get_i32("codec.codebook_dim", 4),
            latent_dim=r.get_i32("codec.latent_dim", 16),
            down_rates=tuple(r.get_arr("nemo.down_rates", list(DOWN_RATES))),
            up_rates=tuple(r.get_arr("nemo.up_rates", list(UP_RATES))),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_nemo_params(r: GGUFReader, cfg: NemoConfig, dtype=torch.float32,
                     device="cpu") -> Dict[str, Any]:
    """Parameters from a NeMo nano codec GGUF (nemo.* names, PyTorch
    layouts). The FSQ constants stay float32."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(base):
        return {"w": t(r.get(base + ".w")), "b": t(r.get(base + ".b"))}

    def a(name):
        return t(r.get(name).reshape(-1))

    p: Dict[str, Any] = {
        "fsq": {k: _to(r.get(f"nemo.fsq.{k}"), torch.float32, device)
                for k in FSQ_KEYS},
        "fsq_cb": t(np.stack([r.get(f"nemo.fsq.codebook.{g}")
                              for g in range(cfg.n_q)])),
    }
    if r.has_tensor("nemo.enc.pre.w"):
        p["enc_pre"] = wb("nemo.enc.pre")
        p["enc_post"] = wb("nemo.enc.post")
        p["enc_down"] = [wb(f"nemo.enc.down.{i}")
                         for i in range(len(cfg.down_rates))]
        p["enc_res"] = [[[{"in": wb(f"nemo.enc.res.l{li}.b{bi}.r{ri}.in"),
                           "sk": wb(f"nemo.enc.res.l{li}.b{bi}.r{ri}.sk")}
                          for ri in range(len(RES_DILATIONS))]
                         for bi in range(len(RES_KERNELS))]
                        for li in range(len(cfg.down_rates))]
    p["dec_pre"] = wb("nemo.dec.pre")
    p["dec_post"] = wb("nemo.dec.post")
    p["dec_post_a"] = a("nemo.dec.post.a")
    p["dec_up"] = [wb(f"nemo.dec.up.{i}") for i in range(len(cfg.up_rates))]
    p["dec_act"] = [a(f"nemo.dec.act.{i}.a") for i in range(len(cfg.up_rates))]
    p["dec_res"] = [[[{
        "in": wb(f"nemo.dec.res.l{li}.b{bi}.r{ri}.in"),
        "sk": wb(f"nemo.dec.res.l{li}.b{bi}.r{ri}.sk"),
        "in_a": a(f"nemo.dec.res.l{li}.b{bi}.r{ri}.in.a"),
        "sk_a": a(f"nemo.dec.res.l{li}.b{bi}.r{ri}.sk.a")}
        for ri in range(len(RES_DILATIONS))] for bi in range(len(RES_KERNELS))]
        for li in range(len(cfg.up_rates))]
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu NeMo tree (from its `load_nemo_params`; leaves as NumPy
    arrays or anything np.asarray takes) → this module's parameters: conv
    weights from WIO [K, C_in, C_out] and convtr weights from pre-flipped
    WIO back to PyTorch's layouts, the codebooks stacked."""
    t = partial(_to, dtype=dtype, device=device)

    def cv(layer):
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": t(layer["b"])}

    def tr(layer):
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(layer["b"])}

    p: Dict[str, Any] = {
        "fsq": {k: _to(tree["fsq"][k], torch.float32, device)
                for k in FSQ_KEYS},
        "fsq_cb": t(np.stack([np.asarray(c) for c in tree["fsq_cb"]])),
    }
    if "enc_pre" in tree:
        p["enc_pre"], p["enc_post"] = cv(tree["enc_pre"]), cv(tree["enc_post"])
        p["enc_down"] = [cv(d) for d in tree["enc_down"]]
        p["enc_res"] = [[[{"in": cv(u["in"]), "sk": cv(u["sk"])} for u in blk]
                         for blk in layer] for layer in tree["enc_res"]]
    p["dec_pre"], p["dec_post"] = cv(tree["dec_pre"]), cv(tree["dec_post"])
    p["dec_post_a"] = t(tree["dec_post_a"])
    p["dec_up"] = [tr(u) for u in tree["dec_up"]]
    p["dec_act"] = [t(a) for a in tree["dec_act"]]
    p["dec_res"] = [[[{"in": cv(u["in"]), "sk": cv(u["sk"]),
                       "in_a": t(u["in_a"]), "sk_a": t(u["sk_a"])}
                      for u in blk] for blk in layer]
                    for layer in tree["dec_res"]]
    return p


# ---------------------------------------------------------------------------
# Forward (channels-first [B, C, T])
# ---------------------------------------------------------------------------

def _rep_conv(x: torch.Tensor, layer: Dict[str, torch.Tensor], stride: int = 1,
              dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Replicate-padded symmetric conv."""
    if padding > 0:
        x = F.pad(x, (padding, padding), mode="replicate")
    return F.conv1d(x, layer["w"], layer["b"], stride=stride,
                    dilation=dilation)


def _half_snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake (α clamped at 1e-9) on the first half of the channels, leaky
    ReLU 0.01 on the rest."""
    half = x.shape[1] // 2
    a, xl = torch.clamp(alpha, min=1e-9)[:, None], x[:, :half]
    left = xl + torch.sin(a * xl) ** 2 / (a + 1e-9)           # act.snake
    return torch.cat([left, act.leaky_relu(x[:, half:], 0.01)], dim=1)


def fsq_encode(x: torch.Tensor, fsq: Dict[str, torch.Tensor], n_q: int,
               d: int) -> torch.Tensor:
    """x [B, T, n_q*d] → codes [B, T, n_q] int32, in float32."""
    b, t, _ = x.shape
    xg = x.reshape(b, t, n_q, d).float()
    x1 = torch.tanh(xg + fsq["in_shift"]) * fsq["out_scale"] - fsq["out_offset"]
    idx = torch.sum((torch.round(x1) + fsq["scale"]) * fsq["dim_base"], dim=-1)
    return idx.to(torch.int32)


def nemo_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                   cfg: NemoConfig) -> torch.Tensor:
    """codes [B, T, n_q] int → pcm [B, T*hop] in [-1, 1]."""
    codes = codes.clamp(0, cfg.codebook_size - 1)
    x = torch.cat([params["fsq_cb"][g][codes[..., g]]
                   for g in range(cfg.n_q)], dim=-1).transpose(1, 2)
    x = conv.conv1d_causal_cf(x, params["dec_pre"]["w"], params["dec_pre"]["b"])
    for li, stride in enumerate(cfg.up_rates):
        x = _half_snake(x, params["dec_act"][li])
        x = conv.convtr1d_causal_cf(x, params["dec_up"][li]["w"],
                                    params["dec_up"][li]["b"], stride=stride)
        acc = None
        for blk in params["dec_res"][li]:
            xb = x
            for u, dil in zip(blk, RES_DILATIONS):
                h = conv.conv1d_causal_cf(_half_snake(xb, u["in_a"]),
                                          u["in"]["w"], u["in"]["b"],
                                          dilation=dil)
                xb = xb + conv.conv1d_causal_cf(_half_snake(h, u["sk_a"]),
                                                u["sk"]["w"], u["sk"]["b"])
            acc = xb if acc is None else acc + xb
        x = acc / 3.0
    x = _half_snake(x, params["dec_post_a"])
    x = conv.conv1d_causal_cf(x, params["dec_post"]["w"],
                              params["dec_post"]["b"])
    return torch.clamp(x[:, 0], -1.0, 1.0)


def nemo_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                          cfg: NemoConfig) -> torch.Tensor:
    """pcm [B, n] → the FSQ input [B, T, n_q*d] (before the bound)."""
    x = _rep_conv(pcm[:, None], params["enc_pre"],
                  padding=params["enc_pre"]["w"].shape[-1] // 2)
    for li, stride in enumerate(cfg.down_rates):
        acc = None
        for k, blk in zip(RES_KERNELS, params["enc_res"][li]):
            xb = x
            for u, dil in zip(blk, RES_DILATIONS):
                h = _rep_conv(act.leaky_relu(xb, 0.01), u["in"], dilation=dil,
                              padding=(k * dil - dil) // 2)
                xb = xb + _rep_conv(act.leaky_relu(h, 0.01), u["sk"],
                                    padding=k // 2)
            acc = xb if acc is None else acc + xb
        x = act.leaky_relu(acc / 3.0, 0.01)
        x = _rep_conv(x, params["enc_down"][li], stride=stride,
                      padding=(2 * stride - stride + 1) // 2)
    x = act.leaky_relu(x, 0.01)
    x = _rep_conv(x, params["enc_post"],
                  padding=params["enc_post"]["w"].shape[-1] // 2)
    return x.transpose(1, 2)


def encode_frames(cfg: NemoConfig, n: int) -> int:
    """The frames an encode of n samples gives (each strided replicate
    conv's floor), or 0 where a stage is left with too few samples for its
    kernel, where codec_tpu's encode fails."""
    for s in cfg.down_rates:
        pad = (s + 1) // 2
        if n < 1 or n + 2 * pad < 2 * s:
            return 0
        n = (n + 2 * pad - 2 * s) // s + 1
    return n


def nemo_encode_fn(params: Dict[str, Any], pcm: torch.Tensor,
                   cfg: NemoConfig) -> torch.Tensor:
    """pcm [B, n] → codes [B, T, n_q] int32."""
    return fsq_encode(nemo_encode_latent_fn(params, pcm, cfg), params["fsq"],
                      cfg.n_q, cfg.codebook_dim)


class NemoNanoCodec(CodecModel):
    arch = "nemo_nano_codec"
    causal_time = False         # the encoder pads symmetrically

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = NemoConfig.from_gguf(reader)
        self.params = load_nemo_params(reader, self.cfg,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.latent_dim
        self.has_encoder = "enc_pre" in self.params
        self.has_decoder = True

    def _use_nq(self, n_q: int, have: int) -> int:
        """A decode reads every FSQ group: n_q 0 or n_q, codes with all
        groups. (codec_tpu's reads group 0 in place of each missing one.)"""
        if n_q not in (0, self.n_q) or have < self.n_q:
            raise CodecError(f"{self.arch}: a decode reads all {self.n_q} "
                             f"FSQ groups, got n_q={n_q} over {have}")
        return self.n_q

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return nemo_decode_fn(self.params, codes, self.cfg)

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        """Every FSQ group whatever n_q asks, as codec_tpu's encode."""
        if encode_frames(self.cfg, pcm.shape[1]) < 1:
            raise CodecError(f"{self.arch}: {pcm.shape[1]} samples are too "
                             f"short to encode")
        return nemo_encode_fn(self.params, pcm, self.cfg)
