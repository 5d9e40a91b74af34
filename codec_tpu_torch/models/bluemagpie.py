"""BlueMagpie / VoxCPM2 AudioVAE V2, a continuous-latent VAE codec, in
PyTorch.

Counterpart of codec_tpu/models/bluemagpie.py:

decode_latent: latent [T, 64] → a causal depthwise conv and a 1x1 → 6
        causal decoder blocks (rates 8, 6, 5, 2, 2, 2; each a per-channel
        scale and bias (the 48 kHz sample-rate conditioning the converter
        bakes), snake, a ConvTranspose cropped by 2·⌈s/2⌉ − (s mod 2)
        samples at its end, 3 residual units at dilations 1 / 3 / 9) →
        snake → causal conv → tanh → 48 kHz PCM
encode_latent: 16 kHz PCM → causal conv → 4 causal encoder blocks (3
        units, snake, a strided causal conv; rates from the file) → fc_mu,
        a causal conv → the latent mean (no codes: n_q = 0)

A residual unit is snake → causal depthwise dilated k7 conv → snake → 1x1
conv → + x: SNAC's depthwise unit with a causal halo instead of a
symmetric one, so the port's snac_res_chain kernel does not compute it;
it runs on plain ops (the float16 depthwise conv without cuDNN on the
card: conv.no_cudnn_for_f16). The conv stacks run channels-first [B, C,
T] on PyTorch's weight layouts.

Parameters (`load_bm_params`, `params_from_jax`), conv weights [C_out,
C_in/groups, K], convtr weights [C_in, C_out, K], each {"w", "b"} with b
None where the file has none:
  dec_in_dw, dec_in_pw, dec_out; dec_act_final; dec_blocks: per block
      cond_scale, cond_bias, act, tr, units
  enc0, fc_mu; enc_blocks: per block units, act, down
  units: per unit a1, c1, a2, c2
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import conv
from ..runtime.model import CodecError, CodecModel, f32_precision

RES_DILATIONS = (1, 3, 9)


@dataclass(frozen=True)
class BmVaeConfig:
    sample_rate: int = 48000
    encode_sample_rate: int = 16000
    latent_dim: int = 64
    decode_hop: int = 1920
    encode_hop: int = 640
    decoder_rates: Tuple[int, ...] = (8, 6, 5, 2, 2, 2)
    encoder_rates: Tuple[int, ...] = (4, 4, 5, 8)

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "BmVaeConfig":
        dr = [int(v) for v in r.get_arr("bluemagpie.decoder_rates",
                                        [8, 6, 5, 2, 2, 2]) if int(v) > 0]
        er = [int(v) for v in r.get_arr("bluemagpie.encoder_rates",
                                        [4, 4, 5, 8]) if int(v) > 0]
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 48000),
            encode_sample_rate=r.get_i32("codec.encode_sample_rate", 16000),
            latent_dim=r.get_i32("codec.latent_dim", 64),
            decode_hop=r.get_i32("codec.decode_hop_size", 1920),
            encode_hop=r.get_i32("codec.hop_size", 640),
            decoder_rates=tuple(dr),
            encoder_rates=tuple(er),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_bm_params(r: GGUFReader, cfg: BmVaeConfig, dtype=torch.float32,
                   device="cpu") -> Dict[str, Any]:
    """Parameters from a BlueMagpie GGUF (bluemagpie.* names, PyTorch
    layouts); the decoder's and the encoder's where the file holds them."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(base):
        b = r.get_or_none(base + ".b")
        return {"w": t(r.get(base + ".w")),
                "b": t(b) if b is not None else None}

    def a(name):
        return t(r.get(name).reshape(-1))

    def units(base):
        return [{"a1": a(f"{base}.r{ri}.act1.alpha"),
                 "c1": wb(f"{base}.r{ri}.conv1"),
                 "a2": a(f"{base}.r{ri}.act2.alpha"),
                 "c2": wb(f"{base}.r{ri}.conv2")}
                for ri in range(len(RES_DILATIONS))]

    p: Dict[str, Any] = {}
    if r.has_tensor("bluemagpie.dec.conv_in_dw.w"):
        p["dec_in_dw"] = wb("bluemagpie.dec.conv_in_dw")
        p["dec_in_pw"] = wb("bluemagpie.dec.conv_in_pw")
        p["dec_blocks"] = [{
            "cond_scale": a(f"bluemagpie.dec.b{bi}.cond.scale"),
            "cond_bias": a(f"bluemagpie.dec.b{bi}.cond.bias"),
            "act": a(f"bluemagpie.dec.b{bi}.act.alpha"),
            "tr": wb(f"bluemagpie.dec.b{bi}.convtr"),
            "units": units(f"bluemagpie.dec.b{bi}"),
        } for bi in range(len(cfg.decoder_rates))]
        p["dec_act_final"] = a("bluemagpie.dec.act_final.alpha")
        p["dec_out"] = wb("bluemagpie.dec.conv_out")
    if r.has_tensor("bluemagpie.enc.conv0.w"):
        p["enc0"] = wb("bluemagpie.enc.conv0")
        p["enc_blocks"] = [{
            "units": units(f"bluemagpie.enc.b{bi}"),
            "act": a(f"bluemagpie.enc.b{bi}.act.alpha"),
            "down": wb(f"bluemagpie.enc.b{bi}.down"),
        } for bi in range(1, len(cfg.encoder_rates) + 1)]
        p["fc_mu"] = wb("bluemagpie.enc.fc_mu")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu BlueMagpie tree (from its `load_bm_params`; leaves as
    NumPy arrays or anything np.asarray takes) → this module's parameters:
    conv weights from WIO [K, C_in/groups, C_out] and convtr weights from
    pre-flipped WIO back to PyTorch's layouts."""
    t = partial(_to, dtype=dtype, device=device)

    def opt(b):
        return t(b) if b is not None else None

    def cv(layer):
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": opt(layer["b"])}

    def tr(layer):
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": opt(layer["b"])}

    def units(us):
        return [{"a1": t(u["a1"]), "c1": cv(u["c1"]), "a2": t(u["a2"]),
                 "c2": cv(u["c2"])} for u in us]

    p: Dict[str, Any] = {}
    if "dec_in_dw" in tree:
        p["dec_in_dw"], p["dec_in_pw"] = cv(tree["dec_in_dw"]), cv(tree["dec_in_pw"])
        p["dec_blocks"] = [{"cond_scale": t(b["cond_scale"]),
                            "cond_bias": t(b["cond_bias"]),
                            "act": t(b["act"]), "tr": tr(b["tr"]),
                            "units": units(b["units"])}
                           for b in tree["dec_blocks"]]
        p["dec_act_final"] = t(tree["dec_act_final"])
        p["dec_out"] = cv(tree["dec_out"])
    if "enc0" in tree:
        p["enc0"] = cv(tree["enc0"])
        p["enc_blocks"] = [{"units": units(b["units"]), "act": t(b["act"]),
                            "down": cv(b["down"])} for b in tree["enc_blocks"]]
        p["fc_mu"] = cv(tree["fc_mu"])
    return p


# ---------------------------------------------------------------------------
# Forward (channels-first [B, C, T])
# ---------------------------------------------------------------------------

def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """act.snake over channels-first x: x + sin²(αx)/(α + 1e-9)."""
    a = alpha[:, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _depthwise_causal(x: torch.Tensor, layer: Dict[str, torch.Tensor],
                      dilation: int = 1) -> torch.Tensor:
    """A causal depthwise conv (float16 on the card without cuDNN)."""
    with conv.no_cudnn_for_f16(x):
        return conv.conv1d_causal_cf(x, layer["w"], layer["b"],
                                     dilation=dilation, groups=x.shape[1])


def _unit(x: torch.Tensor, u: Dict[str, Any], dilation: int) -> torch.Tensor:
    """snake → causal depthwise dilated conv → snake → 1x1 → + x."""
    h = _depthwise_causal(_snake(x, u["a1"]), u["c1"], dilation)
    return x + F.conv1d(_snake(h, u["a2"]), u["c2"]["w"], u["c2"]["b"])


def _units(x: torch.Tensor, units: List[Dict[str, Any]]) -> torch.Tensor:
    for u, d in zip(units, RES_DILATIONS):
        x = _unit(x, u, d)
    return x


def bm_decode_latent_fn(params: Dict[str, Any], latent: torch.Tensor,
                        cfg: BmVaeConfig) -> torch.Tensor:
    """latent [B, T, latent_dim] → pcm [B, T*decode_hop] in [-1, 1]."""
    x = _depthwise_causal(latent.transpose(1, 2), params["dec_in_dw"])
    x = F.conv1d(x, params["dec_in_pw"]["w"], params["dec_in_pw"]["b"])
    for blk, stride in zip(params["dec_blocks"], cfg.decoder_rates):
        x = x * blk["cond_scale"][:, None] + blk["cond_bias"][:, None]
        y = F.conv_transpose1d(_snake(x, blk["act"]), blk["tr"]["w"],
                               blk["tr"]["b"], stride=stride)
        crop = 2 * ((stride + 1) // 2) - (stride % 2)
        x = _units(y[..., : y.shape[-1] - crop], blk["units"])
    x = _snake(x, params["dec_act_final"])
    x = conv.conv1d_causal_cf(x, params["dec_out"]["w"],
                              params["dec_out"]["b"])
    return torch.tanh(x[:, 0])


def bm_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                        cfg: BmVaeConfig) -> torch.Tensor:
    """pcm [B, n] (a multiple of the encode hop) → mu [B, n/encode_hop,
    latent_dim]."""
    x = conv.conv1d_causal_cf(pcm[:, None], params["enc0"]["w"],
                              params["enc0"]["b"])
    for blk, stride in zip(params["enc_blocks"], cfg.encoder_rates):
        x = _snake(_units(x, blk["units"]), blk["act"])
        x = conv.conv1d_causal_cf(x, blk["down"]["w"], blk["down"]["b"],
                                  stride=stride)
    return conv.conv1d_causal_cf(x, params["fc_mu"]["w"],
                                 params["fc_mu"]["b"]).transpose(1, 2)


class BlueMagpieAudioVAE(CodecModel):
    arch = "bluemagpie_audiovae"

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = BmVaeConfig.from_gguf(reader)
        self.params = load_bm_params(reader, self.cfg,
                                     dtype=self.compute_dtype,
                                     device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.encode_sample_rate = self.cfg.encode_sample_rate
        self.hop_size = self.cfg.decode_hop
        self.latent_dim = self.cfg.latent_dim
        self.n_q = 0
        self.has_encoder = "enc0" in self.params
        self.has_decoder = "dec_in_dw" in self.params

    def decode(self, codes, n_q: int = 0, pcm_format: str = "f32"):
        raise CodecError("BlueMagpie-AudioVAE is a continuous-latent codec; "
                         "use decode_latent")

    def encode(self, pcm, n_q: int = 0):
        raise CodecError("BlueMagpie-AudioVAE encode produces a continuous "
                         "latent; use encode_latent")

    def decode_latent(self, latent, pcm_format: str = "f32") -> np.ndarray:
        """latent [T, latent_dim] or [B, T, latent_dim] → pcm [T*hop] or
        [B, T*hop] at 48 kHz; float32, or int16 with pcm_format="i16"."""
        if not self.has_decoder:
            raise CodecError(f"{self.arch}: model has no decoder")
        latent = np.asarray(latent, np.float32)
        squeeze = latent.ndim == 2
        if squeeze:
            latent = latent[None]
        if latent.ndim != 3 or latent.shape[1] == 0:
            raise CodecError(f"bad latent shape {latent.shape}")
        if latent.shape[-1] != self.latent_dim:
            raise CodecError(f"latent_dim mismatch: {latent.shape[-1]} != "
                             f"{self.latent_dim}")
        z = torch.from_numpy(latent).to(self.device, self.compute_dtype)
        out = self._run_on_device(
            lambda: bm_decode_latent_fn(self.params, z, self.cfg), pcm_format)
        return out[0] if squeeze else out

    def encode_latent(self, pcm) -> np.ndarray:
        """pcm [n] or [B, n] at 16 kHz (float, or int16), zero-padded to an
        encode-hop multiple → mu [n/hop, latent_dim] or [B, ...] float32."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        pcm = self._pcm_host_f32(pcm)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        if pcm.ndim != 2 or pcm.shape[1] == 0:
            raise CodecError(f"bad pcm shape {pcm.shape}")
        pad = (-pcm.shape[1]) % self.cfg.encode_hop
        if pad:
            pcm = np.pad(pcm, ((0, 0), (0, pad)))
        x = torch.from_numpy(np.ascontiguousarray(pcm))
        with torch.inference_mode(), f32_precision(self.exact_encode):
            mu = bm_encode_latent_fn(
                self.params, x.to(self.device, self.compute_dtype), self.cfg)
            mu = self._host(mu.float())
        return mu[0] if squeeze else mu
