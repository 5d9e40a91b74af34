"""SNAC (hubertsiuzdak/snac_24khz), decode path, in PyTorch.

Counterpart of codec_tpu/models/snac.py:

decode: codes in the Orpheus packing [B, T, 3] (level q reads every s_q-th
        row, strides 4/2/1) → latent = Σ_q repeat_s_q(out_proj_q(cb_q[idx]))
        → depthwise conv k7 → conv k1 → 4 blocks [snake → convtr k=2s
        (torch crop: padding ceil(s/2), output_padding s % 2) → 3 depthwise
        residual units (snake, depthwise dilated conv k7 d∈{1,3,9}, snake,
        conv k1, +x)] → snake → conv k7 → tanh

The decoder's noise blocks run as identity (deterministic decode, as in
the reference). SNAC is not causal; a decode of T frames gives T·hop
samples exactly, and T must be a multiple of the coarsest stride (4).
Activations are channels-last [B, T, C]. The residual units of a block
run through ops/seanet_cuda.py::snac_res_units (the CUDA kernel on the
card, its plain version on the CPU).

Parameters (`load_snac_params`, `params_from_jax`) are a dict of tensors:
  vq: cb [n_q, V, d], out_w [n_q, latent, d], out_b [n_q, latent]
  dec_in_dw, dec_in_pw, dec_final: {"w": [C_out, C_in/groups, K], "b"}
  dec_blocks[i]: act [C_in]; tr {"w": [C_in, C_out, K], "b"}; units, the
      block's residual units stacked in the kernel's layout: w1 per-channel
      taps [3, K, C], w2 [3, C, C] (in, out), b1, b2, a1, a2 [3, C]
  dec_act_final [C]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, seanet_cuda
from ..runtime.model import CodecError, CodecModel
from .dac import _to, _units

RES_DILATIONS = (1, 3, 9)


@dataclass(frozen=True)
class SnacConfig:
    sample_rate: int = 24000
    hop_size: int = 512
    pad_to: int = 2048
    n_q: int = 3
    codebook_size: int = 4096
    codebook_dim: int = 8
    latent_dim: int = 768
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    vq_strides: Tuple[int, ...] = (4, 2, 1)
    noise: bool = True

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "SnacConfig":
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=r.get_i32("codec.hop_size", 512),
            pad_to=r.get_i32("codec.pad_to", 2048),
            n_q=r.get_i32("codec.n_q", 3),
            codebook_size=r.get_i32("codec.codebook_size", 4096),
            codebook_dim=r.get_i32("codec.codebook_dim", 8),
            latent_dim=r.get_i32("codec.latent_dim", 768),
            encoder_rates=tuple(r.get_arr("snac.encoder_rates", [2, 4, 8, 8])),
            decoder_rates=tuple(r.get_arr("snac.decoder_rates", [8, 8, 4, 2])),
            vq_strides=tuple(r.get_arr("snac.vq_strides", [4, 2, 1])),
            noise=r.get_bool("snac.noise", True),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _unit(w1, b1, a1, a2, w2, b2) -> Dict[str, np.ndarray]:
    """One residual unit from PyTorch layouts (depthwise conv1 [C, 1, K],
    1x1 conv2 [C_out, C_in, 1], alphas of any shape holding C values) to
    the kernel's: taps [K, C], w2 [C_in, C_out], vectors [C]."""
    flat = lambda a: np.asarray(a).reshape(-1)
    return {"w1": np.asarray(w1)[:, 0, :].T, "b1": flat(b1), "a1": flat(a1),
            "a2": flat(a2), "w2": np.asarray(w2)[:, :, 0].T, "b2": flat(b2)}


def load_snac_params(r: GGUFReader, cfg: SnacConfig, dtype=torch.float32,
                     device="cpu") -> Dict[str, Any]:
    """Quantizer (decode half) and decoder parameters from a SNAC GGUF
    (wire layouts are PyTorch's; the residual units are restacked for the
    kernel). The encoder's tensors and the quantizer's in_proj and
    normalised codebooks (encode only) are not read."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(name):
        b = r.get_or_none(f"{name}.b")
        return {"w": t(r.get(f"{name}.w")),
                "b": None if b is None else t(b)}

    def alpha(name):
        return np.asarray(r.get(f"{name}.alpha")).reshape(-1)

    qs = [f"snac.q.{qi}" for qi in range(cfg.n_q)]
    p: Dict[str, Any] = {"vq": {
        "cb": t(np.stack([r.get(f"{q}.codebook") for q in qs])),
        "out_w": t(np.stack([np.asarray(r.get(f"{q}.out_proj.w"))[:, :, 0]
                             for q in qs])),
        "out_b": t(np.stack([r.get(f"{q}.out_proj.b") for q in qs])),
    }}
    p["dec_in_dw"] = wb("snac.dec.conv_in_dw")
    p["dec_in_pw"] = wb("snac.dec.conv_in_pw")
    p["dec_blocks"] = []
    for bi in range(len(cfg.decoder_rates)):
        pre = f"snac.dec.b{bi}"
        units = [_unit(r.get(f"{u}.conv1.w"), r.get(f"{u}.conv1.b"),
                       alpha(f"{u}.act1"), alpha(f"{u}.act2"),
                       r.get(f"{u}.conv2.w"), r.get(f"{u}.conv2.b"))
                 for u in (f"{pre}.r{ri}" for ri in range(len(RES_DILATIONS)))]
        p["dec_blocks"].append({"act": t(alpha(f"{pre}.act")),
                                "tr": wb(f"{pre}.convtr"),
                                "units": _units(units, t)})
    p["dec_act_final"] = t(alpha("snac.dec.act_final"))
    p["dec_final"] = wb("snac.dec.conv_final")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """The quantizer (decode half) and decoder of a codec_tpu SNAC
    parameter tree (from its `load_snac_params`, leaves as NumPy arrays or
    anything np.asarray takes) → this module's parameters.

    codec_tpu keeps conv weights WIO [K, C_in/groups, C_out] (depthwise:
    [K, 1, C]) and convtr weights WIO pre-flipped along K; the plain convs
    go back to PyTorch's layouts and the residual units to the kernel's."""
    t = partial(_to, dtype=dtype, device=device)

    def torch_w(w):
        return np.asarray(w).transpose(2, 1, 0)

    def cv(layer):
        return {"w": t(torch_w(layer["w"])),
                "b": None if layer["b"] is None else t(layer["b"])}

    def tr(layer):
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(layer["b"])}

    p: Dict[str, Any] = {"vq": {
        "cb": t(np.stack([np.asarray(q["cb"]) for q in tree["q"]])),
        "out_w": t(np.stack([torch_w(q["out"]["w"])[:, :, 0]
                             for q in tree["q"]])),
        "out_b": t(np.stack([np.asarray(q["out"]["b"]) for q in tree["q"]])),
    }}
    p["dec_in_dw"] = cv(tree["dec_in_dw"])
    p["dec_in_pw"] = cv(tree["dec_in_pw"])
    p["dec_blocks"] = [{
        "act": t(blk["act"]),
        "tr": tr(blk["tr"]),
        "units": _units([_unit(torch_w(u["c1"]["w"]), u["c1"]["b"], u["a1"],
                               u["a2"], torch_w(u["c2"]["w"]), u["c2"]["b"])
                         for u in blk["units"]], t),
    } for blk in tree["dec_blocks"]]
    p["dec_act_final"] = t(tree["dec_act_final"])
    p["dec_final"] = cv(tree["dec_final"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stride-1 conv with symmetric pad (K-1)/2, grouped when the weight
    takes fewer input channels than x has (depthwise); x [B, T, C]."""
    w = layer["w"]
    return F.conv1d(x.transpose(1, 2), w, layer["b"],
                    padding=(w.shape[-1] - 1) // 2,
                    groups=x.shape[-1] // w.shape[1]).transpose(1, 2)


def _convtr(x: torch.Tensor, layer: Dict[str, torch.Tensor],
            stride: int) -> torch.Tensor:
    """Upsampling conv-transpose k=2s with PyTorch's crop (padding
    ceil(s/2), output_padding s % 2): exactly T·s samples; x [B, T, C]."""
    return F.conv_transpose1d(x.transpose(1, 2), layer["w"], layer["b"],
                              stride=stride, padding=(stride + 1) // 2,
                              output_padding=stride % 2).transpose(1, 2)


def kernel_res_units(x: torch.Tensor,
                     units: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A block's three depthwise residual units (the kernel's wrapper: one
    chain launch or one launch per unit on the card, the plain version on
    the CPU)."""
    return seanet_cuda.snac_res_units(
        x.contiguous(), units["w1"], units["b1"], units["a1"], units["a2"],
        units["w2"], units["b2"], dilations=RES_DILATIONS)


def plain_res_units(x: torch.Tensor,
                    units: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The same units in plain ops on any device."""
    return seanet_cuda.snac_res_chain_ref(
        x, units["w1"], units["b1"], units["a1"], units["a2"], units["w2"],
        units["b2"], dilations=RES_DILATIONS)


def snac_latent_from_codes(vq: Dict[str, torch.Tensor], c_levels,
                           cfg: SnacConfig) -> torch.Tensor:
    """c_levels: per level, [B, T/s_q] int codes → latent [B, T, latent]
    (each level's frames repeated s_q times)."""
    z = None
    for q, (codes, stride) in enumerate(zip(c_levels, cfg.vq_strides)):
        zq = vq["cb"][q][codes] @ vq["out_w"][q].T + vq["out_b"][q]
        zq = zq.repeat_interleave(stride, dim=1)
        z = zq if z is None else z + zq
    return z


def snac_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                   cfg: SnacConfig,
                   res_units: Optional[Callable] = None) -> torch.Tensor:
    """codes [B, T, 3] int in the Orpheus packing, on the parameters'
    device → pcm [B, T·hop].

    `res_units(x, units)` runs a block's residual units (default:
    `kernel_res_units`; `plain_res_units` runs the plain version)."""
    run_units = res_units or kernel_res_units
    codes = codes.clamp(0, cfg.codebook_size - 1)
    c_levels = [codes[:, ::s, q] for q, s in enumerate(cfg.vq_strides)]
    x = snac_latent_from_codes(params["vq"], c_levels, cfg)
    x = _conv(x, params["dec_in_dw"])
    x = _conv(x, params["dec_in_pw"])
    for blk, s in zip(params["dec_blocks"], cfg.decoder_rates):
        x = _convtr(act.snake(x, blk["act"]), blk["tr"], s)
        x = run_units(x, blk["units"])
    x = _conv(act.snake(x, params["dec_act_final"]), params["dec_final"])
    return torch.tanh(x[..., 0])


class SnacCodec(CodecModel):
    arch = "snac"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = SnacConfig.from_gguf(reader)
        self.params = load_snac_params(reader, self.cfg,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.latent_dim
        self.has_encoder = reader.has_tensor("snac.enc.conv0.w")

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        if n_q != self.n_q:
            raise CodecError(f"snac: decode reads all {self.n_q} code levels, "
                             f"got n_q={n_q}")
        return snac_decode_fn(self.params, codes, self.cfg)

    def decode(self, codes, n_q: int = 0,
               pcm_format: str = "f32") -> np.ndarray:
        """codes [T, 3] or [B, T, 3] in the Orpheus packing, T a multiple
        of the coarsest stride → pcm [T·hop] / [B, T·hop]."""
        codes = np.asarray(codes)
        stride = self.cfg.vq_strides[0]
        if codes.ndim >= 2 and codes.shape[-2] % stride:
            raise CodecError(f"SNAC n_frames must be a multiple of {stride}")
        return super().decode(codes, n_q=n_q, pcm_format=pcm_format)

    def encode(self, pcm, n_q: int = 0):
        raise CodecError("snac: encode not yet ported")
