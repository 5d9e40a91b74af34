"""SNAC (hubertsiuzdak/snac_24khz), encode and decode, in PyTorch.

Counterpart of codec_tpu/models/snac.py:

encode: zero-pad to a multiple of pad_to → conv k7 → 4 blocks [3 depthwise
        residual units → snake → strided conv k=2s pad=ceil(s/2)] →
        depthwise conv k7 → 3-level VQ at strides 4/2/1 (average-pool by
        the stride → in_proj → cosine nearest code against the normalised
        codebook → out_proj of the raw row, repeated s times, off the
        residual) → codes in the Orpheus packing [B, T, 3]
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
  vq: cb, cb_norm [n_q, V, d], in_w [n_q, d, latent], in_b [n_q, d],
      out_w [n_q, latent, d], out_b [n_q, latent]
  dec_in_dw, dec_in_pw, dec_final: {"w": [C_out, C_in/groups, K], "b"}
  dec_blocks[i]: act [C_in]; tr {"w": [C_in, C_out, K], "b"}; units, the
      block's residual units stacked in the kernel's layout: w1 per-channel
      taps [3, K, C], w2 [3, C, C] (in, out), b1, b2, a1, a2 [3, C], and
      vec [3, 6, C] f32, the rows the kernels read (built at load)
  dec_act_final [C]
  with an encoder: enc0, enc_final as the decoder's convs; enc_blocks[i]:
      units as the decoder's, act [C], down (the strided conv) {"w", "b"}
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, norms, seanet_cuda
from ..runtime.model import CodecError, CodecModel
from .dac import _down, _to, _units

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
    """Quantizer, decoder and (where the file has one) encoder parameters
    from a SNAC GGUF (wire layouts are PyTorch's; the residual units are
    restacked for the kernel)."""
    t = partial(_to, dtype=dtype, device=device)

    def wb(name):
        b = r.get_or_none(f"{name}.b")
        return {"w": t(r.get(f"{name}.w")),
                "b": None if b is None else t(b)}

    def alpha(name):
        return np.asarray(r.get(f"{name}.alpha")).reshape(-1)

    def units(pre):
        return _units([_unit(r.get(f"{u}.conv1.w"), r.get(f"{u}.conv1.b"),
                             alpha(f"{u}.act1"), alpha(f"{u}.act2"),
                             r.get(f"{u}.conv2.w"), r.get(f"{u}.conv2.b"))
                       for u in (f"{pre}.r{ri}"
                                 for ri in range(len(RES_DILATIONS)))], t)

    def stack(name, k1=False):
        a = [np.asarray(r.get(f"snac.q.{qi}.{name}")) for qi in range(cfg.n_q)]
        return t(np.stack([x[:, :, 0] for x in a] if k1 else a))

    p: Dict[str, Any] = {"vq": {
        "cb": stack("codebook"), "cb_norm": stack("codebook_norm"),
        "in_w": stack("in_proj.w", k1=True), "in_b": stack("in_proj.b"),
        "out_w": stack("out_proj.w", k1=True), "out_b": stack("out_proj.b"),
    }}
    p["dec_in_dw"] = wb("snac.dec.conv_in_dw")
    p["dec_in_pw"] = wb("snac.dec.conv_in_pw")
    p["dec_blocks"] = []
    for bi in range(len(cfg.decoder_rates)):
        pre = f"snac.dec.b{bi}"
        p["dec_blocks"].append({"act": t(alpha(f"{pre}.act")),
                                "tr": wb(f"{pre}.convtr"),
                                "units": units(pre)})
    p["dec_act_final"] = t(alpha("snac.dec.act_final"))
    p["dec_final"] = wb("snac.dec.conv_final")
    if r.has_tensor("snac.enc.conv0.w"):
        p["enc0"] = wb("snac.enc.conv0")
        p["enc_blocks"] = [{"units": units(f"snac.enc.b{bi}"),
                            "act": t(alpha(f"snac.enc.b{bi}.act")),
                            "down": wb(f"snac.enc.b{bi}.down")}
                           for bi in range(1, len(cfg.encoder_rates) + 1)]
        p["enc_final"] = wb("snac.enc.conv_final")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """The quantizer, decoder and (where the tree has one) encoder of a
    codec_tpu SNAC parameter tree (from its `load_snac_params`, leaves as
    NumPy arrays or anything np.asarray takes) → this module's
    parameters.

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

    def units(blk):
        return _units([_unit(torch_w(u["c1"]["w"]), u["c1"]["b"], u["a1"],
                             u["a2"], torch_w(u["c2"]["w"]), u["c2"]["b"])
                       for u in blk["units"]], t)

    def stack(get):
        return t(np.stack([np.asarray(get(q)) for q in tree["q"]]))

    p: Dict[str, Any] = {"vq": {
        "cb": stack(lambda q: q["cb"]),
        "cb_norm": stack(lambda q: q["cb_norm"]),
        "in_w": stack(lambda q: torch_w(q["in"]["w"])[:, :, 0]),
        "in_b": stack(lambda q: q["in"]["b"]),
        "out_w": stack(lambda q: torch_w(q["out"]["w"])[:, :, 0]),
        "out_b": stack(lambda q: q["out"]["b"]),
    }}
    p["dec_in_dw"] = cv(tree["dec_in_dw"])
    p["dec_in_pw"] = cv(tree["dec_in_pw"])
    p["dec_blocks"] = [{"act": t(blk["act"]), "tr": tr(blk["tr"]),
                        "units": units(blk)} for blk in tree["dec_blocks"]]
    p["dec_act_final"] = t(tree["dec_act_final"])
    p["dec_final"] = cv(tree["dec_final"])
    if "enc0" in tree:
        p["enc0"] = cv(tree["enc0"])
        p["enc_blocks"] = [{"units": units(blk), "act": t(blk["act"]),
                            "down": cv(blk["down"])}
                           for blk in tree["enc_blocks"]]
        p["enc_final"] = cv(tree["enc_final"])
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
    unit per call on the card, the plain version on the CPU)."""
    return seanet_cuda.snac_res_units(
        x.contiguous(), units["w1"], units["b1"], units["a1"], units["a2"],
        units["w2"], units["b2"], dilations=RES_DILATIONS, vec=units["vec"])


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


def snac_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                          cfg: SnacConfig,
                          res_units: Optional[Callable] = None
                          ) -> torch.Tensor:
    """pcm [B, n] (n a multiple of pad_to) on the parameters' device → the
    latent before the VQ [B, n/hop, latent]. `res_units` as in
    `snac_decode_fn`."""
    run_units = res_units or kernel_res_units
    x = _conv(pcm[..., None], params["enc0"])
    for blk in params["enc_blocks"]:
        x = run_units(x, blk["units"])
        x = _down(act.snake(x, blk["act"]), blk["down"])
    return _conv(x, params["enc_final"])


def snac_quantize(vq: Dict[str, torch.Tensor], latent: torch.Tensor,
                  cfg: SnacConfig) -> torch.Tensor:
    """The multi-scale VQ: latent [B, T, latent] (T a multiple of the
    coarsest stride) → codes [B, T, 3] in the Orpheus packing (level q's
    code repeated s_q times)."""
    residual, packed = latent, []
    b, t, c = latent.shape
    for q, stride in enumerate(cfg.vq_strides):
        pooled = residual.reshape(b, t // stride, stride, c).mean(dim=2)
        z = pooled @ vq["in_w"][q].T + vq["in_b"][q]
        sims = torch.matmul(norms.l2_normalize(z), vq["cb_norm"][q].T)
        idx = torch.argmax(sims.float(), dim=-1)                   # [B, t_q]
        zq = vq["cb"][q][idx] @ vq["out_w"][q].T + vq["out_b"][q]
        residual = residual - zq.repeat_interleave(stride, dim=1)
        packed.append(idx.to(torch.int32).repeat_interleave(stride, dim=1))
    return torch.stack(packed, dim=-1)


def snac_encode_fn(params: Dict[str, Any], pcm: torch.Tensor,
                   cfg: SnacConfig,
                   res_units: Optional[Callable] = None) -> torch.Tensor:
    """pcm [B, n] (n a multiple of pad_to) → packed codes [B, n/hop, 3]
    int32 (reference: codec_tpu/models/snac.py::snac_encode_fn)."""
    latent = snac_encode_latent_fn(params, pcm, cfg, res_units=res_units)
    return snac_quantize(params["vq"], latent, cfg)


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

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        return snac_encode_fn(self.params, pcm, self.cfg)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm [n] / [B, n] (float32, or int16 kept as it is) → packed
        codes [T, 3] / [B, T, 3] with T = ceil(n / pad_to) · pad_to / hop:
        the input is zero-padded to a multiple of pad_to first."""
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:
            pcm = np.asarray(pcm, np.float32)
        n = pcm.shape[-1] if pcm.ndim else 0
        pad = -(-n // self.cfg.pad_to) * self.cfg.pad_to - n
        if pad and pcm.ndim in (1, 2):
            pcm = np.pad(pcm, [(0, 0)] * (pcm.ndim - 1) + [(0, pad)])
        return super().encode(pcm, n_q=n_q)
