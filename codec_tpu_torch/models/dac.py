"""DAC (Descript Audio Codec), decode path, in PyTorch.

Counterpart of codec_tpu/models/dac.py:

decode: latent = Σ_q out_proj_q(codebook_q[codes_q]) + biases → conv k7 →
        4 blocks [snake → convtr k=2s pad=ceil(s/2) → 3 residual units
        (snake, dilated conv k7 d∈{1,3,9}, snake, conv k1, +x)] → snake →
        conv k7 → tanh

DAC is non-causal (symmetric padding): at the 24 kHz rates (8, 5, 4, 2) it
emits 320·T − 8 samples, and the runtime keeps them all
(`causal_time = False`). Activations are channels-last [B, T, C]. The
residual units of a block run through ops/seanet_cuda.py (the CUDA
kernels on the card, their plain versions on the CPU).

Parameters (`load_dac_params`, `params_from_jax`) are a dict of tensors:
  vq: cb [n_q, V, d], out_w [n_q, hidden, d], out_b [n_q, hidden]
  dec_c1, dec_c2: {"w": [C_out, C_in, K], "b": [C_out]}
  dec_blocks[i]: snake [C_in]; tr {"w": [C_in, C_out, K], "b"}; units, the
      block's residual units stacked in the kernels' layouts: w1 WIO
      [3, K, C, C], w2 [3, C, C] (in, out), b1, b2, a1, a2 [3, C]
  dec_snake [C]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, seanet_cuda
from ..runtime.model import CodecError, CodecModel

RES_DILATIONS = (1, 3, 9)
_UNIT_KEYS = ("w1", "b1", "a1", "a2", "w2", "b2")


@dataclass(frozen=True)
class DacConfig:
    sample_rate: int = 24000
    hop_size: int = 320
    n_q: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent_dim: int = 1024
    n_blocks: int = 4

    @classmethod
    def from_gguf(cls, r: GGUFReader) -> "DacConfig":
        return cls(
            sample_rate=r.get_i32("codec.sample_rate", 24000),
            hop_size=r.get_i32("codec.hop_size", 320),
            n_q=r.get_i32("codec.n_q", 9),
            codebook_size=r.get_i32("codec.codebook_size", 1024),
            codebook_dim=r.get_i32("codec.codebook_dim", 8),
            latent_dim=r.get_i32("codec.latent_dim", 1024),
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _to(a, dtype, device) -> torch.Tensor:
    """A C-contiguous copy (the kernels take contiguous weights)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def _units(units, t) -> Dict[str, torch.Tensor]:
    """Per-unit NumPy dicts (w1 WIO, w2 [in, out], vectors [C]) → the
    stacked tensors of the block."""
    return {key: t(np.stack([np.asarray(u[key]) for u in units]))
            for key in _UNIT_KEYS}


def load_dac_params(r: GGUFReader, cfg: DacConfig, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Quantizer and decoder parameters from a DAC GGUF (wire layouts are
    PyTorch's; the residual units are restacked for the kernels)."""
    t = partial(_to, dtype=dtype, device=device)

    def stack(fmt, transform=lambda a: a):
        return np.stack([transform(np.asarray(r.get(fmt.format(qi))))
                         for qi in range(cfg.n_q)])

    def squeeze_k1(a):
        return a[:, :, 0] if a.ndim == 3 else a       # 1x1 conv → (out, in)

    def wb(name):
        return {"w": t(r.get(f"{name}.weight")), "b": t(r.get(f"{name}.bias"))}

    def alpha(name):
        return np.asarray(r.get(name)).reshape(-1)        # (1, C, 1) → [C]

    p: Dict[str, Any] = {"vq": {
        "cb": t(stack("vq.q{}.codebook.weight")),
        "out_w": t(stack("vq.q{}.out_proj.weight", squeeze_k1)),
        "out_b": t(stack("vq.q{}.out_proj.bias")),
    }}
    p["dec_c1"] = wb("dec.model.0")
    p["dec_blocks"] = []
    for bi in range(1, cfg.n_blocks + 1):
        pre = f"dec.model.{bi}.block"
        units = []
        for ri in (1, 2, 3):
            u = f"{pre}.res_unit{ri}"
            units.append({
                "w1": np.asarray(r.get(f"{u}.conv1.weight")).transpose(2, 1, 0),
                "b1": r.get(f"{u}.conv1.bias"),
                "a1": alpha(f"{u}.snake1.alpha"),
                "a2": alpha(f"{u}.snake2.alpha"),
                "w2": np.asarray(r.get(f"{u}.conv2.weight"))[:, :, 0].T,
                "b2": r.get(f"{u}.conv2.bias"),
            })
        p["dec_blocks"].append({"snake": t(alpha(f"{pre}.snake1.alpha")),
                                "tr": wb(f"{pre}.conv_t1"),
                                "units": _units(units, t)})
    p["dec_snake"] = t(alpha(f"dec.model.{cfg.n_blocks + 1}.alpha"))
    p["dec_c2"] = wb(f"dec.model.{cfg.n_blocks + 2}")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """The quantizer and decoder of a codec_tpu DAC parameter tree (from
    its `load_dac_params`, leaves as NumPy arrays or anything np.asarray
    takes) → this module's parameters.

    codec_tpu keeps conv weights WIO [K, C_in, C_out] and convtr weights
    WIO pre-flipped along K; the plain convs go back to PyTorch's layouts
    and the residual units keep WIO, stacked per block."""
    t = partial(_to, dtype=dtype, device=device)

    def cv(layer):
        return {"w": t(np.asarray(layer["w"]).transpose(2, 1, 0)),
                "b": t(layer["b"])}

    def tr(layer):
        return {"w": t(np.asarray(layer["w"])[::-1].transpose(1, 2, 0)),
                "b": t(layer["b"])}

    vq = tree["vq"]
    p: Dict[str, Any] = {"vq": {k: t(vq[k]) for k in ("cb", "out_w", "out_b")},
                         "dec_c1": cv(tree["dec_c1"])}
    p["dec_blocks"] = [{
        "snake": t(blk["snake"]),
        "tr": tr(blk["tr"]),
        "units": _units([{"w1": u["c1"]["w"], "b1": u["c1"]["b"],
                          "a1": u["s1"], "a2": u["s2"],
                          "w2": np.asarray(u["c2"]["w"])[0],
                          "b2": u["c2"]["b"]} for u in blk["units"]], t),
    } for blk in tree["dec_blocks"]]
    p["dec_snake"] = t(tree["dec_snake"])
    p["dec_c2"] = cv(tree["dec_c2"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stride-1 conv with the reference's symmetric pad k//2; x [B, T, C]."""
    w = layer["w"]
    return F.conv1d(x.transpose(1, 2), w, layer["b"],
                    padding=w.shape[-1] // 2).transpose(1, 2)


def _convtr(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Upsampling conv-transpose k=2s, stride s, padding ceil(s/2):
    T·s + s − 2·ceil(s/2) samples; x [B, T, C]."""
    s = layer["w"].shape[-1] // 2
    return F.conv_transpose1d(x.transpose(1, 2), layer["w"], layer["b"],
                              stride=s, padding=(s + 1) // 2).transpose(1, 2)


def kernel_res_units(x: torch.Tensor,
                     units: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A block's three residual units (the kernels' wrappers: the chain or
    one unit launch per unit on the card, the plain version on the CPU)."""
    return seanet_cuda.seanet_res_units(
        x.contiguous(), units["w1"], units["b1"], units["a1"], units["a2"],
        units["w2"], units["b2"], dilations=RES_DILATIONS)


def plain_res_units(x: torch.Tensor,
                    units: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The same units in plain ops on any device."""
    return seanet_cuda.seanet_res_chain_ref(
        x, units["w1"], units["b1"], units["a1"], units["a2"], units["w2"],
        units["b2"], dilations=RES_DILATIONS)


def dac_latent_from_codes(vq: Dict[str, torch.Tensor], codes: torch.Tensor,
                          n_q: int) -> torch.Tensor:
    """codes [B, T, Q] → latent [B, T, hidden]: Σ_q out_proj_q(cb_q[idx]) +
    Σ_q out_b_q over the first n_q levels."""
    b, t = codes.shape[:2]
    d = vq["cb"].shape[-1]
    emb = torch.stack([vq["cb"][q][codes[..., q]] for q in range(n_q)],
                      dim=-2).reshape(b, t, n_q * d)           # [B, T, q·d]
    w = vq["out_w"][:n_q].transpose(1, 2).reshape(n_q * d, -1)  # [q·d, h]
    return emb @ w + vq["out_b"][:n_q].sum(0)


def dac_decode_from_latent(params: Dict[str, Any], latent: torch.Tensor,
                           cfg: DacConfig,
                           res_units: Optional[Callable] = None
                           ) -> torch.Tensor:
    """latent [B, T, hidden] → pcm [B, 320·T − 8] at the 24 kHz rates.

    `res_units(x, units)` runs a block's residual units (default:
    `kernel_res_units`; `plain_res_units` runs the plain version)."""
    run_units = res_units or kernel_res_units
    x = _conv(latent, params["dec_c1"])
    for blk in params["dec_blocks"]:
        x = _convtr(act.snake(x, blk["snake"]), blk["tr"])
        x = run_units(x, blk["units"])
    x = _conv(act.snake(x, params["dec_snake"]), params["dec_c2"])
    return torch.tanh(x[..., 0])


def dac_decode_fn(params: Dict[str, Any], codes: torch.Tensor,
                  cfg: DacConfig, n_q: Optional[int] = None,
                  res_units: Optional[Callable] = None) -> torch.Tensor:
    """codes [B, T, Q] int on the parameters' device → pcm [B, samples]."""
    if n_q is None:
        n_q = codes.shape[-1]
    codes = codes.clamp(0, cfg.codebook_size - 1)
    latent = dac_latent_from_codes(params["vq"], codes, n_q)
    return dac_decode_from_latent(params, latent, cfg, res_units=res_units)


class DacCodec(CodecModel):
    arch = "dac"
    causal_time = False

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = DacConfig.from_gguf(reader)
        self.params = load_dac_params(reader, self.cfg,
                                      dtype=self.compute_dtype,
                                      device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.latent_dim
        self.has_encoder = reader.has_tensor("enc.block.0.weight")

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return dac_decode_fn(self.params, codes, self.cfg, n_q=n_q)

    def encode(self, pcm, n_q: int = 0):
        raise CodecError("dac: encode not yet ported")

    def decode_latent(self, latent, pcm_format: str = "f32") -> np.ndarray:
        """latent [T, latent_dim] or [B, T, latent_dim] → pcm [samples] or
        [B, samples]; float32, or int16 with pcm_format="i16"."""
        latent = np.asarray(latent, dtype=np.float32)
        squeeze = latent.ndim == 2
        if squeeze:
            latent = latent[None]
        if (latent.ndim != 3 or latent.shape[1] == 0
                or latent.shape[2] != self.latent_dim):
            raise CodecError(f"bad latent shape {latent.shape}: want "
                             f"[T, {self.latent_dim}] or "
                             f"[B, T, {self.latent_dim}]")
        z = torch.from_numpy(latent).to(self.device, self.compute_dtype)
        out = self._run_on_device(
            lambda: dac_decode_from_latent(self.params, z, self.cfg),
            pcm_format)
        return out[0] if squeeze else out
