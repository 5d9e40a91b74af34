"""DAC (Descript Audio Codec), encode and decode, in PyTorch.

Counterpart of codec_tpu/models/dac.py:

encode: conv k7 → 4 blocks [3 residual units → snake → strided conv k=2s
        pad=ceil(s/2)] → snake → conv k3 → latent → residual VQ: per level
        in_proj → cosine (L2-normalised) nearest-code search → residual -=
        out_proj(codebook[idx])
decode: latent = Σ_q out_proj_q(codebook_q[codes_q]) + biases → conv k7 →
        4 blocks [snake → convtr k=2s pad=ceil(s/2) → 3 residual units
        (snake, dilated conv k7 d∈{1,3,9}, snake, conv k1, +x)] → snake →
        conv k7 → tanh

DAC is non-causal (symmetric padding): at the 24 kHz rates (8, 5, 4, 2) it
emits 320·T − 8 samples, and the runtime keeps them all
(`causal_time = False`); an encode of n samples gives n/320 frames.
Activations are channels-last [B, T, C]. The residual units of a block,
in the encoder and the decoder, run through ops/seanet_cuda.py (the CUDA
kernels on the card, their plain versions on the CPU). The cosine search
is plain torch: the reference has no kernel for it.

Parameters (`load_dac_params`, `params_from_jax`) are a dict of tensors:
  vq: cb [n_q, V, d], in_w [n_q, d, hidden], in_b [n_q, d], out_w
      [n_q, hidden, d], out_b [n_q, hidden]
  dec_c1, dec_c2: {"w": [C_out, C_in, K], "b": [C_out]}
  dec_blocks[i]: snake [C_in]; tr {"w": [C_in, C_out, K], "b"}; units, the
      block's residual units stacked in the kernels' layouts: w1 WIO
      [3, K, C, C], w2 [3, C, C] (in, out), b1, b2, a1, a2 [3, C], and
      vec [3, 6, C] f32, the rows the kernels read (built at load)
  dec_snake [C]
  with an encoder: enc_c1, enc_c2 as convs; enc_blocks[i]: units as the
      decoder's, snake [C], dn (the strided conv) {"w", "b"}; enc_snake [C]
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, norms, rvq, seanet_cuda
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
    stacked tensors of the block, and "vec": the f32 rows the kernels read
    (seanet_cuda.unit_vec of the stacked alphas and biases), built once
    here rather than on every launch."""
    out = {key: t(np.stack([np.asarray(u[key]) for u in units]))
           for key in _UNIT_KEYS}
    out["vec"] = seanet_cuda.unit_vec(out["a1"], out["b1"], out["a2"],
                                      out["b2"])
    return out


def load_dac_params(r: GGUFReader, cfg: DacConfig, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Quantizer, decoder and (where the file has one) encoder parameters
    from a DAC GGUF (wire layouts are PyTorch's; the residual units are
    restacked for the kernels)."""
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

    def units(pre):
        out = []
        for ri in (1, 2, 3):
            u = f"{pre}.res_unit{ri}"
            out.append({
                "w1": np.asarray(r.get(f"{u}.conv1.weight")).transpose(2, 1, 0),
                "b1": r.get(f"{u}.conv1.bias"),
                "a1": alpha(f"{u}.snake1.alpha"),
                "a2": alpha(f"{u}.snake2.alpha"),
                "w2": np.asarray(r.get(f"{u}.conv2.weight"))[:, :, 0].T,
                "b2": r.get(f"{u}.conv2.bias"),
            })
        return _units(out, t)

    p: Dict[str, Any] = {"vq": {
        "cb": t(stack("vq.q{}.codebook.weight")),
        "in_w": t(stack("vq.q{}.in_proj.weight", squeeze_k1)),
        "in_b": t(stack("vq.q{}.in_proj.bias")),
        "out_w": t(stack("vq.q{}.out_proj.weight", squeeze_k1)),
        "out_b": t(stack("vq.q{}.out_proj.bias")),
    }}
    p["dec_c1"] = wb("dec.model.0")
    p["dec_blocks"] = []
    for bi in range(1, cfg.n_blocks + 1):
        pre = f"dec.model.{bi}.block"
        p["dec_blocks"].append({"snake": t(alpha(f"{pre}.snake1.alpha")),
                                "tr": wb(f"{pre}.conv_t1"),
                                "units": units(pre)})
    p["dec_snake"] = t(alpha(f"dec.model.{cfg.n_blocks + 1}.alpha"))
    p["dec_c2"] = wb(f"dec.model.{cfg.n_blocks + 2}")
    if r.has_tensor("enc.block.0.weight"):
        p["enc_c1"] = wb("enc.block.0")
        p["enc_blocks"] = [{"units": units(pre),
                            "snake": t(alpha(f"{pre}.snake1.alpha")),
                            "dn": wb(f"{pre}.conv1")}
                           for pre in (f"enc.block.{bi}.block"
                                       for bi in range(1, cfg.n_blocks + 1))]
        p["enc_snake"] = t(alpha(f"enc.block.{cfg.n_blocks + 1}.alpha"))
        p["enc_c2"] = wb(f"enc.block.{cfg.n_blocks + 2}")
    return p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """The quantizer, decoder and (where the tree has one) encoder of a
    codec_tpu DAC parameter tree (from its `load_dac_params`, leaves as
    NumPy arrays or anything np.asarray takes) → this module's
    parameters.

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

    def units(blk):
        return _units([{"w1": u["c1"]["w"], "b1": u["c1"]["b"],
                        "a1": u["s1"], "a2": u["s2"],
                        "w2": np.asarray(u["c2"]["w"])[0],
                        "b2": u["c2"]["b"]} for u in blk["units"]], t)

    vq = tree["vq"]
    p: Dict[str, Any] = {"vq": {k: t(vq[k]) for k in ("cb", "in_w", "in_b",
                                                      "out_w", "out_b")},
                         "dec_c1": cv(tree["dec_c1"])}
    p["dec_blocks"] = [{"snake": t(blk["snake"]), "tr": tr(blk["tr"]),
                        "units": units(blk)} for blk in tree["dec_blocks"]]
    p["dec_snake"] = t(tree["dec_snake"])
    p["dec_c2"] = cv(tree["dec_c2"])
    if "enc_c1" in tree:
        p["enc_c1"] = cv(tree["enc_c1"])
        p["enc_blocks"] = [{"units": units(blk), "snake": t(blk["snake"]),
                            "dn": cv(blk["dn"])} for blk in tree["enc_blocks"]]
        p["enc_snake"] = t(tree["enc_snake"])
        p["enc_c2"] = cv(tree["enc_c2"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stride-1 conv with the reference's symmetric pad k//2; x [B, T, C]."""
    w = layer["w"]
    return F.conv1d(x.transpose(1, 2), w, layer["b"],
                    padding=w.shape[-1] // 2).transpose(1, 2)


def _down(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Downsampling conv k=2s, stride s, padding ceil(s/2): T/s frames for
    T a multiple of s; x [B, T, C]."""
    s = layer["w"].shape[-1] // 2
    return F.conv1d(x.transpose(1, 2), layer["w"], layer["b"], stride=s,
                    padding=(s + 1) // 2).transpose(1, 2)


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
        units["w2"], units["b2"], dilations=RES_DILATIONS, vec=units["vec"])


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


def dac_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor,
                         cfg: DacConfig,
                         res_units: Optional[Callable] = None) -> torch.Tensor:
    """pcm [B, n] on the parameters' device → the latent before the VQ
    [B, n/hop, latent_dim]. `res_units` as in `dac_decode_from_latent`."""
    run_units = res_units or kernel_res_units
    x = _conv(pcm[..., None], params["enc_c1"])
    for blk in params["enc_blocks"]:
        x = run_units(x, blk["units"])
        x = _down(act.snake(x, blk["snake"]), blk["dn"])
    return _conv(act.snake(x, params["enc_snake"]), params["enc_c2"])


def dac_quantize(vq: Dict[str, torch.Tensor], latent: torch.Tensor,
                 n_q: int) -> torch.Tensor:
    """The cosine RVQ over the first n_q levels: latent [B, T, hidden] →
    codes [B, T, n_q] int32. The search compares L2-normalised projections
    and codebooks; the residual takes out_proj of the raw codebook row."""
    residual, codes = latent, []
    for q in range(n_q):
        z = residual @ vq["in_w"][q].T + vq["in_b"][q]             # [B, T, d]
        cbn = norms.l2_normalize(vq["cb"][q])
        idx, _ = rvq.rvq_layer_encode(norms.l2_normalize(z), cbn)
        codes.append(idx)
        residual = residual - (vq["cb"][q][idx] @ vq["out_w"][q].T
                               + vq["out_b"][q])
    return torch.stack(codes, dim=-1)


def dac_encode_fn(params: Dict[str, Any], pcm: torch.Tensor, cfg: DacConfig,
                  n_q: Optional[int] = None,
                  res_units: Optional[Callable] = None) -> torch.Tensor:
    """pcm [B, n] → codes [B, n/hop, n_q] int32 (reference:
    codec_tpu/models/dac.py::dac_encode_fn)."""
    latent = dac_encode_latent_fn(params, pcm, cfg, res_units=res_units)
    return dac_quantize(params["vq"], latent, cfg.n_q if n_q is None else n_q)


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

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        return dac_encode_fn(self.params, pcm, self.cfg, n_q=n_q)

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
