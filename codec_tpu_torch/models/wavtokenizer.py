"""WavTokenizer (novateur/WavTokenizer-large), encode and decode, in PyTorch.

Counterpart of codec_tpu/models/wavtokenizer.py:

decode: codebook sum → embed conv k7 → diffusion pos_net (2 res blocks,
        single-head attention, 2 res blocks, GroupNorm) → LayerNorm
        (AdaLayerNorm row 0) → ConvNeXt stack → final LN → head linear →
        iSTFT (Vocos "same" trim) → T*hop samples
encode: EnCodec encoder (reflect-padded convs, res blocks with conv
        shortcuts, ELU, strided convs 2/4/5/8, a 2-layer skip LSTM, a k7
        conv) → Euclidean VQ over the codebooks

Reflect padding is not causal (`causal_time = False`): an encode of n
samples gives ceil(n/hop) frames. The search runs through
`rvq_cuda.rvq_encode_fused` (the CUDA kernel on the card, the plain
`rvq.rvq_encode` on the CPU) on f32 codebooks and norms kept from load;
the rest is stock torch (codec_tpu computes it outside any Pallas kernel).

Parameters (`load_wt_params`, `params_from_jax`) are a dict of tensors,
PyTorch layouts (conv [C_out, C_in, K], linear [out, in]):
  cb [n_q, V, d]; embed {"w", "b"}; pos_net {"res": 4 dicts (blocks.
  diffusion_resblock), "attn" (blocks.diffusion_attn_block), gn_w, gn_b};
  inln (w, b); cnx: ConvNeXt dicts (blocks.convnext_block); fln_w, fln_b,
  head_w [n_fft+2, C], head_b
  with an encoder: enc {"c0", "stages": 4 x {"b1", "b3", "sc", "dn"},
  "lstm": 2 x {w_ih [4H, In], w_hh, b_ih, b_hh} (f32 whatever the
  compute dtype, views of one buffer a layer: ops/blocks.py::lstm_layer),
  "c_out"} (convs {"w", "b"}); search {"cb": f32 codebooks, "norms":
  [n_q, V] f32}
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops import act, blocks, norms, rvq, rvq_cuda
from ..ops.istft import istft_from_head
from ..runtime.model import CodecModel

ENC_STRIDES = (2, 4, 5, 8)


@dataclass(frozen=True)
class WtConfig:
    sample_rate: int = 24000
    hop_size: int = 320
    n_q: int = 1
    codebook_size: int = 4096
    codebook_dim: int = 512
    backbone_dim: int = 768
    n_convnext: int = 12
    use_adanorm: bool = True
    use_pos_net: bool = True
    head_out_dim: int = 1282


def _to(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device, dtype)


def load_wt_params(r: GGUFReader, dtype=torch.float32, device="cpu"):
    """(WtConfig, parameters) from a WavTokenizer GGUF (the converter's
    compressed names: dec.bb.*, vq.vq.layers.*, enc.model.*)."""
    t = partial(_to, dtype=dtype, device=device)
    cbs = []
    while True:
        qi = len(cbs)
        cb = r.get_or_none(f"vq.vq.layers.{qi}._codebook.embed")
        if cb is None:
            cb = r.get_or_none(f"vq.vq.layers.{qi}.codebook.embed")
        if cb is None:
            break
        cbs.append(cb)
    if not cbs:
        raise ValueError("no WavTokenizer codebooks found")
    use_adanorm = r.has_tensor("dec.bb.norm.scale.weight")
    use_pos_net = r.has_tensor("dec.bb.pos_net.0.norm1.weight")

    def g(name):
        return t(r.get(name))

    def cw(name):
        b = r.get_or_none(name + ".bias")
        return {"w": g(name + ".weight"), "b": t(b) if b is not None else None}

    def norm_row0(pre):
        # AdaLayerNorm keeps one (scale, shift) row per bandwidth; the
        # decoder runs row 0
        if use_adanorm:
            return (t(r.get(f"{pre}.scale.weight")[0]),
                    t(r.get(f"{pre}.shift.weight")[0]))
        return g(f"{pre}.weight"), g(f"{pre}.bias")

    p: Dict[str, Any] = {"cb": t(np.stack(cbs)), "embed": cw("dec.bb.embed")}
    if use_pos_net:
        res = []
        for li in (0, 1, 3, 4):
            pre = f"dec.bb.pos_net.{li}"
            res.append({"n1_w": g(f"{pre}.norm1.weight"),
                        "n1_b": g(f"{pre}.norm1.bias"),
                        "c1_w": g(f"{pre}.conv1.weight"),
                        "c1_b": g(f"{pre}.conv1.bias"),
                        "n2_w": g(f"{pre}.norm2.weight"),
                        "n2_b": g(f"{pre}.norm2.bias"),
                        "c2_w": g(f"{pre}.conv2.weight"),
                        "c2_b": g(f"{pre}.conv2.bias")})
        pa = "dec.bb.pos_net.2"
        attn = {"n_w": g(f"{pa}.norm.weight"), "n_b": g(f"{pa}.norm.bias")}
        for k, n in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "proj_out")):
            attn[f"{k}_w"] = t(r.get(f"{pa}.{n}.weight")[:, :, 0])
            attn[f"{k}_b"] = g(f"{pa}.{n}.bias")
        p["pos_net"] = {"res": res, "attn": attn,
                        "gn_w": g("dec.bb.pos_net.5.weight"),
                        "gn_b": g("dec.bb.pos_net.5.bias")}
    p["inln"] = norm_row0("dec.bb.norm")
    cnx = []
    while r.has_tensor(f"dec.bb.cnx.{len(cnx)}.dwconv.weight"):
        pre = f"dec.bb.cnx.{len(cnx)}"
        ln_w, ln_b = norm_row0(f"{pre}.norm")
        cnx.append({"dw_w": g(f"{pre}.dwconv.weight"),
                    "dw_b": g(f"{pre}.dwconv.bias"),
                    "ln_w": ln_w, "ln_b": ln_b,
                    "pw1_w": g(f"{pre}.pwconv1.weight"),
                    "pw1_b": g(f"{pre}.pwconv1.bias"),
                    "pw2_w": g(f"{pre}.pwconv2.weight"),
                    "pw2_b": g(f"{pre}.pwconv2.bias"),
                    "gamma": (g(f"{pre}.gamma")
                              if r.has_tensor(f"{pre}.gamma") else None)})
    p["cnx"] = cnx
    p["fln_w"], p["fln_b"] = g("dec.bb.fln.weight"), g("dec.bb.fln.bias")
    p["head_w"], p["head_b"] = g("dec.head.out.weight"), g("dec.head.out.bias")

    if r.has_tensor("enc.model.0.conv.conv.weight"):
        def lstm_w(name):
            # torch's layout is [4H, in]; the reference converter stores
            # the transpose [in, 4H]: accept both
            w = np.asarray(r.get(name))
            return t(w.T if w.shape[0] * 4 == w.shape[1] else w)

        def lstm(li):
            pre = "enc.model.13.lstm"
            return blocks.lstm_layer(
                lstm_w(f"{pre}.weight_ih_l{li}"),
                lstm_w(f"{pre}.weight_hh_l{li}"),
                g(f"{pre}.bias_ih_l{li}"), g(f"{pre}.bias_hh_l{li}"))

        p["enc"] = {
            "c0": cw("enc.model.0.conv.conv"),
            "stages": [{"b1": cw(f"enc.model.{mi}.block.1.conv.conv"),
                        "b3": cw(f"enc.model.{mi}.block.3.conv.conv"),
                        "sc": cw(f"enc.model.{mi}.shortcut.conv.conv"),
                        "dn": cw(f"enc.model.{mi + 2}.conv.conv")}
                       for mi in (1, 4, 7, 10)],
            "lstm": [lstm(li) for li in range(2)],
            "c_out": cw("enc.model.15.conv.conv")}
        p["search"] = rvq.search_state(p["cb"])

    cfg = WtConfig(
        sample_rate=r.get_i32("codec.sample_rate", 24000),
        hop_size=r.get_i32("codec.hop_size", 320),
        n_q=len(cbs),
        codebook_size=int(p["cb"].shape[1]),
        codebook_dim=int(p["cb"].shape[2]),
        backbone_dim=int(p["embed"]["w"].shape[0]),
        n_convnext=len(cnx),
        use_adanorm=use_adanorm,
        use_pos_net=use_pos_net,
        head_out_dim=int(p["head_w"].shape[0]),
    )
    return cfg, p


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """A codec_tpu WavTokenizer parameter tree (from its `load_wt_params`,
    leaves as NumPy arrays or anything np.asarray takes) → this module's
    parameters. codec_tpu keeps conv weights WIO [K, C_in, C_out] (and the
    attention's 1x1s as [out, in, 1]); this turns them back."""
    t = partial(_to, dtype=dtype, device=device)

    def conv(w):
        return t(np.asarray(w).transpose(2, 1, 0))

    def cw(layer):
        b = layer["b"]
        return {"w": conv(layer["w"]), "b": t(b) if b is not None else None}

    def vec(d, keys):
        return {k: t(d[k]) for k in keys}

    p: Dict[str, Any] = {"cb": t(tree["cb"]), "embed": cw(tree["embed"])}
    if "pos_net" in tree:
        pn = tree["pos_net"]
        res = [{**vec(b, ("n1_w", "n1_b", "c1_b", "n2_w", "n2_b", "c2_b")),
                "c1_w": conv(b["c1_w"]), "c2_w": conv(b["c2_w"])}
               for b in pn["res"]]
        a = pn["attn"]
        attn = {**vec(a, ("n_w", "n_b", "q_b", "k_b", "v_b", "o_b")),
                **{f"{k}_w": t(np.asarray(a[f"{k}_w"])[:, :, 0])
                   for k in "qkvo"}}
        p["pos_net"] = {"res": res, "attn": attn, "gn_w": t(pn["gn_w"]),
                        "gn_b": t(pn["gn_b"])}
    p["inln"] = (t(tree["inln"][0]), t(tree["inln"][1]))
    p["cnx"] = [{**vec(b, ("dw_b", "ln_w", "ln_b", "pw1_w", "pw1_b",
                           "pw2_w", "pw2_b")),
                 "dw_w": conv(b["dw_w"]),
                 "gamma": t(b["gamma"]) if b.get("gamma") is not None
                 else None} for b in tree["cnx"]]
    p.update(vec(tree, ("fln_w", "fln_b", "head_w", "head_b")))
    if "enc" in tree:
        e = tree["enc"]
        p["enc"] = {"c0": cw(e["c0"]),
                    "stages": [{k: cw(s[k]) for k in ("b1", "b3", "sc", "dn")}
                               for s in e["stages"]],
                    "lstm": [blocks.lstm_layer(*(t(lw[k]) for k in
                                                 blocks.LSTM_KEYS))
                             for lw in e["lstm"]],
                    "c_out": cw(e["c_out"])}
        p["search"] = rvq.search_state(p["cb"])
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def wt_decode_fn(params: Dict[str, Any], codes: torch.Tensor, cfg: WtConfig,
                 n_q: Optional[int] = None) -> torch.Tensor:
    """codes [B, T, Q] int → pcm [B, T*hop] float32."""
    if n_q is None:
        n_q = codes.shape[-1]
    codes = codes.clamp(0, cfg.codebook_size - 1)
    x = rvq.rvq_decode_sum(codes, params["cb"], n_q=n_q)       # [B, T, d]
    w = params["embed"]["w"]
    x = blocks.conv_tc(x, w, params["embed"]["b"],
                       padding=(w.shape[-1] - 1) // 2)
    if cfg.use_pos_net:
        pn = params["pos_net"]
        x = blocks.diffusion_resblock(x, pn["res"][0])
        x = blocks.diffusion_resblock(x, pn["res"][1])
        x = blocks.diffusion_attn_block(x, pn["attn"])
        x = blocks.diffusion_resblock(x, pn["res"][2])
        x = blocks.diffusion_resblock(x, pn["res"][3])
        x = norms.group_norm(x, pn["gn_w"], pn["gn_b"], 32, 1e-6)
    x = norms.layer_norm(x, params["inln"][0], params["inln"][1], 1e-6)
    for blk in params["cnx"]:
        x = blocks.convnext_block(x, blk)
    x = norms.layer_norm(x, params["fln_w"], params["fln_b"], 1e-6)
    head = F.linear(x, params["head_w"], params["head_b"])    # [B, T, n_fft+2]
    return istft_from_head(head, cfg.hop_size)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect padding of the last dim, with NumPy's (and jnp.pad's) rule
    where a pad reaches past the input: the reflection repeats with period
    2(n-1) (a single sample repeats). F.pad's reflect mode takes pads
    shorter than the input only."""
    n = x.shape[-1]
    if left < n and right < n:
        return F.pad(x, (left, right), mode="reflect")
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        idx = torch.remainder(idx, 2 * (n - 1))
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return x[..., idx]


def reflect_sconv(x: torch.Tensor, layer: Dict[str, torch.Tensor],
                  stride: int = 1) -> torch.Tensor:
    """EnCodec's conv on channels-first x [B, C, T]: reflect pad k - s in
    total, the larger half on the left, and on the right the extra that
    makes ceil(T/s) frames; the left pad first, then the right pad on the
    padded input (as codec_tpu pads)."""
    k = layer["w"].shape[-1]
    t = x.shape[-1]
    pt = k - stride
    extra = -(-t // stride) * stride - t
    pad_right = pt // 2
    x = reflect_pad(x, pt - pad_right, 0)
    if pad_right + extra > 0:
        x = reflect_pad(x, 0, pad_right + extra)
    return F.conv1d(x, layer["w"], layer["b"], stride=stride)


def wt_encode_latent_fn(params: Dict[str, Any], pcm: torch.Tensor
                        ) -> torch.Tensor:
    """pcm [B, n] → the latent before the VQ [B, ceil(n/hop), d]."""
    enc = params["enc"]
    x = reflect_sconv(pcm[:, None, :], enc["c0"])
    for st, stride in zip(enc["stages"], ENC_STRIDES):
        h = reflect_sconv(act.elu(x), st["b1"])
        h = reflect_sconv(act.elu(h), st["b3"])
        x = reflect_sconv(x, st["sc"]) + h
        x = reflect_sconv(act.elu(x), st["dn"], stride=stride)
    x = blocks.lstm_stack(x.transpose(1, 2), enc["lstm"], skip=True)
    x = reflect_sconv(act.elu(x).transpose(1, 2), enc["c_out"])
    return x.transpose(1, 2)


def wt_encode_fn(params: Dict[str, Any], pcm: torch.Tensor, cfg: WtConfig,
                 n_q: Optional[int] = None) -> torch.Tensor:
    """pcm [B, n] → codes [B, ceil(n/hop), n_q] int32. The search runs in
    f32 through `rvq_cuda.rvq_encode_fused` on the codebooks and norms kept
    from load."""
    if n_q is None:
        n_q = cfg.n_q
    z = wt_encode_latent_fn(params, pcm).float().contiguous()
    s = params["search"]
    return rvq_cuda.rvq_encode_fused(z, s["cb"][:n_q], norms=s["norms"][:n_q])


class WavTokenizerCodec(CodecModel):
    arch = "wavtokenizer"
    causal_time = False          # reflect padding is not causal

    def _load(self, reader: GGUFReader) -> None:
        self.cfg, self.params = load_wt_params(
            reader, dtype=self.compute_dtype, device=self.device)
        self.sample_rate = self.cfg.sample_rate
        self.hop_size = self.cfg.hop_size
        self.n_q = self.cfg.n_q
        self.codebook_size = self.cfg.codebook_size
        self.latent_dim = self.cfg.codebook_dim
        self.has_encoder = "enc" in self.params
        self.has_decoder = True

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return wt_decode_fn(self.params, codes, self.cfg, n_q=n_q)

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        return wt_encode_fn(self.params, pcm, self.cfg, n_q=n_q)
