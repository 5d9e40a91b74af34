"""Qwen3-TTS ECAPA-TDNN speaker encoder (counterpart of
codec_tpu/lm/speaker_qwen3_tts.py, eager).

Reference behavior: src/lm/speaker_qwen3_tts.cpp + the mel front-end
codec_runtime_qwen3_tts_speaker_mel (audio_dsp.cpp):

  ref 24 kHz PCM
    → host: BigVGAN-style mel (reflect pad (n_fft−hop)/2, magnitude
      spectrum, mel_basis @ |X|, log clip @ 1e-5), float64 [T, n_mels]
    → device: ECAPA-TDNN — initial TDNN+ReLU → SE-Res2Net blocks (reflect
      "same" convs, chunked Res2Net chain, SE gating, identity skip when
      channels match) → MFA concat+conv+ReLU → attentive statistical
      pooling (conv→ReLU→tanh→conv→time-softmax, weighted mean‖std) →
      fc (k=1) → speaker embedding [enc_dim] (1 row of hidden_dim)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader


@dataclass(frozen=True)
class EcapaConfig:
    mel_dim: int = 128
    enc_dim: int = 1024
    attn_ch: int = 128
    res2net_scale: int = 8
    se_ch: int = 128
    n_fft: int = 1024
    hop: int = 256
    win: int = 1024
    sample_rate: int = 24000
    enc_channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    enc_kernels: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    n_rows: int = 1
    hidden_dim: int = 1024

    @classmethod
    def from_gguf(cls, r: GGUFReader, hidden_dim: int) -> "EcapaConfig":
        d = cls()

        def arr(k, v):
            return tuple(int(x) for x in
                         (r.get_arr(f"codec.speaker.ecapa.{k}") or v))
        return cls(
            mel_dim=r.get_i32("codec.speaker.ecapa.mel_dim", d.mel_dim),
            enc_dim=r.get_i32("codec.speaker.ecapa.enc_dim", d.enc_dim),
            attn_ch=r.get_i32("codec.speaker.ecapa.enc_attention_channels",
                              d.attn_ch),
            res2net_scale=r.get_i32("codec.speaker.ecapa.enc_res2net_scale",
                                    d.res2net_scale),
            se_ch=r.get_i32("codec.speaker.ecapa.enc_se_channels", d.se_ch),
            n_fft=r.get_i32("codec.speaker.ecapa.n_fft", d.n_fft),
            hop=r.get_i32("codec.speaker.ecapa.hop_size", d.hop),
            win=r.get_i32("codec.speaker.ecapa.win_size", d.win),
            sample_rate=r.get_i32("codec.speaker.ref_sample_rate",
                                  d.sample_rate),
            enc_channels=arr("enc_channels", d.enc_channels),
            enc_kernels=arr("enc_kernel_sizes", d.enc_kernels),
            enc_dilations=arr("enc_dilations", d.enc_dilations),
            n_rows=r.get_i32("codec.speaker.n_rows", d.n_rows),
            hidden_dim=r.get_i32("codec.speaker.hidden_dim", hidden_dim),
        )


def qwen3_speaker_mel(pcm: np.ndarray, mel_basis: np.ndarray,
                      window: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """24 kHz mono PCM → [T, n_mels] log-mel (reference:
    codec_runtime_qwen3_tts_speaker_mel). A copy of codec_tpu's host
    NumPy."""
    pcm = np.asarray(pcm, np.float64).reshape(-1)
    pad = (n_fft - hop) // 2
    if pad >= len(pcm):
        raise ValueError("PCM too short for the n_fft / hop pair")
    padded = np.pad(pcm, (pad, pad), mode="reflect")
    n_frames = len(pcm) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = padded[idx] * np.asarray(window, np.float64)
    mag = np.abs(np.fft.rfft(frames, axis=1))                # [T, n_freq]
    mel = mag @ np.asarray(mel_basis, np.float64).T          # [T, n_mels]
    return np.log(np.maximum(mel, 1e-5)).astype(np.float32)


def _conv(w, b, dil: int) -> Dict[str, Any]:
    return {"w": w, "b": b, "dil": int(dil)}


def _ecapa_tree(conv, cfg: EcapaConfig) -> Dict[str, Any]:
    """The parameter tree from conv(prefix, dilation) (codec_tpu's layout)."""
    p = {"init": conv("speaker.qwen3_tts.blocks.0.conv", cfg.enc_dilations[0]),
         "mfa": conv("speaker.qwen3_tts.mfa.conv", 1),
         "asp_tdnn": conv("speaker.qwen3_tts.asp.tdnn.conv", 1),
         "asp_conv": conv("speaker.qwen3_tts.asp.conv", 1),
         "fc": conv("speaker.qwen3_tts.fc", 1), "blocks": []}
    for bi in range(1, len(cfg.enc_channels) - 1):
        base = f"speaker.qwen3_tts.blocks.{bi}"
        p["blocks"].append({
            "tdnn1": conv(base + ".tdnn1.conv", 1),
            "tdnn2": conv(base + ".tdnn2.conv", 1),
            "se1": conv(base + ".se.conv1", 1),
            "se2": conv(base + ".se.conv2", 1),
            "res2net": [conv(f"{base}.res2net.{ri}.conv",
                             cfg.enc_dilations[bi])
                        for ri in range(cfg.res2net_scale - 1)]})
    return p


def load_ecapa_params(r: GGUFReader, cfg: EcapaConfig,
                      device="cuda") -> Dict[str, Any]:
    def g(n):
        return torch.from_numpy(np.array(r.get(n), np.float32)).to(device)

    return _ecapa_tree(lambda pre, dil: _conv(g(pre + ".weight"),
                                              g(pre + ".bias"), dil), cfg)


def ecapa_params_from_jax(tree, device="cpu") -> Dict[str, Any]:
    """codec_tpu's `load_ecapa_params` tree (NumPy leaves, each conv a
    {"w", "b", "dil"} dict) → this module's."""
    def conv(c):
        return _conv(*(torch.from_numpy(np.array(c[k], np.float32)).to(device)
                       for k in ("w", "b")), c["dil"])

    return {**{k: conv(tree[k]) for k in ("init", "mfa", "asp_tdnn",
                                          "asp_conv", "fc")},
            "blocks": [{**{k: conv(blk[k]) for k in ("tdnn1", "tdnn2",
                                                     "se1", "se2")},
                        "res2net": [conv(c) for c in blk["res2net"]]}
                       for blk in tree["blocks"]]}


def _conv_reflect(x: torch.Tensor, cw) -> torch.Tensor:
    """'Same' conv with reflect padding. x [T, C_in] → [T, C_out]
    (reference conv1d_reflect). The padding indexes rows as np.pad's
    reflect does, for any T."""
    w, dil = cw["w"], cw["dil"]
    k_eff = (w.shape[-1] - 1) * dil + 1
    center = k_eff // 2
    idx = np.pad(np.arange(x.shape[0]), (center, k_eff - 1 - center),
                 mode="reflect")
    xp = x[torch.from_numpy(idx).to(x.device)]
    y = F.conv1d(xp.t()[None], w, cw["b"], dilation=dil)[0]
    return y.t()


def _se_res2net(x: torch.Tensor, blk, scale: int) -> torch.Tensor:
    res = x
    h = F.relu(_conv_reflect(x, blk["tdnn1"]))
    parts = torch.chunk(h, scale, dim=-1)
    outs = [parts[0]]
    prev = None
    for i in range(1, scale):
        inp = parts[i] if i == 1 else parts[i] + prev
        prev = F.relu(_conv_reflect(inp, blk["res2net"][i - 1]))
        outs.append(prev)
    h = F.relu(_conv_reflect(torch.cat(outs, dim=-1), blk["tdnn2"]))
    # SE gate
    m = torch.mean(h, dim=0)
    z = F.relu(F.linear(m, blk["se1"]["w"][:, :, 0], blk["se1"]["b"]))
    g = torch.sigmoid(F.linear(z, blk["se2"]["w"][:, :, 0], blk["se2"]["b"]))
    h = h * g[None, :]
    if res.shape[-1] == h.shape[-1]:
        h = h + res
    return h


def ecapa_embed_fn(params, mel: torch.Tensor, cfg: EcapaConfig) -> torch.Tensor:
    """mel [T, mel_dim] → speaker embedding [enc_dim]."""
    x = F.relu(_conv_reflect(mel, params["init"]))
    outs = []
    for blk in params["blocks"]:
        x = _se_res2net(x, blk, cfg.res2net_scale)
        outs.append(x)
    h = F.relu(_conv_reflect(torch.cat(outs, dim=-1), params["mfa"]))
    mu = torch.mean(h, dim=0)
    sd = torch.sqrt(torch.clamp(torch.mean((h - mu) ** 2, dim=0), min=1e-12))
    asp_in = torch.cat([h, mu.expand_as(h), sd.expand_as(h)], dim=-1)
    a = torch.tanh(F.relu(_conv_reflect(asp_in, params["asp_tdnn"])))
    w = torch.softmax(_conv_reflect(a, params["asp_conv"]), dim=0)
    pm = torch.sum(w * h, dim=0)
    ps = torch.sqrt(torch.clamp(torch.sum(w * (h - pm) ** 2, dim=0),
                                min=1e-12))
    return F.linear(torch.cat([pm, ps]), params["fc"]["w"][:, :, 0],
                    params["fc"]["b"])


class Qwen3TTSSpeakerEncoder:
    """reference: qwen3_tts_speaker_encode. Weights on `device`; the mel
    front-end stays on the host."""

    def __init__(self, reader: GGUFReader, hidden_dim: int, device="cuda"):
        self.device = torch.device(device)
        self.cfg = EcapaConfig.from_gguf(reader, hidden_dim)
        self.params = load_ecapa_params(reader, self.cfg, self.device)
        self.mel_basis = np.asarray(
            reader.get("speaker.qwen3_tts.mel_basis"), np.float64)
        self.window = np.asarray(
            reader.get("speaker.qwen3_tts.window"), np.float64)

    def encode(self, ref_pcm: np.ndarray) -> np.ndarray:
        """24 kHz mono PCM → [n_rows=1, hidden_dim] speaker row."""
        mel = qwen3_speaker_mel(ref_pcm, self.mel_basis, self.window,
                                self.cfg.n_fft, self.cfg.hop)
        if mel.shape[0] < 2:
            raise ValueError("qwen3_tts speaker: too few mel frames")
        with torch.inference_mode():
            emb = ecapa_embed_fn(self.params,
                                 torch.from_numpy(mel).to(self.device),
                                 self.cfg).cpu().numpy()
        return emb[None, :self.cfg.hidden_dim]
