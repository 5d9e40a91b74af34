"""Chatterbox VoiceEncoder speaker encoder and T3 conditioning encoder
(counterpart of codec_tpu/lm/speaker_chatterbox.py, eager).

Reference behavior: src/lm/speaker_chatterbox.cpp + the VE mel front-end in
src/runtime/audio_dsp.cpp (codec_runtime_chatterbox_ve_mel_partials):

  ref 16 kHz PCM
    → host: librosa-style centered power STFT → mel → overlapping
      "partials" [n_partials, 160, 40] (get_num_wins slicing), float64
    → device: 3-layer LSTM (batched over partials, ops/blocks.lstm_stack)
      → last hidden → proj → ReLU → per-partial L2 norm → mean → L2 norm
      = spk_emb_raw [256]
    → device: cond_enc: spkr_enc linear (→1 row), perceiver (32 learned
      queries cross-attending speech_emb(ref_tokens)+pos, then
      self-attending — both attention blocks share one LayerNorm and one
      set of q/k/v/out weights, as upstream), emotion_adv_fc (→1 row)
    → cond_emb [n_rows=34, hidden=1024]

The perceiver's attention is plain torch ops (codec_tpu runs it as an
einsum, not as a kernel of its own).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops.blocks import lstm_layer, lstm_stack
from .base import tensors_from_tree

PERCEIVER_HEADS = 4
PERCEIVER_QUERIES = 32


@dataclass(frozen=True)
class VeConfig:
    n_mels: int = 40
    hidden_size: int = 256
    num_layers: int = 3
    embed_size: int = 256
    n_fft: int = 400
    hop: int = 160
    win: int = 400
    partial_frames: int = 160
    sample_rate: int = 16000
    overlap: float = 0.5
    rate: float = 1.3
    min_coverage: float = 0.8
    final_relu: bool = True
    hidden_dim: int = 1024
    n_rows: int = 34

    @classmethod
    def from_gguf(cls, r: GGUFReader, hidden_dim: int) -> "VeConfig":
        d = cls()
        return cls(
            n_mels=r.get_i32("codec.speaker.ve.num_mels", d.n_mels),
            hidden_size=r.get_i32("codec.speaker.ve.hidden_size", d.hidden_size),
            num_layers=r.get_i32("codec.speaker.ve.num_layers", d.num_layers),
            embed_size=r.get_i32("codec.speaker.ve.speaker_embed_dim",
                                 d.embed_size),
            n_fft=r.get_i32("codec.speaker.ve.n_fft", d.n_fft),
            hop=r.get_i32("codec.speaker.ve.hop_size", d.hop),
            win=r.get_i32("codec.speaker.ve.win_size", d.win),
            partial_frames=r.get_i32("codec.speaker.ve.partial_frames",
                                     d.partial_frames),
            sample_rate=r.get_i32("codec.speaker.ref_sample_rate",
                                  d.sample_rate),
            overlap=r.get_f32("codec.speaker.ve.overlap", d.overlap),
            rate=r.get_f32("codec.speaker.ve.rate", d.rate),
            min_coverage=r.get_f32("codec.speaker.ve.min_coverage",
                                   d.min_coverage),
            final_relu=r.get_bool("codec.speaker.ve.final_relu", d.final_relu),
            hidden_dim=r.get_i32("codec.speaker.hidden_dim", hidden_dim),
            n_rows=r.get_i32("codec.speaker.n_rows", d.n_rows),
        )


def ve_mel_partials(pcm: np.ndarray, mel_basis: np.ndarray, window: np.ndarray,
                    cfg: VeConfig) -> np.ndarray:
    """16 kHz mono PCM → partials [n_wins, partial_frames, n_mels] f32
    (reference: codec_runtime_chatterbox_ve_mel_partials). A copy of
    codec_tpu's host NumPy."""
    pcm = np.asarray(pcm, np.float64).reshape(-1)
    n_fft, hop = cfg.n_fft, cfg.hop
    pad = n_fft // 2
    if pad >= len(pcm):
        raise ValueError("PCM too short for reflect padding")
    padded = np.pad(pcm, (pad, pad), mode="reflect")
    n_frames = 1 + len(pcm) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = padded[idx] * np.asarray(window, np.float64)
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2              # [T, n_freq]
    mel = power @ np.asarray(mel_basis, np.float64).T             # [T, n_mels]
    mel = mel.astype(np.float32)

    # get_num_wins slicing
    pf = cfg.partial_frames
    if cfg.rate <= 0.0:
        frame_step = int(round(pf * (1.0 - cfg.overlap)))
    else:
        frame_step = int(round(16000.0 / cfg.rate / pf))
    if frame_step <= 0 or frame_step > pf:
        raise ValueError("invalid frame_step (rate / overlap out of range)")
    numer = max(n_frames - pf + frame_step, 0)
    n_wins, rem = divmod(numer, frame_step)
    if n_wins == 0 or (rem + (pf - frame_step)) / pf >= cfg.min_coverage:
        n_wins += 1
    target_n = pf + frame_step * (n_wins - 1)
    if target_n > n_frames:
        mel = np.pad(mel, ((0, target_n - n_frames), (0, 0)))
    else:
        mel = mel[:target_n]
    starts = frame_step * np.arange(n_wins)
    return np.stack([mel[s:s + pf] for s in starts])              # [W, pf, M]


def _ve_params(lstm, proj_w, proj_b) -> Dict[str, Any]:
    return {"lstm": [lstm_layer(lw["w_ih"], lw["w_hh"], lw["b_ih"], lw["b_hh"])
                     for lw in lstm],
            "proj_w": proj_w, "proj_b": proj_b}


def load_ve_params(r: GGUFReader, cfg: VeConfig, device="cuda") -> Dict[str, Any]:
    def g(n):
        return torch.from_numpy(np.array(r.get(n), np.float32)).to(device)

    lstm = [{k: g(f"speaker.voice_encoder.lstm_{l}.{src}")
             for k, src in (("w_ih", "W_ih"), ("w_hh", "W_hh"),
                            ("b_ih", "b_ih"), ("b_hh", "b_hh"))}
            for l in range(cfg.num_layers)]
    return _ve_params(lstm, g("speaker.voice_encoder.proj.weight"),
                      g("speaker.voice_encoder.proj.bias"))


def ve_params_from_jax(tree, device="cpu") -> Dict[str, Any]:
    """codec_tpu's `load_ve_params` tree (NumPy leaves) → this module's."""
    t = tensors_from_tree(tree, device)
    return _ve_params(t["lstm"], t["proj_w"], t["proj_b"])


_COND_TENSORS = {
    "spkr_enc_w": ".spkr_enc.weight", "spkr_enc_b": ".spkr_enc.bias",
    "emotion_w": ".emotion_adv_fc.weight", "queries": ".perceiver.queries",
    "norm_w": ".perceiver.norm.weight", "norm_b": ".perceiver.norm.bias",
    "q_w": ".perceiver.to_q.weight", "q_b": ".perceiver.to_q.bias",
    "k_w": ".perceiver.to_k.weight", "k_b": ".perceiver.to_k.bias",
    "v_w": ".perceiver.to_v.weight", "v_b": ".perceiver.to_v.bias",
    "o_w": ".perceiver.proj_out.weight", "o_b": ".perceiver.proj_out.bias"}


def load_cond_params(r: GGUFReader, device="cuda") -> Dict[str, torch.Tensor]:
    def g(n):
        return torch.from_numpy(np.array(r.get(n), np.float32)).to(device)

    p = {k: g("lm.chatterbox.cond" + suffix)
         for k, suffix in _COND_TENSORS.items()}
    p["queries"] = p["queries"].reshape(PERCEIVER_QUERIES, -1)
    p["speech_emb"] = g("lm.audio_embd_0.weight")
    p["speech_pos_emb"] = g("lm.chatterbox.speech_pos_emb.weight")
    return p


def cond_params_from_jax(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """codec_tpu's `load_cond_params` dict (NumPy leaves) → this module's."""
    return tensors_from_tree(tree, device)


def ve_embed_fn(params, partials: torch.Tensor, cfg: VeConfig) -> torch.Tensor:
    """partials [W, pf, n_mels] → spk_emb_raw [embed_size]."""
    h = lstm_stack(partials, params["lstm"], skip=False)          # [W, pf, H]
    e = F.linear(h[:, -1], params["proj_w"], params["proj_b"])
    if cfg.final_relu:
        e = F.relu(e)
    e = e / torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True) + 1e-12)
    m = torch.mean(e, dim=0)
    return m / torch.sqrt(torch.sum(m * m) + 1e-12)


def _perc_attn(x1, x2, p):
    """AttentionBlock2 with the weights both perceiver blocks share
    (reference perceiver_attn_block). x1 [Tq, H], x2 [Tk, H]."""
    h = x1.shape[-1]
    hd = h // PERCEIVER_HEADS

    def ln(x):
        return F.layer_norm(x, (h,), p["norm_w"], p["norm_b"], 1e-5)

    x1n, x2n = ln(x1), ln(x2)
    q = F.linear(x1n, p["q_w"], p["q_b"]).reshape(-1, PERCEIVER_HEADS, hd)
    k = F.linear(x2n, p["k_w"], p["k_b"]).reshape(-1, PERCEIVER_HEADS, hd)
    v = F.linear(x2n, p["v_w"], p["v_b"]).reshape(-1, PERCEIVER_HEADS, hd)
    logits = torch.einsum("qhd,khd->hqk", q, k) * (hd ** -0.5)
    o = torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v)
    return x1 + F.linear(o.reshape(-1, h), p["o_w"], p["o_b"])


def cond_enc_fn(params, spk_emb: torch.Tensor, ref_tokens: torch.Tensor,
                emotion: float) -> torch.Tensor:
    """spk_emb [E], ref_tokens [T] int64, emotion → cond_emb [34, H]
    (reference build_cond_graph)."""
    cond_spkr = F.linear(spk_emb, params["spkr_enc_w"], params["spkr_enc_b"])
    cond_emotion = float(emotion) * params["emotion_w"][:, 0]
    seq = params["speech_emb"][ref_tokens] \
        + params["speech_pos_emb"][: ref_tokens.shape[0]]
    att = _perc_attn(params["queries"], seq, params)
    att = _perc_attn(att, att, params)
    return torch.cat([cond_spkr[None], att, cond_emotion[None]], dim=0)


class ChatterboxSpeakerEncoder:
    """reference: chatterbox_speaker_encode / _from_emb. Weights on
    `device`; the mel front-end stays on the host."""

    def __init__(self, reader: GGUFReader, hidden_dim: int, device="cuda"):
        self.device = torch.device(device)
        self.cfg = VeConfig.from_gguf(reader, hidden_dim)
        self.ve_params = load_ve_params(reader, self.cfg, self.device)
        self.cond_params = load_cond_params(reader, self.device)
        self.mel_basis = np.asarray(
            reader.get("speaker.voice_encoder.mel_basis"), np.float64)
        self.window = np.asarray(
            reader.get("speaker.voice_encoder.window"), np.float64)

    def embed_ref(self, pcm: np.ndarray) -> np.ndarray:
        """16 kHz mono PCM → speaker embedding [embed_size]."""
        partials = ve_mel_partials(pcm, self.mel_basis, self.window, self.cfg)
        with torch.inference_mode():
            e = ve_embed_fn(self.ve_params,
                            torch.from_numpy(partials).to(self.device),
                            self.cfg)
            return e.cpu().numpy()

    def cond_emb(self, spk_emb: np.ndarray, ref_tokens: np.ndarray,
                 emotion: float) -> np.ndarray:
        """→ cond block [n_rows, hidden]."""
        toks = np.asarray(ref_tokens, np.int64).reshape(-1)
        with torch.inference_mode():
            c = cond_enc_fn(
                self.cond_params,
                torch.from_numpy(np.array(spk_emb, np.float32)).to(self.device),
                torch.from_numpy(toks).to(self.device), emotion)
            return c.cpu().numpy()

    def encode(self, ref_pcm: np.ndarray, ref_tokens: np.ndarray,
               emotion: float) -> np.ndarray:
        return self.cond_emb(self.embed_ref(ref_pcm), ref_tokens, emotion)
