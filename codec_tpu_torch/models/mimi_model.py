"""MimiCodec: the CodecModel over models/mimi.py (counterpart of
codec_tpu/models/mimi_model.py), with its streaming decode and encode
sessions."""

from __future__ import annotations

import numpy as np
import torch

from ..io.gguf import GGUFReader
from ..runtime.model import CodecError, CodecModel, f32_precision
from ..runtime.session import StreamSession
from .mimi import (MimiConfig, load_mimi_params, mimi_decode_fn,
                   mimi_decode_stream_init, mimi_decode_stream_step,
                   mimi_encode_fn, mimi_encode_stream_init,
                   mimi_encode_stream_step)


class MimiCodec(CodecModel):
    arch = "mimi"

    def _load(self, reader: GGUFReader) -> None:
        self.cfg = MimiConfig.from_gguf(reader)
        self.params = load_mimi_params(reader, self.cfg,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        cfg = self.cfg
        self.sample_rate = cfg.sample_rate
        self.hop_size = cfg.hop_size
        self.n_q = cfg.n_q
        self.codebook_size = cfg.codebook_size
        self.latent_dim = cfg.hidden
        self.has_encoder = cfg.has_encoder
        self.has_decoder = cfg.has_decoder

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        return mimi_decode_fn(self.params, codes, self.cfg, n_q=n_q)

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        return mimi_encode_fn(self.params, pcm, self.cfg, n_q=n_q)

    def streaming_decoder(self, n_q: int = 0, batch: int = 1
                          ) -> "MimiStreamingDecoder":
        """Open a frame-streaming decode session (its chunks' PCM is what
        decode() gives for the whole stream)."""
        if not self.has_decoder:
            raise CodecError("mimi: model has no decoder")
        return MimiStreamingDecoder(self, n_q=n_q, batch=batch)

    def streaming_encoder(self, n_q: int = 0, batch: int = 1
                          ) -> "MimiStreamingEncoder":
        """Open a streaming encode session (chunks a multiple of hop_size;
        its codes are what encode() gives for the whole stream)."""
        if not self.has_encoder:
            raise CodecError("mimi: model has no encoder")
        return MimiStreamingEncoder(self, n_q=n_q, batch=batch)


class _Session(StreamSession):
    """A Mimi session: n_q checked against the model's, then the shared
    session (runtime/session.py)."""

    def __init__(self, model: MimiCodec, n_q: int, batch: int, init):
        if not 0 <= n_q <= model.n_q:
            raise CodecError(f"n_q must be 0 or in [1, {model.n_q}]")
        self.n_q = n_q if n_q > 0 else model.n_q
        super().__init__(model, batch, init)


class MimiStreamingDecoder(_Session):
    """Frame-streaming decode: push code chunks, receive their PCM at once
    (the codec's own latency only). Each push is one step of
    models/mimi.py::mimi_decode_stream_step on the model's device (8
    launches of the attention kernel at full width), under inference mode
    with TF32 off for f32."""

    def __init__(self, model: MimiCodec, n_q: int = 0, batch: int = 1):
        super().__init__(model, n_q, batch, mimi_decode_stream_init)

    def push(self, codes) -> np.ndarray:
        """codes [Tc, n_q] or [B, Tc, n_q] int → pcm [Tc*hop] or
        [B, Tc*hop] float32 on the host."""
        codes, squeeze = self._batched(np.asarray(codes), 3, "codes")
        if codes.shape[1] == 0 or codes.shape[2] < self.n_q:
            raise CodecError(f"bad codes shape {codes.shape}: want "
                             f"[B, Tc >= 1, >= {self.n_q}]")
        m = self.model
        c = torch.from_numpy(np.ascontiguousarray(codes[..., :self.n_q],
                                                  dtype=np.int64))
        with torch.inference_mode(), \
                f32_precision(m.compute_dtype == torch.float32):
            pcm, self.state = mimi_decode_stream_step(
                m.params, self.state, c.to(m.device), m.cfg, n_q=self.n_q)
            pcm = pcm.float().cpu().numpy()
        return pcm[0] if squeeze else pcm


class MimiStreamingEncoder(_Session):
    """Frame-streaming encode (the conversation direction, Moshi-style):
    push PCM chunks of a multiple of hop_size, receive their codes. Each
    push is one step of models/mimi.py::mimi_encode_stream_step on the
    model's device (8 attention and 2 RVQ-search kernel launches at full
    width), under inference mode with TF32 off when the model encodes
    exactly (its exact_encode)."""

    def __init__(self, model: MimiCodec, n_q: int = 0, batch: int = 1):
        super().__init__(model, n_q, batch, mimi_encode_stream_init)

    def push(self, pcm) -> np.ndarray:
        """pcm [n] or [B, n], float in [-1, 1] or int16, n a multiple of
        hop_size → codes [n/hop, n_q] or [B, n/hop, n_q] int32 on the
        host."""
        m = self.model
        pcm, squeeze = self._batched(m._pcm_host_f32(pcm), 2, "pcm")
        if pcm.shape[1] == 0 or pcm.shape[1] % m.hop_size:
            raise CodecError(f"chunk length {pcm.shape[1]} not a positive "
                             f"multiple of hop_size {m.hop_size}")
        x = torch.from_numpy(np.ascontiguousarray(pcm))
        with torch.inference_mode(), f32_precision(m.exact_encode):
            codes, self.state = mimi_encode_stream_step(
                m.params, self.state, x.to(m.device, m.compute_dtype), m.cfg,
                n_q=self.n_q)
            codes = codes.to(torch.int32).cpu().numpy()
        return codes[0] if squeeze else codes
