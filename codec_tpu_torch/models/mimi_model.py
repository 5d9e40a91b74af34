"""MimiCodec: the CodecModel over models/mimi.py (counterpart of
codec_tpu/models/mimi_model.py). Encode and decode are ported; the
streaming sessions are not yet."""

from __future__ import annotations

import torch

from ..io.gguf import GGUFReader
from ..runtime.model import CodecError, CodecModel
from .mimi import (MimiConfig, load_mimi_params, mimi_decode_fn,
                   mimi_encode_fn)


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

    def streaming_decoder(self, n_q: int = 0, batch: int = 1):
        raise CodecError("mimi: streaming decode not yet ported")

    def streaming_encoder(self, n_q: int = 0, batch: int = 1):
        raise CodecError("mimi: streaming encode not yet ported")
