"""parallel_heads_delay (Type D): N parallel linear heads off one backbone
hidden, per-codebook audio-embedding tables, optional tied heads, and the
optional Chatterbox learned speech position embedding on
compose_next_embd (counterpart of codec_tpu/lm/parallel_heads_delay.py).

Reference: src/lm/parallel_heads_delay.cpp. All N logits are computed at
step_begin; step_logits hands out one row at a time. Models: MOSS-TTSD
(codebook sizes differ: c0 is the backbone's text vocabulary, the rest
audio codes).

The on-device frame (`_build_frame`) runs every head and its in-graph
sample (ops/sample.py) for B streams, head 0 masked to the cb0 speech
range; each head is its own product at its own width (no padded stack:
MOSS-TTSD's head 0 is 152 697 rows wide, the others 1025). lm/fused_gen.py
chains it with `compose_embd_fn` and the backbone step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..io.gguf import GGUFReader
from ..ops.sample import mask_outside_range, sample_logits, sample_logits_dyn
from .base import CodecLM, LmError, LmInfo, LmState, read_common_info, register_kind


def params_from_jax(heads, audio_embds, pos_emb=None, device="cpu"
                    ) -> Dict[str, Any]:
    """codec_tpu's ParallelHeadsDelayLM weights (`heads`, `audio_embds`,
    `pos_emb`; NumPy arrays or anything np.asarray takes) → this module's
    {"heads", "audio_embds", "pos_emb"}: f32 tensors on `device`, a tied
    head the same tensor as its table (as codec_tpu's tie is), pos_emb a
    NumPy array or None."""
    tabs = [torch.from_numpy(np.array(e, np.float32)).to(device)
            for e in audio_embds]
    out_heads = [tabs[i] if h is audio_embds[i] else
                 torch.from_numpy(np.array(h, np.float32)).to(device)
                 for i, h in enumerate(heads)]
    return {"heads": out_heads, "audio_embds": tabs,
            "pos_emb": None if pos_emb is None else np.asarray(pos_emb,
                                                               np.float32)}


@register_kind("parallel_heads_delay")
class ParallelHeadsDelayLM(CodecLM):
    def _load(self, r: GGUFReader) -> LmInfo:
        info = read_common_info(r, "parallel_heads_delay")
        tied = r.get_bool("codec.lm.parallel.tied_heads_to_embd", False)
        dev = self.device

        def g(name):
            return torch.from_numpy(np.array(r.get(name), np.float32)).to(dev)

        self.audio_embds: List[torch.Tensor] = []
        self.heads: List[torch.Tensor] = []
        for i in range(info.n_codebook):
            self.audio_embds.append(g(f"lm.audio_embd_{i}.weight"))  # [V_i, hidden]
            self.heads.append(self.audio_embds[-1] if tied
                              else g(f"lm.heads_{i}.weight"))
        # Chatterbox's learned per-step position embedding (optional)
        pe = r.get_or_none("lm.chatterbox.speech_pos_emb.weight")
        self.pos_emb = None if pe is None else np.asarray(pe, np.float32)
        if not info.codebook_sizes:
            info.codebook_sizes = tuple(int(h.shape[0]) for h in self.heads)
        return info

    # -- step machine hooks ------------------------------------------------
    def _begin(self, state: LmState, h: np.ndarray) -> None:
        hd = torch.from_numpy(np.array(h, np.float32)).to(self.device)
        with torch.inference_mode():
            # every head's logits in one copy to the host
            outs = torch.cat([head @ hd for head in self.heads]).cpu().numpy()
        cuts = np.cumsum([int(head.shape[0]) for head in self.heads])[:-1]
        state.kind_state["logits"] = np.split(outs, cuts)

    def _logits(self, state: LmState, k: int) -> np.ndarray:
        return state.kind_state["logits"][k]

    # -- on-device frame -----------------------------------------------------
    def noise_width(self) -> int:
        """The last dim of the frame's Gumbel noise [..., n_codebook, W]:
        the widest head (head k reads the first V_k columns)."""
        return max(int(h.shape[0]) for h in self.heads)

    def _build_frame(self, chain, cb0_range=None) -> Callable:
        """The batched frame for a sampler chain: frame(h [B, hidden] f32,
        noise [B, n_codebook, noise_width()] f32, text_ctx [B] (unused: the
        frame signature every kind shares), chains=None) → codes [B,
        n_codebook] int64, with no host read (the heads are independent
        given the hidden, so this is exact, not only fast).

        `chain` is (temperature, top_k, top_p, min_p), or None for the chain
        as data, `chains` [B, 4] (`sample_logits_dyn`). `cb0_range=(start,
        end, *extra)` masks head 0 to the host RangeConstraint's set
        (MOSS-TTSD's merged text vocabulary; reference auto-grammar,
        common/audio_lm.cpp:1164)."""
        if chain is None:
            def sample(lg, g, cv):
                return sample_logits_dyn(lg, g, cv)
        else:
            def sample(lg, g, cv):
                return sample_logits(lg, g, temperature=chain[0],
                                     top_k=chain[1], top_p=chain[2],
                                     min_p=chain[3])

        def frame(h, noise, text_ctx, chains=None):
            outs = []
            for i, head in enumerate(self.heads):
                lg = F.linear(h, head)
                if i == 0 and cb0_range is not None:
                    lg = mask_outside_range(lg, cb0_range[0], cb0_range[1],
                                            cb0_range[2:])
                outs.append(sample(lg, noise[:, i, : head.shape[0]], chains))
            return torch.stack(outs, dim=1)

        return frame

    def compose_embd_fn(self) -> Callable:
        """The device form of compose_audio_embd for the generation chunk
        (lm/fused_gen.py): codes [B, n_codebook] int64 → [B, hidden], the
        tables' rows summed in codebook order. Sampled codes are >= 0, so
        the host path's pad guard is not needed. Chatterbox's per-step
        pos_emb depends on the step: gen_chunk_ok keeps such models on the
        host loop."""
        def compose(codes):
            acc = self.audio_embds[0][codes[:, 0]]
            for i in range(1, len(self.audio_embds)):
                acc = acc + self.audio_embds[i][codes[:, i]]
            return acc

        return compose

    def gen_chunk_ok(self) -> bool:
        return self.pos_emb is None

    # -- embeddings --------------------------------------------------------
    def audio_embd(self, cb_idx: int, code: int) -> np.ndarray:
        if not (0 <= cb_idx < self.info.n_codebook):
            raise LmError(f"cb_idx {cb_idx} out of range")
        embd = self.audio_embds[cb_idx]
        if not (0 <= code < embd.shape[0]):
            raise LmError(f"code {code} out of range (code=-1 is pad; use compose)")
        return embd[code].cpu().numpy()

    def compose_audio_embd(self, codes: Sequence[int]) -> np.ndarray:
        """sum_i audio_embd[i][codes[i]], -1 a pad that adds nothing: one
        gather and one copy to the host, then the f32 sum in codebook
        order."""
        codes = [int(c) for c in codes]
        if len(codes) != self.info.n_codebook:
            raise LmError("codes length must equal n_codebook")
        out = np.zeros((self.info.hidden_dim,), np.float32)
        rows = [self.audio_embds[i][min(c, self.audio_embds[i].shape[0] - 1)]
                for i, c in enumerate(codes) if c >= 0]
        if rows:
            for row in torch.stack(rows).cpu().numpy():
                out += row
        return out

    def compose_next_embd(self, codes: Sequence[int], step: int = 0) -> np.ndarray:
        out = self.compose_audio_embd(codes)
        if self.pos_emb is not None:
            out = out + self.pos_emb[min(step, self.pos_emb.shape[0] - 1)]
        return out
