"""On-device token sampling for the captured frame and chunk loops
(counterpart of codec_tpu/ops/sample.py).

The reference samples on the host (llama.cpp's sampler chain, order:
penalties -> temperature -> top_k -> min_p -> top_p). Here the chain runs
on the device inside the frame, so that a frame (and a chunk of frames)
needs no host round trip. Every filter masks raw logits to -inf, which
equals llama.cpp's candidate-list truncation followed by a softmax over
the survivors.

Randomness comes in as data: a categorical draw is argmax(logits + g) with
g standard Gumbel noise of the logits' shape, which is exactly what
`jax.random.categorical(key, logits)` computes from
`jax.random.gumbel(key, logits.shape)`. The samplers take that noise
instead of a key; the runners draw it (`gumbel`) from a torch.Generator
outside the captured graph, and tests can feed the noise that JAX's key
splits make.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_NEG = float("-inf")


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in [0, 1), float32,
    drawn from `generator` on `device` (U = 0 gives -inf: never drawn)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u))


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits (ties at the threshold all survive)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, _NEG)


def _apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens with prob < min_p * max_prob: keep logit >= max_logit +
    log(min_p)."""
    if min_p <= 0.0:
        return logits
    cutoff = logits.amax(dim=-1, keepdim=True) + float(
        np.log(np.float32(min_p)))
    return torch.where(logits >= cutoff, logits, _NEG)


def _top_p_threshold(lg: torch.Tensor, top_p) -> torch.Tensor:
    """The smallest logit of the shortest descending-probability prefix
    whose mass reaches top_p (the token that crosses it is kept), [..., 1]."""
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    return torch.where(keep, sorted_lg, float("inf")).amin(dim=-1,
                                                            keepdim=True)


def _apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter (llama.cpp llama_sampler_top_p)."""
    if top_p >= 1.0:
        return logits
    return torch.where(logits >= _top_p_threshold(logits, top_p), logits,
                       _NEG)


def mask_outside_range(logits: torch.Tensor, start: int, end: int,
                       extra=()) -> torch.Tensor:
    """-inf every logit outside [start, end) except the `extra` ids (the
    host RangeConstraint's set; all bounds are Python ints)."""
    idx = torch.arange(logits.shape[-1], device=logits.device)
    keep = (idx >= int(start)) & (idx < int(end))
    for e in extra:
        if e is not None and 0 <= int(e) < logits.shape[-1]:
            keep = keep | (idx == int(e))
    return torch.where(keep, logits, _NEG)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """llama-style repetition penalty on raw logits: seen positive logits
    are divided by the penalty, negative ones multiplied. `seen` is a bool
    mask over the vocab."""
    if penalty == 1.0:
        return logits
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def seen_mask_from_ring(ring: torch.Tensor, vocab: int) -> torch.Tensor:
    """Bool [..., vocab] mask of the ids in a history ring [..., W].

    As codec_tpu's scatter does, a negative id counts from the end (an
    empty slot, -1, marks id vocab - 1) and ids outside [-vocab, vocab)
    mark nothing."""
    mask = torch.zeros((*ring.shape[:-1], vocab + 1), dtype=torch.bool,
                       device=ring.device)
    idx = torch.where(ring < 0, ring + vocab, ring).long()
    idx = torch.where((idx >= 0) & (idx < vocab), idx, vocab)
    return mask.scatter(-1, idx, True)[..., :vocab]


def sample_logits(logits: torch.Tensor, noise: torch.Tensor | None, *,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0, min_p: float = 0.0) -> torch.Tensor:
    """Sampled ids (int64) from logits [..., V] with a static chain.

    temperature <= 0 is greedy argmax (noise unused, may be None). Else
    temperature -> top_k -> min_p -> top_p, then argmax(lg + noise), noise
    standard Gumbel [..., V]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    lg = _apply_top_k(lg, int(top_k))
    lg = _apply_min_p(lg, float(min_p))
    lg = _apply_top_p(lg, float(top_p))
    return torch.argmax(lg + noise, dim=-1)


def sample_logits_dyn(logits: torch.Tensor, noise: torch.Tensor,
                      chain: torch.Tensor) -> torch.Tensor:
    """`sample_logits` with the chain as a tensor [..., 4] `[temperature,
    top_k, top_p, min_p]` (one row per stream: per-request parameters in
    one captured graph). Per element as the static path: temperature <= 0
    is greedy argmax over the raw logits; top_k outside [1, V), top_p >= 1
    and min_p <= 0 each turn that filter off."""
    v = logits.shape[-1]
    temp, top_k, top_p, min_p = (chain[..., i:i + 1] for i in range(4))
    lg = logits.float() / torch.where(temp > 0.0, temp, 1.0)
    ki = top_k.long()
    kth = torch.gather(torch.sort(lg, dim=-1, descending=True).values, -1,
                       ki.clamp(1, v) - 1)
    k_on = (ki >= 1) & (ki < v)
    lg = torch.where(k_on & (lg < kth), _NEG, lg)
    cut = lg.amax(dim=-1, keepdim=True) + torch.log(min_p.clamp_min(1e-30))
    lg = torch.where((min_p > 0.0) & (lg < cut), _NEG, lg)
    lg = torch.where((top_p < 1.0) & (lg < _top_p_threshold(lg, top_p)),
                     _NEG, lg)
    sampled = torch.argmax(lg + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp[..., 0] > 0.0, sampled, greedy)


@dataclass(frozen=True)
class OnDeviceSampling:
    """Asks the AR runners for the on-device frame instead of the host
    sampler chain. `seed` seeds the torch.Generator the Gumbel noise is
    drawn from (stream s of a batch: seed + s).

    `chunk_frames` whole frames (LM frame + EOS gate + feedback compose +
    backbone step) per device call (lm/fused_gen.py), on CUDA one replay
    of a captured graph; a backbone the chunk cannot run takes one frame
    per call and its own host step."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0xC0DEC1AB
    chunk_frames: int = 1
    # the repetition penalty of the Chatterbox chunk (over its whole
    # history) and the realtime-streaming chunk (over the last
    # `repetition_window` frames per codebook, < 0 all, 0 none); the other
    # codebook-AR chunks take none
    repetition_penalty: float = 1.0
    repetition_window: int = 0

    def chain_vec(self) -> np.ndarray:
        """This config's chain as the f32[4] row `sample_logits_dyn` takes."""
        return np.asarray([self.temperature, self.top_k, self.top_p,
                           self.min_p], np.float32)
