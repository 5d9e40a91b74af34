"""codec_lm — the adaptor between a host LLM and the codec (counterpart of
codec_tpu/lm/base.py).

The host LLM is never part of the adaptor: the boundary is data (a
backbone hidden in, logits or codes out), and sampling is the caller's
job. Each kind registers its class under its `codec.lm.kind` string:

  parallel_heads_delay  — N parallel heads off one hidden (MOSS-TTSD)
  residual_depth_ar     — c0 head + small depth transformer (CSM-style)
  continuous_latent_cfm — VoxCPM / BlueMagpie CFM diffusion patches
  flow_lm               — Pocket-TTS self-contained AR + flow head

State-machine invariants (reference: lm.cpp:563-705): exactly one
step_begin, then (step_logits, step_push_code) × n_codebook in order, then
one step_finish; out-of-order calls raise LmStateError.
"""

from __future__ import annotations

import copy

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.gguf import GGUFReader


class LmError(ValueError):
    pass


class LmStateError(LmError):
    """Out-of-phase state machine call (reference: CODEC_STATUS_INVALID_STATE)."""


@dataclass
class LmInfo:
    kind: str
    hidden_dim: int = 0
    audio_embed_dim: int = 0
    compose_audio_embed_dim: int = 0
    n_codebook: int = 0
    codebook_sizes: Tuple[int, ...] = ()
    delay_pattern: Tuple[int, ...] = ()
    host_arch: str = ""
    is_continuous: bool = False
    patch_size: int = 0
    latent_dim: int = 0
    eos_code_c0: int = -1
    eos_min_step: int = 0


_KIND_REGISTRY: Dict[str, Callable] = {}


def register_kind(kind: str):
    def deco(cls):
        _KIND_REGISTRY[kind] = cls
        return cls
    return deco


def create_lm(reader: GGUFReader, device="cuda") -> Optional["CodecLM"]:
    """The LM adaptor of an open codec GGUF with its weights on `device`,
    or None when `codec.lm.has_adaptor` is absent or false (reference:
    codec_lm_create)."""
    if not reader.get_bool("codec.lm.has_adaptor", False):
        return None
    kind = reader.get_str("codec.lm.kind")
    cls = _KIND_REGISTRY.get(kind)
    if cls is None:
        raise LmError(f"unrecognised codec.lm.kind: {kind!r}")
    return cls(reader, device=device)


def tensors_from_tree(tree, device="cpu"):
    """A codec_tpu weight tree (dicts and lists of NumPy arrays, or
    anything np.asarray takes; None where a tensor is absent) → the same
    tree of f32 tensors on `device` (the kinds' `params_from_jax`)."""
    if isinstance(tree, dict):
        return {k: tensors_from_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors_from_tree(v, device) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def read_common_info(r: GGUFReader, kind: str) -> LmInfo:
    hidden = r.get_i32("codec.lm.hidden_dim", 0)
    aed = r.get_i32("codec.lm.audio_embed_dim", hidden)
    n_cb = r.get_i32("codec.lm.n_codebook", 0)
    sizes = tuple(int(v) for v in r.get_arr("codec.lm.codebook_sizes", []))
    delays = tuple(int(v) for v in r.get_arr("codec.lm.delay_pattern", [0] * n_cb))
    if sizes and len(sizes) != n_cb:
        raise LmError("codec.lm.codebook_sizes length must equal n_codebook")
    return LmInfo(
        kind=kind,
        hidden_dim=hidden,
        audio_embed_dim=aed,
        compose_audio_embed_dim=r.get_i32("codec.lm.compose.audio_embed_dim", aed),
        n_codebook=n_cb,
        codebook_sizes=sizes,
        delay_pattern=delays if len(delays) == n_cb else (0,) * n_cb,
        host_arch=r.get_str("codec.lm.host_arch"),
        eos_code_c0=r.get_i32("codec.lm.eos_code_c0", -1),
        eos_min_step=r.get_i32("codec.lm.eos_min_step", 0),
    )


class CodecLM:
    """Base class for kind implementations; weights live on `device`."""

    def __init__(self, reader: GGUFReader, device="cuda"):
        self.reader = reader
        self.device = torch.device(device)
        self.info = self._load(reader)

    def _load(self, reader: GGUFReader) -> LmInfo:
        raise NotImplementedError

    def new_state(self) -> "LmState":
        return LmState(self)

    def on_device(self, device) -> "CodecLM":
        """This LM with its weights on `device`, for a data-parallel share
        whose frame runs there and reads no other device's tensor: itself
        where its weights already are (a device named twice, as on one
        card), else a copy made once and kept (its tensors placed with
        parallel/mesh.py::place, its caches of derived tensors emptied)."""
        from ..parallel.mesh import physical, place

        if physical(device) == physical(self.device):
            return self
        reps = self.__dict__.setdefault("_replicas", {})
        key = str(physical(device))
        if key not in reps:
            rep = copy.copy(self)
            rep.__dict__ = {
                k: None if k.endswith("_cache") else place(v, device)
                for k, v in self.__dict__.items()
                if k not in ("_replicas", "_frame_runners")}
            rep.device = torch.device(device)
            reps[key] = rep
        return reps[key]

    # -- kind hooks (codebook kinds) --------------------------------------
    def _begin(self, state: "LmState", h: np.ndarray) -> None:
        raise NotImplementedError

    def _logits(self, state: "LmState", k: int) -> np.ndarray:
        raise NotImplementedError

    def _pushed(self, state: "LmState", k: int, code: int) -> None:
        pass

    # -- embeddings --------------------------------------------------------
    def audio_embd(self, cb_idx: int, code: int) -> np.ndarray:
        raise NotImplementedError

    def compose_audio_embd(self, codes: Sequence[int]) -> np.ndarray:
        """sum_i audio_embd[i][codes[i]], with -1 = skip
        (reference: codec_lm_compose_audio_embd)."""
        raise NotImplementedError

    def compose_next_embd(self, codes: Sequence[int], step: int = 0) -> np.ndarray:
        return self.compose_audio_embd(codes)


class LmState:
    """Per-generation state (reference: codec_lm_state). Several states may
    share one CodecLM."""

    def __init__(self, lm: CodecLM):
        self.lm = lm
        self.kind_state: Dict[str, Any] = {}
        self.reset()

    def reset(self) -> None:
        self._phase = "idle"            # idle | begun | await_push | done
        self._k = 0
        self._codes: List[int] = []
        self.frame_counter = 0
        self.text_context: Optional[int] = None
        self.kind_state.clear()

    def set_text_context(self, text_token: int) -> None:
        """Moshi c0_input_modality='text': stash the backbone-sampled text
        token before step_begin (reference: codec_lm_state_set_text_context)."""
        self.text_context = int(text_token)

    # -- state machine -----------------------------------------------------
    def step_begin(self, h: np.ndarray) -> None:
        if self._phase != "idle":
            raise LmStateError("step_begin: previous step not finished")
        h = np.asarray(h, dtype=np.float32).reshape(-1)
        if h.shape[0] != self.lm.info.hidden_dim:
            raise LmError(f"hidden size {h.shape[0]} != {self.lm.info.hidden_dim}")
        self._k = 0
        self._codes = []
        self.lm._begin(self, h)
        self._phase = "begun"

    @property
    def step_pending(self) -> bool:
        """True while codebooks remain in the current frame (reference:
        codec_lm_step_pending, lm.cpp:592)."""
        return self._phase in ("begun", "await_push")

    def step_logits(self) -> Tuple[np.ndarray, int]:
        """→ (logits[codebook_sizes[k]], cb_idx)."""
        if self._phase != "begun":
            raise LmStateError("step_logits: call step_begin first / push pending code")
        logits = self.lm._logits(self, self._k)
        self._phase = "await_push"
        return logits, self._k

    def step_push_code(self, code: int) -> None:
        if self._phase != "await_push":
            raise LmStateError("step_push_code: no pending step_logits")
        size = self.lm.info.codebook_sizes[self._k]
        if not (0 <= code < size):
            raise LmError(f"code {code} out of range [0, {size}) for cb {self._k}")
        self._codes.append(int(code))
        self.lm._pushed(self, self._k, int(code))
        self._k += 1
        self._phase = "begun" if self._k < self.lm.info.n_codebook else "done"

    def step_finish(self) -> List[int]:
        if self._phase != "done":
            raise LmStateError("step_finish: not all codebooks pushed")
        codes = list(self._codes)
        self._phase = "idle"
        self.frame_counter += 1
        return codes

    def push_frame(self, codes: Sequence[int]) -> List[int]:
        """Record one whole frame made on the device (the kind's fused
        frame): checks the codes' ranges and advances the frame counter as
        a begin → (logits / push) × N → finish cycle would. The
        per-codebook machine stays the host-sampler and parity path."""
        if self._phase != "idle":
            raise LmStateError("push_frame: a per-codebook step is in flight")
        codes = [int(c) for c in codes]
        info = self.lm.info
        if len(codes) != info.n_codebook:
            raise LmError(f"push_frame: {len(codes)} codes != "
                          f"{info.n_codebook}")
        for k, c in enumerate(codes):
            size = info.codebook_sizes[k]
            if not (0 <= c < size):
                raise LmError(f"code {c} out of range [0, {size}) for cb {k}")
        self.frame_counter += 1
        return codes

    def step_is_eos(self, codes: Sequence[int]) -> bool:
        """reference: codec_lm_step_is_eos — cb0 sentinel + min-step gate."""
        info = self.lm.info
        if info.is_continuous:
            raise LmError("continuous kinds signal stop via step_generate")
        if info.eos_code_c0 < 0 or not codes:
            return False
        return codes[0] == info.eos_code_c0 and (self.frame_counter - 1) >= info.eos_min_step
