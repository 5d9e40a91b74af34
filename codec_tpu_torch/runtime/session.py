"""What every streaming session shares (models/mimi_model.py's decode and
encode sessions, models/pocket_mimi.py's latent decoder): the batch
checked, a state on the model's device built by the model's `init`
function, reset(), and the batch axis of what a push takes."""

from __future__ import annotations

import numpy as np
import torch

from .model import CodecError


class StreamSession:
    """A stream of pushes over one model. `init(params, cfg, batch)` builds
    the zero state (conv carries, a KV carry, "pos" a host int)."""

    def __init__(self, model, batch: int, init):
        if batch < 1:
            raise CodecError(f"batch must be >= 1, got {batch}")
        self.model = model
        self.batch = batch
        self._init = init
        self.reset()

    def reset(self) -> None:
        """Start a new stream: zero carries, position 0."""
        with torch.inference_mode():
            self.state = self._init(self.model.params, self.model.cfg,
                                    self.batch)

    def _batched(self, x: np.ndarray, ndim: int, what: str):
        """x with the batch axis → (x [B, ...], squeeze)."""
        squeeze = x.ndim == ndim - 1
        if squeeze:
            x = x[None]
        if x.ndim != ndim or x.shape[0] != self.batch:
            raise CodecError(f"bad {what} shape {x.shape} for a session of "
                             f"batch {self.batch}")
        return x, squeeze
