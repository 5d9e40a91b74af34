"""codec_tpu_torch — the codec engine on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of codec_tpu, which stays the reference it is held
against. Only Mimi decode is ported so far:

    model = codec_tpu_torch.load_model("mimi.gguf", device="cuda")
    pcm = model.decode(codes)          # codes [T, n_q] → [T*hop] float32

Importing the package builds nothing and touches no GPU; the CUDA kernels
(csrc/) are compiled with nvcc on first launch (kernels/build.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from .io.gguf import GGUFReader
from .models.registry import get_model_class, known_archs
from .runtime.model import CodecError, CodecModel

__version__ = "0.1.0"


def load_model(path: Union[str, Path], compute_dtype="float32",
               device="cuda") -> CodecModel:
    """Load a codec GGUF → the arch's CodecModel, weights on `device`.

    compute_dtype: "float32" (the parity path; TF32 stays off), "bfloat16"
    (weights cast at load; RoPE and softmax stay float32), "auto"
    (bfloat16 when the checkpoint is mostly 16-bit), or a torch dtype."""
    reader = GGUFReader(path)
    cls = get_model_class(reader.architecture)
    return cls(reader, compute_dtype=compute_dtype, device=device)


__all__ = ["load_model", "CodecModel", "CodecError", "GGUFReader",
           "known_archs"]
