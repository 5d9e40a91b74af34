"""codec_tpu_torch — the codec engine on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of codec_tpu, which stays the reference it is held
against. All 16 of codec_tpu's codec archs (models/registry.py), Mimi's
and Pocket-Mimi's streaming sessions, the per-op profile table
(runtime/op_profile.py), every codec_lm kind and TTS flow
(codec_tpu_torch.lm), serving (codec_tpu_torch.serve) and the device mesh
(codec_tpu_torch.parallel) are ported:

    model = codec_tpu_torch.load_model("mimi.gguf", device="cuda")
    codes = model.encode(pcm)          # pcm [n] → [ceil(n/hop), n_q] int32
    pcm = model.decode(codes)          # codes [T, n_q] → [T*hop] float32

Importing the package builds nothing and touches no GPU; the CUDA kernels
(csrc/) are compiled with nvcc on first launch (kernels/build.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from .io.gguf import GGUFReader
from .models.registry import get_model_class, known_archs
from .runtime.model import CodecError, CodecModel

__version__ = "0.1.0"


def load_model(path: Union[str, Path], compute_dtype="float32",
               device=None, exact_encode: Optional[bool] = None,
               mesh=None, mesh_axis: str = "dp") -> CodecModel:
    """Load a codec GGUF → the arch's CodecModel, weights on `device`
    ("cuda" by default; with a mesh, the first device of its axis).

    compute_dtype: "float32" (the parity path; TF32 stays off), "bfloat16"
    (weights cast at load; RoPE and softmax stay float32), "auto"
    (bfloat16 when the checkpoint is mostly 16-bit), or a torch dtype.
    exact_encode: run encode with TF32 off for every matmul and conv
    (codes then match the f32 reference up to float near-ties). Default:
    on for f32 compute, off for bf16. Decode is unaffected.
    mesh: a parallel/mesh.py Mesh: one replica of the weights a device of
    `mesh_axis`, and every decode and encode batch split over them
    (data parallelism; CodecModel.set_mesh)."""
    if device is None:
        device = mesh.axis_devices(mesh_axis)[0] if mesh is not None \
            else "cuda"
    reader = GGUFReader(path)
    cls = get_model_class(reader.architecture)
    model = cls(reader, compute_dtype=compute_dtype, device=device)
    if exact_encode is not None:
        model.exact_encode = bool(exact_encode)
    if mesh is not None:
        model.set_mesh(mesh, axis=mesh_axis)
    return model


__all__ = ["load_model", "CodecModel", "CodecError", "GGUFReader",
           "known_archs"]
