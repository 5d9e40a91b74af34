"""The codec_lm layer and the TTS host loop (counterpart of codec_tpu/lm).

Ported: the residual_depth_ar kind (CSM-style), the llama-family
backbone with packed Q8_0/Q4_K weights (backbone.py), and the codebook-AR
flow (tts_runner.run_codebook_ar, on the host or on the device in CUDA-graph
chunks, fused_gen.py; tts_runner.run_codebook_ar_batch)."""

from .base import CodecLM, LmInfo, LmState, create_lm  # noqa: F401
from . import residual_depth_ar  # noqa: F401 (registers the kind)
