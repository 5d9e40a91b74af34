"""The codec_lm layer and the TTS host loops (counterpart of codec_tpu/lm).

Ported: the four adaptor kinds (residual_depth_ar, parallel_heads_delay,
continuous_latent_cfm, flow_lm), the llama-family backbone with packed
Q8_0/Q4_K weights (backbone.py), the codebook-AR flow
(tts_runner.run_codebook_ar, on the host or on the device in CUDA-graph
chunks, fused_gen.py; tts_runner.run_codebook_ar_batch) and the
continuous-latent flow (tts_runner.run_continuous). FlowLM needs no
backbone: cli/tts_cli.py::run_flow_synthesize drives it."""

from .base import CodecLM, LmInfo, LmState, create_lm  # noqa: F401
from . import (continuous_cfm, flow_lm, parallel_heads_delay,  # noqa: F401
               residual_depth_ar)  # (each registers its kind)
