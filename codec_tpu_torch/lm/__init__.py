"""The codec_lm layer and the TTS host loops (counterpart of codec_tpu/lm).

Ported: the four adaptor kinds (residual_depth_ar, parallel_heads_delay,
continuous_latent_cfm, flow_lm), the llama-family backbone with packed
Q8_0/Q4_K weights and the Qwen3-MoE FFN (backbone.py), the codebook-AR flow
(tts_runner.run_codebook_ar, on the host or on the device in CUDA-graph
chunks, fused_gen.py, with GBNF grammars, gbnf.py;
tts_runner.run_codebook_ar_batch), the continuous-latent flow
(tts_runner.run_continuous, one step a call or K steps a CUDA-graph chunk)
and the Chatterbox T3 flow (chatterbox_t3.py, tts_runner.run_chatterbox:
both CFG lanes on the host or as one batch in CUDA-graph chunks),
MOSS-TTS-Realtime's streaming interleave and LFM2-Audio's sequential flow
(tts_runner.run_realtime_streaming, run_lfm2_sequential: on the host or in
CUDA-graph chunks, the realtime one with its repetition penalty), the two
speaker encoders (`create_speaker_encoder`) and the backbones' SPM and
byte-level BPE tokenizers (spm.py, bpe.py). FlowLM needs no backbone:
cli/tts_cli.py::run_flow_synthesize drives it."""

from .base import CodecLM, LmInfo, LmState, create_lm  # noqa: F401
from . import (continuous_cfm, flow_lm, parallel_heads_delay,  # noqa: F401
               residual_depth_ar)  # (each registers its kind)


def create_speaker_encoder(reader, device="cuda"):
    """The speaker encoder of a GGUF's `codec.speaker.*` section with its
    weights on `device` (reference: speaker_arch_init, lm.cpp:316, keyed on
    codec.speaker.encoder_arch), or None when the GGUF has none."""
    if not reader.get_bool("codec.speaker.has_encoder", False):
        return None
    arch = reader.get_str("codec.speaker.encoder_arch", "")
    hidden = reader.get_i32("codec.lm.hidden_dim", 1024)
    if arch == "chatterbox_voice_encoder":
        from .speaker_chatterbox import ChatterboxSpeakerEncoder

        return ChatterboxSpeakerEncoder(reader, hidden, device=device)
    if arch == "qwen3_tts_ecapa_tdnn":
        from .speaker_qwen3_tts import Qwen3TTSSpeakerEncoder

        return Qwen3TTSSpeakerEncoder(reader, hidden, device=device)
    raise ValueError(f"unknown speaker encoder arch: {arch!r}")
