"""Per-model-family prompt templates + flow flags.

Reference behavior: audio_lm_get_prompt_info (common/audio_lm.cpp:908-1100):
the codec GGUF's `codec.lm.*` metadata picks the host-LLM chat template,
flow kind (continuous / streaming-interleave / sequential text→audio /
codebook-AR), special ids, and sampling defaults.

A copy of codec_tpu/lm/prompt_info.py (NumPy only), kept here because importing
codec_tpu imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..io.gguf import GGUFReader

MOSS_TTSD_PREFIX = (
    "<|begin_of_style|>You are a speech synthesizer that generates "
    "natural, realistic, and human-like conversational audio from "
    "dialogue text.<|end_of_style|>\n<|begin_of_text|>")
MOSS_REALTIME_PREFIX = (
    "<|im_start|>system\nYou are a highly expressive "
    "text-to-speech (TTS) engine developed by Mosi "
    "Intelligence. \nYou possess natural language "
    "understanding, emotional modeling, and multi-style "
    "speech generation capabilities, allowing you to generate "
    "the corresponding speech based on the text given in the "
    "assistant.<|im_end|>\n<|im_start|>user\n")
LFM2_PREFIX = (
    "<|im_start|>system\nPerform TTS. Use the US male voice."
    "<|im_end|>\n<|im_start|>user\n")


@dataclass
class PromptInfo:
    host_arch: str = ""
    model_kind: str = ""
    n_codebook: int = 0
    hidden_dim: int = 0
    is_continuous: bool = False
    eos_code_c0: int = -1
    eos_min_step: int = 0
    cb0_speech_range_start: int = -1
    cb0_speech_range_end: int = -1
    prompt_prefix: str = ""
    prompt_suffix: str = ""
    add_bos: bool = False
    parse_special: bool = True
    cb0_from_backbone: bool = False
    audio_codebook_offset: int = 0
    # streaming interleave (MOSS-TTS-Realtime)
    streaming_interleave: bool = False
    text_externally_added: bool = True
    prefill_text_len: int = 12
    text_pad_id: int = 151655
    audio_pad_code: int = 1024
    bos_code_c0: int = 1025
    # sequential text→audio (LFM2-Audio)
    sequential_text_audio: bool = False
    audio_start_id: int = 128
    text_end_id: int = 7
    max_text_tokens: int = 64
    # sampling defaults
    default_temperature: float = 0.9
    default_top_p: float = 0.95
    default_top_k: int = 50
    default_repetition_penalty: float = 1.0
    repetition_window: int = 0


def build_prompt_info(reader: GGUFReader, lm_info=None) -> PromptInfo:
    pi = PromptInfo()
    pi.host_arch = reader.get_str("codec.lm.host_arch", "")
    kind = reader.get_str("codec.lm.kind", "")
    pi.model_kind = kind
    if lm_info is not None:
        pi.n_codebook = lm_info.n_codebook
        pi.hidden_dim = lm_info.hidden_dim
        pi.is_continuous = lm_info.is_continuous
        pi.eos_code_c0 = lm_info.eos_code_c0
        pi.eos_min_step = lm_info.eos_min_step
    pi.cb0_speech_range_start = reader.get_i32("codec.lm.cb0_speech_offset", -1)
    pi.cb0_speech_range_end = reader.get_i32("codec.lm.cb0_speech_range_end", -1)
    pi.audio_codebook_offset = reader.get_i32("codec.lm.audio_cb_offset", 0)
    is_delay = kind == "parallel_heads_delay"
    is_depth = kind == "residual_depth_ar"

    if pi.host_arch == "barbet" or pi.is_continuous:
        pi.prompt_prefix, pi.prompt_suffix = "<|bm_spk|>", "<|bm_audio_start|>"
        pi.is_continuous = True
        return pi

    if pi.host_arch == "llama":
        pi.prompt_prefix, pi.prompt_suffix = "[0]", "<|end_of_text|>"
        pi.add_bos = True
        return pi

    if pi.host_arch == "qwen3":
        pi.cb0_from_backbone = is_delay
        if is_delay:                                    # MOSS-TTSD
            pi.prompt_prefix = MOSS_TTSD_PREFIX
            pi.prompt_suffix = "<|end_of_text|>\n<|begin_of_speech|>"
            return pi
        c0mod = reader.get_str("codec.lm.residual.c0_input_modality", "")
        if is_depth and c0mod == "none":                # MOSS-TTS-Realtime
            pi.prompt_prefix = MOSS_REALTIME_PREFIX
            pi.prompt_suffix = "<|im_end|>\n<|im_start|>assistant\n"
            pi.streaming_interleave = True
            pi.text_externally_added = reader.get_bool(
                "codec.lm.compose.text_externally_added", True)
            pi.prefill_text_len = reader.get_i32(
                "codec.lm.compose.prefill_text_len", 12)
            pi.text_pad_id = reader.get_i32("codec.lm.text_pad", 151655)
            pi.audio_pad_code = reader.get_i32("codec.lm.audio_pad_token", 1024)
            pi.bos_code_c0 = reader.get_i32("codec.lm.bos_code_c0", 1025)
            pi.default_temperature = 0.8
            pi.default_top_p = 0.6
            pi.default_top_k = 30
            pi.default_repetition_penalty = 1.1
            pi.repetition_window = 50
            return pi
        pi.prompt_prefix = "<|im_start|>user\n"         # Qwen3-TTS ChatML
        pi.prompt_suffix = "<|im_end|>\n<|im_start|>assistant\n"
        return pi

    if pi.host_arch == "lfm2":
        pi.prompt_prefix = LFM2_PREFIX
        pi.prompt_suffix = "<|im_end|>\n<|im_start|>assistant\n"
        pi.add_bos = True
        pi.sequential_text_audio = True
        pi.audio_start_id = reader.get_i32("codec.lm.audio_start_id", 128)
        pi.text_end_id = reader.get_i32("codec.lm.text_end_id", 7)
        pi.max_text_tokens = reader.get_i32("codec.lm.max_text_tokens", 64)
        pi.default_temperature = 0.0
        pi.default_top_p = 1.0
        pi.default_top_k = 0
        return pi

    return pi
