"""Arch-string → model-class registry (counterpart of
codec_tpu/models/registry.py). Only the archs ported so far are listed."""

from __future__ import annotations

from typing import Callable, Dict, Type

from ..runtime.model import CodecError, CodecModel

_REGISTRY: Dict[str, Callable[[], Type[CodecModel]]] = {}


def register(*archs: str):
    def deco(fn: Callable[[], Type[CodecModel]]):
        for arch in archs:
            _REGISTRY[arch] = fn
        return fn
    return deco


def get_model_class(arch: str) -> Type[CodecModel]:
    if arch not in _REGISTRY:
        raise CodecError(f"codec architecture {arch!r} is not yet ported to "
                         f"codec_tpu_torch (ported: {known_archs()})")
    return _REGISTRY[arch]()


def known_archs():
    return sorted(_REGISTRY)


@register("mimi")
def _mimi():
    from .mimi_model import MimiCodec
    return MimiCodec


@register("dac")
def _dac():
    from .dac import DacCodec
    return DacCodec


@register("wavtokenizer", "wavtokenizer_large", "wavtokenizer-large")
def _wavtokenizer():
    from .wavtokenizer import WavTokenizerCodec
    return WavTokenizerCodec


@register("snac", "snac_24khz")
def _snac():
    from .snac import SnacCodec
    return SnacCodec


@register("soprano")
def _soprano():
    from .soprano import SopranoCodec
    return SopranoCodec


@register("xy_tokenizer", "xy-tokenizer")
def _xy():
    from .xy_tokenizer import XyTokenizerCodec
    return XyTokenizerCodec


@register("qwen3_tts_tokenizer", "qwen3-tts-tokenizer", "qwen3")
def _qwen3():
    from .qwen3_tts import Qwen3TTSTokenizerCodec
    return Qwen3TTSTokenizerCodec


@register("pocket_mimi", "pocket-mimi", "pocket_tts")
def _pocket():
    from .pocket_mimi import PocketMimiCodec
    return PocketMimiCodec


@register("neucodec")
def _neucodec():
    from .neucodec import NeuCodec
    return NeuCodec


@register("distill_neucodec", "distill-neucodec")
def _distill_neucodec():
    from .neucodec import DistillNeuCodec
    return DistillNeuCodec


@register("xcodec2", "x-codec2", "x_codec2")
def _xcodec2():
    from .xcodec2 import XCodec2
    return XCodec2


@register("moss_audio_tokenizer", "moss-audio-tokenizer", "moss_audio")
def _moss():
    from .moss_audio import MossAudioCodec
    return MossAudioCodec


@register("nemo_nano_codec", "nemo-nano-codec", "nemo")
def _nemo():
    from .nemo_nano import NemoNanoCodec
    return NemoNanoCodec


@register("bluemagpie_audiovae", "bluemagpie-audiovae")
def _bluemagpie():
    from .bluemagpie import BlueMagpieAudioVAE
    return BlueMagpieAudioVAE


@register("chatterbox_s3t", "chatterbox-s3t", "s3t")
def _s3t():
    from .chatterbox_s3t import ChatterboxS3T
    return ChatterboxS3T
