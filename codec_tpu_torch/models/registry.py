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


@register("snac", "snac_24khz")
def _snac():
    from .snac import SnacCodec
    return SnacCodec
