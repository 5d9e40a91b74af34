"""CodecModel: the public runtime object (load → encode / decode, and
decode_async / decode_many for callers with more than one request).

Counterpart of codec_tpu/runtime/model.py, eager: no jit cache, no shape
buckets, no mesh. Decoding at the exact T gives what the reference's
padded-and-cropped decode gives: a causal arch is cropped to T*hop
samples, and a non-causal one (`causal_time = False`) keeps its whole
output, as the reference decodes it unpadded. Encoding at the exact length
gives what the reference's bucketed encode gives: a causal arch pads each
strided conv's input with zeros to a stride multiple (ops/conv.py), which
is what the reference's per-layer re-mask of its bucket pad computes, and
is cropped to ceil(n/hop) frames. Each model holds its parameters on one
`device` in one `compute_dtype`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.gguf import (GGML_TYPE_BF16, GGML_TYPE_F16, GGML_TYPE_F32,
                       GGUFReader)
from . import op_profile
from .perf_log import perf_scope


class CodecError(ValueError):
    """Invalid-argument / invalid-state errors."""


_DTYPE_ALIASES = {
    "float32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "f16": torch.float16,
}


def resolve_compute_dtype(spec, reader: Optional[GGUFReader] = None
                          ) -> torch.dtype:
    """Resolve "float32" | "bfloat16" | "float16" | "auto" | a torch dtype.

    "auto" follows the checkpoint by byte share: bfloat16 when 16-bit
    (F16/BF16) tensors hold more than half the bytes and nothing is
    quantized, float32 otherwise (quantized checkpoints compute in f32)."""
    if isinstance(spec, torch.dtype):
        if spec not in _DTYPE_ALIASES.values():
            raise CodecError(f"unsupported compute dtype {spec}")
        return spec
    if not isinstance(spec, str):
        raise CodecError(f"unknown compute dtype {spec!r}")
    s = spec.lower()
    if s in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[s]
    if s == "auto":
        if reader is not None:
            b16 = tot = qnt = 0
            for info in reader.tensors.values():
                tot += info.n_bytes
                if info.ggml_type in (GGML_TYPE_F16, GGML_TYPE_BF16):
                    b16 += info.n_bytes
                elif info.ggml_type != GGML_TYPE_F32:
                    qnt += info.n_bytes
            if qnt == 0 and tot and b16 * 2 > tot:
                return torch.bfloat16
        return torch.float32
    raise CodecError(f"unknown compute dtype {spec!r}")


@contextlib.contextmanager
def f32_precision(enabled: bool = True):
    """Run float32 matmuls and convolutions in full float32 on the card.

    PyTorch lets cuDNN convolutions use TF32 by default, which keeps about
    three decimal digits; the f32 path is the parity path, so it turns
    TF32 off for both matmuls and convolutions and restores the previous
    settings afterwards."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class CodecModel:
    """Base class; per-arch subclasses live in codec_tpu_torch/models/ and
    are listed in models/registry.py. Each entry (op_profile.ENTRIES), the
    base class's and any an arch overrides, runs under the per-op profiler
    while $CODEC_OP_PROFILE or $CODEC_OP_PROFILE_TRACE is set
    (runtime/op_profile.py)."""

    arch: str = ""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for entry in op_profile.ENTRIES:
            if entry in cls.__dict__:
                setattr(cls, entry,
                        op_profile.profiled(entry, cls.__dict__[entry]))

    # Subclasses set these after load:
    sample_rate: int = 0
    # the rate encode takes where it differs from sample_rate (XY-Tokenizer:
    # 16 kHz in, 24 kHz out); 0: encode takes sample_rate
    encode_sample_rate: int = 0
    hop_size: int = 1
    n_q: int = 0
    codebook_size: int = 0
    latent_dim: int = 0
    has_encoder: bool = False
    has_decoder: bool = True
    # PCM channels a decode gives and an encode takes (MOSS-Audio-Tokenizer:
    # 2, interleaved into one stream); a decode of C > 1 channels returns
    # [B, samples, C]
    expected_channels: int = 1
    # causal archs decode exactly T*hop samples and are cropped to them;
    # a non-causal arch (symmetric padding) keeps its whole output
    causal_time: bool = True

    def __init__(self, reader: GGUFReader, compute_dtype="float32",
                 device="cuda"):
        self.reader = reader
        self.device = torch.device(device)
        self.compute_dtype = resolve_compute_dtype(compute_dtype, reader)
        # encode with TF32 off: f32 compute is the parity path, bf16 the
        # fast one (load_model's exact_encode overrides it)
        self.exact_encode = self.compute_dtype == torch.float32
        self.metadata: Dict[str, Any] = dict(reader.kv)
        self._load(reader)

    # -- metadata accessors (reference: codec_model_n_fft / win_length /
    #    n_mels / name / n_tensors; -1 or "" when absent) ------------------
    @property
    def n_fft(self) -> int:
        return int(self.metadata.get("codec.n_fft", -1))

    @property
    def win_length(self) -> int:
        return int(self.metadata.get("codec.win_length", -1))

    @property
    def n_mels(self) -> int:
        return int(self.metadata.get("codec.n_mels", -1))

    @property
    def name(self) -> str:
        return str(self.metadata.get("general.name", ""))

    @property
    def n_tensors(self) -> int:
        return len(self.reader.tensors) if self.reader is not None else 0

    # -- subclass hooks ----------------------------------------------------
    def _load(self, reader: GGUFReader) -> None:
        raise NotImplementedError

    def _decode_impl(self, codes: torch.Tensor, n_q: int) -> torch.Tensor:
        """codes [B, T, n_q] int64 on the device → pcm [B, T*hop]."""
        raise NotImplementedError

    def _encode_impl(self, pcm: torch.Tensor, n_q: int) -> torch.Tensor:
        """pcm [B, n] in the compute dtype on the device → codes
        [B, T, n_q] int."""
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    @staticmethod
    def _fmt_out(pcm: torch.Tensor, pcm_format: str) -> torch.Tensor:
        """"f32" passes float32 through; "i16" converts to 16-bit PCM with
        io/wav.py::write_wav's formula (round half to even), so a WAV
        written from it is byte-identical to one written from f32."""
        if pcm_format == "f32":
            return pcm.float()
        if pcm_format == "i16":
            return torch.clamp(torch.round(pcm.float() * 32767.0),
                               -32768, 32767).to(torch.int16)
        raise CodecError(f"unknown pcm_format {pcm_format!r}")

    def _use_nq(self, n_q: int, have: int) -> int:
        """The codebooks a decode reads: n_q, or with n_q=0 all the model's
        (or all the codes carry, if fewer)."""
        use_nq = n_q if n_q > 0 else min(self.n_q, have)
        if n_q < 0 or use_nq < 1 or use_nq > self.n_q or have < use_nq:
            raise CodecError(f"n_q must be 0 or in [1, {self.n_q}]")
        return use_nq

    def _decode_dispatch(self, codes, n_q: int,
                         pcm_format: str) -> Tuple[torch.Tensor, bool]:
        """Checks, uploads and enqueues a decode, under the caller's
        _decoding() → (formatted pcm [B, samples] on the device, whether to
        squeeze the batch). A CUDA upload goes from pinned memory without
        waiting: a copy from pageable memory first waits for the work
        already queued on the stream, which would serialise back-to-back
        decode_async calls."""
        if not self.has_decoder:
            raise CodecError(f"{self.arch}: model has no decoder")
        if pcm_format not in ("f32", "i16"):
            raise CodecError(f"unknown pcm_format {pcm_format!r}")
        codes = np.asarray(codes)
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[None]
        if codes.ndim != 3 or codes.shape[1] == 0:
            raise CodecError(f"bad codes shape {codes.shape}")
        use_nq = self._use_nq(n_q, codes.shape[2])
        c = torch.from_numpy(np.ascontiguousarray(codes[:, :, :use_nq],
                                                  dtype=np.int64))
        if self.device.type == "cuda":
            c = c.pin_memory().to(self.device, non_blocking=True)
        else:
            c = c.to(self.device)
        pcm = self._decode_impl(c, use_nq)
        nch = self.expected_channels
        if self.causal_time:
            pcm = pcm[:, :codes.shape[1] * self.hop_size * nch]
        if nch > 1:
            pcm = pcm.reshape(pcm.shape[0], -1, nch)
        return self._fmt_out(pcm, pcm_format), squeeze

    @contextlib.contextmanager
    def _decoding(self):
        """Inference mode, with TF32 off for f32 compute."""
        with torch.inference_mode(), \
                f32_precision(self.compute_dtype == torch.float32):
            yield

    def decode(self, codes, n_q: int = 0,
               pcm_format: str = "f32") -> np.ndarray:
        """codes: [T, Q] or [B, T, Q] int → pcm [T*hop] / [B, T*hop] on the
        host ([.., T*hop, channels] for a multi-channel model); float32, or
        int16 with pcm_format="i16".

        n_q=0 means all model codebooks (or all the codes carry, if fewer).
        Logs the JAX package's perf phases (runtime/perf_log.py)."""
        with perf_scope("decode_total", self.arch), self._decoding():
            out, squeeze = self._decode_dispatch(codes, n_q, pcm_format)
            with perf_scope("graph_compute", "decode"):
                pcm = out.cpu().numpy()
        return pcm[0] if squeeze else pcm

    def decode_async(self, codes, n_q: int = 0,
                     pcm_format: str = "f32") -> "PendingPcm":
        """decode without waiting: uploads and enqueues the work on the
        card, no sync → a PendingPcm whose result() makes the one copy to
        the host. Back-to-back calls queue on the card; PendingPcm.gather
        fetches several with one sync."""
        with self._decoding():
            out, squeeze = self._decode_dispatch(codes, n_q, pcm_format)
        return PendingPcm(out, squeeze)

    def decode_many(self, seqs, n_q: int = 0,
                    pcm_format: str = "f32") -> List[np.ndarray]:
        """Decode a list of [T, Q] code sequences: the sequences of equal
        (T, n_q) go through one batched decode each, all are enqueued
        before the one sync that fetches every output. Batch rows are
        independent, so each output equals its own decode() (up to the
        order of float sums). The JAX package also pads lengths into
        geometric buckets to bound its XLA compiles; eager torch compiles
        nothing, so lengths are grouped only when equal."""
        if not self.has_decoder:
            raise CodecError(f"{self.arch}: model has no decoder")
        seqs = [np.asarray(s) for s in seqs]
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, s in enumerate(seqs):
            if s.ndim != 2 or s.shape[0] == 0:
                raise CodecError(
                    f"decode_many wants [T, Q] sequences, got {s.shape}")
            use_nq = self._use_nq(n_q, s.shape[1])
            groups.setdefault((s.shape[0], use_nq), []).append(i)
        outs: List[Optional[np.ndarray]] = [None] * len(seqs)
        with perf_scope("decode_total", f"{self.arch}_many{len(seqs)}"):
            pending = [(self.decode_async(
                np.stack([seqs[i][:, :use_nq] for i in idxs]), use_nq,
                pcm_format), idxs) for (_, use_nq), idxs in groups.items()]
            with perf_scope("graph_compute", "decode_many"):
                arrs = PendingPcm.gather([p for p, _ in pending])
        for (_, idxs), a in zip(pending, arrs):
            for row, i in enumerate(idxs):
                outs[i] = a[row]
        return outs

    @staticmethod
    def _pcm_host_f32(pcm) -> np.ndarray:
        """A PCM argument on the host as float32: float passes through,
        int16 scales by 1/32768 (for encode paths that take the PCM on the
        host, as the streaming encoder does)."""
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            return pcm.astype(np.float32) / 32768.0
        return np.asarray(pcm, np.float32)

    def encode(self, pcm, n_q: int = 0) -> np.ndarray:
        """pcm: [n] / [B, n] float32 in [-1, 1], or int16 PCM, which goes to
        the device as it is and becomes x * (1/32768) there → codes int32
        [T, n_q] / [B, T, n_q] on the host.

        n_q=0 means all model codebooks. With `exact_encode` (the default
        for f32 compute) the encode runs with TF32 off. Logs the JAX
        package's perf phases (runtime/perf_log.py)."""
        if not self.has_encoder:
            raise CodecError(f"{self.arch}: model has no encoder")
        pcm = np.asarray(pcm)
        i16_in = pcm.dtype == np.int16
        if not i16_in:
            pcm = pcm.astype(np.float32)
        squeeze = pcm.ndim == 1
        if squeeze:
            pcm = pcm[None]
        if pcm.ndim != 2 or pcm.shape[1] == 0:
            raise CodecError(f"bad pcm shape {pcm.shape}")
        use_nq = n_q if n_q > 0 else self.n_q
        if n_q < 0 or use_nq < 1 or use_nq > self.n_q:
            raise CodecError(f"n_q must be 0 or in [1, {self.n_q}]")
        n = pcm.shape[1]
        x = torch.from_numpy(np.array(pcm, order="C"))     # a writable copy
        with perf_scope("encode_total", self.arch), torch.inference_mode(), \
                f32_precision(self.exact_encode):
            x = x.to(self.device)
            if i16_in:
                x = x.float() * (1.0 / 32768.0)
            with perf_scope("graph_compute", "encode"):
                codes = self._encode_impl(x.to(self.compute_dtype), use_nq)
                if self.causal_time:
                    codes = codes[:, :-(-n // self.hop_size)]
                codes = codes.to(torch.int32).cpu().numpy()
        return codes[0] if squeeze else codes

    def decode_latent(self, latent, pcm_format: str = "f32") -> np.ndarray:
        raise CodecError(f"{self.arch}: decode_latent not supported")

    def encode_latent(self, pcm) -> np.ndarray:
        raise CodecError(f"{self.arch}: continuous-latent encode not supported")

    def _run_on_device(self, fn, pcm_format: str,
                       n_samples: Optional[int] = None) -> np.ndarray:
        """fn() → pcm [B, samples] under inference mode (TF32 off for f32),
        cut to n_samples when given, formatted, on the host."""
        if pcm_format not in ("f32", "i16"):
            raise CodecError(f"unknown pcm_format {pcm_format!r}")
        with self._decoding():
            pcm = fn()
            if n_samples is not None:
                pcm = pcm[:, :n_samples]
            return self._fmt_out(pcm, pcm_format).cpu().numpy()


for _entry in op_profile.ENTRIES:
    setattr(CodecModel, _entry,
            op_profile.profiled(_entry, CodecModel.__dict__[_entry]))


class PendingPcm:
    """A decode in flight (CodecModel.decode_async): the formatted output
    on the device. result() copies it to the host (one sync); gather
    fetches many with one sync."""

    def __init__(self, out: torch.Tensor, squeeze: bool):
        self._out = out
        self._squeeze = squeeze

    def device_array(self) -> torch.Tensor:
        """The output [B, samples] on the device, for consumers that stay
        there (no copy to the host)."""
        return self._out

    def _host(self, pcm: np.ndarray) -> np.ndarray:
        return pcm[0] if self._squeeze else pcm

    def result(self) -> np.ndarray:
        return self._host(self._out.cpu().numpy())

    @staticmethod
    def gather(pending: List["PendingPcm"]) -> List[np.ndarray]:
        """The host PCM of every PendingPcm: the copies are enqueued into
        pinned memory without waiting, then one sync per device."""
        copies = [p._out.to("cpu", non_blocking=True) if p._out.is_cuda
                  else p._out for p in pending]
        for dev in {p._out.device for p in pending if p._out.is_cuda}:
            torch.cuda.synchronize(dev)
        return [p._host(c.numpy()) for p, c in zip(pending, copies)]
