"""GGUF v2/v3 reader + writer with GGML-compatible (de)quantization.

A copy of codec_tpu/io/gguf.py's NumPy path (the original's package
imports JAX on import). The file is parsed with NumPy (zero-copy
memory-map for F32/F16) and quantized blocks are dequantized into float32
host arrays, which the model loaders move once to the device as tensors.

Quantization formats implemented bit-exactly against the reference spec
(reference: scripts/utils/quantization.py:14-156):
  - Q8_0 : blocks of 32, f16 scale + int8 quants
  - Q4_K : super-blocks of 256, f16 d/dmin + 12-byte packed 6-bit scales/mins
           + 128 nibble-packed quants    (x = d*sc*q - dmin*m)
  - Q5_K : as Q4_K plus a 32-byte high-bit plane (5-bit quants)
All dequantization is vectorized NumPy (no per-block Python loops).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

GGUF_MAGIC = b"GGUF"
ALIGNMENT_KEY = "general.alignment"
DEFAULT_ALIGNMENT = 32

# -- GGUF value types (spec) -------------------------------------------------
GGUF_TYPE_UINT8 = 0
GGUF_TYPE_INT8 = 1
GGUF_TYPE_UINT16 = 2
GGUF_TYPE_INT16 = 3
GGUF_TYPE_UINT32 = 4
GGUF_TYPE_INT32 = 5
GGUF_TYPE_FLOAT32 = 6
GGUF_TYPE_BOOL = 7
GGUF_TYPE_STRING = 8
GGUF_TYPE_ARRAY = 9
GGUF_TYPE_UINT64 = 10
GGUF_TYPE_INT64 = 11
GGUF_TYPE_FLOAT64 = 12

_SCALAR_FMT = {
    GGUF_TYPE_UINT8: ("<B", 1),
    GGUF_TYPE_INT8: ("<b", 1),
    GGUF_TYPE_UINT16: ("<H", 2),
    GGUF_TYPE_INT16: ("<h", 2),
    GGUF_TYPE_UINT32: ("<I", 4),
    GGUF_TYPE_INT32: ("<i", 4),
    GGUF_TYPE_FLOAT32: ("<f", 4),
    GGUF_TYPE_UINT64: ("<Q", 8),
    GGUF_TYPE_INT64: ("<q", 8),
    GGUF_TYPE_FLOAT64: ("<d", 8),
}

# -- GGML tensor types (ggml.h enum values) ----------------------------------
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q8_0 = 8
GGML_TYPE_Q4_K = 12
GGML_TYPE_Q5_K = 13
GGML_TYPE_Q6_K = 14
GGML_TYPE_I32 = 26
GGML_TYPE_BF16 = 30

TYPE_NAMES = {
    GGML_TYPE_F32: "F32",
    GGML_TYPE_F16: "F16",
    GGML_TYPE_Q8_0: "Q8_0",
    GGML_TYPE_Q4_K: "Q4_K",
    GGML_TYPE_Q5_K: "Q5_K",
    GGML_TYPE_Q6_K: "Q6_K",
    GGML_TYPE_I32: "I32",
    GGML_TYPE_BF16: "BF16",
}
NAME_TO_TYPE = {v: k for k, v in TYPE_NAMES.items()}
NAME_TO_TYPE["Q4_K_M"] = GGML_TYPE_Q4_K
NAME_TO_TYPE["Q5_K_M"] = GGML_TYPE_Q5_K

QK8_0 = 32
QK_K = 256
K_SCALE_SIZE = 12

# bytes per block for each quantized type
_BLOCK_BYTES = {
    GGML_TYPE_Q8_0: 2 + QK8_0,                       # f16 d + 32 q
    GGML_TYPE_Q4_K: 2 + 2 + K_SCALE_SIZE + QK_K // 2,  # d, dmin, scales, qs
    GGML_TYPE_Q5_K: 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2,
}
_BLOCK_ELEMS = {
    GGML_TYPE_Q8_0: QK8_0,
    GGML_TYPE_Q4_K: QK_K,
    GGML_TYPE_Q5_K: QK_K,
}


def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


# ---------------------------------------------------------------------------
# Dequantization (vectorized)
# ---------------------------------------------------------------------------

def _unpack_scale_min_k4(scale_bytes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack [N, 12] uint8 → ([N, 8] scales, [N, 8] mins), 6-bit each.

    Inverse of the reference packer (scripts/utils/quantization.py:19-32):
      j < 4:  sc = b[j] & 63            ; mn = b[j+4] & 63
      j >= 4: sc = (b[j+4] & 0xF) | ((b[j-4] >> 6) << 4)
              mn = (b[j+4] >> 4)  | ((b[j]   >> 6) << 4)
    """
    b = scale_bytes.astype(np.uint8)
    sc = np.empty(b.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = b[..., j] & 63
        mn[..., j] = b[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (b[..., j + 4] & 0x0F) | ((b[..., j - 4] >> 6) << 4)
        mn[..., j] = (b[..., j + 4] >> 4) | ((b[..., j] >> 6) << 4)
    return sc, mn


def dequantize_q8_0(raw: bytes, n_elems: int) -> np.ndarray:
    bb = _BLOCK_BYTES[GGML_TYPE_Q8_0]
    n_blocks = n_elems // QK8_0
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * bb).reshape(n_blocks, bb)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)        # [N,1]
    q = buf[:, 2:].view(np.int8).astype(np.float32)                  # [N,32]
    return (q * d).reshape(-1)


def dequantize_q4_k(raw: bytes, n_elems: int) -> np.ndarray:
    bb = _BLOCK_BYTES[GGML_TYPE_Q4_K]
    n_blocks = n_elems // QK_K
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * bb).reshape(n_blocks, bb)
    d = buf[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
    dmin = buf[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:4 + K_SCALE_SIZE])        # [N,8]
    qs = buf[:, 4 + K_SCALE_SIZE:]                                   # [N,128]
    # nibble order: for each 64-elem group g, bytes [g*32:(g+1)*32] hold
    # lo-nibbles (elems 0..31 of group) and hi-nibbles (elems 32..63)
    qs = qs.reshape(n_blocks, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo[:, :, None, :], hi[:, :, None, :]], axis=2)  # [N,4,2,32]
    q = q.reshape(n_blocks, 8, 32)
    scale = d[:, None] * sc.astype(np.float32)                       # [N,8]
    minv = dmin[:, None] * mn.astype(np.float32)                     # [N,8]
    out = q * scale[:, :, None] - minv[:, :, None]
    return out.reshape(-1)


def dequantize_q5_k(raw: bytes, n_elems: int) -> np.ndarray:
    bb = _BLOCK_BYTES[GGML_TYPE_Q5_K]
    n_blocks = n_elems // QK_K
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * bb).reshape(n_blocks, bb)
    d = buf[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
    dmin = buf[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
    sc, mn = _unpack_scale_min_k4(buf[:, 4:4 + K_SCALE_SIZE])
    off = 4 + K_SCALE_SIZE
    qh = buf[:, off:off + QK_K // 8]                                 # [N,32]
    ql = buf[:, off + QK_K // 8:]                                    # [N,128]
    ql = ql.reshape(n_blocks, 4, 32)
    lo = (ql & 0x0F).astype(np.uint8)
    hi = (ql >> 4).astype(np.uint8)
    # high bits: group g in 0..3 → elems g*64+j use bit (2g), elems g*64+32+j bit (2g+1)
    q = np.empty((n_blocks, 8, 32), dtype=np.float32)
    for g in range(4):
        m1 = np.uint8(1 << (2 * g))
        m2 = np.uint8(1 << (2 * g + 1))
        q[:, 2 * g] = lo[:, g] + ((qh & m1) != 0) * 16.0
        q[:, 2 * g + 1] = hi[:, g] + ((qh & m2) != 0) * 16.0
    scale = d[:, None] * sc.astype(np.float32)
    minv = dmin[:, None] * mn.astype(np.float32)
    out = q * scale[:, :, None] - minv[:, :, None]
    return out.reshape(-1)


_DEQUANT = {
    GGML_TYPE_Q8_0: dequantize_q8_0,
    GGML_TYPE_Q4_K: dequantize_q4_k,
    GGML_TYPE_Q5_K: dequantize_q5_k,
}


def _dequant_dispatch(t: int, raw: np.ndarray, n_elems: int) -> np.ndarray:
    """NumPy dequantization (bit-exact)."""
    return _DEQUANT[t](raw.tobytes(), n_elems)


# ---------------------------------------------------------------------------
# Quantization (vectorized; bit-exact vs reference scripts/utils/quantization.py)
# ---------------------------------------------------------------------------

def _pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Pack [N, 8] 6-bit scales/mins → [N, 12] bytes (K-quants layout)."""
    n = ls.shape[0]
    out = np.zeros((n, K_SCALE_SIZE), dtype=np.uint8)
    ls = ls.astype(np.uint8) & 63
    lm = lm.astype(np.uint8) & 63
    for j in range(4):
        out[:, j] = ls[:, j]
        out[:, j + 4] = lm[:, j]
    for j in range(4, 8):
        out[:, j + 4] = (ls[:, j] & 0x0F) | ((lm[:, j] & 0x0F) << 4)
        out[:, j - 4] |= (ls[:, j] >> 4) << 6
        out[:, j] |= (lm[:, j] >> 4) << 6
    return out


def quantize_q8_0(arr: np.ndarray) -> bytes:
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if x.size % QK8_0:
        raise ValueError(f"Q8_0 needs multiple of {QK8_0} elems, got {x.size}")
    b = x.reshape(-1, QK8_0)
    amax = np.max(np.abs(b), axis=1)
    d = np.where(amax > 0, amax / 127.0, 0.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.rint(b * inv[:, None]).astype(np.int8)
    n = b.shape[0]
    out = np.empty((n, 2 + QK8_0), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def _kquant_subscales(sub: np.ndarray, qmax: float):
    """Shared Q4_K/Q5_K per-32-elem sub-block affine quantization.

    sub: [N, 8, 32] f32.  Returns (d, dmin, ls, lm, q) matching the reference
    row quantizer exactly (scripts/utils/quantization.py:52-127)."""
    xmin = sub.min(axis=2)
    xmax = sub.max(axis=2)
    scale = np.where(xmax > xmin, (xmax - xmin) / qmax, 0.0).astype(np.float32)
    mins = (-xmin).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint((sub - xmin[:, :, None]) / safe[:, :, None]), 0, qmax)
    q = np.where(scale[:, :, None] > 0, q, 0.0).astype(np.uint8)
    max_scale = scale.max(axis=1)
    max_min = mins.max(axis=1)
    d = np.where(max_scale > 0, max_scale / 63.0, 0.0).astype(np.float32)
    dmin = np.where(max_min > 0, max_min / 63.0, 0.0).astype(np.float32)
    safe_d = np.where(d > 0, d, 1.0)
    safe_m = np.where(dmin > 0, dmin, 1.0)
    ls = np.where(d[:, None] > 0, np.clip(np.rint(scale / safe_d[:, None]), 0, 63), 0).astype(np.uint8)
    lm = np.where(dmin[:, None] > 0, np.clip(np.rint(mins / safe_m[:, None]), 0, 63), 0).astype(np.uint8)
    return d, dmin, ls, lm, q


def quantize_q4_k(arr: np.ndarray) -> bytes:
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if x.size % QK_K:
        raise ValueError(f"Q4_K needs multiple of {QK_K} elems, got {x.size}")
    sub = x.reshape(-1, 8, 32)
    d, dmin, ls, lm, q = _kquant_subscales(sub, 15.0)
    n = sub.shape[0]
    scale_bytes = _pack_scale_min_k4(ls, lm)
    qflat = q.reshape(n, 4, 2, 32)
    qs = (qflat[:, :, 0] | (qflat[:, :, 1] << 4)).reshape(n, QK_K // 2)
    out = np.empty((n, _BLOCK_BYTES[GGML_TYPE_Q4_K]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:4 + K_SCALE_SIZE] = scale_bytes
    out[:, 4 + K_SCALE_SIZE:] = qs
    return out.tobytes()


def quantize_q5_k(arr: np.ndarray) -> bytes:
    x = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if x.size % QK_K:
        raise ValueError(f"Q5_K needs multiple of {QK_K} elems, got {x.size}")
    sub = x.reshape(-1, 8, 32)
    d, dmin, ls, lm, q = _kquant_subscales(sub, 31.0)
    n = sub.shape[0]
    scale_bytes = _pack_scale_min_k4(ls, lm)
    q = q.reshape(n, 4, 2, 32)            # [N, group, half, 32]
    hibit = (q > 15)
    qlow = (q & 0x0F).astype(np.uint8)
    ql = (qlow[:, :, 0] | (qlow[:, :, 1] << 4)).reshape(n, QK_K // 2)
    qh = np.zeros((n, QK_K // 8), dtype=np.uint8)
    for g in range(4):
        qh |= hibit[:, g, 0].astype(np.uint8) << (2 * g)
        qh |= hibit[:, g, 1].astype(np.uint8) << (2 * g + 1)
    out = np.empty((n, _BLOCK_BYTES[GGML_TYPE_Q5_K]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:4 + K_SCALE_SIZE] = scale_bytes
    off = 4 + K_SCALE_SIZE
    out[:, off:off + QK_K // 8] = qh
    out[:, off + QK_K // 8:] = ql
    return out.tobytes()


_QUANT = {
    GGML_TYPE_Q8_0: quantize_q8_0,
    GGML_TYPE_Q4_K: quantize_q4_k,
    GGML_TYPE_Q5_K: quantize_q5_k,
}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class GGUFTensorInfo:
    name: str
    ne: Tuple[int, ...]          # ggml dim order (ne0 fastest)
    ggml_type: int
    offset: int                  # relative to data section start

    @property
    def shape(self) -> Tuple[int, ...]:
        """NumPy row-major shape (reverse of ggml ne order)."""
        return tuple(reversed(self.ne))

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        t = self.ggml_type
        if t == GGML_TYPE_F32 or t == GGML_TYPE_I32:
            return self.n_elems * 4
        if t == GGML_TYPE_F16 or t == GGML_TYPE_BF16:
            return self.n_elems * 2
        if t in _BLOCK_BYTES:
            return (self.n_elems // _BLOCK_ELEMS[t]) * _BLOCK_BYTES[t]
        raise ValueError(f"unsupported ggml type {t} for tensor {self.name}")

    @property
    def type_name(self) -> str:
        return TYPE_NAMES.get(self.ggml_type, f"?{self.ggml_type}")


class GGUFReader:
    """Parses a GGUF file; lazily materializes tensors as float32/int32 arrays.

    Mirrors the reference loader's behavior (src/codec.cpp:303-449): metadata KVs
    with typed fallbacks, tensor streaming, dequant-on-read for quantized types.
    """

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.kv: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        self._order: List[str] = []
        with open(self.path, "rb") as f:
            self._parse_header(f)
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        self._cache: Dict[str, np.ndarray] = {}

    # -- header parsing ---------------------------------------------------
    # Fail-closed discipline (reference: src/codec.cpp:374-401 — the loader
    # rejects any short read / size overflow rather than carrying on with
    # partial data): every read is exact-length-checked, counts and string
    # lengths are bounded by the file size, and tensor extents are
    # validated against the data section before any bytes are served.

    def _read_exact(self, f: BinaryIO, n: int, what: str) -> bytes:
        b = f.read(n)
        if len(b) != n:
            raise ValueError(
                f"truncated GGUF file {self.path}: short read of {what} "
                f"(wanted {n} bytes, got {len(b)})")
        return b

    def _read_str(self, f: BinaryIO) -> str:
        (n,) = struct.unpack("<Q", self._read_exact(f, 8, "string length"))
        if n > self._file_size:
            raise ValueError(
                f"corrupt GGUF file {self.path}: string length {n} exceeds "
                f"file size {self._file_size}")
        return self._read_exact(f, n, "string").decode("utf-8")

    def _read_value(self, f: BinaryIO, vtype: int) -> Any:
        if vtype in _SCALAR_FMT:
            fmt, sz = _SCALAR_FMT[vtype]
            return struct.unpack(fmt, self._read_exact(f, sz, "KV scalar"))[0]
        if vtype == GGUF_TYPE_BOOL:
            return self._read_exact(f, 1, "KV bool")[0] != 0
        if vtype == GGUF_TYPE_STRING:
            return self._read_str(f)
        if vtype == GGUF_TYPE_ARRAY:
            (elem_type,) = struct.unpack("<i", self._read_exact(f, 4, "array type"))
            (count,) = struct.unpack("<Q", self._read_exact(f, 8, "array count"))
            if count > self._file_size:          # each element is >= 1 byte
                raise ValueError(
                    f"corrupt GGUF file {self.path}: array count {count} "
                    f"exceeds file size {self._file_size}")
            return [self._read_value(f, elem_type) for _ in range(count)]
        raise ValueError(f"unknown GGUF KV type {vtype}")

    def _parse_header(self, f: BinaryIO) -> None:
        f.seek(0, 2)
        self._file_size = f.tell()
        f.seek(0)
        if self._read_exact(f, 4, "magic") != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: {self.path}")
        (self.version,) = struct.unpack("<I", self._read_exact(f, 4, "version"))
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors, n_kv = struct.unpack("<qq", self._read_exact(f, 16, "counts"))
        # each KV / tensor record occupies >= 12 bytes in the header
        if not (0 <= n_tensors <= self._file_size // 12):
            raise ValueError(
                f"corrupt GGUF file {self.path}: tensor count {n_tensors}")
        if not (0 <= n_kv <= self._file_size // 12):
            raise ValueError(f"corrupt GGUF file {self.path}: KV count {n_kv}")
        for _ in range(n_kv):
            key = self._read_str(f)
            (vtype,) = struct.unpack("<i", self._read_exact(f, 4, "KV type"))
            self.kv[key] = self._read_value(f, vtype)
        for _ in range(n_tensors):
            name = self._read_str(f)
            (n_dims,) = struct.unpack("<I", self._read_exact(f, 4, "n_dims"))
            if n_dims > 4:                       # GGUF spec: ne has <= 4 dims
                raise ValueError(
                    f"corrupt GGUF file {self.path}: tensor {name!r} has "
                    f"{n_dims} dims")
            ne = struct.unpack(f"<{n_dims}q",
                               self._read_exact(f, 8 * n_dims, "tensor dims"))
            if any(d <= 0 for d in ne):
                raise ValueError(
                    f"corrupt GGUF file {self.path}: tensor {name!r} has "
                    f"non-positive dim in {ne}")
            ggml_type, = struct.unpack("<i", self._read_exact(f, 4, "tensor type"))
            offset, = struct.unpack("<Q", self._read_exact(f, 8, "tensor offset"))
            info = GGUFTensorInfo(name, tuple(int(d) for d in ne), ggml_type, offset)
            self.tensors[name] = info
            self._order.append(name)
        alignment = int(self.kv.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
        if alignment <= 0:
            raise ValueError(
                f"corrupt GGUF file {self.path}: alignment {alignment}")
        self.data_offset = _align_up(f.tell(), alignment)

    # -- KV accessors (typed, with fallback; reference: src/runtime/gguf_kv.cpp)
    def get_i32(self, key: str, default: int = 0) -> int:
        v = self.kv.get(key, default)
        return int(v)

    def get_f32(self, key: str, default: float = 0.0) -> float:
        v = self.kv.get(key, default)
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.kv.get(key, default)
        return bool(v)

    def get_str(self, key: str, default: str = "") -> str:
        v = self.kv.get(key, default)
        return str(v)

    def get_arr(self, key: str, default=None):
        return self.kv.get(key, default if default is not None else [])

    @property
    def architecture(self) -> str:
        return self.get_str("general.architecture")

    def tensor_names(self) -> List[str]:
        return list(self._order)

    def has_tensor(self, name: str) -> bool:
        return name in self.tensors

    # -- tensor materialization -------------------------------------------
    def _raw(self, info: GGUFTensorInfo) -> np.ndarray:
        start = self.data_offset + info.offset
        end = start + info.n_bytes
        if end > self._mmap.size:
            raise ValueError(
                f"truncated GGUF file {self.path}: tensor {info.name!r} "
                f"needs bytes [{start}, {end}) but file has {self._mmap.size}")
        return self._mmap[start:end]

    def get(self, name: str, dtype: Optional[np.dtype] = None) -> np.ndarray:
        """Materialize tensor `name` as a NumPy array in row-major (numpy) shape.

        Quantized tensors are dequantized to float32; F16/BF16 are upcast
        to float32 (exactly) unless dtype is given. The loaders cast to
        the compute dtype on the device.
        """
        if name in self._cache:
            arr = self._cache[name]
        else:
            info = self.tensors[name]
            raw = self._raw(info)
            t = info.ggml_type
            if t == GGML_TYPE_F32:
                arr = raw.view(np.float32).reshape(info.shape)
            elif t == GGML_TYPE_F16:
                arr = raw.view(np.float16).reshape(info.shape).astype(np.float32)
            elif t == GGML_TYPE_BF16:
                arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32).reshape(info.shape)
            elif t == GGML_TYPE_I32:
                arr = raw.view(np.int32).reshape(info.shape)
            elif t in _DEQUANT:
                arr = _dequant_dispatch(t, raw, info.n_elems).reshape(info.shape)
            else:
                raise ValueError(f"unsupported tensor type {info.type_name} for {name}")
            self._cache[name] = arr
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr

    def get_or_none(self, name: str, dtype: Optional[np.dtype] = None) -> Optional[np.ndarray]:
        if name not in self.tensors:
            return None
        return self.get(name, dtype)



# ---------------------------------------------------------------------------
# Writer (GGUF v3; matches reference scripts/utils/gguf_writer.py layout)
# ---------------------------------------------------------------------------

def _f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (uint16), round to nearest even;
    NaN stays a quiet NaN."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = (u + (((u >> 16) & 1) + 0x7FFF)) >> 16
    return np.where(np.isnan(arr), np.uint32(0x7FC0), rounded).astype(np.uint16)


KV_UINT32 = GGUF_TYPE_UINT32
KV_INT32 = GGUF_TYPE_INT32
KV_FLOAT32 = GGUF_TYPE_FLOAT32
KV_BOOL = GGUF_TYPE_BOOL
KV_STRING = GGUF_TYPE_STRING
KV_ARRAY = GGUF_TYPE_ARRAY


def _u64(n): return struct.pack("<Q", int(n))
def _i64(n): return struct.pack("<q", int(n))
def _u32(n): return struct.pack("<I", int(n))
def _i32(n): return struct.pack("<i", int(n))
def _str_bytes(s: str) -> bytes:
    b = s.encode("utf-8")
    return _u64(len(b)) + b


class GGUFWriter:
    """Minimal GGUF v3 writer for converter output (KV + tensors, 32-byte aligned)."""

    def __init__(self, path: Union[str, Path], architecture: str):
        self.path = Path(path)
        self.kv: List[Tuple[str, int, Any]] = [("general.architecture", KV_STRING, architecture)]
        self.tensors: List[Tuple[str, int, List[int], bytes]] = []

    def add_name(self, name): self.kv.append(("general.name", KV_STRING, name))
    def add_uint32(self, k, v): self.kv.append((k, KV_UINT32, int(v)))
    def add_int32(self, k, v): self.kv.append((k, KV_INT32, int(v)))
    def add_float32(self, k, v): self.kv.append((k, KV_FLOAT32, float(v)))
    def add_bool(self, k, v): self.kv.append((k, KV_BOOL, bool(v)))
    def add_string(self, k, v): self.kv.append((k, KV_STRING, str(v)))

    def add_array(self, key: str, values) -> None:
        arr = np.asarray(values)
        if arr.size == 0:
            raise ValueError("values must be non-empty")
        if np.issubdtype(arr.dtype, np.floating):
            self.kv.append((key, KV_ARRAY, (KV_FLOAT32, [float(x) for x in arr.tolist()])))
        elif int(arr.min()) < 0:
            self.kv.append((key, KV_ARRAY, (KV_INT32, [int(x) for x in arr.tolist()])))
        else:
            self.kv.append((key, KV_ARRAY, (KV_UINT32, [int(x) for x in arr.tolist()])))

    def add_tensor(self, name: str, arr: np.ndarray, st_dtype: Optional[str] = None) -> None:
        arr = np.ascontiguousarray(arr)
        if st_dtype is None:
            st_dtype = {"float32": "F32", "float16": "F16", "int32": "I32"}.get(str(arr.dtype))
            if st_dtype is None:
                raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        t = NAME_TO_TYPE[st_dtype]
        if t == GGML_TYPE_F32:
            data = arr.astype(np.float32).tobytes()
        elif t == GGML_TYPE_F16:
            data = arr.astype(np.float16).tobytes()
        elif t == GGML_TYPE_BF16:
            data = _f32_to_bf16_bits(arr).tobytes()
        elif t == GGML_TYPE_I32:
            data = arr.astype(np.int32).tobytes()
        elif t in _QUANT:
            if arr.shape[-1] % _BLOCK_ELEMS[t]:
                raise ValueError(f"{st_dtype} needs last dim % {_BLOCK_ELEMS[t]} == 0 ({name}: {arr.shape})")
            data = _QUANT[t](arr)
        else:
            raise ValueError(f"unsupported storage type {st_dtype}")
        self.tensors.append((name, t, list(arr.shape), data))

    def _encode_kv(self, key: str, t: int, v: Any) -> bytes:
        out = bytearray()
        out += _str_bytes(key)
        out += _i32(t)
        if t == KV_STRING:
            out += _str_bytes(str(v))
        elif t == KV_UINT32:
            out += _u32(v)
        elif t == KV_INT32:
            out += _i32(v)
        elif t == KV_FLOAT32:
            out += struct.pack("<f", float(v))
        elif t == KV_BOOL:
            out += struct.pack("<b", 1 if v else 0)
        elif t == KV_ARRAY:
            elem_type, payload = v
            out += _i32(elem_type)
            out += _u64(len(payload))
            for item in payload:
                if elem_type == KV_UINT32:
                    out += _u32(item)
                elif elem_type == KV_INT32:
                    out += _i32(item)
                elif elem_type == KV_FLOAT32:
                    out += struct.pack("<f", float(item))
                else:
                    raise ValueError(f"bad array elem type {elem_type}")
        else:
            raise ValueError(f"bad KV type {t}")
        return bytes(out)

    def write(self) -> None:
        kv_blob = bytearray()
        for key, t, v in self.kv:
            kv_blob += self._encode_kv(key, t, v)

        tensor_infos = bytearray()
        cur_off = 0
        metas = []
        for name, t, shape, data in self.tensors:
            data_off = _align_up(cur_off, DEFAULT_ALIGNMENT)
            metas.append((name, t, list(reversed(shape)), data_off, data))
            cur_off = data_off + len(data)

        data_blob = bytearray(cur_off)
        for name, t, shape_rev, data_off, data in metas:
            data_blob[data_off:data_off + len(data)] = data
            tensor_infos += _str_bytes(name)
            tensor_infos += _u32(len(shape_rev))
            for dim in shape_rev:
                tensor_infos += _i64(dim)
            tensor_infos += _i32(t)
            tensor_infos += _u64(data_off)

        header = bytearray()
        header += GGUF_MAGIC
        header += _u32(3)
        header += _i64(len(self.tensors))
        header += _i64(len(self.kv))
        header += kv_blob
        header += tensor_infos
        pad = _align_up(len(header), DEFAULT_ALIGNMENT) - len(header)
        header += b"\x00" * pad
        with open(self.path, "wb") as f:
            f.write(header)
            f.write(data_blob)
