"""Fused SEANet residual units (DAC's dense ones, SNAC's depthwise ones):
the CUDA kernels' wrappers, their plain PyTorch versions and the gates
between unit and chain.

Counterpart of codec_tpu/ops/seanet_pallas.py::seanet_res_unit,
::seanet_res_chain and ::snac_res_chain. The kernels are csrc/seanet_res.cu
and csrc/snac_res.cu, built by kernels/build.py on first launch (never at
import). For a CPU tensor each wrapper runs its plain version; for a CUDA
tensor it launches its kernel or raises. Each wrapper takes the units'
f32 rows (`unit_vec`) precomputed as `vec`, as the models build them once
at load, or builds them per call.

One unit is x + conv1x1(snake(conv_kK,d(snake(x, α1)) + b1, α2)) + b2 with
symmetric zero padding (K-1)·d/2; in SNAC's units the dilated conv is
depthwise (one K-tap filter per channel). Layouts are the reference's: x
[B, T, C]; w1 WIO [K, C, C] (dense) or per-channel taps [K, C]
(depthwise); w2 [C, C] (in, out); alphas and biases [C]. The chains take
them stacked over a leading unit dim.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import act, conv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PI = 3.14159265358979323846
# The DAC kernels' tiles (csrc/seanet_res.cu, csrc/seanet_gemm.cuh), as
# (rows, columns per output pass): a block, one per SM, is two consumer
# warpgroups and one producer warpgroup. f32 (Fma): eight warp tiles of
# 32 x 64, input chunks of 32. bf16 and f16 (Wg, wgmma): 64 or 128 rows
# per warpgroup, passes of 64-192 columns (at most 128 accumulators a
# thread), input chunks of 64. Each tile is the fastest at some DAC width,
# batch (1, 4) or length (20 s, 2 s) on an H100 (PERF.md,
# tools/seanet_times.py --what tiles); f16 starts from bf16's tiles (both
# are 2-byte operands).
_UNIT_TILES = {torch.float32: ((256, 64), (128, 128), (64, 256)),
               torch.bfloat16: ((128, 64), (128, 128), (128, 192), (256, 128))}
_UNIT_TILES[torch.float16] = _UNIT_TILES[torch.bfloat16]
_CHUNK = {torch.float32: 32, torch.bfloat16: 64, torch.float16: 64}
_UNIT_STAGES, _CHAIN_STAGES = 4, 2      # weight stages of the TMA ring
_BARRIER_BYTES = 1024
_H100_SMEM = 232448     # opt-in shared memory per block (csrc: kSmemLimit)
# a pass's fixed cost in columns and a tile's in outputs (unit_tile): with
# these, its choice is within 1.1% (f32) and 5.6% (bf16) of the fastest
# tile at every case of the sweep in PERF.md
_PASS_COST = 16
_BLOCK_COST = 2048
# SNAC's unit (N = 1) is two launches: the depthwise pass
# (csrc/snac_res.cu::snac_dw_kernel: blocks of dw_rows rows of 32
# channels, their rows and halo landing by cp.async and snaked once into
# f32 in shared memory; items of 4 outputs along a residue class; taps K
# <= 7), then the DAC unit's 1x1 product at a tile of _SNAC_TILES
# (snac_tile) with SNAC's epilogue.
_DW_CHANNELS = 32
_DW_OUT = 4
_DW_MAX_ROWS = 256
_DW_MAX_TAPS = 7
# SNAC's 1x1 tiles (csrc/seanet_res.cu::dispatch_snac_tile): of the unit's
# tiles, the two per dtype that won the SNAC sweep in PERF.md
# (seanet_times --what snac_tiles), each with two x tiles; and snac_tile's
# costs, as unit_tile's (a pass's in columns, a tile's in outputs), fit to
# that sweep
_SNAC_TILES = {torch.float32: ((256, 64), (128, 128)),
               torch.bfloat16: ((128, 64), (128, 128))}
_SNAC_TILES[torch.float16] = _SNAC_TILES[torch.bfloat16]
_SNAC_X_SLOTS = 2
_SNAC_PASS_COST = 0
_SNAC_BLOCK_COST = 8192
# SNAC's chain kernel (csrc/snac_res.cu, csrc/seanet_tiles.cuh): 32-row
# blocks, input channels staged 32 at a time, output channels in passes of
# a tile's width: f32 (FMA) passes are 32·TN columns of at most 256, or,
# from C = 512 on, where each warp takes 8 rows and half the columns,
# 64·TN of at most 512; bf16 (mma.sync) passes are 64·NT columns of at
# most 384
_ROWS = 32
_KC = 32
_WIDE_C = 512
# tile: (compiled widths, columns per width unit, rows per warp)
_TILES = {"f32": ((1, 2, 3, 4, 6, 8), 32, 4), "f32 wide": ((4, 6, 8), 64, 8),
          "bf16": ((1, 2, 3, 4, 6), 64, 32)}
_TILE_DTYPES = (torch.float32, torch.bfloat16)   # SNAC chain kernel (N > 1)
_MAX_UNITS = 4
# The chain's rows of state per block: at most 512 (more would leave a
# narrow C too few blocks to fill the card).
_CHAIN_MAX_TILE = 512


def sin2(y: torch.Tensor) -> torch.Tensor:
    """sin²(y) as the kernels compute it: period-π range reduction and an
    odd Taylor series on [-π/2, π/2] (the reference's `_sin2`)."""
    r = y - _PI * torch.round(y * (1.0 / _PI))
    r2 = r * r
    s = r * (1.0 + r2 * (-1.0 / 6.0 + r2 * (1.0 / 120.0 + r2 * (
        -1.0 / 5040.0 + r2 * (1.0 / 362880.0)))))
    return s * s


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def seanet_res_unit_ref(x: torch.Tensor, alpha1: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor,
                        alpha2: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, dilation: int = 1,
                        eps: float = 1e-9) -> torch.Tensor:
    """One residual unit in plain ops, in x's dtype."""
    k = w1.shape[0]
    h = act.snake(x, alpha1, eps)
    h = conv.conv1d(h, w1, b1, dilation=dilation,
                    padding=((k - 1) * dilation) // 2)
    h = act.snake(h, alpha2, eps)
    return x + (h @ w2 + b2)


def seanet_res_chain_ref(x: torch.Tensor, w1s: torch.Tensor,
                         b1s: torch.Tensor, a1s: torch.Tensor,
                         a2s: torch.Tensor, w2s: torch.Tensor,
                         b2s: torch.Tensor,
                         dilations: Sequence[int] = (1, 3, 9),
                         eps: float = 1e-9) -> torch.Tensor:
    """The units in sequence over the whole sequence, in plain ops."""
    for u, d in enumerate(dilations):
        x = seanet_res_unit_ref(x, a1s[u], w1s[u], b1s[u], a2s[u], w2s[u],
                                b2s[u], dilation=d, eps=eps)
    return x


def snac_dw_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                a1: torch.Tensor, a2: torch.Tensor, dilation: int = 1,
                eps: float = 1e-9) -> torch.Tensor:
    """The first half of a SNAC unit, its depthwise pass, in plain ops in
    x's dtype: the snaked hidden S = snake(dwconv(snake(x, α1)) + b1, α2),
    [B, T, C]; w1 [K, C] the per-channel taps."""
    h = act.snake(x, a1, eps)
    with conv.no_cudnn_for_f16(x):
        h = conv.conv1d(h, w1[:, None, :], b1, dilation=dilation,
                        padding=_halo(w1.shape[0], dilation),
                        groups=x.shape[-1])
    return act.snake(h, a2, eps)


def snac_pointwise_ref(x: torch.Tensor, s: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor) -> torch.Tensor:
    """The second half, the 1x1 on the snaked hidden s plus the residual:
    x + (s @ w2 + b2)."""
    return x + (s @ w2 + b2)


def snac_res_chain_ref(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                       a1s: torch.Tensor, a2s: torch.Tensor, w2s: torch.Tensor,
                       b2s: torch.Tensor, dilations: Sequence[int] = (1, 3, 9),
                       eps: float = 1e-9) -> torch.Tensor:
    """SNAC's depthwise units in sequence over the whole sequence, in plain
    ops in x's dtype: snake, depthwise dilated conv (groups=C), snake, 1x1,
    +x. w1s [N, K, C] are each unit's per-channel taps."""
    for u, d in enumerate(dilations):
        s = snac_dw_ref(x, w1s[u], b1s[u], a1s[u], a2s[u], d, eps)
        x = snac_pointwise_ref(x, s, w2s[u], b2s[u])
    return x


# ---------------------------------------------------------------------------
# The gates: tiles and shared memory of each kernel, and the chains' tiles
# ---------------------------------------------------------------------------

def _pick_tile(tiles: Sequence[tuple], c: int, t: int, batch: int,
               sms: int, pass_cost: int, block_cost: int) -> tuple:
    """Of `tiles`, the tile that computes the fewest outputs in
    its rounds over the SMs (batch · ⌈T / rows⌉ · ⌈C / columns⌉ tiles, one
    at a time on each of `sms` SMs), a pass costing pass_cost more columns
    (its A is read anew) and a tile block_cost more outputs (its loads'
    latency and its epilogue; with t = 0: over a T so long that only the
    columns past C count), then the widest pass, then the most rows."""
    def cost(tile):
        rows, cols = tile
        passes = -(-c // cols)
        if not t:
            return passes * cols, -cols, -rows
        blocks = batch * -(-t // rows) * passes
        return (-(-blocks // sms) * (rows * (cols + pass_cost)
                                     + block_cost), -cols, -rows)

    return min(tiles, key=cost)


def unit_tile(c: int, dtype: torch.dtype, t: int = 0, batch: int = 1,
              sms: int = 132) -> tuple:
    """The DAC unit kernels' tile at width C, (rows per tile, columns per
    output pass): `_pick_tile` with _PASS_COST and _BLOCK_COST."""
    return _pick_tile(_UNIT_TILES[dtype], c, t, batch, sms, _PASS_COST,
                      _BLOCK_COST)


def snac_tile(c: int, dtype: torch.dtype, t: int = 0, batch: int = 1,
              sms: int = 132) -> tuple:
    """The tile of a SNAC unit's 1x1 launch (the DAC unit's 1x1 product),
    (rows per tile, columns per output pass): `_pick_tile` over
    _SNAC_TILES with SNAC's own costs, fit to the SNAC sweep."""
    return _pick_tile(_SNAC_TILES[dtype], c, t, batch, sms, _SNAC_PASS_COST,
                      _SNAC_BLOCK_COST)


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _layout_bytes(stages: int, stage: int, a: int, s: int = 0,
                  state: int = 0) -> int:
    """csrc/seanet_res.cu's make_layout: barriers, the weight ring, A, S
    and the state, plus 1024 bytes to align the base."""
    return (_BARRIER_BYTES + stages * stage + _r16(a) + _r16(s) + _r16(state)
            + 1024)


def _tile_bytes(tile: tuple, dtype: torch.dtype) -> tuple:
    """(rows, bytes of a ring stage, bytes of an A row, element bytes)."""
    rows, cols = tile
    op, kc = dtype.itemsize, _CHUNK[dtype]
    return rows, kc * cols * op, (kc + 16 // op) * op, op


def unit_smem_bytes(c: int, k: int, dilation: int, dtype: torch.dtype,
                    tile: tuple, pointwise: bool = False,
                    x_slots: int = 1) -> int:
    """Shared memory of a unit's product launch at `tile`: its ring of
    weight tiles, its A slots (the rows with their halo, in boxes of 64
    rows of 128 bytes; two, or for the 1x1 four where they fit an H100's
    shared memory), and for the 1x1 (pointwise) its x_slots tiles of x."""
    rows, stage, _, op = _tile_bytes(tile, dtype)
    halo = 0 if pointwise else _halo(k, dilation)
    slot = -(-(rows + 2 * halo) // 64) * 64 * 128
    x_tiles = x_slots * rows * tile[1] * op if pointwise else 0
    slots = 4 if pointwise and _layout_bytes(
        _UNIT_STAGES, stage, 4 * slot, x_tiles) <= _H100_SMEM else 2
    return _layout_bytes(_UNIT_STAGES, stage, slots * slot, x_tiles)


def _halo(k: int, d: int) -> int:
    return ((k - 1) * d) // 2


def _state_bytes(c: int, k: int, dilations: Sequence[int], tile: int) -> int:
    """A chain's f32 state [tile + 2·Σ halos, C | 1] (rows of odd length),
    rounded up to 16 bytes."""
    halo = sum(_halo(k, d) for d in dilations)
    return -(-(tile + 2 * halo) * (c | 1) // 4) * 16


def chain_smem_bytes(c: int, k: int, dilations: Sequence[int], tile: int,
                     dtype: torch.dtype, block: tuple) -> int:
    """The chain at `tile` rows of state and the product tile `block`: its
    ring, A at the largest halo, S for one row block [rows, C rounded up to
    a chunk + 16 bytes] and its state."""
    rows, stage, a_row, op = _tile_bytes(block, dtype)
    halo = max(_halo(k, d) for d in dilations)
    s_row = (-(-c // _CHUNK[dtype]) * _CHUNK[dtype]) * op + 16
    return _layout_bytes(_CHAIN_STAGES, stage, (rows + 2 * halo) * a_row,
                         rows * s_row, _state_bytes(c, k, dilations, tile))


def _largest_tile(smem_bytes, smem_limit: int) -> int:
    """The largest multiple of 32, up to 512, with smem_bytes(tile) <=
    smem_limit, or 0 when not even 32 rows fit."""
    tile = _CHAIN_MAX_TILE
    while tile and smem_bytes(tile) > smem_limit:
        tile -= _ROWS
    return tile


def chain_block(c: int, dtype: torch.dtype) -> tuple:
    """The chain's product tile (csrc/seanet_res.cu::dispatch_chain): bf16
    and f16 128 x 64; f32 one output pass, the narrowest of the unit's f32
    tiles that covers C (64, 128 or 256 columns), else the widest."""
    if dtype != torch.float32:
        return (128, 64)
    return next((tile for tile in sorted(_UNIT_TILES[dtype],
                                         key=lambda tile: tile[1])
                 if tile[1] >= c), (64, 256))


def chain_tile(c: int, k: int, dilations: Sequence[int], dtype: torch.dtype,
               smem_limit: int) -> int:
    """Rows of state per block of the chain kernel at its product tile
    (`chain_block`): the most, a multiple of 32 up to 512, that fit
    `smem_limit` bytes; 0 when not even 32 fit."""
    block = chain_block(c, dtype)
    return _largest_tile(lambda tile: chain_smem_bytes(
        c, k, dilations, tile, dtype, block), smem_limit)


def use_chain(c: int, k: int, dilations: Sequence[int], dtype: torch.dtype,
              smem_limit: int) -> bool:
    """The gate: a block's units run as one chain launch only in a 16-bit
    dtype (bf16 or f16) and where the chain's whole 512-row state fits (at
    the DAC widths: C64, the encoder's first block), else as one unit
    launch each. On an H100 the chain lost to three unit launches at every
    DAC width where it fits, in f32 and bf16, least at bf16 C64 (PERF.md):
    the gate keeps it there, so that a DAC path still runs it."""
    return (dtype != torch.float32 and chain_tile(
        c, k, dilations, dtype, smem_limit) == _CHAIN_MAX_TILE)


# SNAC's kernel (csrc/snac_res.cu)

def _tile(c: int, dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bf16"
    return "f32 wide" if c >= _WIDE_C else "f32"


def tile_width(c: int, dtype: torch.dtype) -> int:
    """SNAC's pass width parameter (TN for f32, NT for bf16): the fewest
    passes, split evenly, rounded up to a compiled width."""
    widths, cols, _ = _TILES[_tile(c, dtype)]
    passes = -(-c // (cols * widths[-1]))
    need = -(-c // (cols * passes))
    return next(w for w in widths if w >= need)


def _pass_columns(c: int, dtype: torch.dtype) -> int:
    return _TILES[_tile(c, dtype)][1] * tile_width(c, dtype)


def _tile_args(c: int, dtype: torch.dtype) -> tuple:
    """(rows per warp, width, dtype code): SNAC's kernel's tile arguments."""
    return (_TILES[_tile(c, dtype)][2], tile_width(c, dtype),
            _DTYPE_CODES[dtype])


def _dw_block_bytes(c: int, k: int, dilation: int, dtype: torch.dtype) -> int:
    """The buffers of a row block of SNAC's chain (csrc/snac_res.cu::
    dw_common_bytes): S and two weight tiles as the dense tiles stage them
    (f32 for f32, bf16 for bf16), and the snaked input chunk A [32 +
    2·halo, 32] in f32 in both."""
    cp = -(-c // _KC) * _KC
    bn = _pass_columns(c, dtype)
    a = 4 * (_ROWS + 2 * _halo(k, dilation)) * _KC
    if dtype == torch.float32:
        return 4 * (_ROWS * cp + 2 * _KC * bn) + a
    return 2 * (_ROWS * (cp + 8) + 2 * _KC * (bn + 8)) + a


def dw_chain_smem_bytes(c: int, k: int, dilations: Sequence[int], tile: int,
                        dtype: torch.dtype) -> int:
    """SNAC's chain: its f32 state plus a row block's buffers at the
    largest dilation."""
    return (_state_bytes(c, k, dilations, tile)
            + _dw_block_bytes(c, k, max(dilations), dtype))


def dw_chain_tile(c: int, k: int, dilations: Sequence[int],
                  dtype: torch.dtype, smem_limit: int) -> int:
    """Rows per block of SNAC's chain kernel (as `chain_tile`)."""
    return _largest_tile(
        lambda tile: dw_chain_smem_bytes(c, k, dilations, tile, dtype),
        smem_limit)


def dw_rows(dilation: int) -> int:
    """Rows per block of SNAC's depthwise pass: the most, up to 256, that
    are a multiple of 4·d (each residue class mod d then splits into whole
    items of 4 outputs; 4·d rows where d > 64)."""
    step = _DW_OUT * dilation
    return max(step, _DW_MAX_ROWS // step * step)


def dw_smem_bytes(k: int, dilation: int, dtype: torch.dtype) -> int:
    """The depthwise pass's shared memory (csrc/snac_res.cu::dw_smem_bytes):
    a block's rows and their halo, 32 channels each, as f32, and in bf16
    also as they land, before the snake."""
    row = 4 if dtype == torch.float32 else 4 + dtype.itemsize
    return (dw_rows(dilation) + 2 * _halo(k, dilation)) * _DW_CHANNELS * row


def snac_unit_smem_bytes(c: int, k: int, dilation: int, dtype: torch.dtype,
                         tile: tuple) -> int:
    """The larger shared memory of a SNAC unit's two launches: the
    depthwise pass and the 1x1 at `tile`."""
    return max(dw_smem_bytes(k, dilation, dtype),
               unit_smem_bytes(c, k, dilation, dtype, tile, pointwise=True,
                               x_slots=_SNAC_X_SLOTS))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from ..kernels.build import load_library

    lib = load_library()
    lib.codec_seanet_res_unit.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.codec_seanet_res_unit.restype = ctypes.c_int
    lib.codec_seanet_res_chain.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.codec_seanet_res_chain.restype = ctypes.c_int
    lib.codec_seanet_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.codec_seanet_smem_bytes.restype = ctypes.c_int
    lib.codec_snac_res_chain.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.codec_snac_res_chain.restype = ctypes.c_int
    lib.codec_snac_res_unit.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.codec_snac_res_unit.restype = ctypes.c_int
    lib.codec_snac_dw.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.codec_snac_dw.restype = ctypes.c_int
    lib.codec_snac_dw_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.codec_snac_dw_smem_bytes.restype = ctypes.c_int
    lib.codec_smem_per_block_optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.codec_smem_per_block_optin.restype = ctypes.c_int
    lib.codec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.codec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().codec_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} "
                           f"(cudaError {err})")


@functools.cache
def smem_per_block(index: int) -> int:
    """Opt-in shared memory per block of CUDA device `index`, in bytes."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().codec_smem_per_block_optin(ctypes.byref(out)),
                  "cudaDeviceGetAttribute")
    return out.value


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(what: str, x: torch.Tensor, w1s: torch.Tensor, w2s: torch.Tensor,
           vectors: Sequence, depthwise: bool = False) -> None:
    """x [B, T, C]; w1s [N, K, C, C] (or, depthwise, [N, K, C]), K odd;
    w2s [N, C, C]; each vector [N, C]; all contiguous on x's device in
    x's dtype."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype} not supported "
                         f"(float32, bfloat16 or float16)")
    if x.ndim != 3 or x.shape[1] < 1 or not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{what}: x must be [B, T, C] with T >= 1, "
                         f"got {tuple(x.shape)}")
    n, c = w1s.shape[0], x.shape[2]
    taps = (c,) if depthwise else (c, c)
    k = w1s.shape[1] if w1s.ndim == 2 + len(taps) else 0
    if w1s.shape != (n, k, *taps) or k % 2 == 0:
        form = f"taps [K, {c}]" if depthwise else f"WIO [K, {c}, {c}]"
        raise ValueError(f"{what}: w1 must be {form} with K odd, got "
                         f"{tuple(w1s.shape[1:])}")
    if w2s.shape != (n, c, c):
        raise ValueError(f"{what}: w2 must be [{c}, {c}] (the second conv "
                         f"is 1x1), got {tuple(w2s.shape[1:])}")
    for v in vectors:
        if v is None:
            raise ValueError(f"{what}: both convs need a bias")
        if v.shape != (n, c) or v.device != x.device:
            raise ValueError(f"{what}: alphas and biases must be [{c}] on "
                             f"{x.device}, got {tuple(v.shape[1:])} on "
                             f"{v.device}")
    for name, t in (("x", x), ("w1", w1s), ("w2", w2s)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _dilations(what: str, dilations: Sequence[int], n: int) -> tuple:
    dilations = tuple(dilations)
    if (len(dilations) != n or len(dilations) > _MAX_UNITS
            or not all(isinstance(d, int) and d >= 1 for d in dilations)):
        raise ValueError(f"{what}: want one positive dilation per unit (at "
                         f"most {_MAX_UNITS}), got {dilations} for {n} units")
    return dilations


def unit_vec(a1s: torch.Tensor, b1s: torch.Tensor, a2s: torch.Tensor,
             b2s: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """The f32 rows the kernels read, [N, 6, C]: α1, 1/(α1+eps), b1, α2,
    1/(α2+eps), b2 per unit (alphas and biases [N, C] in any dtype)."""
    a1, a2 = a1s.float(), a2s.float()
    return torch.stack([a1, 1.0 / (a1 + eps), b1s.float(), a2,
                        1.0 / (a2 + eps), b2s.float()], dim=1).contiguous()


def _unit_rows(what: str, vec, vectors, eps: float) -> torch.Tensor:
    """The caller's precomputed rows (checked: [N, 6, C] f32, contiguous,
    on the vectors' device) or unit_vec's."""
    if vec is None:
        return unit_vec(*vectors, eps=eps)
    n, c = vectors[0].shape
    if (vec.shape != (n, 6, c) or vec.dtype != torch.float32
            or vec.device != vectors[0].device or not vec.is_contiguous()):
        raise ValueError(f"{what}: vec must be unit_vec's contiguous f32 "
                         f"[{n}, 6, {c}] on {vectors[0].device}, got "
                         f"{vec.dtype} {tuple(vec.shape)} on {vec.device}")
    return vec


def _weight_width(c: int, dtype: torch.dtype) -> int:
    """The weights' row length for the tensor maps: C rounded up to 16
    bytes (every DAC width is already)."""
    per = 16 // dtype.itemsize
    return -(-c // per) * per


def _pad_weights(w: torch.Tensor, cw: int) -> torch.Tensor:
    """w [..., C, C] zero-padded to [..., cw, cw] (a copy only where C is
    no multiple of 16 bytes)."""
    pad = cw - w.shape[-1]
    return w if not pad else torch.nn.functional.pad(w, (0, pad, 0, pad))


def _launch_unit(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 vec: torch.Tensor, dilation: int, tile: tuple) -> torch.Tensor:
    """One unit's launches at a product tile (checked arguments)."""
    b, t, c = x.shape
    k = w1.shape[0]
    limit = smem_per_block(x.device.index or 0)
    need = max(unit_smem_bytes(c, k, dilation, x.dtype, tile, pointwise)
               for pointwise in (False, True))
    if need > limit:
        raise ValueError(f"seanet_res_unit: C={c}, K={k}, d={dilation} needs "
                         f"{need} bytes of shared memory, the device has "
                         f"{limit}")
    cw = _weight_width(c, x.dtype)
    w1, w2 = _pad_weights(w1, cw), _pad_weights(w2, cw)
    s = x.new_empty((b, t, cw))                 # the snaked hidden S
    out = torch.empty_like(x)
    # xs = snake(x) is dead before the 1x1 writes out: it lives in out
    xs = out if cw == c else x.new_empty((b, t, cw))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().codec_seanet_res_unit(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), vec.data_ptr(),
            xs.data_ptr(), s.data_ptr(), out.data_ptr(), b, t, c, cw, k,
            dilation, *tile, _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, "seanet_res_unit")
    return out


def seanet_res_unit(x: torch.Tensor, alpha1: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, alpha2: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, dilation: int = 1, eps: float = 1e-9,
                    vec: torch.Tensor | None = None) -> torch.Tensor:
    """One residual unit: x [B, T, C] (f32, bf16 or f16) → [B, T, C]; vec: its
    rows [1, 6, C] or [6, C] (unit_vec), else built here.

    Counts its kernel launches in `seanet_res_unit.launches`."""
    if x.device.type == "cpu":
        return seanet_res_unit_ref(x, alpha1, w1, b1, alpha2, w2, b2,
                                   dilation=dilation, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"seanet_res_unit: no kernel for device {x.device}")
    vectors = [None if v is None else v[None]
               for v in (alpha1, b1, alpha2, b2)]
    _check("seanet_res_unit", x, w1[None], w2[None], vectors)
    if not isinstance(dilation, int) or dilation < 1:
        raise ValueError(f"seanet_res_unit: dilation must be a positive "
                         f"int, got {dilation!r}")
    vec = _unit_rows("seanet_res_unit", None if vec is None else
                     vec.reshape(1, 6, -1), vectors, eps)
    b, t, c = x.shape
    out = _launch_unit(x, w1, w2, vec, dilation, unit_tile(
        c, x.dtype, t, b, _sm_count(x.device.index or 0)))
    seanet_res_unit.launches += 1
    return out


def seanet_res_chain(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                     a1s: torch.Tensor, a2s: torch.Tensor, w2s: torch.Tensor,
                     b2s: torch.Tensor, dilations: Sequence[int] = (1, 3, 9),
                     eps: float = 1e-9,
                     vec: torch.Tensor | None = None) -> torch.Tensor:
    """N residual units in one pass: x [B, T, C] (f32, bf16 or f16); w1s
    [N, K, C, C]; w2s [N, C, C]; alphas and biases [N, C]; vec their rows
    [N, 6, C] (unit_vec), else built here → [B, T, C]. The residual stays
    f32 across units. Raises on CUDA where not even 32 rows of the chain's
    state fit shared memory (`chain_tile`).

    Counts its kernel launches in `seanet_res_chain.launches`."""
    if x.device.type == "cpu":
        return seanet_res_chain_ref(x, w1s, b1s, a1s, a2s, w2s, b2s,
                                    dilations=dilations, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"seanet_res_chain: no kernel for device {x.device}")
    vectors = (a1s, b1s, a2s, b2s)
    _check("seanet_res_chain", x, w1s, w2s, vectors)
    dilations = _dilations("seanet_res_chain", dilations, w1s.shape[0])
    b, t, c = x.shape
    k = w1s.shape[1]
    tile = chain_tile(c, k, dilations, x.dtype,
                      smem_per_block(x.device.index or 0))
    if not tile:
        raise ValueError(f"seanet_res_chain: the chain's state at C={c}, "
                         f"K={k} does not fit shared memory; run the units "
                         f"one by one (seanet_res_unit)")
    tile = min(tile, -(-t // _ROWS) * _ROWS)
    vec = _unit_rows("seanet_res_chain", vec, vectors, eps)
    cw = _weight_width(c, x.dtype)
    w1s, w2s = _pad_weights(w1s, cw), _pad_weights(w2s, cw)
    out = torch.empty_like(x)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().codec_seanet_res_chain(
            x.data_ptr(), w1s.data_ptr(), w2s.data_ptr(), vec.data_ptr(),
            out.data_ptr(), b, t, c, cw, k, len(dilations), dils, tile,
            *chain_block(c, x.dtype), _DTYPE_CODES[x.dtype], stream)
    _raise_on(err, "seanet_res_chain")
    seanet_res_chain.launches += 1
    return out


seanet_res_unit.launches = 0
seanet_res_chain.launches = 0


def seanet_res_units(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                     a1s: torch.Tensor, a2s: torch.Tensor, w2s: torch.Tensor,
                     b2s: torch.Tensor, dilations: Sequence[int] = (1, 3, 9),
                     eps: float = 1e-9,
                     vec: torch.Tensor | None = None) -> torch.Tensor:
    """A block's residual units (arguments as `seanet_res_chain`). On a
    CUDA tensor: the chain kernel where the gate (`use_chain`) takes it,
    else one unit kernel launch per unit. On a CPU tensor: the plain
    version."""
    if x.device.type == "cuda" and not use_chain(
            x.shape[-1], w1s.shape[1], dilations, x.dtype,
            smem_per_block(x.device.index or 0)):
        for u, d in enumerate(dilations):
            x = seanet_res_unit(x, a1s[u], w1s[u], b1s[u], a2s[u], w2s[u],
                                b2s[u], dilation=d, eps=eps,
                                vec=None if vec is None else vec[u])
        return x
    return seanet_res_chain(x, w1s, b1s, a1s, a2s, w2s, b2s,
                            dilations=dilations, eps=eps, vec=vec)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_snac_dw(x: torch.Tensor, w1: torch.Tensor,
                    vec: torch.Tensor, dilation: int) -> torch.Tensor:
    """A SNAC unit's depthwise pass alone, x → S [B, T, cw] (checked
    arguments; w1 the taps [K, C])."""
    b, t, c = x.shape
    k = w1.shape[0]
    s = x.new_empty((b, t, _weight_width(c, x.dtype)))
    with torch.cuda.device(x.device):
        err = _lib().codec_snac_dw(
            x.data_ptr(), w1.data_ptr(), vec.data_ptr(), s.data_ptr(), b, t,
            c, s.shape[-1], k, dilation, dw_rows(dilation),
            _DTYPE_CODES[x.dtype], _stream(x))
    _raise_on(err, "snac_res_chain")
    return s


def _launch_snac_unit(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                      vec: torch.Tensor, dilation: int,
                      tile: tuple) -> torch.Tensor:
    """One SNAC unit's two launches, the depthwise pass (x → S) and the 1x1
    at a product tile (S, x → out) (checked arguments; w1 the taps [K, C],
    w2 [C, C])."""
    b, t, c = x.shape
    k = w1.shape[0]
    if k > _DW_MAX_TAPS:
        raise ValueError(f"snac_res_chain: the depthwise pass takes at most "
                         f"{_DW_MAX_TAPS} taps, got K={k}")
    limit = smem_per_block(x.device.index or 0)
    need = snac_unit_smem_bytes(c, k, dilation, x.dtype, tile)
    if need > limit:
        raise ValueError(f"snac_res_chain: C={c}, K={k}, d={dilation} needs "
                         f"{need} bytes of shared memory, the device has "
                         f"{limit}")
    cw = _weight_width(c, x.dtype)
    w2 = _pad_weights(w2, cw)
    s = x.new_empty((b, t, cw))                 # the snaked hidden S
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().codec_snac_res_unit(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), vec.data_ptr(),
            s.data_ptr(), out.data_ptr(), b, t, c, cw, k, dilation,
            dw_rows(dilation), *tile, _DTYPE_CODES[x.dtype], _stream(x))
    _raise_on(err, "snac_res_chain")
    return out


def snac_res_chain(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                   a1s: torch.Tensor, a2s: torch.Tensor, w2s: torch.Tensor,
                   b2s: torch.Tensor, dilations: Sequence[int] = (1, 3, 9),
                   eps: float = 1e-9,
                   vec: torch.Tensor | None = None) -> torch.Tensor:
    """N depthwise residual units (SNAC): x [B, T, C] (f32, bf16 or f16); w1s
    [N, K, C] per-channel taps; w2s [N, C, C]; alphas and biases [N, C];
    vec their rows [N, 6, C] (unit_vec), else built here → [B, T, C]. With
    N = 1 (what a decode launches) two kernels in stream order: the
    depthwise pass writes the snaked hidden S once, then the 1x1 at
    `snac_tile` reads S and x (K <= 7). With N > 1 the chain kernel keeps
    the residual in f32 in shared memory across units (f32 and bf16 only),
    and raises on CUDA where not even 32 rows of that state fit
    (`dw_chain_tile`).

    Counts its wrapper calls that launch in `snac_res_chain.launches`."""
    if x.device.type == "cpu":
        return snac_res_chain_ref(x, w1s, b1s, a1s, a2s, w2s, b2s,
                                  dilations=dilations, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"snac_res_chain: no kernel for device {x.device}")
    vectors = (a1s, b1s, a2s, b2s)
    _check("snac_res_chain", x, w1s, w2s, vectors, depthwise=True)
    dilations = _dilations("snac_res_chain", dilations, w1s.shape[0])
    vec = _unit_rows("snac_res_chain", vec, vectors, eps)
    b, t, c = x.shape
    k = w1s.shape[1]
    if len(dilations) == 1:
        out = _launch_snac_unit(x, w1s[0], w2s[0], vec, dilations[0],
                                snac_tile(c, x.dtype, t, b,
                                          _sm_count(x.device.index or 0)))
        snac_res_chain.launches += 1
        return out
    if x.dtype not in _TILE_DTYPES:
        raise ValueError(f"snac_res_chain: the chain kernel (N > 1) takes "
                         f"float32 or bfloat16, got {x.dtype}; run the "
                         f"units one at a time (N = 1)")
    tile = dw_chain_tile(c, k, dilations, x.dtype,
                         smem_per_block(x.device.index or 0))
    if not tile:
        raise ValueError(f"snac_res_chain: the chain's state at C={c}, "
                         f"K={k} does not fit shared memory; run the "
                         f"units one at a time (N = 1)")
    tile = min(tile, -(-t // _ROWS) * _ROWS)
    out = torch.empty_like(x)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    with torch.cuda.device(x.device):
        err = _lib().codec_snac_res_chain(
            x.data_ptr(), w1s.data_ptr(), w2s.data_ptr(), vec.data_ptr(),
            out.data_ptr(), b, t, c, k, len(dilations), dils, tile,
            *_tile_args(c, x.dtype), _stream(x))
    _raise_on(err, "snac_res_chain")
    snac_res_chain.launches += 1
    return out


snac_res_chain.launches = 0


def snac_res_units(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                   a1s: torch.Tensor, a2s: torch.Tensor, w2s: torch.Tensor,
                   b2s: torch.Tensor, dilations: Sequence[int] = (1, 3, 9),
                   eps: float = 1e-9,
                   vec: torch.Tensor | None = None) -> torch.Tensor:
    """A SNAC block's residual units (arguments as `snac_res_chain`). On a
    CUDA tensor: one N = 1 call of `snac_res_chain` per unit (its
    depthwise pass and 1x1), which on an H100 beats the chain (N = 3) at
    every SNAC width and dtype: the chain's state leaves one or two blocks
    per SM (PERF.md). On a CPU tensor: the plain version."""
    if x.device.type == "cuda":
        for u, d in enumerate(dilations):
            s = slice(u, u + 1)
            x = snac_res_chain(x, w1s[s], b1s[s], a1s[s], a2s[s], w2s[s],
                               b2s[s], dilations=(d,), eps=eps,
                               vec=None if vec is None else vec[s])
        return x
    return snac_res_chain(x, w1s, b1s, a1s, a2s, w2s, b2s,
                          dilations=dilations, eps=eps)
