"""Random CSM-style TTS fixtures from a seed: a llama backbone GGUF and a
Mimi codec GGUF with a residual_depth_ar adaptor.

Widths default to the published ones: the backbone is Llama-3.2-1B
(meta-llama/Llama-3.2-1B config.json; CSM-1B's backbone): hidden 2048, 16
layers, 32 heads x 64, 8 KV heads, FFN 8192, vocab 128256, rope_theta
500000 with llama3 rope scaling, tied embeddings. The adaptor is CSM-1B's
depth decoder (codec_tpu/models/bench_lm_init.py::write_rda_gguf's
defaults): 4 layers at 1024, 8 heads x 128, 2 KV heads, FFN 4096, 32
codebooks of 2051 codes, over a backbone hidden of 2048. The codec is the
random kyutai/mimi of models/mimi_init.py (32 codebooks x 2048).

The files use the wire schemas that codec_tpu reads too (the backbone's
is codec_tpu/convert/backbone.py's), so both packages load the same file.
"""

from __future__ import annotations

import base64
import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..io.gguf import GGUFWriter, encode_tensor
from ..lm.backbone import BackboneConfig
from .mimi import MimiConfig
from .mimi_init import add_random_mimi

LLAMA_3_2_1B = BackboneConfig(
    hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
    ffn_dim=8192, vocab_size=128256, rope_theta=500000.0, rms_eps=1e-5,
    max_ctx=2048, tied_lm_head=True)
LLAMA3_SCALING = {"factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192}


@dataclass(frozen=True)
class DepthConfig:
    """A residual_depth_ar adaptor's widths (CSM-1B's by default)."""
    hidden: int = 2048            # the backbone's hidden
    depth_hidden: int = 1024
    layers: int = 4
    heads: int = 8
    kv_heads: int = 2
    head_dim: int = 128
    ffn: int = 4096
    n_codebook: int = 32
    vocab: int = 2051


def llama3_freq_factors(head_dim: int, rope_theta: float,
                        scaling: dict) -> np.ndarray:
    """HF Llama3RotaryEmbedding's factors (a copy of
    codec_tpu/convert/backbone.py::llama3_freq_factors): inv_freq /= factor
    for low frequencies, a smooth ramp in between."""
    factor = float(scaling.get("factor", 8.0))
    lo = float(scaling.get("low_freq_factor", 1.0))
    hi = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    inv = rope_theta ** (-2.0 * np.arange(head_dim // 2) / head_dim)
    wavelen = 2.0 * math.pi / inv
    low_wl = orig / lo
    high_wl = orig / hi
    smooth = (orig / wavelen - lo) / (hi - lo)
    ff = np.where(wavelen > low_wl, factor,
                  np.where(wavelen < high_wl, 1.0,
                           1.0 / ((1.0 - smooth) / factor + smooth)))
    return ff.astype(np.float32)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def spm_model_b64(pieces: Sequence[Tuple[str, float, int]]) -> str:
    """A SentencePiece ModelProto holding only `pieces` (piece, score,
    type: 1 normal, 2 unknown, 3 control, 6 byte), base64 — the
    `backbone.tokenizer.spm_b64` KV that lm/spm.py parses."""
    out = b""
    for piece, score, ptype in pieces:
        b = piece.encode("utf-8")
        body = (b"\x0a" + _varint(len(b)) + b + b"\x15" + struct.pack("<f", score)
                + b"\x18" + _varint(ptype))
        out += b"\x0a" + _varint(len(body)) + body
    return base64.b64encode(out).decode("ascii")


def byte_fallback_vocab() -> list:
    """A small unigram vocab that tokenizes any text (every byte has a
    fallback piece): <unk>, a few words, and <0x00>..<0xFF>."""
    pieces = [("<unk>", 0.0, 2), ("▁", -1.0, 1), ("▁hello", -2.0, 1),
              ("▁there", -2.5, 1), ("lo", -3.0, 1), ("he", -3.0, 1)]
    return pieces + [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]


def write_random_backbone_gguf(path: Union[str, Path], seed: int = 0,
                               qtype: str = "Q4_K",
                               cfg: BackboneConfig = LLAMA_3_2_1B,
                               rope_scaling: Optional[dict] = LLAMA3_SCALING,
                               spm_b64: str = "", bpe_zb64: str = "") -> Path:
    """A llama_backbone GGUF with random weights from `seed`: the layer
    matrices in `qtype` (Q4_K, Q8_0 or F32; Q4_K needs every matrix's
    input width to be a multiple of 256), tok_embd (and an untied lm_head)
    in F16, norms and biases in F32. The draws do not depend on `qtype`,
    so one seed gives the same weights in every type. `rope_scaling`
    (llama3) bakes `backbone.rope_freq_factors`; `spm_b64` bakes an SPM
    tokenizer (`spm_model_b64`), `bpe_zb64` a byte-level BPE one (a
    tokenizer.json in lm/bpe.py's KV form, BpeByteLevel.json_to_zb64).
    A config with n_experts > 0 writes a Qwen3-MoE backbone
    (codec_tpu/convert/backbone.py's names and KVs): per layer the router
    [E, hidden] in F32 and the stacked experts gate_exps / up_exps [E,
    moe_ffn, hidden] and down_exps [E, hidden, moe_ffn] in F16, whatever
    `qtype` (codec_tpu loads experts dense), in place of gate / up /
    down."""
    return write_random_backbone_ggufs({qtype: path}, seed, cfg,
                                       rope_scaling, spm_b64, bpe_zb64)[qtype]


def write_random_backbone_ggufs(paths: Dict[str, Union[str, Path]],
                                seed: int = 0,
                                cfg: BackboneConfig = LLAMA_3_2_1B,
                                rope_scaling: Optional[dict] = LLAMA3_SCALING,
                                spm_b64: str = "",
                                bpe_zb64: str = "") -> Dict[str, Path]:
    """write_random_backbone_gguf for several layer-matrix types at once
    ({qtype: path}): the weights are drawn once and each file gets them in
    its type, the same files as one call per type. The matrices are
    quantized on a pool of threads (NumPy leaves the GIL in its array
    loops) while the next ones are drawn."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02, off=0.0):
        return rng.standard_normal(shape, dtype=np.float32) * scale + off

    h, nh, nkv, hd = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    writers = {q: GGUFWriter(p, "llama_backbone") for q, p in paths.items()}
    for wr in writers.values():
        for key, val in (("hidden_dim", h), ("n_layers", cfg.n_layers),
                         ("n_heads", nh), ("n_kv_heads", nkv), ("head_dim", hd),
                         ("ffn_dim", cfg.ffn_dim),
                         ("vocab_size", cfg.vocab_size),
                         ("max_ctx", cfg.max_ctx)):
            wr.add_int32(f"backbone.{key}", val)
        wr.add_float32("backbone.rope_theta", cfg.rope_theta)
        wr.add_float32("backbone.rms_eps", cfg.rms_eps)
        wr.add_bool("backbone.qk_norm", cfg.has_qk_norm)
        wr.add_bool("backbone.attn_bias", cfg.has_attn_bias)
        wr.add_bool("backbone.tied_lm_head", cfg.tied_lm_head)
        if cfg.n_experts:
            wr.add_int32("backbone.n_experts", cfg.n_experts)
            wr.add_int32("backbone.n_experts_used", cfg.n_experts_used)
            wr.add_bool("backbone.norm_topk_prob", cfg.norm_topk_prob)
            wr.add_int32("backbone.moe_ffn_dim", cfg.moe_ffn_dim)
        if spm_b64:
            wr.add_string("backbone.tokenizer.spm_b64", spm_b64)
        if bpe_zb64:
            wr.add_string("backbone.tokenizer.bpe_json_zb64", bpe_zb64)

    # (name, future or array, storage type per qtype) in file order
    queue = []
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))

    def add(name, arr, storage=None):
        for q in writers:
            st = storage or q
            if st in ("F32", "F16") and arr.nbytes < 2 ** 24:
                queue.append((q, name, arr, st))
            else:
                queue.append((q, name, pool.submit(encode_tensor, arr, st), st))
        # a MoE layer's stacked experts are 0.4-0.8 GB drawn: encode them
        # and keep no more than one draw in flight
        while len(queue) > (1 if arr.nbytes >= 2 ** 28 else 64):
            _flush_one()

    def _flush_one():
        q, name, item, st = queue.pop(0)
        if hasattr(item, "result"):
            writers[q].add_encoded(name, item.result())
        else:
            writers[q].add_tensor(name, item, st)

    try:
        add("backbone.tok_embd", w(cfg.vocab_size, h), "F16")
        add("backbone.out_norm.w", w(h, off=1.0), "F32")
        if not cfg.tied_lm_head:
            add("backbone.lm_head.w", w(cfg.vocab_size, h), "F16")
        if rope_scaling is not None:
            add("backbone.rope_freq_factors",
                llama3_freq_factors(hd, cfg.rope_theta, rope_scaling), "F32")
        for i in range(cfg.n_layers):
            pre = f"backbone.l{i}."
            add(pre + "attn_norm.w", w(h, off=1.0), "F32")
            for name, shape in (("q", (nh * hd, h)), ("k", (nkv * hd, h)),
                                ("v", (nkv * hd, h)), ("o", (h, nh * hd))):
                add(f"{pre}{name}.w", w(*shape))
                if cfg.has_attn_bias and name != "o":
                    add(f"{pre}{name}.b", w(shape[0]), "F32")
            if cfg.has_qk_norm:
                add(pre + "q_norm.w", w(hd, off=1.0), "F32")
                add(pre + "k_norm.w", w(hd, off=1.0), "F32")
            add(pre + "ffn_norm.w", w(h, off=1.0), "F32")
            if cfg.n_experts:
                e, f = cfg.n_experts, cfg.moe_ffn_dim
                add(pre + "router.w", w(e, h), "F32")
                for name, shape in (("gate_exps", (e, f, h)),
                                    ("up_exps", (e, f, h)),
                                    ("down_exps", (e, h, f))):
                    add(f"{pre}{name}.w", w(*shape), "F16")
                continue
            for name, shape in (("gate", (cfg.ffn_dim, h)),
                                ("up", (cfg.ffn_dim, h)),
                                ("down", (h, cfg.ffn_dim))):
                add(f"{pre}{name}.w", w(*shape))
        while queue:
            _flush_one()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for wr in writers.values():
        wr.write()
    return {q: Path(p) for q, p in paths.items()}


def add_random_depth_adaptor(wr: GGUFWriter, seed: int = 0,
                             dcfg: DepthConfig = DepthConfig(),
                             eos_code_c0: int = -1,
                             delay_pattern: Optional[Sequence[int]] = None) -> None:
    """Add a CSM-style residual_depth_ar adaptor (shared in_proj, c0 head,
    NEOX rope, one 2D head per depth codebook) to an open writer, F16.

    Scales keep the logits peaked: each head's logits have a standard
    deviation of about 3 over unit-RMS inputs, and the depth matrices are
    drawn at 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    h, dh, n_cb, vocab = dcfg.hidden, dcfg.depth_hidden, dcfg.n_codebook, dcfg.vocab
    qd, kvd = dcfg.heads * dcfg.head_dim, dcfg.kv_heads * dcfg.head_dim

    def w(out_d, in_d=None, scale=None, off=0.0):
        shape = (out_d,) if in_d is None else (out_d, in_d)
        s = scale if scale is not None else 1.0 / math.sqrt(in_d)
        return rng.standard_normal(shape, dtype=np.float32) * s + off

    wr.add_bool("codec.lm.has_adaptor", True)
    wr.add_string("codec.lm.kind", "residual_depth_ar")
    wr.add_string("codec.lm.host_arch", "llama")
    wr.add_uint32("codec.lm.hidden_dim", h)
    wr.add_uint32("codec.lm.audio_embed_dim", h)
    wr.add_uint32("codec.lm.n_codebook", n_cb)
    wr.add_array("codec.lm.codebook_sizes", [vocab] * n_cb)
    wr.add_array("codec.lm.delay_pattern",
                 list(delay_pattern) if delay_pattern is not None else [0] * n_cb)
    if eos_code_c0 >= 0:
        wr.add_int32("codec.lm.eos_code_c0", eos_code_c0)
    for key, val in (("depth_layers", dcfg.layers), ("depth_hidden", dh),
                     ("depth_n_heads", dcfg.heads),
                     ("depth_n_kv_heads", dcfg.kv_heads),
                     ("depth_head_dim", dcfg.head_dim)):
        wr.add_uint32(f"codec.lm.residual.{key}", val)
    wr.add_float32("codec.lm.residual.depth_rope_theta", 10000.0)
    wr.add_float32("codec.lm.residual.depth_rms_norm_eps", 1e-5)
    wr.add_bool("codec.lm.residual.depth_has_in_proj", True)
    wr.add_bool("codec.lm.residual.depth_has_output_norm", True)
    wr.add_bool("codec.lm.residual.depth_use_rope", True)
    wr.add_string("codec.lm.residual.c0_input_modality", "audio")

    def add(name, a):
        wr.add_tensor(name, a, "F16")

    add("lm.c0_head.weight", w(vocab, h, scale=3.0 / math.sqrt(h)))
    add("lm.depth.in_proj.weight", w(dh, h))
    add("lm.depth.output_norm.weight", w(dh, scale=0.02, off=1.0))
    for i in range(n_cb):
        add(f"lm.audio_embd_{i}.weight", w(vocab, h, scale=0.5))
    for i in range(n_cb - 1):
        add(f"lm.depth.heads_{i}.weight", w(vocab, dh, scale=3.0 / math.sqrt(dh)))
    for li in range(dcfg.layers):
        p = f"lm.depth.blk_{li}"
        add(f"{p}.attn_norm.weight", w(dh, scale=0.02, off=1.0))
        add(f"{p}.q.weight", w(qd, dh))
        add(f"{p}.k.weight", w(kvd, dh))
        add(f"{p}.v.weight", w(kvd, dh))
        add(f"{p}.o.weight", w(dh, qd))
        add(f"{p}.ffn_norm.weight", w(dh, scale=0.02, off=1.0))
        add(f"{p}.ffn_gate.weight", w(dcfg.ffn, dh))
        add(f"{p}.ffn_up.weight", w(dcfg.ffn, dh))
        add(f"{p}.ffn_down.weight", w(dh, dcfg.ffn))


def write_random_csm_gguf(path: Union[str, Path], seed: int = 0,
                          mimi_cfg: MimiConfig = MimiConfig(),
                          num_filters: int = 64,
                          dcfg: DepthConfig = DepthConfig(),
                          eos_code_c0: int = -1,
                          delay_pattern: Optional[Sequence[int]] = None,
                          encoder: bool = False) -> Path:
    """A CSM-style codec GGUF: the random Mimi of models/mimi_init.py
    (arch "mimi", F32; with its encoder half when `encoder`) with a random
    residual_depth_ar adaptor (F16) beside it. `eos_code_c0` (default
    unset: no EOS) and `delay_pattern` (default all 0) set the adaptor's
    frame-stop and delay metadata."""
    wr = GGUFWriter(path, "mimi")
    wr.add_name("CSM")
    add_random_mimi(wr, seed, mimi_cfg, num_filters, encoder=encoder)
    add_random_depth_adaptor(wr, seed + 1, dcfg, eos_code_c0, delay_pattern)
    wr.write()
    return Path(path)

