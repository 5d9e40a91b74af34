#!/usr/bin/env python3
"""Smoke run of codec_tpu_torch on one NVIDIA GPU (H100): the quickest proof
that the port builds, is right, and decodes on the card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. require CUDA; print the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from codec_tpu_torch/csrc (nvcc, one process
     per source); the packed products' ptxas stack frames and spills and
     their SASS I2F counts (cuobjdump), all of which must be 0; the DAC
     residual units' and SNAC's unit's (its depthwise pass and its 1x1)
     stack frames and spills (0), and HGMMA (wgmma) but no HMMA
     (mma.sync) in every bf16 and f16 product; the split-f32 kernels' stack frames
     and spills (0), HMMA (mma.sync) and no HGMMA in the attention, HGMMA
     and no HMMA in the RVQ search; the RVQ search's cluster occupancy
  3. each kernel against its plain PyTorch version on the card, in f32,
     bf16 and f16 where it takes them (the attention also with carried
     keys, at the streaming steps' shapes, and at MOSS's four stages
     against the banded plain version, and at MOSS's first stage at 200 s
     of stereo (Tq 1 200 000, 75 000 query tiles, f32 and bf16); the
     residual units also at
     every DAC and SNAC decoder and encoder block's shape (f16: the
     decoder blocks, where its requests run it), unit by unit in the
     launches a request makes, each launch settled (synchronized) before
     the next so that a fault is charged to the launch that made it, the
     RVQ search also on integer-valued inputs and duplicated rows, where
     it must agree bit for bit; at WavTokenizer's V 4096 also with each
     block's second row tile a copy of its first)
  4. Mimi: write a full-width random Mimi GGUF, load it with load_model,
     and decode requests through it (20 s b1, 60 s b1, 20 s b4 in f32,
     20 s b1 in bf16 and in f16) with every launch count set to 0 just
     before and read just after; the f32 outputs are held against the
     same weights with the plain attention on the card, the f16 one
     against the plain path in f16 on the card
  5. DAC: the same for a full-width random DAC (descript/dac_24khz widths):
     20 s b1 and 20 s b4 in f32, 20 s b1 in bf16 and f16, and one
     decode_latent; the f32 outputs are held against the same weights
     with the plain residual units on the card, the f16 one as in 4
  6. SNAC: the same for a full-width random SNAC (hubertsiuzdak/snac_24khz
     widths, Orpheus packing): 20 s b1 and 20 s b4 in f32, 20 s b1 in
     bf16 and f16, each checked for its launch count, shape, finite
     samples and (f32) saturation and held against the plain residual
     units (f16 as in 4)
  7. encode: the same random Mimi, DAC and SNAC files hold their encoders;
     encode requests through load_model(...).encode (Mimi 20 s b1 and b4
     in f32, 20 s b1 in bf16; DAC and SNAC 20 s b1 in f32 and bf16), each
     with every launch count set to 0 just before and read just after
     (exact counts), checked for shape and range, the f32 codes held
     against the plain path on the card (plain attention, plain RVQ,
     plain residual units) under the near-tie rule, and one encode →
     decode round trip per arch
  8. Mimi streaming sessions on the same random Mimi: decode 20 s b1 f32 in
     pushes of 1 and 5 frames, 20 s b4 f32 and b1 bf16 in pushes of 1, and
     60 s b1 f32 in pushes of 5 (past the 250-frame window); encode 20 s b1
     f32 in pushes of 1 and 5 hops; every push's launches checked exactly
     (decode 8 flash_sdpa_window with carried keys, encode 8 + 2
     rvq_encode_fused), each f32 stream held against the full decode
     (encode) on the card, the bf16 one for shape, finite samples and
     saturation; decode_many over three Mimi sequences of two lengths and
     decode_async + PendingPcm.gather over two DAC requests, each output
     held against its own decode
  8b. the iSTFT-head codecs: write full-width random WavTokenizer (with
     its encoder), Soprano and XY-Tokenizer (with its encoder) GGUFs, load
     each on the card (f32, bf16, f16) and on the CPU (f32); WavTokenizer
     decode 20 s b1 and b4 f32, b1 bf16 and f16, 200 s b4 f16 (60 000
     frames, where cuDNN's f16 depthwise conv faults), encode 20 s b1 f32 and
     bf16; Soprano decode_latent 20 s b1 f32, bf16 and f16; XY decode 20 s
     b1 f32, bf16 and f16 and 40 s b1 f32 (two decode windows), encode
     20 s b1 f32; each with
     the launch counts set to 0 just before and read just after (decodes
     none, encodes one rvq_encode_fused: WavTokenizer's a request, XY's a
     row), checked for shape, finite
     samples and saturation (codes: range), each f32 decode held against
     the same function on the CPU from the same file, each f16 decode
     against the same decode with cuDNN off, each f32 encode's
     codes against the plain search on the card (near-tie rule), one
     encode → decode round trip per encoding arch, and each request timed
  8c. the windowed-transformer codecs: write full-width random
     Qwen3-TTS-Tokenizer (with its Mimi encoder; window 72) and Pocket-Mimi
     (with its encoder) GGUFs, load each on the card (f32, bf16, f16);
     Qwen3 decode 20 s b1 f32, bf16 and f16, b4 f32, and b1 f32 with the
     window off (full causal), encode 20 s b1 f32 and bf16; Pocket
     decode_latent 20 s b1 f32, bf16 and f16, b4 f32, 60 s b1 f32,
     encode_latent 20 s b1 f32 (a ragged tail), and latent streams of 20 s
     b1 f32 in pushes of 1 and 5 frames; each with the launch counts set to
     0 just before and read just after (exactly one flash_sdpa_window per
     transformer layer: Qwen3 8 a decode, 8 + 2 rvq_encode_fused an encode;
     Pocket 2 a call and a push), each f32 output held against the same
     function with the plain attention (and the plain search) on the card,
     each f16 decode against the plain path in f16, each stream against
     decode_latent of the whole stream, and each request and push timed
  8d. the NeuCodec family: write full-width random NeuCodec (decoder
     only), DistillNeuCodec (the same decoder and the distill encoder) and
     XCodec2 (with its encoder) GGUFs, load each on the card (f32, bf16,
     f16) and on the CPU (f32); NeuCodec decode 20 s b1 and b4 f32, b1 bf16
     and f16 (the base file's encode must raise CodecError); the distill
     decode 20 s b1 f32, equal to the base file's bit for bit; distill
     encode 20 s of 16 kHz b1 f32 and bf16; XCodec2 decode 20 s b1 and b4
     f32, b1 bf16 and f16, encode 20 s b1 f32 and bf16; each with the
     launch counts set to 0 just before and read just after (none), checked
     for shape, finite samples and saturation (codes: range), each f32
     decode held against the same function on the CPU, each f16 decode
     against the f32 model on the card, each f32 encode against the CPU on
     a 4 s request run both ways (the FSQ near-tie rule), one encode →
     decode round trip an encoding arch, and each request timed
  8e. the last small codecs: write full-width random MOSS-Audio-Tokenizer
     (48 kHz stereo, with its encoder), NeMo nano codec (with its encoder),
     BlueMagpie AudioVAE (with its encoder) and Chatterbox S3T GGUFs, load
     each on the card (f32, bf16, f16) and on the CPU (f32); MOSS decode
     20 s b1 and b4 f32, b1 bf16 and f16, encode 20 s of stereo b1 f32 and
     bf16 and 20 s + 733 samples f32 (tail rows past the true length);
     NeMo decode 20 s b1 and b4 f32, b1 bf16 and f16, encode 20 s b1 f32
     and bf16; BlueMagpie decode_latent 20 s b1 and b4 f32, b1 bf16 and
     f16 (its depthwise convs at 960 000 frames without cuDNN),
     encode_latent 20 s of 16 kHz b1 f32 and bf16; S3T encode 20 s of
     16 kHz b1 and b2 f32, b1 bf16; each with the launch counts set to 0
     just before and read just after (MOSS 15 flash_sdpa_window a request,
     one a transformer layer; the others none), checked for shape, finite
     samples and saturation (codes: range), each f32 MOSS request held
     against the banded plain attention on the card, each f32 request of
     the four against the CPU on 4 s of it (S3T: all 20 s), each f16
     decode against the f32 model, one encode → decode round trip per arch
     that decodes, and each request timed; then a MOSS decode of 2250
     codes (180 s of stereo, past the 174.72 s one launch took while the
     kernel's query tiles sat on the grid's y dimension), 15 launches, its
     first 250 codes' samples held against their own 20 s decode (corr >
     0.99999: MOSS is causal in time)
  8f. Chatterbox S3Gen: write a full-width random S3Gen GGUF (a 10 s
     builtin prompt), load it on the card (f32, bf16) and on the CPU (f32);
     decode 5 s of speech tokens in f32 on the card against the CPU (corr
     > 0.99999, max abs err <= 1e-4 x peak), 20 s b1 in f32 and bf16
     (bf16 against f32, corr > 0.99), each with the launch counts set to 0
     just before and read just after (none), timed (CUDA events), and
     profiled once (device busy time, idle share, top kernels); the NSF
     phase at 20 s summed in f32 on the card and the CPU against the
     port's float64 sum
  9. CSM-style TTS: write a random CSM codec GGUF (full-width Mimi + a
     residual_depth_ar adaptor at CSM-1B's depth-decoder widths) and
     Llama-3.2-1B-shaped backbones in Q4_K and Q8_0, load each backbone
     packed on the card (the memory it adds is checked), and run three
     requests of a 16-token prompt to 25 greedy frames (Q4_K per-token
     prefill, Q4_K prefill in one bucket of 16, Q8_0 per-token) through
     run_codebook_ar and the Mimi decode, each with the launch counts set
     to 0 just before and read just after; the backbone hiddens are held
     against the plain packed product on the card, teacher-forced on the
     same inputs, and the greedy codes against the plain path's
  9b. the on-device TTS path on the same files: run_codebook_ar(
     on_device=OnDeviceSampling(chunk_frames=8)) in Q4_K and Q8_0 greedy,
     one sampled request (temperature 0.8, top-k 50) and
     run_codebook_ar_batch over 4 streams, each chunk one replay of a
     captured CUDA graph; the captured chunk against the eager chunk bit
     for bit, greedy codes against the host path's (and each batched
     stream against its single-stream run) equal or first differing at a
     near-tie, 896 packed-product launches in one replay (torch.profiler),
     per-frame and request times and a replay's idle share; one backbone
     step as a graph at m = 1, 8 and 32, packed Q4_K against F.linear on
     the dequantized weights
  10. CUDA-event times (median of >= 10 runs after warm-up), each kernel
     beside its plain version, its bound on this card and, for the
     attention and the packed products, one PyTorch call that computes
     the same function; the DAC residual unit at every decoder and
     encoder width, d = 1, 3, 9, f32 and bf16, and the chain against three
     unit launches at C96, C64 and C128 (tools/seanet_times.py); SNAC's
     four decoder blocks' three units beside their bound; device
     times of the packed products from torch.profiler, warm (one matrix
     again and again), cold (cycling over the loaded backbones' 16 layers
     of each shape) at m = 1 and 16, and
     one backbone forward's 112 products; per-request TTS times (median of 3 runs after one
     warm-up); per-request encode times (median of 10 after 2 warm-ups);
     the attention (also as device time, torch.profiler) and the RVQ search
     (norms given, as a model passes them) beside a second bound, three
     TF32 passes per f32 product at the tensor cores' TF32 rate; the
     streaming sessions' pushes (median event time, x realtime, time to
     first audio, one push's device busy time, idle share and launches
     under torch.profiler) and the attention with carried keys beside its
     plain version, SDPA with the same mask and its bound; the windowed
     codecs' attention shapes (Qwen3 H16 T250 with and without its window,
     Pocket T4000 w250, Pocket's pushes with carried keys) the same way;
     MOSS's four (T 250 w125, T 2500 w12, T 15 000 w75, T 120 000 w600)
     and its 200 s stage (T 1 200 000 w600) beside the banded plain
     version, SDPA with the band mask where that mask fits, and the bound;
     at n_q 1 the RVQ search also beside one cuBLAS product and an argmax
Then one JSON line of kernel results, the card line again, and the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
TIMED_RUNS = 10

# -- flash_sdpa_window: (B, H, T, D, window): the Mimi decoder transformer
# at 20 s b1, 60 s b1 and 20 s b4, pure causal, and D=128 with a small
# window; bounds of tests/test_attn_pallas.py (f32 atol 2e-5 rtol 1e-5,
# bf16 atol 3e-2)
# the windowed codecs' (phase 8c): Qwen3-TTS-Tokenizer's decoder at 20 s
# (16 heads, full causal and its 72-frame window) and Pocket-Mimi's 200 Hz
# transformer at 20 s (T 4000 against its 250-frame window); timed in
# phase 10 beside SDPA with the same mask and their bound
WINDOWED_ATTN_SHAPES = [(1, 16, 250, 64, None), (1, 16, 250, 64, 72),
                        (1, 8, 4000, 64, 250)]
ATTN_SHAPES_F32 = [(1, 8, 500, 64, 250), (1, 8, 1500, 64, 250),
                   (4, 8, 500, 64, 250), (1, 2, 300, 64, None),
                   (1, 2, 256, 128, 16), *WINDOWED_ATTN_SHAPES]
# MOSS-Audio-Tokenizer's four transformer stages at 20 s of 48 kHz stereo
# (phase 8e): T 250 w125, T 2500 w12 (a window below the kernel's 16-query
# block), T 15 000 w75, T 120 000 w600; heads of 64. The plain version is
# banded (the full mask at T 120 000 would need 173 GB of logits)
MOSS_ATTN_SHAPES = [(1, 12, 250, 64, 125), (1, 12, 2500, 64, 12),
                    (1, 6, 15000, 64, 75), (1, 3, 120000, 64, 600)]
# MOSS's first stage at 200 s of stereo: 1 200 000 queries, 75 000 query
# tiles of 16 (past the 65 535 a grid's y dimension takes), in f32 and bf16
MOSS_LONG_ATTN = (1, 3, 1200000, 64, 600)
ATTN_SHAPE_BF16 = (1, 8, 500, 64, 250)
ATTN_F32_TOL = dict(atol=2e-5, rtol=1e-5)
ATTN_BF16_ATOL = 3e-2
# (name, seconds of audio, batch, compute dtype)
MIMI_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                 ("60s_b1_f32", 60, 1, "float32"),
                 ("20s_b4_f32", 20, 4, "float32"),
                 ("20s_b1_bf16", 20, 1, "bfloat16"),
                 ("20s_b1_f16", 20, 1, "float16")]
MIMI_LAYERS = 8                    # flash_sdpa_window launches per decode

# -- seanet_res_unit (B, T, C, d) and seanet_res_chain (B, T, C): the DAC
# decoder's block shapes at 20 s b1, a batch of 2, and T below the halo.
# f32 bound: max abs err <= 1e-4 * max|plain| and corr > 0.99999 (the
# kernels' sin^2 series differs from torch.sin by up to 7.2e-6, and sums
# run in another order). bf16 kernels round their conv operands to bf16
# as the TPU kernels do; they are held against the plain version in f32
# on the same bf16 inputs, at the bounds of tests/test_seanet_pallas.py.
# Those bounds leave about 5 standard deviations of the rounding noise at
# outputs near 0, and a check over 46M outputs meets its 6-7 sigma tail:
# so the inputs keep the chain's output near that test's scale (std about
# 3.4): alphas |N(0, 1)| + 1 and biases N(0, 0.1) (res_params).
UNIT_SHAPES = [(1, 12000, 768, 1), (1, 12000, 768, 9), (1, 60000, 384, 3),
               (2, 1000, 384, 9), (1, 20, 96, 9)]
CHAIN_SHAPES = [(1, 240000, 192), (1, 480000, 96), (2, 100, 96), (1, 20, 192)]
# the unit's 11 tiles (f32 3, bf16 4, f16 4) x its 2 launches (dilated
# conv, 1x1) and the chain's 5 tiles (csrc/seanet_res.cu::dispatch_tile,
# dispatch_chain)
DENSE_KERNELS = 27
# the split-f32 kernels: flash_sdpa_window at D 64 / 128 x f32 / bf16 /
# f16 and rvq_encode at 32, 16 and 8 frames per cluster
SPLIT_KERNELS = 9
# SNAC's unit: the depthwise pass for K = 1, 3, 5, 7 in f32, bf16 and f16
# (csrc/snac_res.cu) and its 1x1 at its 6 tiles (csrc/seanet_res.cu)
SNAC_UNIT_KERNELS = 18
# the 16-bit dtypes the kernels take besides f32; f16 is held to bf16's
# bounds (both 16-bit operands; f16 rounds finer)
HALF_DTYPES = (torch.bfloat16, torch.float16)
UNIT_BF16 = dict(rtol=2e-2, atol=5e-2, corr=0.9999)
CHAIN_BF16 = dict(rtol=3e-2, atol=8e-2, corr=0.9995)
DILATIONS = (1, 3, 9)
DAC_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                ("20s_b4_f32", 20, 4, "float32"),
                ("20s_b1_bf16", 20, 1, "bfloat16"),
                ("20s_b1_f16", 20, 1, "float16")]

# -- snac_res_chain (B, T, C): the four SNAC decoder blocks of a 20 s b1
# decode (936 frames), a batch of 2, a T that is no multiple of 32, T below
# the halo and T = 1. Each shape runs in the form a decode launches (one
# N = 1 launch per dilation, snac_res_units) and, where its state fits, as
# the chain (N = 3). Bounds as for the DAC chain; inputs at the scales of
# tests/test_seanet_pallas.py's depthwise test (x 0.3, taps 0.2, biases
# 0.1, the 1x1 at that test's gain for any C), alphas N(1, 0.5)
SNAC_BLOCKS = [(512, 7488), (256, 59904), (128, 239616), (64, 479232)]
SNAC_SHAPES = [(1, t, c) for c, t in SNAC_BLOCKS] + [
    (2, 1000, 128), (1, 4100, 256), (1, 20, 64), (1, 1, 64)]
SNAC_REQUESTS = [("20s_b1_f32", 20, 1, "float32"),
                 ("20s_b4_f32", 20, 4, "float32"),
                 ("20s_b1_bf16", 20, 1, "bfloat16"),
                 ("20s_b1_f16", 20, 1, "float16")]

# -- q8_0_matmul / q4_k_matmul: the Llama-3.2-1B backbone's matrices
# (out, in) q/o, k/v, gate/up and down, at m = 1, 16 and 32 rows with x in
# f32 and at m = 1 in bf16. The kernel and its plain version multiply the
# same dequantized weights in f32 with sums in another order: max abs err
# <= 1e-4 * max|plain|. One-hot rows must give the dequantized weights bit
# for bit.
QMAT_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
QMAT_MS = (1, 16, 32)
QMAT_MAIN = (8192, 2048)                # gate/up, the kernels' line shape
SHAPE_NAMES = {(2048, 2048): "q/o", (512, 2048): "k/v", (8192, 2048): "gate/up",
               (2048, 8192): "down"}
FORWARD_ORDER = ("q", "k", "v", "o", "gate", "up", "down")
L2_BYTES = 50 * 2 ** 20
FLUSH_BYTES = 64 * 2 ** 20
# -- the CSM TTS path: (name, backbone qtype, prefill bucket); each request
# is a 16-token prompt (ids from SEED) to 25 greedy frames (2 s at 12.5 Hz)
TTS_REQUESTS = [("q4_k_per_token", "Q4_K", 0), ("q4_k_bucket16", "Q4_K", 16),
                ("q8_0_per_token", "Q8_0", 0)]
TTS_PROMPT, TTS_FRAMES, TTS_TIMED_RUNS = 16, 25, 3
# -- the on-device TTS path: chunks of 8 frames (one CUDA graph each),
# greedy in Q4_K and Q8_0, one sampled request, one batch of 4 streams;
# greedy codes equal the host path's or first differ at a near-tie (top-2
# logit margin < NEAR_TIE of the top logit)
TTS_CHUNK, TTS_STREAMS = 8, 4
TTS_SAMPLED = dict(temperature=0.8, top_k=50)
Q4K_LOAD_LIMIT = 2.5e9                  # bytes a Q4_K backbone load may add

# -- rvq_encode_fused (B, T, D, n_q, V): Mimi at 20 s b1 (acoustic and
# semantic) and b4, the unaligned shapes of tests/test_rvq_pallas.py, the
# streaming encode's pushes (1 frame: semantic and acoustic; 5 frames), and
# V = 5 with frames near 0 (rows past V are never chosen). Integer-valued
# inputs (exact in f32, with many exact ties), with or without duplicated
# rows (the lower copy must win), must give the plain version's codes bit
# for bit; normal inputs equal codes, or each differing frame's first
# differing level an f64 near-tie (relative distance margin < 1e-4) in at
# most max(2, N/100) frames.
# The iSTFT-head codecs' searches at 20 s b1: WavTokenizer (one 4096 x 512
# codebook: each of a cluster's 8 blocks scores two 256-row tiles a level)
# and XY-Tokenizer (8 x 1024 x 512); the WavTokenizer shape also with
# "seam" inputs (each block's second tile a copy of its first: the lower
# copy must win across the tile seam, bit for bit)
RVQ_ISTFT_SHAPES = [(1, 1500, 512, 1, 4096), (1, 250, 512, 8, 1024)]
# Qwen3-TTS-Tokenizer's encode at 20 s b1: its Mimi encoder's acoustic
# search (15 levels; the semantic one is Mimi's N250 n_q1 shape)
RVQ_QWEN3 = (1, 250, 256, 15, 2048)
RVQ_SHAPES = [(1, 250, 256, 31, 2048), (1, 250, 256, 1, 2048),
              (4, 250, 256, 31, 2048), (1, 7, 32, 4, 64), (1, 130, 96, 3, 100),
              (1, 250, 512, 4, 2048), *RVQ_ISTFT_SHAPES, RVQ_QWEN3,
              (1, 1, 256, 1, 2048),
              (1, 1, 256, 31, 2048), (1, 5, 256, 31, 2048)]
RVQ_MAIN = (1, 250, 256, 31, 2048)      # the kernels line's shape
NEAR_TIE = 1e-4
# the residual-unit blocks at 20 s b1: the DAC decoder's and encoder's
# (C, T) and SNAC's encoder's (C, T) after its pad to 2048
DAC_DEC_BLOCKS = [(768, 12000), (384, 60000), (192, 240000), (96, 480000)]
DAC_ENC_BLOCKS = [(64, 480000), (128, 240000), (256, 60000), (512, 12000)]
SNAC_ENC_BLOCKS = [(48, 481280), (96, 240640), (192, 60160), (384, 7520)]
# (arch, name, seconds of audio, batch, compute dtype)
ENCODE_REQUESTS = [("mimi", "20s_b1_f32", 20, 1, "float32"),
                   ("mimi", "20s_b4_f32", 20, 4, "float32"),
                   ("mimi", "20s_b1_bf16", 20, 1, "bfloat16"),
                   ("dac", "20s_b1_f32", 20, 1, "float32"),
                   ("dac", "20s_b1_bf16", 20, 1, "bfloat16"),
                   ("snac", "20s_b1_f32", 20, 1, "float32"),
                   ("snac", "20s_b1_bf16", 20, 1, "bfloat16")]
# -- the Mimi streaming sessions on the same random Mimi: (name, seconds of
# audio, batch, compute dtype, frames a push). 60 s is 1500 transformer
# frames, past the 250-frame window: the KV carry rolls. Each f32 stream is
# held against the full decode (encode) of the same codes (PCM) on the card
STREAM_DECODES = [("20s_b1_f32_c1", 20, 1, "float32", 1),
                  ("20s_b1_f32_c5", 20, 1, "float32", 5),
                  ("20s_b4_f32_c1", 20, 4, "float32", 1),
                  ("20s_b1_bf16_c1", 20, 1, "bfloat16", 1),
                  ("60s_b1_f32_c5", 60, 1, "float32", 5)]
STREAM_ENCODES = [("20s_b1_f32_c1", 20, 1, "float32", 1),
                  ("20s_b1_f32_c5", 20, 1, "float32", 5)]
# the decode streams whose steps are timed (events, profiler), and how many
STREAM_TIMED = ("20s_b1_f32_c1", "20s_b1_f32_c5", "20s_b4_f32_c1",
                "20s_b1_bf16_c1")
STREAM_TIMED_STEPS = 30
# flash_sdpa_window with carried keys, (B, H, Tq, Tk, D, window, k_start):
# a 1-frame step (2 queries against 249 carried keys and their own) at
# stream start (k_start 249: every carried slot masked) and past it
# (k_start 0), a 5-frame step and the b4 step
# and Pocket-Mimi's pushes of 1 and 5 latent frames (16 and 80 queries at
# 200 Hz against 249 carried keys; the 1-frame push also at stream start)
STREAM_ATTN_SHAPES = [(1, 8, 2, 251, 64, 250, 0), (1, 8, 2, 251, 64, 250, 249),
                      (1, 8, 10, 259, 64, 250, 0), (4, 8, 2, 251, 64, 250, 0),
                      (1, 8, 16, 265, 64, 250, 0), (1, 8, 16, 265, 64, 250, 249),
                      (1, 8, 80, 329, 64, 250, 0)]
STREAM_ATTN_MAIN = (1, 8, 2, 251, 64, 250, 0)   # the kernels line's shape
# -- the iSTFT-head codecs at full width (phase 8b): (arch, name, seconds,
# batch, compute dtype); each decode launches none of the port's kernels,
# each encode one rvq_encode_fused (WavTokenizer's a request, XY's a row,
# as codec_tpu encodes it row by row). The 40 s XY decode crosses a
# decode window (375 codes, the post-RVQ positional rows); the 200 s b4
# f16 decode runs its ConvNeXt depthwise convs at 60 000 frames, where
# cuDNN's f16 kernel (which blocks.depthwise_conv goes around) faults
ISTFT_DECODES = [("wavtokenizer", "20s_b1_f32", 20, 1, "float32"),
                 ("wavtokenizer", "20s_b4_f32", 20, 4, "float32"),
                 ("wavtokenizer", "20s_b1_bf16", 20, 1, "bfloat16"),
                 ("wavtokenizer", "20s_b1_f16", 20, 1, "float16"),
                 ("wavtokenizer", "200s_b4_f16", 200, 4, "float16"),
                 ("soprano", "20s_b1_f32", 20, 1, "float32"),
                 ("soprano", "20s_b1_bf16", 20, 1, "bfloat16"),
                 ("soprano", "20s_b1_f16", 20, 1, "float16"),
                 ("xy_tokenizer", "20s_b1_f32", 20, 1, "float32"),
                 ("xy_tokenizer", "20s_b1_bf16", 20, 1, "bfloat16"),
                 ("xy_tokenizer", "20s_b1_f16", 20, 1, "float16"),
                 ("xy_tokenizer", "40s_b1_f32", 40, 1, "float32")]
# f16 20 s decodes: alternating pairs of the request as it runs (its
# ConvNeXt depthwise convs around cuDNN) and with them on cuDNN (each side
# a median of TIMED_RUNS)
F16_DW_PAIRS = 6
ISTFT_ENCODES = [("wavtokenizer", "20s_b1_f32", 20, 1, "float32"),
                 ("wavtokenizer", "20s_b1_bf16", 20, 1, "bfloat16"),
                 ("xy_tokenizer", "20s_b1_f32", 20, 1, "float32")]
# -- the windowed-transformer codecs at full width (phase 8c): (arch, name,
# seconds, batch, compute dtype). Qwen3-TTS-Tokenizer's decoder transformer
# runs at 12.5 Hz over a 72-frame window (one more decode with the window
# off: full causal attention); Pocket-Mimi's at 200 Hz (T 4000 a 20 s
# request, 12000 at 60 s) over its 250-frame window. Each layer launches
# flash_sdpa_window: Qwen3 8 a decode, 8 + 2 rvq_encode_fused an encode;
# Pocket 2 a decode_latent, encode_latent and push
Q3T_WINDOW = 72
WINDOWED_DECODES = [("qwen3", "20s_b1_f32", 20, 1, "float32"),
                    ("qwen3", "20s_b1_bf16", 20, 1, "bfloat16"),
                    ("qwen3", "20s_b1_f16", 20, 1, "float16"),
                    ("qwen3", "20s_b4_f32", 20, 4, "float32"),
                    ("pocket", "20s_b1_f32", 20, 1, "float32"),
                    ("pocket", "20s_b1_bf16", 20, 1, "bfloat16"),
                    ("pocket", "20s_b1_f16", 20, 1, "float16"),
                    ("pocket", "20s_b4_f32", 20, 4, "float32"),
                    ("pocket", "60s_b1_f32", 60, 1, "float32")]
WINDOWED_ENCODES = [("qwen3", "20s_b1_f32", 20, 1, "float32"),
                    ("qwen3", "20s_b1_bf16", 20, 1, "bfloat16"),
                    ("pocket", "20s_b1_f32", 20, 1, "float32")]
# samples past 20 s in the Pocket encode: a ragged tail, its valid-length path
POCKET_TAIL = 733
# Pocket-Mimi's latent streams (the Pocket-TTS vocoder): (name, seconds,
# batch, compute dtype, latent frames a push)
POCKET_STREAMS = [("20s_b1_f32_c1", 20, 1, "float32", 1),
                  ("20s_b1_f32_c5", 20, 1, "float32", 5)]
# -- the NeuCodec family at full width (phase 8d): (arch, name, seconds,
# batch, compute dtype). NeuCodec decodes 50 codes a second to 24 kHz,
# XCodec2 to 16 kHz; DistillNeuCodec and XCodec2 encode 16 kHz PCM. None
# of these requests launches a kernel of the port (their attentions are
# non-causal, biased or relative-key: the plain sdpa). The distill file's
# decoder is the base file's (one seed): its decode must be the base's bit
# for bit
NEU_DECODES = [("neucodec", "20s_b1_f32", 20, 1, "float32"),
               ("neucodec", "20s_b4_f32", 20, 4, "float32"),
               ("neucodec", "20s_b1_bf16", 20, 1, "bfloat16"),
               ("neucodec", "20s_b1_f16", 20, 1, "float16"),
               ("distill_neucodec", "20s_b1_f32", 20, 1, "float32"),
               ("xcodec2", "20s_b1_f32", 20, 1, "float32"),
               ("xcodec2", "20s_b4_f32", 20, 4, "float32"),
               ("xcodec2", "20s_b1_bf16", 20, 1, "bfloat16"),
               ("xcodec2", "20s_b1_f16", 20, 1, "float16")]
NEU_ENCODES = [("distill_neucodec", "20s_b1_f32", 20, 1, "float32"),
               ("distill_neucodec", "20s_b1_bf16", 20, 1, "bfloat16"),
               ("xcodec2", "20s_b1_f32", 20, 1, "float32"),
               ("xcodec2", "20s_b1_bf16", 20, 1, "bfloat16")]
# an f32 encode is held against the CPU on a request of this length, run
# both ways (the 20 s encodes' CPU runs would take tens of seconds each)
NEU_CPU_ENCODE_SECONDS = 4

# -- the last small codecs at full width (phase 8e): (arch, kind, name,
# seconds, batch, compute dtype, samples past the seconds). MOSS decodes
# codes to 48 kHz stereo and encodes stereo PCM (one stream a call), each
# transformer layer one flash_sdpa_window launch: 2 + 4 + 6 + 3 = 15 a
# decode, 3 + 6 + 4 + 2 = 15 an encode (the 733 samples past 20 s give
# tail rows, which run on the masked sdpa after the kernel). NeMo decodes
# codes and encodes PCM at 22.05 kHz, BlueMagpie decodes latents to 48 kHz
# and encodes 16 kHz PCM, S3T encodes 16 kHz PCM: no kernel of the port
SMALL_REQUESTS = [
    ("moss", "decode", "20s_b1_f32", 20, 1, "float32", 0),
    ("moss", "decode", "20s_b4_f32", 20, 4, "float32", 0),
    ("moss", "decode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("moss", "decode", "20s_b1_f16", 20, 1, "float16", 0),
    ("moss", "encode", "20s_b1_f32", 20, 1, "float32", 0),
    ("moss", "encode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("moss", "encode", "20s+733_b1_f32", 20, 1, "float32", 733),
    ("nemo", "decode", "20s_b1_f32", 20, 1, "float32", 0),
    ("nemo", "decode", "20s_b4_f32", 20, 4, "float32", 0),
    ("nemo", "decode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("nemo", "decode", "20s_b1_f16", 20, 1, "float16", 0),
    ("nemo", "encode", "20s_b1_f32", 20, 1, "float32", 0),
    ("nemo", "encode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("bluemagpie", "decode", "20s_b1_f32", 20, 1, "float32", 0),
    ("bluemagpie", "decode", "20s_b4_f32", 20, 4, "float32", 0),
    ("bluemagpie", "decode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("bluemagpie", "decode", "20s_b1_f16", 20, 1, "float16", 0),
    ("bluemagpie", "encode", "20s_b1_f32", 20, 1, "float32", 0),
    ("bluemagpie", "encode", "20s_b1_bf16", 20, 1, "bfloat16", 0),
    ("s3t", "encode", "20s_b1_f32", 20, 1, "float32", 0),
    ("s3t", "encode", "20s_b2_f32", 20, 2, "float32", 0),
    ("s3t", "encode", "20s_b1_bf16", 20, 1, "bfloat16", 0)]
MOSS_LAYERS = 15                 # flash_sdpa_window launches a request
# a MOSS decode past 174.72 s of stereo: 2250 codes (180 s), its first 250
# codes (20 s) held against their own decode
MOSS_LONG_CODES, MOSS_PREFIX_CODES = 2250, 250
# -- Chatterbox S3Gen at full width (phase 8f): seconds of speech tokens
# after the builtin 10 s prompt. The f32 decode of S3G_CPU_SECONDS is held
# against the CPU at corr > 0.99999 and max abs err <= 1e-4 x peak (the
# NSF phase is summed in float64 on both, so the two f32 runs differ by
# sums taken in other orders); bf16 against f32 at corr > 0.99 (a bf16
# CFM through 10 Euler steps, its f0 and so its NSF phase in bf16)
S3G_SECONDS, S3G_CPU_SECONDS = 20, 5
S3G_F32_GATE = (0.99999, 1e-4)
S3G_BF16_CORR = 0.99
# a complete profiler trace of a 20 s S3G request holds at least this many
# kernel launches (18 559 in f32, 21 530 in bf16 on the H100)
S3G_LEAST_LAUNCHES = 15000
# f32 requests are held against the CPU on this many seconds of the same
# input (MOSS, NeMo and BlueMagpie: the 20 s CPU runs would take tens of
# seconds); S3T's CPU encode takes the whole 20 s in about a second
SMALL_CPU_SECONDS = {"moss": 4, "nemo": 4, "bluemagpie": 4, "s3t": 20}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier in a mangled name: an Itanium name is
    prefixed by its length, which may follow a hash's digits."""
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for j in range(len(run)):
            ident = mangled[m.end(): m.end() + int(run[j:])]
            if len(ident) == int(run[j:]) and ident.endswith("_kernel") \
                    and re.fullmatch(r"[A-Za-z_]\w*", ident):
                return ident
    return mangled[:60]


def ptxas_report(nvcc_log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: the
    kernel, its type and tile, its registers and any spills."""
    out, name, spill = [], None, ""
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            tile = re.search(r"(FmaTile|MmaTile|Fma|Wg)I((?:Li\d+E)+)", mangled)
            rows = re.search(r"matmul_kernelI(?:Lb(\d)E)?Li(\d+)E", mangled)
            name = " ".join(filter(None, [
                kernel_name(mangled),
                "bf16" if "bfloat16" in mangled else
                "f16" if "6__half" in mangled else "f32",
                tile and f"{tile.group(1)}<"
                f"{','.join(re.findall(r'Li(\d+)E', tile.group(2)))}>",
                rows and f"m<={rows.group(2)}",
                rows and rows.group(1) == "0" and "cp.async"]))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (f", spills {m.group(1)}/{m.group(2)} bytes"
                     if m.group(1) != "0" or m.group(2) != "0" else "")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers{spill}")
            name, spill = None, ""
    return out


def cuda_ms(fn, reps: int = 1, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    """Median over `runs` CUDA-event samples of one call of fn (each sample
    averages `reps` back-to-back calls), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def settled(what: str, out=None):
    """Wait for the card and charge a fault to `what`, the launch just made
    (a kernel's fault shows only at the next synchronize); → out."""
    try:
        torch.cuda.synchronize()
    except Exception as e:                              # noqa: BLE001
        raise RuntimeError(f"{what}: the card reported {type(e).__name__}: "
                           f"{e}") from e
    return out


def turns(kernel, plain, reps: int = 1, runs: int = TIMED_RUNS):
    """Kernel and plain times in turns (plain, kernel, kernel, plain), each
    a median of `runs`: the best of each pair and the four samples."""
    p1 = cuda_ms(plain, reps, runs)
    k1 = cuda_ms(kernel, reps, runs)
    k2 = cuda_ms(kernel, reps, runs)
    p2 = cuda_ms(plain, reps, runs)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def randn(shape, dtype, seed, scale=1.0):
    """N(0, scale²) on the card from `seed`: drawn by NumPy, or past 1e8
    values (MOSS's 200 s stage) by torch's generator on the card, where
    NumPy would take seconds."""
    if math.prod(shape) > 10 ** 8:
        g = torch.Generator("cuda").manual_seed(seed)
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            dtype)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to("cuda", dtype)


def corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1])


def attn_work(b, h, t, d, w, dtype):
    """flash_sdpa_window's FLOP (QK and PV over the visible band) and bytes
    (q, k, v read and out written once)."""
    pairs = sum(min(i + 1, w or t) for i in range(t))
    return [(4 * d * pairs * b * h, dtype)], 4 * b * h * t * d * dtype.itemsize


def stream_attn_work(b, h, tq, tk, d, w, k_start, dtype):
    """flash_sdpa_window with carried keys: its FLOP (QK and PV over the
    pairs this call's mask leaves visible: query i at key Tk - Tq + i sees
    max(k_start, that - w + 1) .. that) and bytes (q, k, v read and out
    written once)."""
    pairs = sum(tk - tq + i - max(k_start, tk - tq + i - w + 1) + 1
                for i in range(tq))
    return ([(4 * d * pairs * b * h, dtype)],
            2 * b * h * (tq + tk) * d * dtype.itemsize)


def stream_mask(tq, tk, w, k_start):
    """The boolean mask of that attention for F.scaled_dot_product_attention
    (True: visible)."""
    qp = tk - tq + torch.arange(tq, device="cuda")[:, None]
    kj = torch.arange(tk, device="cuda")[None, :]
    return (kj <= qp) & (kj > qp - w) & (kj >= k_start)


def qmat_work(out_d, in_d, m, packed):
    """A packed product's FLOP (f32 FMAs) and bytes: the packed weights
    (quants, scales, mins), x read and y written once."""
    wbytes = sum(t.numel() * t.element_size() for t in packed.values())
    return [(2 * m * in_d * out_d, torch.float32)], wbytes + 4 * m * (in_d + out_d)


def rvq_work(n, d, n_q, v):
    """The RVQ search's operations (f32 FMAs: 2·N·V·D·n_q; the row lookup is
    a gather) and bytes (x, the codebooks and their norms read once, the
    codes written once)."""
    return ([(2 * n * v * d * n_q, torch.float32)],
            4 * (n * d + n_q * v * d + n_q * v + n * n_q))


def rvq_inputs(b, t, d, n_q, v, kind, seed):
    """x [b, t, d], codebooks [n_q, v, d] f32 on the card: "int" small
    integers (every product and sum exact in f32, many exact ties); "dup"
    the same with row v + V/2 a copy of row v; "normal" N(0, 1) frames,
    N(0, 0.5) codebooks; "tiny" normal frames near 0; "seam" integers with
    each block's second 256-row tile (rows per + 256 ..., per = V/8 rows a
    block) a copy of its first."""
    rng = np.random.default_rng(seed)
    if kind in ("int", "dup", "seam"):
        x, cb = rng.integers(-3, 4, (b, t, d)), rng.integers(-3, 4, (n_q, v, d))
        if kind == "dup":
            cb[:, v // 2: 2 * (v // 2)] = cb[:, : v // 2]
        for blk in range(0, v, -(-v // 8)) if kind == "seam" else ():
            cb[:, blk + 256: blk + 512] = cb[:, blk: blk + 256]
    else:
        x = rng.standard_normal((b, t, d)) * (1e-3 if kind == "tiny" else 1.0)
        cb = rng.standard_normal((n_q, v, d)) * 0.5
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(cb.astype(np.float32)).cuda())


def rel_margin(d, got_v, want_v):
    return float((d[got_v] - d[want_v]) / max(d[want_v], 1e-12))


def euclid_margin(r, cb, prefix, got_v, want_v):
    """f64: r [D] minus cb[lvl][c] for each prefix code, then the relative
    distance margin of got's pick over want's at the next level."""
    for lvl, c in enumerate(prefix):
        r = r - cb[lvl][c]
    return rel_margin(((r[None] - cb[len(prefix)]) ** 2).sum(-1), got_v,
                      want_v)


def cosine_margin(z, cb, got_v, want_v):
    zn = z / max(np.linalg.norm(z), 1e-12)
    cbn = cb / np.maximum(np.linalg.norm(cb, axis=1, keepdims=True), 1e-12)
    return rel_margin(((zn[None] - cbn) ** 2).sum(-1), got_v, want_v)


def near_ties(got, want, margin_fn):
    """got, want [T, Q]: equal codes, or at most max(2, T/100) differing
    frames, each first differing level an f64 near-tie. Returns the
    differing frames' (frame, level, margin); raises otherwise."""
    diff = got != want
    frames = np.where(diff.any(axis=1))[0]
    if len(frames) > max(2, want.shape[0] // 100):
        raise RuntimeError(f"{len(frames)}/{want.shape[0]} frames differ")
    out = []
    for fr in frames:
        q = int(diff[fr].argmax())
        m = margin_fn(int(fr), q)
        if not abs(m) < NEAR_TIE:
            raise RuntimeError(f"frame {fr} level {q}: codes differ with "
                               f"relative margin {m:.3e}")
        out.append((int(fr), q, m))
    return out


def mimi_margin(p, mcfg, lat, want, got):
    """margin_fn (near_ties) of one row of a Mimi encoder's codes: lat
    [T, hidden] f64, the latent before the semantic and acoustic input
    projections; p and mcfg the encoder's parameters and config."""
    groups = [(f64(p["sem_ip"]), f64(p["cb_sem"]), 0),
              (f64(p["acu_ip"]), f64(p["cb_acu"]), mcfg.n_sem)]

    def margin(fr, q):
        ip, cb, base = groups[q >= mcfg.n_sem]
        return euclid_margin(lat[fr] @ ip.T, cb, want[fr, base:q],
                             got[fr, q], want[fr, q])
    return margin


def stream(session, x, chunk, want_step, axis, counts, push_s=None):
    """Pushes x in chunks along axis, each push's launches read from
    counts() and checked against want_step → (the concatenated outputs,
    the launches read, summed over the pushes). With a list push_s, each
    push's host seconds are appended to it."""
    outs, read = [], dict.fromkeys(want_step, 0)
    for lo in range(0, x.shape[axis], chunk):
        part = np.take(x, range(lo, min(lo + chunk, x.shape[axis])), axis=axis)
        before = counts()
        t0 = time.perf_counter()
        outs.append(session.push(part))
        if push_s is not None:
            push_s.append(time.perf_counter() - t0)
        step = {k: v - before[k] for k, v in counts().items()}
        if step != want_step:
            raise RuntimeError(f"stream step at {lo}: launches {step}, "
                               f"want {want_step}")
        read = {k: read[k] + v for k, v in step.items()}
    return np.concatenate(outs, axis=axis), read


def f64(t):
    return t.detach().double().cpu().numpy()


def device_ms(fn, n: int = 50, tries: int = 3):
    """Device time per call of fn: the kernels' self time under
    torch.profiler over n warm calls (aten ops left out), / n. The card's
    machine's profiler now and then returns a trace that lost device
    events: one with fewer kernel launches than calls is taken again; None
    when `tries` traces in a row were short."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and not e.key.startswith("aten::")]
        if sum(e.count for e in kern) >= n:
            return sum(e.self_device_time_total for e in kern) / 1e3 / n
    return None


def profiled_ms(fn, calls: int, keep, tries: int = 5, launches: int = 0):
    """Device time per call: fn runs once to warm up, then once under
    torch.profiler; the self time of the kernels whose name `keep` accepts
    (aten ops left out), / calls. The card's machine's profiler now and then
    returns a trace that lost device events: one with fewer such kernels
    than `launches` (default: calls) is taken again; None ("not measured")
    when `tries` traces in a row were short."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and not e.key.startswith("aten::") and keep(e.key)]
        if sum(e.count for e in kern) >= (launches or calls):
            return sum(e.self_device_time_total for e in kern) / 1e3 / calls
    return None


def profiled_step(fn, tries: int = 5):
    """One call of fn under torch.profiler → (the kernels' and copies'
    device time in ms, kernel launches, copies and fills): the device
    events of the trace, aten ops left out. Retried like profiled_ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and not e.key.startswith("aten::")]
        if dev:
            busy = sum(e.self_device_time_total for e in dev) / 1e3
            copies = sum(e.count for e in dev
                         if e.key.startswith(("Memcpy", "Memset")))
            return busy, sum(e.count for e in dev) - copies, copies
    raise RuntimeError(f"torch.profiler reported no device time in {tries} runs")


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def istft_codecs(name_limit: str, zero_counts, counts, none: dict) -> dict:
    """Phase 8b: write full-width random WavTokenizer (with its encoder),
    Soprano and XY-Tokenizer (with its encoder) GGUFs, load each with
    load_model on the card in f32, bf16 and f16 and on the CPU in f32, and run
    ISTFT_DECODES and ISTFT_ENCODES with every launch count set to 0 just
    before each request and read just after (decodes: none of the port's
    kernels; encodes: one rvq_encode_fused, WavTokenizer's a request,
    XY's a row). Each output is checked
    for shape, finite samples (codes: range) and saturation; each f32
    decode against the same port function on the CPU from the same file
    (corr > 0.99999, max abs err <= 1e-4 x peak); each f16 decode against
    the plain f16 path, the same decode with cuDNN off (PyTorch's own conv
    kernels; phases 4-6's f16 bound, corr > 0.9995) and against the f32
    model on the card (corr > 0.9999), and (20 s) timed in alternating
    pairs against the same with its depthwise convs on cuDNN; each f32
    encode's codes
    against the plain RVQ search on the card (the near-tie rule); one
    encode → decode round trip an encoding arch. Each request's median
    time (CUDA events). → this phase's launch counts."""
    import codec_tpu_torch
    from codec_tpu_torch.dsp.audio import whisper_mel_padded
    from codec_tpu_torch.models import wavtokenizer as wt
    from codec_tpu_torch.ops import blocks
    from codec_tpu_torch.models import xy_tokenizer as xy
    from codec_tpu_torch.models.soprano_init import write_random_soprano_gguf
    from codec_tpu_torch.models.wavtokenizer_init import write_random_wt_gguf
    from codec_tpu_torch.models.xy_init import write_random_xy_gguf
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_istft_") as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf"
                 for a in ("wavtokenizer", "soprano", "xy_tokenizer")}
        t0 = time.monotonic()
        write_random_wt_gguf(paths["wavtokenizer"], seed=SEED, encoder=True)
        write_random_soprano_gguf(paths["soprano"], seed=SEED)
        write_random_xy_gguf(paths["xy_tokenizer"], seed=SEED, encoder=True)
        log("[istft] wrote " + ", ".join(
            f"{p.name} ({p.stat().st_size / 2**20:.1f} MiB)"
            for p in paths.values()) + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        for arch, path in paths.items():
            for dev, dt in (("cuda", "float32"), ("cuda", "bfloat16"),
                            ("cuda", "float16"), ("cpu", "float32")):
                models[arch, dev, dt] = codec_tpu_torch.load_model(
                    path, compute_dtype=dt, device=dev)
        torch.cuda.synchronize()
    log(f"[istft] load_model x3 archs, card f32 + bf16 + f16 and CPU f32, in "
        f"{time.monotonic() - t0:.2f} s")
    wcfg = models["wavtokenizer", "cuda", "float32"].cfg
    scfg = models["soprano", "cuda", "float32"].cfg
    xm = models["xy_tokenizer", "cuda", "float32"]
    log(f"[istft] WavTokenizer: {wcfg}; Soprano: {scfg}; XY-Tokenizer: "
        f"{xm.cfg}, decode window {xm.chunk_codes} codes; parameters "
        + ", ".join(f"{a} {sum(t.numel() for t in _tensors(models[a, 'cpu', 'float32'].params)) / 1e6:.1f} M"
                    for a in paths))

    rng = np.random.default_rng(SEED + 300)

    def request(arch, secs, batch):
        """The inputs of one decode request and the samples it gives."""
        m = models[arch, "cuda", "float32"]
        if arch == "soprano":
            frames = secs * m.sample_rate // (m.hop_size * scfg.upscale) + 1
            z = rng.standard_normal((batch, frames, m.latent_dim)).astype(
                np.float32)
            return z, scfg.upscale * (frames - 1) * m.hop_size
        frames = secs * m.sample_rate // m.hop_size
        codes = rng.integers(0, m.codebook_size, (batch, frames, m.n_q)
                             ).astype(np.int32)
        n = frames * m.hop_size
        if arch == "xy_tokenizer":
            n += m.cfg.vocos_hop * -(-frames // m.chunk_codes)
        return codes, n

    def decode(model, x):
        return (model.decode_latent(x) if model.arch == "soprano"
                else model.decode(x))

    phase_counts = dict(none)
    for arch, name, secs, batch, dt in ISTFT_DECODES:
        model = models[arch, "cuda", dt]
        x, n = request(arch, secs, batch)
        zero_counts()
        pcm = decode(model, x)
        if counts() != none:
            raise RuntimeError(f"{arch} decode {name}: launches {counts()}, "
                               f"want none")
        if pcm.shape != (batch, n) or pcm.dtype != np.float32:
            raise RuntimeError(f"{arch} decode {name}: pcm {pcm.shape} "
                               f"{pcm.dtype}, want {(batch, n)} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"{arch} decode {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        if not sat < 0.01:
            raise RuntimeError(f"{arch} decode {name}: {sat:.2%} of samples "
                               f"saturated")
        line = (f"[istft] {arch} decode {name}: launches none; pcm "
                f"{pcm.shape} finite, peak {np.abs(pcm).max():.4f}, std "
                f"{pcm.std():.4f}, share |pcm| > 0.99: {sat:.2e}")
        if dt == "float32":
            ref = decode(models[arch, "cpu", dt], x)
            c = corr(pcm, ref)
            err, peak = np.abs(pcm - ref).max(), np.abs(ref).max()
            if not (c > 0.99999 and err <= 1e-4 * peak):
                raise RuntimeError(f"{arch} decode {name}: corr {c}, max abs "
                                   f"err {err} (peak {peak}) vs the CPU")
            line += (f"; vs the same function on the CPU: corr {c:.9f}, max "
                     f"abs err {err:.3e} ({err / peak:.2e} of peak {peak:.4f})")
        else:
            line += (f"; vs the f32 model on the card: corr "
                     f"{corr(pcm, decode(models[arch, 'cuda', 'float32'], x)):.6f}")
        if dt == "float16":
            cudnn, torch.backends.cudnn.enabled = (
                torch.backends.cudnn.enabled, False)
            try:
                ref = decode(model, x)
            finally:
                torch.backends.cudnn.enabled = cudnn
            c = corr(pcm, ref)
            c32 = corr(pcm, decode(models[arch, "cuda", "float32"], x))
            if not (np.isfinite(ref).all() and c > CHAIN_BF16["corr"]
                    and c32 > 0.9999):
                raise RuntimeError(f"{arch} decode {name}: corr {c} vs the "
                                   f"plain f16 path with cuDNN off, {c32} vs "
                                   f"the f32 model")
            line += (f"; vs the f16 path with cuDNN off on the card: corr "
                     f"{c:.9f}, max abs err {np.abs(pcm - ref).max():.3e}")
            if secs * batch <= 20:
                # what going around cuDNN costs, in turns: the request as it
                # runs against the same with its depthwise convs on cuDNN
                # (which faults past ~60 000 frames, so 20 s b1 only)
                def on_cudnn():
                    keep = blocks.depthwise_conv
                    blocks.depthwise_conv = lambda h, w, b: F.conv1d(
                        h.transpose(1, 2), w, b,
                        padding=(w.shape[-1] - 1) // 2,
                        groups=h.shape[-1]).transpose(1, 2)
                    try:
                        return decode(model, x)
                    finally:
                        blocks.depthwise_conv = keep
                pairs = []
                for i in range(F16_DW_PAIRS):
                    if i % 2:
                        b_ms = cuda_ms(on_cudnn)
                        a_ms = cuda_ms(lambda: decode(model, x))
                    else:
                        a_ms = cuda_ms(lambda: decode(model, x))
                        b_ms = cuda_ms(on_cudnn)
                    pairs.append((a_ms, b_ms))
                line += (f"; as it runs vs its depthwise convs on cuDNN, "
                         f"{F16_DW_PAIRS} alternating pairs: "
                         f"{statistics.median(a for a, _ in pairs):.3f} vs "
                         f"{statistics.median(b for _, b in pairs):.3f} ms, "
                         f"faster in {sum(a < b for a, b in pairs)} of "
                         f"{F16_DW_PAIRS}")
        ms = cuda_ms(lambda: decode(model, x))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")

    def latent(arch, model, pcm_row):
        """The f32 model's latent before the search, on the card."""
        with torch.inference_mode(), f32_precision(True):
            if arch == "wavtokenizer":
                x = torch.from_numpy(pcm_row[None]).cuda()
                return wt.wt_encode_latent_fn(model.params, x)[0].float()
            c = model.cfg
            mel, n_frames = whisper_mel_padded(
                pcm_row, c.encode_sample_rate, c.mel_n_fft, c.mel_hop,
                c.mel_n_mels, c.encoder_downsample_rate)
            n_valid = min(n_frames, len(pcm_row) // c.mel_hop)
            x = torch.from_numpy(np.ascontiguousarray(mel.T[None])).cuda()
            return xy.xy_encode_latent_fn(model.params, x, c, n_valid)[0]

    for arch, name, secs, batch, dt in ISTFT_ENCODES:
        model = models[arch, "cuda", dt]
        rate = model.encode_sample_rate or model.sample_rate
        pcm = (rng.standard_normal((batch, secs * rate)) * 0.3).astype(
            np.float32)
        zero_counts()
        codes = model.encode(pcm)
        step = counts()
        want_launches = batch if arch == "xy_tokenizer" else 1
        if step != {**none, "rvq_encode_fused": want_launches}:
            raise RuntimeError(f"{arch} encode {name}: launches {step}, want "
                               f"{want_launches} rvq_encode_fused")
        phase_counts["rvq_encode_fused"] += want_launches
        frames = (secs * rate // (model.cfg.encoder_downsample_rate
                                  if arch == "xy_tokenizer" else model.hop_size))
        if codes.shape != (batch, frames, model.n_q) or codes.dtype != np.int32:
            raise RuntimeError(f"{arch} encode {name}: codes {codes.shape} "
                               f"{codes.dtype}, want {(batch, frames, model.n_q)}")
        if codes.min() < 0 or codes.max() >= model.codebook_size:
            raise RuntimeError(f"{arch} encode {name}: codes out of range")
        distinct = [len(np.unique(codes[..., q])) for q in range(model.n_q)]
        line = (f"[istft] {arch} encode {name}: launches {step['rvq_encode_fused']} "
                f"rvq_encode_fused; codes {codes.shape} in range, distinct "
                f"codes per level {distinct}")
        if dt == "float32":
            ties = []
            search = model.params["search"]
            for bi in range(batch):
                z = latent(arch, model, pcm[bi])
                want = rvq_encode(z[None].contiguous(), search["cb"],
                                  search["norms"])[0].cpu().numpy()
                z64, cb64 = f64(z), f64(search["cb"])
                ties += near_ties(codes[bi], want, lambda fr, q: euclid_margin(
                    z64[fr], cb64, want[fr, :q], codes[bi, fr, q], want[fr, q]))
            line += ("; equal to the plain search on the card" if not ties
                     else f"; vs the plain search on the card: {len(ties)} "
                     f"frames differ, each a near-tie (margins "
                     f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
            zero_counts()
            back = model.decode(codes)
            if counts() != none or not np.isfinite(back).all():
                raise RuntimeError(f"{arch}: encode → decode gave launches "
                                   f"{counts()}, finite "
                                   f"{np.isfinite(back).all()}")
            line += f"; encode → decode round trip: pcm {back.shape} finite"
        ms = cuda_ms(lambda: model.encode(pcm))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")
    del models
    torch.cuda.empty_cache()
    log(f"[istft] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts


def windowed_codecs(name_limit: str, zero_counts, counts, none: dict) -> dict:
    """Phase 8c: write full-width random Qwen3-TTS-Tokenizer (with its Mimi
    encoder) and Pocket-Mimi (with its encoder) GGUFs, load each with
    load_model on the card in f32, bf16 and f16, and run WINDOWED_DECODES,
    one Qwen3 decode with its window taken off (full causal attention),
    WINDOWED_ENCODES and POCKET_STREAMS, with every launch count set to 0
    just before each request and read just after (each push's read just
    before and after it, the warm first push's too): exactly one
    flash_sdpa_window per transformer layer (Qwen3 decode 8, encode 8 + 2
    rvq_encode_fused; Pocket 2 per decode_latent, encode_latent and push).
    Each output is checked for shape, finite samples and saturation; each
    f32 decode against the same function with the plain attention on the
    card (corr > 0.99999, max abs err <= 1e-4 x peak), each f16 decode
    against the plain path in f16 (corr > 0.9995); the f32 Qwen3 codes
    against the plain path (plain attention, plain search) under the
    near-tie rule, the f32 Pocket latents against the plain path at 1e-4 x
    peak, each f32 stream against decode_latent of the whole stream on the
    card. Each request's median time (CUDA events), each stream's push
    time (median, host clock around a push that ends in its copy to the
    host) and time to first audio. → this phase's launch counts (the
    streams' under "flash_sdpa_window (carried keys)")."""
    import dataclasses

    import codec_tpu_torch
    from codec_tpu_torch.models import mimi, pocket_mimi, qwen3_tts
    from codec_tpu_torch.models.pocket_init import write_random_pocket_gguf
    from codec_tpu_torch.models.qwen3_tts_init import write_random_q3t_gguf
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_windowed_") as tmp:
        paths = {"qwen3": Path(tmp) / "qwen3_random.gguf",
                 "pocket": Path(tmp) / "pocket_random.gguf"}
        t0 = time.monotonic()
        write_random_q3t_gguf(paths["qwen3"], seed=SEED)
        write_random_pocket_gguf(paths["pocket"], seed=SEED)
        log("[windowed] wrote " + ", ".join(
            f"{p.name} ({p.stat().st_size / 2**20:.1f} MiB)"
            for p in paths.values()) + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        for arch, path in paths.items():
            for dt in ("float32", "bfloat16", "float16"):
                models[arch, dt] = codec_tpu_torch.load_model(
                    path, compute_dtype=dt, device="cuda")
        torch.cuda.synchronize()
    q3m, pmm = models["qwen3", "float32"], models["pocket", "float32"]
    if q3m.cfg.window != Q3T_WINDOW or not (q3m.has_encoder
                                            and pmm.has_encoder):
        raise RuntimeError(f"windowed: Qwen3 window {q3m.cfg.window}, "
                           f"encoders {q3m.has_encoder} {pmm.has_encoder}")
    log(f"[windowed] load_model x2 archs, f32 + bf16 + f16 on the card, in "
        f"{time.monotonic() - t0:.2f} s; Qwen3-TTS-Tokenizer: {q3m.cfg}, "
        f"encoder {q3m.enc_cfg}; Pocket-Mimi: {pmm.cfg}; parameters "
        + ", ".join(f"{a} {sum(t.numel() for t in _tensors(models[a, 'float32'].params)) / 1e6:.1f} M"
                    for a in paths) + f" (+ Qwen3's encoder "
        f"{sum(t.numel() for t in _tensors(q3m.enc_params)) / 1e6:.1f} M)")

    layers = {"qwen3": q3m.cfg.n_layers, "pocket": pmm.cfg.tf_layers}
    rng = np.random.default_rng(SEED + 600)

    def inputs(arch, secs, batch):
        m = models[arch, "float32"]
        frames = secs * m.sample_rate // m.hop_size
        if arch == "qwen3":
            return rng.integers(0, m.codebook_size, (batch, frames, m.n_q)
                                ).astype(np.int32)
        return rng.standard_normal((batch, frames, m.latent_dim)).astype(
            np.float32)

    def run(model, x):
        return (model.decode(x) if model.arch == "qwen3_tts_tokenizer"
                else model.decode_latent(x))

    def plain(model, x):
        """The decode function with the plain attention, on the card."""
        with model._decoding():
            if model.arch == "qwen3_tts_tokenizer":
                pcm = qwen3_tts.q3t_decode_fn(
                    model.params, torch.from_numpy(x.astype(np.int64)).cuda(),
                    model.cfg, attention=flash_sdpa_window_ref)
            else:
                pcm = pocket_mimi.pocket_decode_latent_fn(
                    model.params, torch.from_numpy(x).to(
                        "cuda", model.compute_dtype), model.cfg,
                    attention=flash_sdpa_window_ref)
            return pcm.float().cpu().numpy()

    def held(label, got, want, bound_corr, peak_bound=True):
        c = corr(got, want)
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if not (np.isfinite(want).all() and c > bound_corr
                and (not peak_bound or err <= 1e-4 * peak)):
            raise RuntimeError(f"{label}: corr {c}, max abs err {err} (peak "
                               f"{peak})")
        return (f"corr {c:.9f}, max abs err {err:.3e} ({err / peak:.2e} of "
                f"peak {peak:.4f})")

    phase_counts = dict(none, **{"flash_sdpa_window (carried keys)": 0})
    requests = [(a, n, s, b, dt, None) for a, n, s, b, dt in WINDOWED_DECODES]
    requests.append(("qwen3", "20s_b1_f32_full_causal", 20, 1, "float32",
                     dataclasses.replace(q3m.cfg, window=None)))
    for arch, name, secs, batch, dt, cfg in requests:
        model = models[arch, dt]
        keep = model.cfg
        model.cfg = cfg or keep
        try:
            x = inputs(arch, secs, batch)
            zero_counts()
            pcm = run(model, x)
            step = counts()
            want_step = {**none, "flash_sdpa_window": layers[arch]}
            if step != want_step:
                raise RuntimeError(f"{arch} decode {name}: launches {step}, "
                                   f"want {want_step}")
            phase_counts["flash_sdpa_window"] += layers[arch]
            n = x.shape[1] * model.hop_size
            if pcm.shape != (batch, n) or pcm.dtype != np.float32 \
                    or not np.isfinite(pcm).all():
                raise RuntimeError(f"{arch} decode {name}: pcm {pcm.shape} "
                                   f"{pcm.dtype}, want {(batch, n)} finite "
                                   f"float32")
            sat = float((np.abs(pcm) > 0.99).mean())
            if not sat < 0.01:
                raise RuntimeError(f"{arch} decode {name}: {sat:.2%} of "
                                   f"samples saturated")
            line = (f"[windowed] {arch} decode {name} (window "
                    f"{model.cfg.window if arch == 'qwen3' else model.cfg.tf_context}): "
                    f"launches {layers[arch]} flash_sdpa_window; pcm "
                    f"{pcm.shape} finite, peak {np.abs(pcm).max():.4f}, std "
                    f"{pcm.std():.4f}, share |pcm| > 0.99: {sat:.2e}")
            if dt == "float32":
                line += "; vs the plain attention on the card: " + held(
                    f"{arch} decode {name}", pcm, plain(model, x), 0.99999)
            elif dt == "float16":
                line += "; vs the plain path in f16 on the card: " + held(
                    f"{arch} decode {name}", pcm, plain(model, x),
                    CHAIN_BF16["corr"], peak_bound=False)
            if dt != "float32":
                line += (f"; vs the f32 model: corr "
                         f"{corr(pcm, run(models[arch, 'float32'], x)):.6f}")
            ms = cuda_ms(lambda: run(model, x))
            log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}),"
                f" {secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")
        finally:
            model.cfg = keep

    for arch, name, secs, batch, dt in WINDOWED_ENCODES:
        model = models[arch, dt]
        n = secs * model.sample_rate + (POCKET_TAIL if arch == "pocket" else 0)
        pcm = (rng.standard_normal((batch, n)) * 0.3).astype(np.float32)
        frames = -(-n // model.hop_size)
        zero_counts()
        out = model.encode(pcm) if arch == "qwen3" else model.encode_latent(pcm)
        step = counts()
        if arch == "qwen3":
            want_step = {**none, "flash_sdpa_window": model.enc_cfg.n_layers,
                         "rvq_encode_fused": 2}
            want_shape, want_dtype = (batch, frames, model.n_q), np.int32
        else:
            want_step = {**none, "flash_sdpa_window": layers[arch]}
            want_shape, want_dtype = (batch, frames, model.latent_dim), np.float32
        if step != want_step:
            raise RuntimeError(f"{arch} encode {name}: launches {step}, want "
                               f"{want_step}")
        for k in ("flash_sdpa_window", "rvq_encode_fused"):
            phase_counts[k] += want_step[k]
        if out.shape != want_shape or out.dtype != want_dtype \
                or not np.isfinite(out).all():
            raise RuntimeError(f"{arch} encode {name}: {out.shape} "
                               f"{out.dtype}, want {want_shape} {want_dtype}")
        line = (f"[windowed] {arch} encode {name} ({n} samples): launches "
                f"{step['flash_sdpa_window']} flash_sdpa_window + "
                f"{step['rvq_encode_fused']} rvq_encode_fused; {out.shape}")
        x = torch.from_numpy(pcm).cuda()
        if arch == "qwen3":
            if out.min() < 0 or out.max() >= model.codebook_size:
                raise RuntimeError(f"qwen3 encode {name}: codes out of range")
            line += (f" in range, distinct codes per level "
                     f"{[len(np.unique(out[..., q])) for q in range(model.n_q)]}")
        if arch == "qwen3" and dt == "float32":
            with torch.inference_mode(), f32_precision(True):
                want = mimi.mimi_encode_fn(
                    model.enc_params, x, model.enc_cfg,
                    attention=flash_sdpa_window_ref,
                    quantize=rvq_encode).cpu().numpy()
                lat = f64(mimi.mimi_encode_latent_fn(
                    model.enc_params, x, model.enc_cfg,
                    attention=flash_sdpa_window_ref))
            ties = [t for bi in range(batch) for t in near_ties(
                out[bi], want[bi], mimi_margin(model.enc_params,
                                               model.enc_cfg, lat[bi],
                                               want[bi], out[bi]))]
            line += ("; equal to the plain path's on the card" if not ties
                     else f"; vs the plain path on the card: {len(ties)} "
                     f"frames differ, each a near-tie (margins "
                     f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
            zero_counts()
            back = model.decode(out)
            if counts() != {**none, "flash_sdpa_window": layers[arch]} \
                    or not np.isfinite(back).all():
                raise RuntimeError(f"qwen3: encode → decode gave launches "
                                   f"{counts()}, finite "
                                   f"{np.isfinite(back).all()}")
            phase_counts["flash_sdpa_window"] += layers[arch]
            line += f"; encode → decode round trip: pcm {back.shape} finite"
        elif arch == "pocket" and dt == "float32":
            xp = F.pad(x, (0, frames * model.hop_size - n))
            with torch.inference_mode(), f32_precision(True):
                want = pocket_mimi.pocket_encode_latent_fn(
                    model.params, xp, model.cfg, n_valid=n,
                    attention=flash_sdpa_window_ref).cpu().numpy()
            line += "; vs the plain attention on the card: " + held(
                f"pocket encode {name}", out, want, 0.99999)
        ms = cuda_ms(lambda: model.encode(pcm) if arch == "qwen3"
                     else model.encode_latent(pcm))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")

    push_step = {**none, "flash_sdpa_window": layers["pocket"]}

    def first_audio(model, batch, z, chunk, push_s):
        """Opens a session and pushes z through it in chunks → (pcm, the
        launches read, the host seconds from the open to the first push's
        PCM)."""
        t0 = time.perf_counter()
        session = model.streaming_decoder(batch=batch)
        open_s = time.perf_counter() - t0
        pcm, read = stream(session, z, chunk, push_step, 1, counts, push_s)
        return pcm, read, open_s + push_s[0]

    for name, secs, batch, dt, chunk in POCKET_STREAMS:
        model = models["pocket", dt]
        z = inputs("pocket", secs, batch)
        push_s = []
        # the process's first push of this shape opens the stream
        pcm, read, ttfa_cold = first_audio(model, batch, z, chunk, push_s)
        full = model.decode_latent(z)
        steady = statistics.median(push_s[2:]) * 1e3
        # a session opened once this push shape has run (its convs' plans
        # and allocations warm): open it and push its first chunk
        _, warm, ttfa_warm = first_audio(model, batch, z[:, :chunk],
                                           chunk, [])
        phase_counts["flash_sdpa_window (carried keys)"] += (
            read["flash_sdpa_window"] + warm["flash_sdpa_window"])
        log(f"[windowed] pocket stream {name}: {len(push_s)} pushes of {chunk} "
            f"latent frame(s) ({model.cfg.resample_stride * chunk} queries "
            f"against {model.cfg.tf_context - 1} carried keys), launches per "
            f"push {layers['pocket']} flash_sdpa_window; "
            f"pcm {pcm.shape} finite; vs decode_latent of the whole stream "
            f"on the card: " + held(f"pocket stream {name}", pcm, full,
                                    0.99999)
            + f"; push {steady:.3f} ms (median after 2, host clock), "
            f"{chunk * 80 / steady:.1f}x realtime; time to first audio "
            f"(open a session, push its first chunk) {ttfa_cold * 1e3:.3f} ms "
            f"the first time in the process, {ttfa_warm * 1e3:.3f} ms once "
            f"warm [{name_limit}]")
    del models
    torch.cuda.empty_cache()
    log(f"[windowed] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts


def fsq_near_ties(got, want, z):
    """FSQ codes [T, 1] against the reference's, digit by digit (base 4, 8
    digits): equal, or at most max(2, digits / 50) differ, each where the
    reference's f64 twice-bounded latent z [T, 8] lies within 1e-3 of a
    half (tests/fsq_ties.py's rule) → [(frame, digit, |frac − 0.5|)]."""
    half_l = 3.0 * (1 + 1e-3) / 2.0
    shift = math.atanh(0.5 / half_l)
    zb = half_l * np.tanh(half_l * np.tanh(np.asarray(z, np.float64) + shift)
                          - 0.5 + shift) - 0.5
    gd, wd = ((np.asarray(c).reshape(-1, 1).astype(np.int64)
               // 4 ** np.arange(8)) % 4 for c in (got, want))
    bad = np.argwhere(gd != wd)
    if len(bad) > max(2, gd.size // 50):
        raise RuntimeError(f"{len(bad)}/{gd.size} FSQ digits differ")
    out = []
    for fr, d in bad:
        frac = abs(zb[fr, d] - np.floor(zb[fr, d]) - 0.5)
        if not frac < 1e-3:
            raise RuntimeError(f"FSQ frame {fr} digit {d}: |frac - 0.5| "
                               f"{frac:.2e}, not a tie")
        out.append((int(fr), int(d), float(frac)))
    return out


def neu_codecs(name_limit: str, zero_counts, counts, none: dict) -> dict:
    """Phase 8d: write a full-width random NeuCodec GGUF (decoder only), a
    DistillNeuCodec GGUF (the same seed's decoder and the distill encoder)
    and an XCodec2 GGUF (decoder and encoder), load each with load_model on
    the card in f32, bf16 and f16 and on the CPU in f32, and run
    NEU_DECODES and NEU_ENCODES with every launch count set to 0 just
    before each request and read just after (none: no kernel of the port
    is on these paths). The base file's encode must raise CodecError. Each
    output is checked for shape, finite samples and saturation (codes:
    shape and range); each f32 decode against the same port function on
    the CPU from the same file (corr > 0.99999, max abs err <= 1e-4 x
    peak), the distill decode against the base file's bit for bit, each f16
    decode against the f32 model on the card (corr > 0.9999); each f32
    encode against the CPU on a NEU_CPU_ENCODE_SECONDS request run both
    ways (the FSQ near-tie rule: fsq_near_ties); one encode → decode round
    trip an encoding arch. Each request's median time (CUDA events, 10
    after 2 warm-ups). → this phase's launch counts (all 0)."""
    import codec_tpu_torch
    from codec_tpu_torch import CodecError
    from codec_tpu_torch.models import neucodec as neu
    from codec_tpu_torch.models import xcodec2 as x2
    from codec_tpu_torch.models.neucodec_init import write_random_neu_gguf
    from codec_tpu_torch.models.xcodec2_init import write_random_x2_gguf
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_neu_") as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf"
                 for a in ("neucodec", "distill_neucodec", "xcodec2")}
        t0 = time.monotonic()
        write_random_neu_gguf(paths["neucodec"], seed=SEED)
        write_random_neu_gguf(paths["distill_neucodec"], seed=SEED,
                              encoder=True)
        write_random_x2_gguf(paths["xcodec2"], seed=SEED, encoder=True)
        log("[neu] wrote " + ", ".join(
            f"{p.name} ({p.stat().st_size / 2**20:.1f} MiB)"
            for p in paths.values()) + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        for arch, path in paths.items():
            for dev, dt in (("cuda", "float32"), ("cuda", "bfloat16"),
                            ("cuda", "float16"), ("cpu", "float32")):
                models[arch, dev, dt] = codec_tpu_torch.load_model(
                    path, compute_dtype=dt, device=dev)
        torch.cuda.synchronize()
    base, dm, xm = (models[a, "cuda", "float32"] for a in paths)
    if base.has_encoder or not (dm.has_encoder and xm.has_encoder):
        raise RuntimeError(f"neu: encoders {base.has_encoder} "
                           f"{dm.has_encoder} {xm.has_encoder}")
    try:
        base.encode(np.zeros(16000, np.float32))
        raise RuntimeError("neu: the base NeuCodec encoded")
    except CodecError as e:
        refused = str(e)

    def n_params(m):
        return sum(t.numel() for t in _tensors(
            [m.params, getattr(m, "enc_params", {})])) / 1e6

    log(f"[neu] load_model x3 files, card f32 + bf16 + f16 and CPU f32, in "
        f"{time.monotonic() - t0:.2f} s; NeuCodec {base.cfg}; distill "
        f"encoder {dm.enc_cfg}; XCodec2 {xm.cfg}, encoder {xm.enc_cfg}; "
        f"parameters " + ", ".join(f"{a} {n_params(models[a, 'cpu', 'float32']):.1f} M"
                                   for a in paths)
        + f"; the base file's encode raises CodecError: {refused!r}")

    rng = np.random.default_rng(SEED + 700)
    base_out = {}
    for arch, name, secs, batch, dt in NEU_DECODES:
        model = models[arch, "cuda", dt]
        frames = secs * model.sample_rate // model.hop_size
        codes = (base_out["codes"] if arch == "distill_neucodec" else
                 rng.integers(0, model.codebook_size, (batch, frames, 1)
                              ).astype(np.int32))
        zero_counts()
        pcm = model.decode(codes)
        if counts() != none:
            raise RuntimeError(f"{arch} decode {name}: launches {counts()}, "
                               f"want none")
        n = frames * model.hop_size
        if pcm.shape != (batch, n) or pcm.dtype != np.float32:
            raise RuntimeError(f"{arch} decode {name}: pcm {pcm.shape} "
                               f"{pcm.dtype}, want {(batch, n)} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"{arch} decode {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        if not sat < 0.01:
            raise RuntimeError(f"{arch} decode {name}: {sat:.2%} of samples "
                               f"saturated")
        line = (f"[neu] {arch} decode {name}: launches none; pcm {pcm.shape} "
                f"finite, peak {np.abs(pcm).max():.4f}, std {pcm.std():.4f}, "
                f"share |pcm| > 0.99: {sat:.2e}")
        if arch == "neucodec" and (batch, dt) == (1, "float32"):
            base_out.update(codes=codes, pcm=pcm)
        if arch == "distill_neucodec":
            if not np.array_equal(pcm, base_out["pcm"]):
                raise RuntimeError("distill decode differs from the base "
                                   "file's")
            line += "; equal to the base file's decode bit for bit"
        if dt == "float32":
            ref = models[arch, "cpu", dt].decode(codes)
            c = corr(pcm, ref)
            err, peak = np.abs(pcm - ref).max(), np.abs(ref).max()
            if not (c > 0.99999 and err <= 1e-4 * peak):
                raise RuntimeError(f"{arch} decode {name}: corr {c}, max abs "
                                   f"err {err} (peak {peak}) vs the CPU")
            line += (f"; vs the same function on the CPU: corr {c:.9f}, max "
                     f"abs err {err:.3e} ({err / peak:.2e} of peak {peak:.4f})")
        else:
            c = corr(pcm, models[arch, "cuda", "float32"].decode(codes))
            if dt == "float16" and not c > 0.9999:
                raise RuntimeError(f"{arch} decode {name}: corr {c} vs the "
                                   f"f32 model on the card")
            line += f"; vs the f32 model on the card: corr {c:.6f}"
        ms = cuda_ms(lambda: model.decode(codes))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")

    def latent(model, row):
        """The FSQ latent (before the bound) of one encode row, as the
        model computes it."""
        with torch.inference_mode(), f32_precision(model.exact_encode):
            if model.arch == "xcodec2":
                mel = model.mel(row)
                n = min(len(row) // model.hop_size, mel.shape[0])
                x, m = (torch.from_numpy(np.ascontiguousarray(a[None])).to(
                    model.device, model.compute_dtype) for a in (row, mel))
                return x2.x2_encode_latent_fn(model.enc_params, x, m, n,
                                              model.enc_cfg)[0]
            (row_pad, sem), = neu.encode_rows(row[None])
            x, s = (torch.from_numpy(np.ascontiguousarray(a[None])).to(
                model.device, model.compute_dtype) for a in (row_pad, sem))
            return neu.neu_encode_latent_fn(model.enc_params, x, s,
                                            model.enc_cfg)[0]

    for arch, name, secs, batch, dt in NEU_ENCODES:
        model = models[arch, "cuda", dt]
        rate = 16000
        pcm = (rng.standard_normal((batch, secs * rate)) * 0.3).astype(
            np.float32)
        zero_counts()
        codes = model.encode(pcm)
        if counts() != none:
            raise RuntimeError(f"{arch} encode {name}: launches {counts()}, "
                               f"want none")
        if arch == "xcodec2":         # T = min(n // hop, the mel frames)
            ec = model.enc_cfg
            frames = min(secs * rate // model.hop_size,
                         ((secs * rate - ec.mel_win) // ec.mel_hop + 1)
                         // ec.mel_stride)
        else:                          # n padded up to a multiple of 320
            frames = secs * rate // 320 + 1
        if codes.shape != (batch, frames, 1) or codes.dtype != np.int32:
            raise RuntimeError(f"{arch} encode {name}: codes {codes.shape} "
                               f"{codes.dtype}, want {(batch, frames, 1)}")
        if codes.min() < 0 or codes.max() >= model.codebook_size:
            raise RuntimeError(f"{arch} encode {name}: codes out of range")
        dig = (codes.reshape(-1, 1).astype(np.int64) // 4 ** np.arange(8)) % 4
        line = (f"[neu] {arch} encode {name}: launches none; codes "
                f"{codes.shape} in range, {len(np.unique(codes))} distinct, "
                f"levels used per digit "
                f"{[len(np.unique(dig[:, d])) for d in range(8)]}")
        if dt == "float32":
            short = pcm[:1, :NEU_CPU_ENCODE_SECONDS * rate]
            got = model.encode(short)[0]
            cpu = models[arch, "cpu", dt]
            want = cpu.encode(short)[0]
            ties = ([] if np.array_equal(got, want) else
                    fsq_near_ties(got, want, f64(latent(cpu, short[0]))))
            line += (f"; {NEU_CPU_ENCODE_SECONDS} s b1 vs the same function "
                     f"on the CPU: " + ("codes equal" if not ties else
                                        f"{len(ties)} FSQ digits differ, each "
                                        f"a near-tie (|frac - 0.5| "
                                        f"{', '.join(f'{t[2]:.1e}' for t in ties)})"))
            zero_counts()
            back = model.decode(codes)
            if (counts() != none or not np.isfinite(back).all()
                    or back.shape != (batch, frames * model.hop_size)):
                raise RuntimeError(f"{arch}: encode → decode gave launches "
                                   f"{counts()}, pcm {back.shape}, finite "
                                   f"{np.isfinite(back).all()}")
            line += f"; encode → decode round trip: pcm {back.shape} finite"
        ms = cuda_ms(lambda: model.encode(pcm))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")
    del models
    torch.cuda.empty_cache()
    log(f"[neu] main path launches: none; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return dict(none)


def level_near_ties(got, want, x1, levels):
    """Mixed-radix FSQ codes [T, G] (NeMo's) against the reference's,
    digit by digit: equal, or at most max(2, digits / 50) differ, each
    where the reference's f64 value before the round x1 [T, G, d] lies
    within 1e-3 of a half (tests/fsq_ties.py's rule) → [(frame, group,
    digit, |frac − 0.5|)]."""
    lv = np.asarray(levels, np.int64)
    base = np.concatenate([[1], np.cumprod(lv[:-1])])
    gd, wd = ((np.asarray(c, np.int64)[..., None] // base) % lv
              for c in (got, want))
    bad = np.argwhere(gd != wd)
    if len(bad) > max(2, gd.size // 50):
        raise RuntimeError(f"{len(bad)}/{gd.size} FSQ digits differ")
    out = []
    for fr, g, d in bad:
        v = float(x1[fr, g, d])
        frac = abs(v - math.floor(v) - 0.5)
        if not frac < 1e-3:
            raise RuntimeError(f"FSQ frame {fr} group {g} digit {d}: "
                               f"|frac - 0.5| {frac:.2e}, not a tie")
        out.append((int(fr), int(g), int(d), frac))
    return out


def ternary_near_ties(got, want, q):
    """S3T tokens [T, 1] against the reference's, ternary digit by digit:
    equal, or at most max(2, digits / 50) differ, each where the
    reference's bounded value q [T, 8] lies within 1e-3 of ±0.5 →
    [(frame, digit, ||q| − 0.5|)]."""
    gd, wd = ((np.asarray(c, np.int64).reshape(-1, 1) // 3 ** np.arange(8))
              % 3 for c in (got, want))
    bad = np.argwhere(gd != wd)
    if len(bad) > max(2, gd.size // 50):
        raise RuntimeError(f"{len(bad)}/{gd.size} ternary digits differ")
    out = []
    for fr, d in bad:
        gap = abs(abs(float(q[fr, d])) - 0.5)
        if not gap < 1e-3:
            raise RuntimeError(f"S3T frame {fr} digit {d}: q {q[fr, d]}, "
                               f"not a tie")
        out.append((int(fr), int(d), gap))
    return out


def moss_margin(p, lat, want, got):
    """margin_fn (near_ties) of MOSS's cosine LFQ: lat [T, rvq] f64, the
    quantizer's input; the residual before level q is what want's own
    earlier levels leave."""
    lv = [{k: f64(v) for k, v in q.items()} for q in p["q"]]

    def margin(fr, q):
        r = lat[fr].copy()
        for i in range(q):
            r -= lv[i]["cb"][want[fr, i]] @ lv[i]["out_w"].T + lv[i]["out_b"]
        z = r @ lv[q]["in_w"].T + lv[q]["in_b"]
        return cosine_margin(z, lv[q]["cb"], got[fr, q], want[fr, q])
    return margin


def small_codecs(name_limit: str, zero_counts, counts, none: dict) -> dict:
    """Phase 8e: write full-width random MOSS-Audio-Tokenizer (stereo, with
    its encoder), NeMo nano codec (with its encoder), BlueMagpie AudioVAE
    (with its encoder) and Chatterbox S3T GGUFs, load each with load_model
    on the card in f32, bf16 and f16 and on the CPU in f32, and run
    SMALL_REQUESTS with every launch count set to 0 just before each
    request and read just after (MOSS exactly MOSS_LAYERS
    flash_sdpa_window a request, the others none). Each output is checked
    for shape, finite samples and saturation (codes: shape and range);
    each f32 MOSS request against the same function with the banded plain
    attention on the card (corr > 0.99999, max abs err <= 1e-4 x peak;
    codes under the cosine near-tie rule), each f32 request of the four
    archs against the same function on the CPU from the same file on
    SMALL_CPU_SECONDS of the same input (codes: NeMo's and S3T's FSQ
    near-tie rules, MOSS's cosine one), each f16 decode against the f32
    model on the card (corr > 0.999); one encode → decode round trip per
    arch that decodes. Each request's median time (CUDA events, 10 after
    2 warm-ups). → this phase's launch counts."""
    import codec_tpu_torch
    from codec_tpu_torch.models import bluemagpie, chatterbox_s3t, moss_audio
    from codec_tpu_torch.models import nemo_nano
    from codec_tpu_torch.models.bluemagpie_init import write_random_bm_gguf
    from codec_tpu_torch.models.moss_init import write_random_moss_gguf
    from codec_tpu_torch.models.nemo_init import LEVELS, write_random_nemo_gguf
    from codec_tpu_torch.models.s3t_init import write_random_s3t_gguf
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    writers = {"moss": write_random_moss_gguf, "nemo": write_random_nemo_gguf,
               "bluemagpie": write_random_bm_gguf,
               "s3t": write_random_s3t_gguf}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf" for a in writers}
        t0 = time.monotonic()
        for arch, write in writers.items():
            kw = {} if arch == "s3t" else {"encoder": True}
            write(paths[arch], seed=SEED, **kw)
        log("[small] wrote " + ", ".join(
            f"{p.name} ({p.stat().st_size / 2**20:.1f} MiB)"
            for p in paths.values()) + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        for arch, path in paths.items():
            for dev, dt in (("cuda", "float32"), ("cuda", "bfloat16"),
                            ("cuda", "float16"), ("cpu", "float32")):
                models[arch, dev, dt] = codec_tpu_torch.load_model(
                    path, compute_dtype=dt, device=dev)
        torch.cuda.synchronize()
    mm = models["moss", "cuda", "float32"]
    if not all(models[a, "cuda", "float32"].has_encoder for a in writers) \
            or mm.expected_channels != 2:
        raise RuntimeError("small: an encoder is missing, or MOSS is not "
                           "stereo")
    log(f"[small] load_model x4 files, card f32 + bf16 + f16 and CPU f32, in "
        f"{time.monotonic() - t0:.2f} s; MOSS {mm.cfg}; NeMo "
        f"{models['nemo', 'cuda', 'float32'].cfg}; BlueMagpie "
        f"{models['bluemagpie', 'cuda', 'float32'].cfg}; S3T "
        f"{models['s3t', 'cuda', 'float32'].cfg}; parameters " + ", ".join(
            f"{a} {sum(t.numel() for t in _tensors(models[a, 'cpu', 'float32'].params)) / 1e6:.1f} M"
            for a in writers))

    rng = np.random.default_rng(SEED + 800)
    phase_counts = dict(none)

    def rate(model, kind):
        return (model.sample_rate if kind == "decode"
                else model.encode_sample_rate or model.sample_rate)

    def make_input(arch, kind, secs, batch, extra, model):
        if kind == "decode":
            frames = secs * model.sample_rate // model.hop_size
            if arch == "bluemagpie":
                return rng.standard_normal((batch, frames, model.latent_dim)
                                           ).astype(np.float32)
            return rng.integers(0, model.codebook_size,
                                (batch, frames, model.n_q)).astype(np.int32)
        n = secs * rate(model, kind) + extra
        if arch == "moss":                 # one stereo stream a call
            return (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
        return (rng.standard_normal((batch, n)) * 0.3).astype(np.float32)

    def call(model, arch, kind):
        if arch == "bluemagpie":
            return model.decode_latent if kind == "decode" else \
                model.encode_latent
        return model.decode if kind == "decode" else model.encode

    def cut(x, arch, kind, model, secs):
        """The first `secs` seconds of a request's input (a MOSS encode's
        samples past its seconds kept)."""
        if kind == "decode":
            return x[:, : secs * model.sample_rate // model.hop_size]
        if arch == "moss":
            return x[: secs * rate(model, kind) + (len(x) % model.hop_size)]
        return x[:, : secs * rate(model, kind)]

    def held(label, got, want, bound_corr=0.99999, peak_bound=True):
        c = corr(got, want)
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if not (np.isfinite(want).all() and c > bound_corr
                and (not peak_bound or err <= 1e-4 * peak)):
            raise RuntimeError(f"{label}: corr {c}, max abs err {err} (peak "
                               f"{peak})")
        return (f"corr {c:.9f}, max abs err {err:.3e} ({err / peak:.2e} of "
                f"peak {peak:.4f})")

    def codes_held(arch, model, x, got, want):
        """Codes of the f32 request on `model` (the CPU) against `got`
        under the arch's near-tie rule → the note."""
        if np.array_equal(got, want):
            return "codes equal"
        with torch.inference_mode(), f32_precision(True):
            if arch == "moss":
                flat = np.pad(x, ((0, (-len(x)) % model.hop_size), (0, 0)))
                lat = f64(moss_audio.moss_encode_latent_fn(
                    model.params, torch.from_numpy(flat.reshape(1, -1)).to(
                        model.device), model.cfg, x.size)[0])
                ties = near_ties(got, want, moss_margin(model.params, lat,
                                                        want, got))
            elif arch == "nemo":
                z = nemo_nano.nemo_encode_latent_fn(
                    model.params, torch.from_numpy(x).to(model.device),
                    model.cfg).double()
                f = {k: f64(v) for k, v in model.params["fsq"].items()}
                zg = z.cpu().numpy().reshape(*z.shape[:2], model.n_q, -1)
                x1 = np.tanh(zg + f["in_shift"]) * f["out_scale"] \
                    - f["out_offset"]
                ties = [t for b in range(len(got)) for t in level_near_ties(
                    got[b], want[b], x1[b], LEVELS)]
            else:
                ties = []
                for b in range(len(got)):
                    mel = torch.from_numpy(model.log_mel(x[b])[None])
                    q = f64(chatterbox_s3t.s3t_latent_fn(
                        model.params, mel.to(model.device), model.cfg)[0])
                    ties += ternary_near_ties(got[b], want[b], q)
        return f"{len(ties)} differ, each a near-tie ({ties})"

    for arch, kind, name, secs, batch, dt, extra in SMALL_REQUESTS:
        model = models[arch, "cuda", dt]
        fn = call(model, arch, kind)
        x = make_input(arch, kind, secs, batch, extra, model)
        zero_counts()
        out = fn(x)
        step = counts()
        want_step = {**none, "flash_sdpa_window":
                     MOSS_LAYERS if arch == "moss" else 0}
        if step != want_step:
            raise RuntimeError(f"{arch} {kind} {name}: launches {step}, "
                               f"want {want_step}")
        phase_counts["flash_sdpa_window"] += want_step["flash_sdpa_window"]
        if kind == "decode":
            n = x.shape[1] * model.hop_size
            want_shape = (batch, n, 2) if arch == "moss" else (batch, n)
        elif arch == "bluemagpie":
            want_shape = (batch, x.shape[1] // model.cfg.encode_hop,
                          model.latent_dim)
        elif arch == "moss":
            want_shape = (-(-len(x) // model.hop_size), model.n_q)
        elif arch == "nemo":
            want_shape = (batch, x.shape[1] // model.hop_size, model.n_q)
        else:
            want_shape = (batch, -(-x.shape[1] // 640), 1)
        if out.shape != want_shape or not np.isfinite(out).all():
            raise RuntimeError(f"{arch} {kind} {name}: {out.shape}, want "
                               f"{want_shape} finite")
        line = (f"[small] {arch} {kind} {name}: launches "
                f"{step['flash_sdpa_window']} flash_sdpa_window; {out.shape}")
        if out.dtype == np.int32:
            if out.min() < 0 or out.max() >= model.codebook_size:
                raise RuntimeError(f"{arch} {kind} {name}: codes out of range")
            line += (f" in range, {len(np.unique(out.reshape(-1, out.shape[-1]), axis=0))}"
                     f" distinct code rows")
        else:
            if out.dtype != np.float32:
                raise RuntimeError(f"{arch} {kind} {name}: dtype {out.dtype}")
            line += f" finite, peak {np.abs(out).max():.4f}, std {out.std():.4f}"
            if kind == "decode":
                sat = float((np.abs(out) > 0.99).mean())
                if not sat < 0.01:
                    raise RuntimeError(f"{arch} decode {name}: {sat:.2%} of "
                                       f"samples saturated")
                line += f", share |pcm| > 0.99: {sat:.2e}"
        if dt == "float32":
            if arch == "moss":
                with model._decoding():
                    if kind == "decode":
                        plain = moss_audio.moss_decode_fn(
                            model.params, torch.from_numpy(
                                x.astype(np.int64)).cuda(), model.cfg,
                            attention=flash_sdpa_window_ref)
                        plain = plain.float().cpu().numpy().reshape(out.shape)
                        line += ("; vs the banded plain attention on the "
                                 "card: " + held(f"moss decode {name}", out,
                                                 plain))
                    else:
                        flat = np.pad(x, ((0, (-len(x)) % model.hop_size),
                                          (0, 0))).reshape(1, -1)
                        xt = torch.from_numpy(flat).cuda()
                        plain = moss_audio.moss_encode_fn(
                            model.params, xt, model.cfg, x.size,
                            attention=flash_sdpa_window_ref)[0].to(
                                torch.int32).cpu().numpy()
                        lat = f64(moss_audio.moss_encode_latent_fn(
                            model.params, xt, model.cfg, x.size,
                            attention=flash_sdpa_window_ref)[0])
                        ties = near_ties(out, plain, moss_margin(
                            model.params, lat, plain, out))
                        line += ("; vs the banded plain attention on the "
                                 "card: " + ("codes equal" if not ties else
                                             f"{len(ties)} frames differ, "
                                             f"each a near-tie {ties}"))
            cpu = models[arch, "cpu", "float32"]
            cs = SMALL_CPU_SECONDS[arch]
            xs = cut(x, arch, kind, model, cs)
            got_s = fn(xs)
            want_s = call(cpu, arch, kind)(xs)
            if got_s.dtype == np.int32:
                note = codes_held(arch, cpu, xs, got_s, want_s)
            else:
                note = held(f"{arch} {kind} {name} vs the CPU", got_s, want_s)
            line += f"; {cs} s of it vs the same function on the CPU: {note}"
            if kind == "encode" and arch != "s3t":
                zero_counts()
                back = (model.decode_latent(out) if arch == "bluemagpie"
                        else model.decode(out))
                if counts() != {**none, "flash_sdpa_window":
                                MOSS_LAYERS if arch == "moss" else 0} \
                        or not np.isfinite(back).all():
                    raise RuntimeError(f"{arch}: encode → decode gave "
                                       f"launches {counts()}, finite "
                                       f"{np.isfinite(back).all()}")
                phase_counts["flash_sdpa_window"] += \
                    counts()["flash_sdpa_window"]
                line += f"; encode → decode round trip: {back.shape} finite"
        elif kind == "decode":
            c = corr(out, call(models[arch, "cuda", "float32"], arch,
                               kind)(x))
            if dt == "float16" and not c > 0.999:
                raise RuntimeError(f"{arch} decode {name}: corr {c} vs the "
                                   f"f32 model on the card")
            line += f"; vs the f32 model on the card: corr {c:.6f}"
        ms = cuda_ms(lambda: fn(x))
        log(line + f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
            f"{secs * batch / (ms / 1e3):.1f}x realtime [{name_limit}]")

    # MOSS past 174.72 s of stereo (2184 codes, the most one attention
    # launch took while its query tiles sat on the grid's y dimension):
    # MOSS_LONG_CODES codes, 15 launches; causal in time, so the samples of
    # its first MOSS_PREFIX_CODES codes are the decode of those codes alone
    model = models["moss", "cuda", "float32"]
    codes = rng.integers(0, model.codebook_size,
                         (1, MOSS_LONG_CODES, model.n_q)).astype(np.int32)
    zero_counts()
    long = model.decode(codes)
    step = counts()
    queries = MOSS_LONG_CODES * (MOSS_ATTN_SHAPES[-1][2] // 250)
    want_step = {**none, "flash_sdpa_window": MOSS_LAYERS}
    n = MOSS_LONG_CODES * model.hop_size
    if step != want_step or long.shape != (1, n, 2) \
            or not np.isfinite(long).all():
        raise RuntimeError(f"moss decode of {MOSS_LONG_CODES} codes: "
                           f"launches {step}, {long.shape} finite "
                           f"{np.isfinite(long).all()}")
    phase_counts["flash_sdpa_window"] += MOSS_LAYERS
    head = model.decode(codes[:, :MOSS_PREFIX_CODES])
    note = held(f"moss decode of {MOSS_LONG_CODES} codes, its first "
                f"{MOSS_PREFIX_CODES}", long[:, :head.shape[1]], head,
                peak_bound=False)
    ms = cuda_ms(lambda: model.decode(codes), runs=3)
    log(f"[small] moss decode {n / model.sample_rate:.0f}s_b1_f32 "
        f"({MOSS_LONG_CODES} codes; the last stage {queries} queries, "
        f"{-(-queries // 16)} query tiles of 16): launches "
        f"{step['flash_sdpa_window']} flash_sdpa_window; {long.shape} finite, "
        f"peak {np.abs(long).max():.4f}; its first {MOSS_PREFIX_CODES} codes' "
        f"samples vs their own decode: {note}; {ms:.3f} ms per request "
        f"(median of 3), {n / model.sample_rate / (ms / 1e3):.1f}x realtime "
        f"[{name_limit}]")
    del models
    torch.cuda.empty_cache()
    log(f"[small] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts


def s3g_codec(name_limit: str, zero_counts, counts, none: dict) -> dict:
    """Phase 8f: write a full-width random Chatterbox S3Gen GGUF
    (models/s3g_init.py: FULL_S3G's widths, a 10 s builtin prompt of 250
    tokens and 500 mel frames), load it with load_model on the card in f32
    and bf16 and on the CPU in f32, and decode through it with every launch
    count set to 0 just before each request and read just after (none of
    the port's kernels lies on its path: all counts 0):
      - S3G_CPU_SECONDS of speech after the prompt in f32 on the card,
        against the same decode on the CPU (S3G_F32_GATE);
      - S3G_SECONDS of speech b1 in f32 and bf16: shape, finite samples,
        the share clipped at ±0.99; bf16 against f32 (corr >
        S3G_BF16_CORR); each request's median time (CUDA events, 10 after 2
        warm-ups), x realtime, one call's device busy time, idle share and
        top kernels under torch.profiler;
      - the NSF phase of the 20 s request's f0 summed in float32 on the
        card and on the CPU (how far two f32 running sums drift) and as
        the port sums it (float64, rounded once).
    → this phase's launch counts (all 0)."""
    import codec_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    from codec_tpu_torch.models import chatterbox_s3g as s3g
    from codec_tpu_torch.models.s3g_init import write_random_s3g_gguf
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s3g_") as tmp:
        path = Path(tmp) / "s3g_random.gguf"
        t0 = time.monotonic()
        write_random_s3g_gguf(path, seed=SEED)
        log(f"[s3g] wrote {path.name} ({path.stat().st_size / 2**20:.1f} "
            f"MiB) in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        models = {(dev, dt): codec_tpu_torch.load_model(
            path, compute_dtype=dt, device=dev)
            for dev, dt in (("cuda", "float32"), ("cuda", "bfloat16"),
                            ("cpu", "float32"))}
        torch.cuda.synchronize()
    f32 = models["cuda", "float32"]
    n_par = sum(t.numel() for t in _tensors(models["cpu", "float32"].params))
    log(f"[s3g] load_model card f32 + bf16 and CPU f32 in "
        f"{time.monotonic() - t0:.2f} s; {f32.cfg}; prompt "
        f"{f32.prompt_token_len} tokens, {f32.prompt_feat_frames} mel "
        f"frames; parameters {n_par / 1e6:.1f} M")
    rng = np.random.default_rng(SEED + 900)
    rate = f32.sample_rate // f32.hop_size                  # 25 tokens a s

    def request(model, codes):
        zero_counts()
        out = model.decode(codes)
        if counts() != none:
            raise RuntimeError(f"s3g decode: launches {counts()}, want none")
        n = 2 * codes.shape[0] * s3g.HIFT_SOURCE_UPSAMPLE
        if out.shape != (n,) or not np.isfinite(out).all():
            raise RuntimeError(f"s3g decode: {out.shape}, want ({n},) finite")
        return out

    codes = rng.integers(0, f32.codebook_size,
                         (S3G_CPU_SECONDS * rate, 1)).astype(np.int32)
    got = request(f32, codes)
    t0 = time.monotonic()
    want = models["cpu", "float32"].decode(codes)
    cpu_s = time.monotonic() - t0
    c = corr(got, want)
    err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
    if not (c > S3G_F32_GATE[0] and err <= S3G_F32_GATE[1] * peak):
        raise RuntimeError(f"s3g {S3G_CPU_SECONDS} s f32 card vs CPU: corr "
                           f"{c}, max abs err {err} (peak {peak})")
    log(f"[s3g] decode {S3G_CPU_SECONDS}s_b1_f32 ({len(codes)} tokens after "
        f"the prompt): launches none; ({len(got)},) finite, peak {peak:.4f}; "
        f"vs the same decode on the CPU ({cpu_s:.1f} s there): corr {c:.9f}, "
        f"max abs err {err:.3e} ({err / peak:.2e} of peak)")

    codes = rng.integers(0, f32.codebook_size,
                         (S3G_SECONDS * rate, 1)).astype(np.int32)
    outs = {}
    for dt in ("float32", "bfloat16"):
        model = models["cuda", dt]
        out = outs[dt] = request(model, codes)
        clipped = float((np.abs(out) >= s3g.HIFT_AUDIO_LIMIT).mean())
        if not clipped < 0.01:
            raise RuntimeError(f"s3g {dt}: {clipped:.2%} of samples clipped")
        tag = {"float32": "f32", "bfloat16": "bf16"}[dt]
        line = (f"[s3g] decode {S3G_SECONDS}s_b1_{tag} "
                f"({len(codes)} tokens after the prompt): launches none; "
                f"({len(out)},) finite, peak {np.abs(out).max():.4f}, std "
                f"{out.std():.4f}, share clipped at 0.99: {clipped:.2e}")
        if dt == "bfloat16":
            cb = corr(out, outs["float32"])
            if not cb > S3G_BF16_CORR:
                raise RuntimeError(f"s3g bf16 vs f32: corr {cb}")
            line += f"; vs the f32 model on the card: corr {cb:.6f}"
        ms = cuda_ms(lambda: model.decode(codes))
        line += (f"; {ms:.3f} ms per request (median of {TIMED_RUNS}), "
                 f"{S3G_SECONDS / (ms / 1e3):.1f}x realtime")
        # one call under the profiler; a trace that lost device events (far
        # fewer launches than the ~18 500 a request makes) is taken again
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model.decode(codes)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if e.self_device_time_total > 0
                    and not e.key.startswith("aten::")]
            if sum(e.count for e in kern) >= S3G_LEAST_LAUNCHES:
                break
        else:
            kern = []
        if kern:
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
            line += (f"; one call under torch.profiler: device busy "
                     f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / ms):.3f}"
                     f", {sum(e.count for e in kern)} kernel launches; top "
                     f"kernels " + "; ".join(
                         f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                         f"{e.key[:60]}" for e in top))
        else:
            line += "; device busy time not measured (short profiler traces)"
        log(line + f" [{name_limit}]")

    # the NSF phase at 20 s: θ = 2π·cumsum(f0·h / sr) over 480 000 samples
    with torch.inference_mode(), f32_precision(True):
        t_tok = f32.prompt_token_len + len(codes)
        noise_z, _, _ = s3g.decode_noise(2 * t_tok, 0, f32.cfg.mel_dim)
        tok = torch.from_numpy(f32.tokens(codes).astype(np.int64))[None]
        mel = s3g.s3g_mel_fn(f32.params, tok.cuda(),
                             torch.from_numpy(noise_z).cuda(),
                             f32.prompt_feat_frames, f32.cfg)
        f0 = torch.repeat_interleave(s3g._hift_f0(f32.params, mel).float(),
                                     s3g.HIFT_SOURCE_UPSAMPLE, dim=-1)
        scales = torch.arange(1, s3g.HIFT_NB_HARMONICS + 2,
                              device="cuda") / f32.sample_rate
        f_harm = f0[..., None] * scales
        exact = 2.0 * math.pi * np.cumsum(f64(f_harm), axis=1)
        card32 = f64(2.0 * math.pi * torch.cumsum(f_harm, dim=1))
        cpu32 = f64(2.0 * math.pi * torch.cumsum(f_harm.cpu(), dim=1))
        card64 = f64(s3g.nsf_phase(f_harm))
        cpu64 = f64(s3g.nsf_phase(f_harm.cpu()))
    log(f"[s3g] NSF phase of the {S3G_SECONDS} s request ({f_harm.shape[1]} "
        f"samples x {f_harm.shape[2]} harmonics, θ up to {exact.max():.4g} "
        f"rad, voiced share {float((f0 > 10).float().mean()):.3f}): float32 "
        f"running sums, card vs CPU max |Δθ| {np.abs(card32 - cpu32).max():.4g} "
        f"rad (card vs exact {np.abs(card32 - exact).max():.4g}, CPU vs exact "
        f"{np.abs(cpu32 - exact).max():.4g}); float64 sums rounded once (the "
        f"port's): card vs CPU {np.abs(card64 - cpu64).max():.4g} rad, vs "
        f"exact {np.abs(card64 - exact).max():.4g} [{name_limit}]")
    del models
    torch.cuda.empty_cache()
    log(f"[s3g] main path launches: {none}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return dict(none)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


class Recorder:
    """The Backbone protocol around a LlamaBackbone that records each call:
    (kind, input rows, returned hidden, host seconds). Every call ends in
    a copy of the hidden to the host, so its time covers the device work."""

    def __init__(self, bb):
        self.bb, self.calls = bb, []

    def step(self, embed):
        t = time.perf_counter()
        h = self.bb.step(embed)
        self.calls.append(("step", np.asarray(embed), h, time.perf_counter() - t))
        return h

    def prefill(self, embeds, bucket: int = 0):
        t = time.perf_counter()
        h = self.bb.prefill(embeds, bucket=bucket)
        self.calls.append(("prefill", np.asarray(embeds), h,
                           time.perf_counter() - t))
        return h


def main() -> int:
    t_start = time.monotonic()
    # -- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this runs on an NVIDIA GPU")
    name_limit = card()
    log(f"card: {name_limit}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import codec_tpu_torch
    from codec_tpu_torch.kernels import build
    from codec_tpu_torch.models import dac, snac
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.mimi import mimi_decode_fn
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf
    from codec_tpu_torch.ops import seanet_cuda
    from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                               flash_sdpa_window_ref)
    from codec_tpu_torch.ops.seanet_cuda import (seanet_res_chain,
                                                 seanet_res_unit,
                                                 snac_res_chain)
    from codec_tpu_torch.runtime.model import f32_precision
    from codec_tpu_torch.io.gguf import GGUFReader, quantize_q4_k, quantize_q8_0
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.fused_gen import chunk_ctx, gen_chunk_cached
    from codec_tpu_torch.lm.tts_runner import prefill_prompt
    from codec_tpu_torch.lm.tts_runner import run_codebook_ar_batch
    from codec_tpu_torch.ops.sample import OnDeviceSampling
    from codec_tpu_torch.lm.tts_runner import (_decode_transformed,
                                               run_codebook_ar)
    from codec_tpu_torch.models.lm_init import (write_random_backbone_gguf,
                                                write_random_csm_gguf)
    from codec_tpu_torch.ops import qmat
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul
    from codec_tpu_torch.models import mimi
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.ops import rvq_cuda
    from codec_tpu_torch.ops.rvq import codebook_norms
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from codec_tpu_torch.tools import sass_report, seanet_times
    # the bound (H100 data-sheet peaks)
    from codec_tpu_torch.tools.roofline import least_time
    # the residual units' work and inputs
    from codec_tpu_torch.tools.seanet_times import (dw_params, res_params,
                                                    res_work, unit_args)

    wrappers = {"flash_sdpa_window": flash_sdpa_window,
                "seanet_res_unit": seanet_res_unit,
                "seanet_res_chain": seanet_res_chain,
                "snac_res_chain": snac_res_chain,
                "q8_0_matmul": q8_0_matmul,
                "q4_k_matmul": q4_k_matmul,
                "rvq_encode_fused": rvq_encode_fused}
    none = dict.fromkeys(wrappers, 0)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # -- 2. build ------------------------------------------------------------
    log(f"[phase] 2 starts at {time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    res = build.build()
    log(f"[build] {res.path.name}: nvcc {res.seconds:.2f} s "
        f"(phase {time.monotonic() - t0:.2f} s)")
    for line in ptxas_report(res.log):
        log(f"[build] {line}")
    # the packed products' machine code: ptxas's stack frame and spills, and
    # the int→float conversions (I2F) left in the SASS; the DAC residual
    # units': stack frame and spills, and in bf16 wgmma (HGMMA), not
    # mma.sync (HMMA)
    sass = (sass_report.combine(res.log, res.path) if res.log
            else sass_report.report())
    packed = [r for r in sass if "matmul_kernel" in r.name]
    for r in packed:
        log(f"[build] {kernel_name(r.name)} {r.name}: {r.registers} registers, "
            f"{r.stack} bytes stack frame, spills {r.spill_stores}/"
            f"{r.spill_loads} bytes, {r.i2f} I2F of {r.instructions} SASS "
            f"instructions")
    if len(packed) != 36 or any(r.stack or r.spill_stores or r.spill_loads
                                or r.i2f for r in packed):
        raise RuntimeError(f"packed products: want 36 kernels with no stack "
                           f"frame, no spills and no I2F, got {len(packed)}")
    dense = [r for r in sass if "seanet_res_" in r.name]
    snac_unit = [r for r in sass if "snac_res_1x1" in r.name
                 or "snac_dw" in r.name]
    for r in dense + snac_unit:
        half = ("bf16" if "bfloat16" in r.name else
                "f16" if "6__half" in r.name else None)
        product = "snac_dw" not in r.name
        log(f"[build] {kernel_name(r.name)} {half or 'f32'} "
            f"{r.name}: {r.registers} registers, {r.stack} bytes stack frame, "
            f"spills {r.spill_stores}/{r.spill_loads} bytes, {r.hgmma} HGMMA, "
            f"{r.hmma} HMMA of {r.instructions} SASS instructions")
        if r.stack or r.spill_stores or r.spill_loads or (
                half and product and (not r.hgmma or r.hmma)):
            raise RuntimeError(f"{r.name}: want no stack frame, no spills "
                               f"and, in a bf16 or f16 product, HGMMA and no "
                               f"HMMA")
    if len(dense) != DENSE_KERNELS or len(snac_unit) != SNAC_UNIT_KERNELS:
        raise RuntimeError(f"seanet_res / SNAC's unit: want {DENSE_KERNELS} "
                           f"/ {SNAC_UNIT_KERNELS} kernels, got {len(dense)} "
                           f"/ {len(snac_unit)}")
    # the split-f32 kernels (csrc/tf32x3.cuh): attention in f32 and bf16 at
    # D 64 and 128 on mma.sync (HMMA, no HGMMA), the RVQ search at 32, 16
    # and 8 frames on wgmma (HGMMA, no HMMA)
    split = [r for r in sass if "flash_sdpa_window_kernel" in r.name
             or "rvq_encode_kernel" in r.name]
    for r in split:
        log(f"[build] {kernel_name(r.name)} {r.name}: {r.registers} registers, "
            f"{r.stack} bytes stack frame, spills {r.spill_stores}/"
            f"{r.spill_loads} bytes, {r.hmma} HMMA, {r.hgmma} HGMMA of "
            f"{r.instructions} SASS instructions")
        wgmma = "rvq_encode_kernel" in r.name
        if r.stack or r.spill_stores or r.spill_loads or not (
                r.hgmma if wgmma else r.hmma) or (r.hmma if wgmma else r.hgmma):
            raise RuntimeError(f"{r.name}: want no stack frame, no spills, and "
                               f"{'HGMMA and no HMMA' if wgmma else 'HMMA and no HGMMA'}")
    if len(split) != SPLIT_KERNELS:
        raise RuntimeError(f"flash_sdpa_window / rvq_encode: want "
                           f"{SPLIT_KERNELS} kernels, got {len(split)}")
    smem = seanet_cuda.smem_per_block(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[build] opt-in shared memory per block: {smem} bytes, {sms} SMs")
    for frames in rvq_cuda.FRAMES:
        log(f"[build] rvq_encode_fused F{frames}: "
            f"{rvq_cuda.held_clusters(0, frames, 256)} clusters of "
            f"{rvq_cuda.CLUSTER} held at once (D 256; the plan assumes "
            f"{rvq_cuda.HELD} at 16 and 32 frames)")

    # -- 3. kernels against their plain versions ------------------------------
    log(f"[phase] 3 starts at {time.monotonic() - t_start:.1f} s")
    max_err = {name: 0.0 for name in wrappers}
    cases = [(s, torch.float32) for s in ATTN_SHAPES_F32]
    cases += [(ATTN_SHAPE_BF16, dt) for dt in HALF_DTYPES]
    cases += [(s, dt) for s in MOSS_ATTN_SHAPES
              for dt in (torch.float32, *HALF_DTYPES)]
    cases += [(MOSS_LONG_ATTN, dt) for dt in (torch.float32, torch.bfloat16)]
    for i, ((b, h, t, d, w), dtype) in enumerate(cases):
        q, k, v = (randn((b, h, t, d), dtype, SEED + 3 * i + j) for j in range(3))
        got = settled(f"flash_sdpa_window B{b} H{h} T{t} D{d} {dtype}",
                      flash_sdpa_window(q, k, v, window=w))
        want = settled("its plain version",
                       flash_sdpa_window_ref(q, k, v, window=w))
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **ATTN_F32_TOL)
            max_err["flash_sdpa_window"] = max(max_err["flash_sdpa_window"], err)
            bound = "atol 2e-5 rtol 1e-5"
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=ATTN_BF16_ATOL, rtol=0)
            bound = f"atol {ATTN_BF16_ATOL}"
        log(f"[kernel] flash_sdpa_window B{b} H{h} T{t} D{d} window={w} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} ({bound}) ok")
    # with carried keys (a streaming step), at the shapes the sessions give it
    stream_attn_err = 0.0
    for i, ((b, h, tq, tk, d, w, ks), dtype) in enumerate(
            (s, dt) for s in STREAM_ATTN_SHAPES
            for dt in (torch.float32, *HALF_DTYPES)):
        q = randn((b, h, tq, d), dtype, SEED + 300 + 3 * i)
        k, v = (randn((b, h, tk, d), dtype, SEED + 301 + 3 * i + j)
                for j in range(2))
        got = settled(f"flash_sdpa_window carried keys Tq{tq} Tk{tk} D{d} "
                      f"{dtype}", flash_sdpa_window(q, k, v, window=w,
                                                    k_start=ks))
        want = settled("its plain version", flash_sdpa_window_ref(
            q, k, v, window=w, k_start=ks))
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **ATTN_F32_TOL)
            stream_attn_err = max(stream_attn_err, err)
            bound = "atol 2e-5 rtol 1e-5"
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=ATTN_BF16_ATOL, rtol=0)
            bound = f"atol {ATTN_BF16_ATOL}"
        log(f"[kernel] flash_sdpa_window carried keys B{b} H{h} Tq{tq} Tk{tk} "
            f"D{d} window={w} k_start={ks} {str(dtype)[6:]}: max abs err "
            f"{err:.3e} ({bound}) ok")
    max_err["flash_sdpa_window (carried keys)"] = stream_attn_err
    log(f"[phase] 3: the attention checked at {time.monotonic() - t_start:.1f} s")

    def hold(name, label, got, want_f32, dtype, bf16_bounds):
        """The seanet bounds (see UNIT_SHAPES); want_f32 is the plain
        version in f32 (`got` settled where it was launched). The
        comparison runs in float64 on the card: over tens of millions of
        outputs NumPy's took seconds a check on the host."""
        settled(f"the plain version of {name} {label}")
        g, w = got.double(), want_f32.double()
        diff, mag = (g - w).abs(), w.abs()
        err, peak = diff.max().item(), mag.max().item()
        gc, wc = g - g.mean(), w - w.mean()
        c = float(torch.sum(gc * wc) / torch.sqrt(torch.sum(gc * gc)
                                                  * torch.sum(wc * wc)))
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name} {label}: non-finite output")
        if dtype == torch.float32:
            if not (err <= 1e-4 * peak and c > 0.99999):
                raise RuntimeError(f"{name} {label}: max abs err {err} "
                                   f"(peak {peak}), corr {c}")
            max_err[name] = max(max_err[name], err)
            bound = "max err <= 1e-4 peak, corr > 0.99999"
        else:
            # np.testing.assert_allclose's test: |g - w| <= atol + rtol·|w|
            over = diff - bf16_bounds["atol"] - bf16_bounds["rtol"] * mag
            margin = over.max().item()
            if margin > 0:
                raise RuntimeError(
                    f"{name} {label}: {int((over > 0).sum())} outputs past "
                    f"rtol {bf16_bounds['rtol']} atol {bf16_bounds['atol']}"
                    f" (worst by {margin})")
            if not c > bf16_bounds["corr"]:
                raise RuntimeError(f"{name} {label}: corr {c}")
            bound = (f"rtol {bf16_bounds['rtol']} atol {bf16_bounds['atol']}"
                     f" corr > {bf16_bounds['corr']}; worst margin {margin:.4f}")
        log(f"[kernel] {name} {label}: max abs err {err:.3e} (peak "
            f"{peak:.3f}), corr {c:.9f} ({bound}) ok")

    for dtype in (torch.float32, *HALF_DTYPES):
        for i, (b, t, c, d) in enumerate(UNIT_SHAPES):
            p = res_params(1, c, dtype, SEED + 10 + i)
            x = randn((b, t, c), dtype, SEED + 20 + i)
            got = settled(f"seanet_res_unit B{b} T{t} C{c} d{d} {dtype}",
                          seanet_res_unit(x, *unit_args(p), dilation=d))
            with f32_precision(True):
                want = seanet_cuda.seanet_res_unit_ref(
                    x.float(), *(a.float() for a in unit_args(p)), dilation=d)
            hold("seanet_res_unit", f"B{b} T{t} C{c} d{d} {str(dtype)[6:]}",
                 got, want, dtype, UNIT_BF16)
        for i, (b, t, c) in enumerate(CHAIN_SHAPES):
            p = res_params(3, c, dtype, SEED + 30 + i)
            x = randn((b, t, c), dtype, SEED + 40 + i)
            got = settled(f"seanet_res_chain B{b} T{t} C{c} {dtype}",
                          seanet_res_chain(x, **p, dilations=DILATIONS))
            with f32_precision(True):
                want = seanet_cuda.seanet_res_chain_ref(
                    x.float(), **{k: v.float() for k, v in p.items()},
                    dilations=DILATIONS)
            hold("seanet_res_chain", f"B{b} T{t} C{c} {str(dtype)[6:]}",
                 got, want, dtype, CHAIN_BF16)
            del x, got, want
        for i, (b, t, c) in enumerate(SNAC_SHAPES):
            p = dw_params(3, c, dtype, SEED + 70 + i)
            if c >= 64 and not (p["a1s"] < 0).any():
                raise RuntimeError("snac_res_chain: no negative alpha drawn")
            x = randn((b, t, c), dtype, SEED + 80 + i, scale=0.3)
            with f32_precision(True):
                want = seanet_cuda.snac_res_chain_ref(
                    x.float(), **{k: v.float() for k, v in p.items()},
                    dilations=DILATIONS)
            forms = [("N=1 x3", lambda: seanet_cuda.snac_res_units(
                x, **p, dilations=DILATIONS))]
            # SNAC's chain kernel (N > 1, on no request path) is f32/bf16
            if dtype != torch.float16 and seanet_cuda.dw_chain_tile(
                    c, 7, DILATIONS, dtype, smem):
                forms.append(("N=3", lambda: snac_res_chain(
                    x, **p, dilations=DILATIONS)))
            for form, run in forms:
                label = f"{form} B{b} T{t} C{c} {str(dtype)[6:]}"
                hold("snac_res_chain", label, settled(
                    f"snac_res_chain {label}", run()), want, dtype, CHAIN_BF16)
            del x, want

    log(f"[phase] 3: the unit and chain shapes checked at "
        f"{time.monotonic() - t_start:.1f} s")
    # the residual units at the DAC and SNAC decoder's and encoder's block
    # shapes (20 s b1), in the launches a request makes (DAC: the gate's
    # chain, or one unit launch per unit, each at the tile unit_tile picks
    # for the shape; SNAC: one N = 1 launch per unit, its 1x1 at the tile
    # snac_tile picks). A
    # chain is held against the plain chain, each unit launch (on the
    # block's input, one per dilation) against the plain unit, at the
    # bounds of the checks above of the same forms
    def unit_by_unit(name, x, p, dtype, label, launch, plain, bounds):
        for u, dil in enumerate(DILATIONS):
            pu = {k: v[u:u + 1] for k, v in p.items()}
            got = settled(f"{name} {label} unit {u + 1} {dtype}",
                          launch(x, pu, dil))
            with f32_precision(True):
                want = plain(x.float(), {k: v.float() for k, v in pu.items()},
                             dil)
            hold(name, f"{label} unit {u + 1} (d={dil}) {str(dtype)[6:]}",
                 got, want, dtype, bounds)
            del got, want

    dac_blocks = ([("decoder", c, t, SEED + 230 + i)
                   for i, (c, t) in enumerate(DAC_DEC_BLOCKS)]
                  + [("encoder", c, t, SEED + 150 + i)
                     for i, (c, t) in enumerate(DAC_ENC_BLOCKS)])
    for dtype in (torch.float32, *HALF_DTYPES):
        # f16 at the decoder blocks: this run's f16 requests are decodes
        blocks_of = (lambda bl: [x for x in bl if x[0] == "decoder"]) \
            if dtype == torch.float16 else (lambda bl: bl)
        for where, c, t, seed in blocks_of(dac_blocks):
            p = res_params(3, c, dtype, seed)
            x = randn((1, t, c), dtype, seed + 10)
            label = f"DAC {where} block C{c} T{t}"
            if seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem):
                with f32_precision(True):
                    want = seanet_cuda.seanet_res_chain_ref(
                        x.float(), **{k: v.float() for k, v in p.items()},
                        dilations=DILATIONS)
                hold("seanet_res_chain", f"{label} as the chain "
                     f"{str(dtype)[6:]}", settled(
                         f"seanet_res_chain {label} {dtype}", seanet_res_chain(
                             x, **p, dilations=DILATIONS)),
                     want, dtype, CHAIN_BF16)
                del want
            else:
                unit_by_unit(
                    "seanet_res_unit", x, p, dtype, label,
                    lambda y, pu, dil: seanet_res_unit(
                        y, *unit_args(pu), dilation=dil),
                    lambda y, pu, dil: seanet_cuda.seanet_res_unit_ref(
                        y, *unit_args(pu), dilation=dil), UNIT_BF16)
            del x
        snac_blocks = ([("decoder", c, t, SEED + 240 + i)
                        for i, (c, t) in enumerate(SNAC_BLOCKS)]
                       + [("encoder", c, t, SEED + 170 + i)
                          for i, (c, t) in enumerate(SNAC_ENC_BLOCKS)])
        for where, c, t, seed in blocks_of(snac_blocks):
            p = dw_params(3, c, dtype, seed)
            x = randn((1, t, c), dtype, seed + 10, scale=0.3)
            tile = seanet_cuda.snac_tile(c, dtype, t, 1, sms)
            unit_by_unit(
                "snac_res_chain", x, p, dtype,
                f"SNAC {where} block C{c} T{t} (1x1 tile {tile[0]}x{tile[1]})",
                lambda y, pu, dil: snac_res_chain(y, **pu, dilations=(dil,)),
                lambda y, pu, dil: seanet_cuda.snac_res_chain_ref(
                    y, **pu, dilations=(dil,)), CHAIN_BF16)
            del x

    # the RVQ search: integer-valued inputs, also with duplicated rows, bit
    # for bit; normal inputs under the near-tie rule, V = 5 with frames
    # near 0. Its
    # codes have no error in size: its max_abs_err is the largest relative
    # distance margin at a frame where its codes differ (0.0: none differ)
    log(f"[phase] 3: the DAC and SNAC block shapes checked at "
        f"{time.monotonic() - t_start:.1f} s")
    rvq_cases = [(shape, kind) for shape in RVQ_SHAPES
                 for kind in ("int", "dup", "normal")]
    rvq_cases += [((1, 300, 64, 3, 5), "tiny"), (RVQ_ISTFT_SHAPES[0], "seam")]
    for i, ((b, t, d, n_q, v), kind) in enumerate(rvq_cases):
        x, cb = rvq_inputs(b, t, d, n_q, v, kind, SEED + 190 + i)
        got = rvq_encode_fused(x, cb).cpu().numpy().reshape(b * t, n_q)
        want = rvq_encode(x, cb).cpu().numpy().reshape(b * t, n_q)
        label = f"rvq_encode_fused N{b * t} D{d} n_q{n_q} V{v} {kind}"
        if got.min() < 0 or got.max() >= (v // 2 if kind == "dup" else v) \
                or (kind == "seam" and (got % -(-v // 8)).max() >= 256):
            raise RuntimeError(f"{label}: a code past V or past the lower "
                               f"copy of a duplicated row")
        if kind in ("int", "dup", "seam"):
            if not np.array_equal(got, want):
                raise RuntimeError(f"{label}: {(got != want).sum()} codes "
                                   f"differ from the plain version's")
            note = "equal to the plain version's bit for bit"
        else:
            x64, cb64 = f64(x).reshape(b * t, d), f64(cb)
            ties = near_ties(got, want, lambda fr, q: euclid_margin(
                x64[fr], cb64, want[fr, :q], got[fr, q], want[fr, q]))
            max_err["rvq_encode_fused"] = max(
                [max_err["rvq_encode_fused"]] + [abs(m) for _, _, m in ties])
            note = ("equal to the plain version's" if not ties else
                    f"{len(ties)} frames differ, each a near-tie (margins "
                    f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
        log(f"[kernel] {label}: codes {note} ok")
        del x, cb

    # the packed products: each backbone shape, m = 1/16/32 in f32 and m = 1
    # in bf16 against the plain version, then 32 one-hot rows (bit-exact)
    def packed_product(name, x, qt):
        if name == "q8_0_matmul":
            return q8_0_matmul(x, qt["qs"], qt["scale"])
        return q4_k_matmul(x, qt["qs"], qt["scale"], qt["minv"])

    qrng = np.random.default_rng(SEED + 110)
    qmat_weights = {}
    for out_d, in_d in QMAT_SHAPES:
        w = qrng.standard_normal((out_d, in_d), dtype=np.float32) * 0.02
        for name, quantize, pack in (
                ("q8_0_matmul", quantize_q8_0, qmat.pack_q8_0),
                ("q4_k_matmul", quantize_q4_k, qmat.pack_q4_k)):
            qt = qmat.to_device(pack(np.frombuffer(quantize(w), np.uint8),
                                     w.shape), "cuda")
            qmat_weights[name, out_d, in_d] = qt
            dense = qmat.dequant_ref(qt)
            for m in QMAT_MS:
                for dtype in (torch.float32, torch.bfloat16)[:2 if m == 1 else 1]:
                    x = randn((m, in_d), dtype, SEED + 120 + m)
                    got = packed_product(name, x, qt)
                    want = x.float() @ dense.T
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    peak = want.abs().max().item()
                    if not (got.dtype == torch.float32 and err <= 1e-4 * peak):
                        raise RuntimeError(f"{name} {out_d}x{in_d} m{m} "
                                           f"{dtype}: max abs err {err} "
                                           f"(peak {peak})")
                    max_err[name] = max(max_err[name], err)
                    log(f"[kernel] {name} out {out_d} in {in_d} m{m} "
                        f"{str(dtype)[6:]}: max abs err {err:.3e} (peak "
                        f"{peak:.3f}; bound 1e-4 peak) ok")
            cols = torch.from_numpy(qrng.choice(in_d, 32, replace=False)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.zeros((32, in_d), dtype=dtype, device="cuda")
                x[torch.arange(32, device="cuda"), cols] = 1
                if not torch.equal(packed_product(name, x, qt), dense[:, cols].T):
                    raise RuntimeError(f"{name} {out_d}x{in_d} {dtype}: one-hot "
                                       f"rows do not give the dequantized "
                                       f"weights bit for bit")
            log(f"[kernel] {name} out {out_d} in {in_d}: 32 one-hot rows give "
                f"the dequantized weights bit for bit, f32 and bf16 x")
            del dense

    # -- 4, 5. full-width models through load_model ---------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        paths = {name: Path(tmp.name) / f"{name}_random.gguf"
                 for name in ("mimi", "dac", "snac")}
        t0 = time.monotonic()
        write_random_mimi_gguf(paths["mimi"], seed=SEED, encoder=True)
        write_random_dac_gguf(paths["dac"], seed=SEED, encoder=True)
        write_random_snac_gguf(paths["snac"], seed=SEED, encoder=True)
        log("[model] wrote " + ", ".join(
            f"{path.name} ({path.stat().st_size / 2**20:.1f} MiB)"
            for path in paths.values())
            + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        mimi_models, dac_models, snac_models = (
            {dt: codec_tpu_torch.load_model(paths[name], compute_dtype=dt,
                                            device="cuda")
             for dt in ("float32", "bfloat16", "float16")}
            for name in ("mimi", "dac", "snac"))
        torch.cuda.synchronize()
    finally:
        tmp.cleanup()
    cfg = mimi_models["float32"].cfg
    dcfg = dac_models["float32"].cfg
    widths = [blk["units"]["w1"].shape[-1]
              for blk in dac_models["float32"].params["dec_blocks"]]
    scfg = snac_models["float32"].cfg
    snac_widths = [blk["units"]["w1"].shape[-1]
                   for blk in snac_models["float32"].params["dec_blocks"]]
    log(f"[model] load_model Mimi + DAC + SNAC, f32 + bf16 + f16, in "
        f"{time.monotonic() - t0:.2f} s")
    log(f"[model] Mimi: hidden {cfg.hidden}, {cfg.n_layers} layers, "
        f"{cfg.n_heads} heads x {cfg.head_dim}, mlp {cfg.intermediate}, "
        f"{cfg.n_q} codebooks x {cfg.codebook_size} x {cfg.codebook_dim}, "
        f"window {cfg.window}")
    log(f"[model] DAC: latent {dcfg.latent_dim}, block widths {widths}, hop "
        f"{dcfg.hop_size}, {dcfg.n_q} codebooks x {dcfg.codebook_size} x "
        f"{dcfg.codebook_dim}, {dcfg.sample_rate} Hz")
    log(f"[model] SNAC: latent {scfg.latent_dim}, block widths {snac_widths}, "
        f"rates {scfg.decoder_rates}, hop {scfg.hop_size}, {scfg.n_q} "
        f"codebooks x {scfg.codebook_size} x {scfg.codebook_dim} at strides "
        f"{scfg.vq_strides}, {scfg.sample_rate} Hz")

    rng = np.random.default_rng(SEED)

    def requests(spec, models, mcfg, multiple=1):
        out = []
        for name, secs, batch, dt in spec:
            frames = secs * mcfg.sample_rate // mcfg.hop_size
            frames -= frames % multiple
            codes = rng.integers(0, mcfg.codebook_size,
                                 (batch, frames, mcfg.n_q)).astype(np.int32)
            out.append((name, secs, batch, models[dt], codes))
        return out

    mimi_reqs = requests(MIMI_REQUESTS, mimi_models, cfg)
    dac_reqs = requests(DAC_REQUESTS, dac_models, dcfg)
    snac_reqs = requests(SNAC_REQUESTS, snac_models, scfg,
                         multiple=scfg.vq_strides[0])

    # -- 4. the Mimi path ------------------------------------------------------
    log(f"[phase] 4 starts at {time.monotonic() - t_start:.1f} s")
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in mimi_reqs:
        before = flash_sdpa_window.launches
        outs[name] = model.decode(codes)
        step = flash_sdpa_window.launches - before
        if step != MIMI_LAYERS:
            raise RuntimeError(f"mimi {name}: {step} kernel launches, want "
                               f"{MIMI_LAYERS}")
    mimi_counts = counts()
    want_counts = {**none, "flash_sdpa_window": MIMI_LAYERS * len(mimi_reqs)}
    if mimi_counts != want_counts:
        raise RuntimeError(f"Mimi path launches {mimi_counts}, want {want_counts}")
    log(f"[mimi] main path launches: {mimi_counts} over {len(mimi_reqs)} "
        f"decodes ({MIMI_LAYERS} per decode)")

    def plain_mimi(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = mimi_decode_fn(model.params, c, model.cfg,
                                 attention=flash_sdpa_window_ref)
        return pcm.float().cpu().numpy()

    for name, secs, batch, model, codes in mimi_reqs:
        pcm = outs[name]
        want_shape = (batch, codes.shape[1] * cfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"mimi {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"mimi {name}: non-finite samples")
        line = (f"[mimi] {name}: pcm {pcm.shape} finite, peak "
                f"{np.abs(pcm).max():.4f}")
        if model.compute_dtype == torch.float32:
            ref = plain_mimi(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"mimi {name}: corr {c} vs plain attention")
            line += (f"; vs plain attention on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, mimi_models['float32'].decode(codes)):.6f}")
        if model.compute_dtype == torch.float16:
            c = corr(pcm, plain_mimi(model, codes))
            if not c > CHAIN_BF16["corr"]:
                raise RuntimeError(f"mimi {name}: corr {c} vs plain attention")
            line += (f"; vs plain attention in f16 on the card: corr "
                     f"{c:.9f}")
        log(line)

    # -- 5. the DAC path -------------------------------------------------------
    log(f"[phase] 5 starts at {time.monotonic() - t_start:.1f} s")
    plan, per_decode = {}, {}
    for dtype in (torch.float32, *HALF_DTYPES):
        plan[dtype] = [seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem)
                       for c in widths]
        per_decode[dtype] = {
            **none, "seanet_res_unit": 3 * sum(not t for t in plan[dtype]),
            "seanet_res_chain": sum(plan[dtype])}
        tiles = [seanet_cuda.chain_tile(c, 7, DILATIONS, dtype, smem)
                 for c in widths]
        log(f"[dac] gate at {smem} bytes, {str(dtype)[6:]}: widths {widths}, "
            f"chain tiles {tiles}, chain taken {plan[dtype]} (16-bit where "
            f"all 512 rows fit); launches per decode "
            f"{per_decode[dtype]}")
    n_latent = dcfg.sample_rate * 20 // dcfg.hop_size
    latent = np.random.default_rng(SEED + 1).standard_normal(
        (n_latent, dcfg.latent_dim)).astype(np.float32)
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in dac_reqs:
        before = counts()
        outs[name] = model.decode(codes)
        step = {k: v - before[k] for k, v in counts().items()}
        if step != per_decode[model.compute_dtype]:
            raise RuntimeError(f"dac {name}: launches {step}, want "
                               f"{per_decode[model.compute_dtype]}")
    before = counts()
    lat_pcm = dac_models["float32"].decode_latent(latent)
    step = {k: v - before[k] for k, v in counts().items()}
    dac_counts = counts()
    if step != per_decode[torch.float32]:
        raise RuntimeError(f"dac decode_latent: launches {step}, want "
                           f"{per_decode[torch.float32]}")
    log(f"[dac] main path launches: {dac_counts} over {len(dac_reqs)} decodes "
        f"and 1 decode_latent")

    def plain_dac(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = dac.dac_decode_fn(model.params, c, model.cfg,
                                    res_units=dac.plain_res_units)
        return pcm.float().cpu().numpy()

    n_out = lambda frames: dcfg.hop_size * frames - 8     # rates 8/5/4/2
    if lat_pcm.shape != (n_out(n_latent),) or not np.isfinite(lat_pcm).all():
        raise RuntimeError(f"dac decode_latent: pcm {lat_pcm.shape}, finite "
                           f"{np.isfinite(lat_pcm).all()}")
    log(f"[dac] decode_latent 20s_b1_f32: pcm {lat_pcm.shape} finite")
    for name, secs, batch, model, codes in dac_reqs:
        pcm = outs[name]
        want_shape = (batch, n_out(codes.shape[1]))
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"dac {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"dac {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        line = (f"[dac] {name}: pcm {pcm.shape} finite, peak "
                f"{np.abs(pcm).max():.4f}, std {pcm.std():.4f}, share "
                f"|pcm| > 0.99: {sat:.2e}")
        if model.compute_dtype == torch.float32:
            if not sat < 0.01:
                raise RuntimeError(f"dac {name}: {sat:.2%} of samples saturated")
            ref = plain_dac(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"dac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, dac_models['float32'].decode(codes)):.6f}")
        if model.compute_dtype == torch.float16:
            c = corr(pcm, plain_dac(model, codes))
            if not c > CHAIN_BF16["corr"]:
                raise RuntimeError(f"dac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units in f16 on the card: corr "
                     f"{c:.9f}")
        log(line)
    del outs

    # -- 6. the SNAC path ------------------------------------------------------
    log(f"[phase] 6 starts at {time.monotonic() - t_start:.1f} s")
    # the gate (seanet_cuda.snac_res_units): one N = 1 launch per unit
    snac_per_decode = {**none,
                       "snac_res_chain": len(DILATIONS) * len(snac_widths)}
    log(f"[snac] gate: one N=1 launch per unit at widths {snac_widths}; "
        f"launches per decode {snac_per_decode}")
    outs = {}
    zero_counts()
    for name, secs, batch, model, codes in snac_reqs:
        before = counts()
        outs[name] = model.decode(codes)
        step = {k: v - before[k] for k, v in counts().items()}
        if step != snac_per_decode:
            raise RuntimeError(f"snac {name}: launches {step}, want "
                               f"{snac_per_decode}")
    snac_counts = counts()
    log(f"[snac] main path launches: {snac_counts} over {len(snac_reqs)} "
        f"decodes")

    def plain_snac(model, codes):
        c = torch.from_numpy(codes.astype(np.int64)).cuda()
        with torch.inference_mode(), f32_precision(True):
            pcm = snac.snac_decode_fn(model.params, c, model.cfg,
                                      res_units=snac.plain_res_units)
        return pcm.float().cpu().numpy()

    for name, secs, batch, model, codes in snac_reqs:
        pcm = outs[name]
        want_shape = (batch, codes.shape[1] * scfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32:
            raise RuntimeError(f"snac {name}: pcm {pcm.shape} {pcm.dtype}, "
                               f"want {want_shape} float32")
        if not np.isfinite(pcm).all():
            raise RuntimeError(f"snac {name}: non-finite samples")
        sat = float((np.abs(pcm) > 0.99).mean())
        line = (f"[snac] {name}: {codes.shape[1]} frames -> pcm {pcm.shape} "
                f"finite, peak {np.abs(pcm).max():.4f}, std {pcm.std():.4f}, "
                f"share |pcm| > 0.99: {sat:.2e}")
        if model.compute_dtype == torch.float32:
            if not sat < 0.01:
                raise RuntimeError(f"snac {name}: {sat:.2%} of samples saturated")
            ref = plain_snac(model, codes)
            c = corr(pcm, ref)
            rel = np.abs(pcm - ref).max() / np.abs(ref).max()
            if not c > 0.99999:
                raise RuntimeError(f"snac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units on the card: corr {c:.9f}, "
                     f"max rel err {rel:.3e}")
        else:
            line += (f"; vs the f32 model: corr "
                     f"{corr(pcm, snac_models['float32'].decode(codes)):.6f}")
        if model.compute_dtype == torch.float16:
            c = corr(pcm, plain_snac(model, codes))
            if not c > CHAIN_BF16["corr"]:
                raise RuntimeError(f"snac {name}: corr {c} vs plain res units")
            line += (f"; vs plain res units in f16 on the card: corr "
                     f"{c:.9f}")
        log(line)
    del outs

    # -- 7. encode --------------------------------------------------------------
    log(f"[phase] 7 starts at {time.monotonic() - t_start:.1f} s")
    enc_models = {"mimi": mimi_models, "dac": dac_models, "snac": snac_models}
    enc_widths = {arch: [blk["units"]["w1"].shape[-1]
                         for blk in enc_models[arch]["float32"].params["enc_blocks"]]
                  for arch in ("dac", "snac")}
    enc_per = {}
    for dtype in (torch.float32, torch.bfloat16):
        chains = [seanet_cuda.use_chain(c, 7, DILATIONS, dtype, smem)
                  for c in enc_widths["dac"]]
        enc_per["mimi", dtype] = {**none, "flash_sdpa_window": MIMI_LAYERS,
                                  "rvq_encode_fused": 2}
        enc_per["dac", dtype] = {
            **none, "seanet_res_unit": 3 * sum(not c for c in chains),
            "seanet_res_chain": sum(chains)}
        enc_per["snac", dtype] = {
            **none, "snac_res_chain": len(DILATIONS) * len(enc_widths["snac"])}
        log(f"[encode] {str(dtype)[6:]}: DAC encoder widths "
            f"{enc_widths['dac']}, chain taken {chains}; SNAC encoder widths "
            f"{enc_widths['snac']}; launches per encode: mimi "
            f"{enc_per['mimi', dtype]}, dac {enc_per['dac', dtype]}, snac "
            f"{enc_per['snac', dtype]}")
    # the gate takes the chain only where it measured fastest, or lost least
    # (PERF.md); some DAC decode or encode must still run each kernel
    for name in ("seanet_res_unit", "seanet_res_chain"):
        if not any(plan[name] for plan in [*per_decode.values(), *(
                enc_per["dac", dt] for dt in (torch.float32, torch.bfloat16))]):
            raise RuntimeError(f"the gate runs {name} on no DAC decode or "
                               f"encode")
    enc_rng = np.random.default_rng(SEED + 200)
    enc_reqs = []
    for arch, name, secs, batch, dt in ENCODE_REQUESTS:
        model = enc_models[arch][dt]
        if not model.has_encoder:
            raise RuntimeError(f"{arch}: the random file holds no encoder")
        pcm = (enc_rng.standard_normal((batch, secs * model.sample_rate))
               * 0.3).astype(np.float32)
        enc_reqs.append((arch, name, secs, batch, model, pcm))
    enc_counts, enc_outs = dict(none), {}
    for arch, name, secs, batch, model, pcm in enc_reqs:
        zero_counts()
        enc_outs[arch, name] = model.encode(pcm)
        step = counts()
        if step != enc_per[arch, model.compute_dtype]:
            raise RuntimeError(f"{arch} encode {name}: launches {step}, want "
                               f"{enc_per[arch, model.compute_dtype]}")
        enc_counts = {k: v + step[k] for k, v in enc_counts.items()}
    log(f"[encode] main path launches: {enc_counts} over {len(enc_reqs)} "
        f"encodes")

    def plain_encode(arch, model, pcm):
        """The plain path on the card (plain attention, plain RVQ, plain
        residual units) → (latent f64 [B, T, C], codes [B, T, Q])."""
        x = torch.from_numpy(pcm).cuda()
        with torch.inference_mode(), f32_precision(True):
            if arch == "mimi":
                lat = mimi.mimi_encode_latent_fn(
                    model.params, x, model.cfg, attention=flash_sdpa_window_ref)
                codes = mimi.mimi_quantize(model.params, lat, model.cfg,
                                           quantize=rvq_encode)
            elif arch == "dac":
                lat = dac.dac_encode_latent_fn(model.params, x, model.cfg,
                                               res_units=dac.plain_res_units)
                codes = dac.dac_quantize(model.params["vq"], lat,
                                         model.cfg.n_q)
            else:
                lat = snac.snac_encode_latent_fn(
                    model.params, x, model.cfg, res_units=snac.plain_res_units)
                codes = snac.snac_quantize(model.params["vq"], lat, model.cfg)
            return f64(lat), codes.cpu().numpy()

    def encode_margin(arch, model, lat, want, got):
        """margin_fn (near_ties) at one batch row: lat [T, C] f64."""
        p, mcfg = model.params, model.cfg
        if arch == "mimi":
            return mimi_margin(p, mcfg, lat, want, got)
        vq = {k: f64(v) for k, v in p["vq"].items()}
        if arch == "dac":
            def margin(fr, q):
                r = lat[fr]
                for lvl in range(q):
                    r = r - (vq["out_w"][lvl] @ vq["cb"][lvl][want[fr, lvl]]
                             + vq["out_b"][lvl])
                return cosine_margin(vq["in_w"][q] @ r + vq["in_b"][q],
                                     vq["cb"][q], got[fr, q], want[fr, q])
            return margin

        def margin(fr, q):
            res = lat
            for lvl in range(q):
                s_ = mcfg.vq_strides[lvl]
                zq = vq["cb"][lvl][want[::s_, lvl]] @ vq["out_w"][lvl].T \
                    + vq["out_b"][lvl]
                res = res - np.repeat(zq, s_, axis=0)
            s_ = mcfg.vq_strides[q]
            pooled = res.reshape(-1, s_, res.shape[-1]).mean(axis=1)
            return cosine_margin(vq["in_w"][q] @ pooled[fr // s_]
                                 + vq["in_b"][q], vq["cb"][q], got[fr, q],
                                 want[fr, q])
        return margin

    for arch, name, secs, batch, model, pcm in enc_reqs:
        codes = enc_outs[arch, name]
        n = pcm.shape[1]
        if arch == "mimi":
            frames = -(-n // model.hop_size)
        elif arch == "dac":
            frames = n // model.hop_size
        else:
            frames = -(-n // model.cfg.pad_to) * model.cfg.pad_to // model.hop_size
        want_shape = (batch, frames, model.n_q)
        if codes.shape != want_shape or codes.dtype != np.int32:
            raise RuntimeError(f"{arch} encode {name}: codes {codes.shape} "
                               f"{codes.dtype}, want {want_shape} int32")
        if codes.min() < 0 or codes.max() >= model.codebook_size:
            raise RuntimeError(f"{arch} encode {name}: codes out of range")
        distinct = [len(np.unique(codes[..., q])) for q in range(model.n_q)]
        line = (f"[encode] {arch} {name}: codes {codes.shape} in range, "
                f"distinct codes per level {distinct[:4]}"
                f"{'...' if len(distinct) > 4 else ''}")
        if model.compute_dtype == torch.float32:
            x = pcm if arch != "snac" else np.pad(
                pcm, ((0, 0), (0, frames * model.hop_size - n)))
            lat, want = plain_encode(arch, model, x)
            ties = [t for bi in range(batch) for t in near_ties(
                codes[bi], want[bi],
                encode_margin(arch, model, lat[bi], want[bi], codes[bi]))]
            line += ("; equal to the plain path's on the card" if not ties
                     else f"; vs the plain path on the card: {len(ties)} "
                     f"frames differ, each a near-tie (margins "
                     f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
            if batch == 1:
                pcm_out = model.decode(codes)
                if not np.isfinite(pcm_out).all():
                    raise RuntimeError(f"{arch}: encode → decode gave "
                                       f"non-finite samples")
                line += (f"; encode → decode round trip: pcm "
                         f"{pcm_out.shape} finite")
        log(line)

    # -- 8. the Mimi streaming sessions, decode_many and decode_async ----------
    log(f"[phase] 8 starts at {time.monotonic() - t_start:.1f} s")
    # every push of a session makes exactly the step's launches; the
    # attention launches of the sessions (carried keys) are the kernels
    # line's second attention row
    t0 = time.monotonic()
    dec_step = {**none, "flash_sdpa_window": MIMI_LAYERS}
    enc_step = {**none, "flash_sdpa_window": MIMI_LAYERS, "rvq_encode_fused": 2}
    srng = np.random.default_rng(SEED + 400)
    stream_codes, stream_pcm, stream_launches = {}, {}, 0

    for name, secs, batch, dt, chunk in STREAM_DECODES:
        model = mimi_models[dt]
        frames = secs * cfg.sample_rate // cfg.hop_size
        codes = srng.integers(0, cfg.codebook_size,
                              (batch, frames, cfg.n_q)).astype(np.int32)
        stream_codes[name] = codes
        pcm, read = stream(model.streaming_decoder(batch=batch), codes,
                           chunk, dec_step, 1, counts)
        stream_launches += read["flash_sdpa_window"]
        want_shape = (batch, frames * cfg.hop_size)
        if pcm.shape != want_shape or pcm.dtype != np.float32 \
                or not np.isfinite(pcm).all():
            raise RuntimeError(f"mimi stream {name}: pcm {pcm.shape} "
                               f"{pcm.dtype}, finite {np.isfinite(pcm).all()}")
        full = model.decode(codes)
        sat = float((np.abs(pcm) > 0.99).mean())
        line = (f"[stream] decode {name}: {-(-frames // chunk)} pushes of "
                f"{chunk} frame(s), launches per push {dec_step['flash_sdpa_window']} "
                f"flash_sdpa_window; pcm {pcm.shape} finite, peak "
                f"{np.abs(pcm).max():.4f}, share |pcm| > 0.99 {sat:.2e}")
        if dt == "float32":
            c, err = corr(pcm, full), float(np.abs(pcm - full).max())
            peak = float(np.abs(full).max())
            if not (c > 0.99999 and err <= 1e-4 * peak):
                raise RuntimeError(f"mimi stream {name}: vs the full decode "
                                   f"corr {c}, max abs err {err} (peak {peak})")
            line += (f"; vs the full decode on the card: corr {c:.9f}, max "
                     f"abs err {err:.3e} (peak {peak:.4f}; bound 1e-4 peak)")
        else:
            full_sat = float((np.abs(full) > 0.99).mean())
            if not sat <= full_sat + 0.01:
                raise RuntimeError(f"mimi stream {name}: {sat:.2%} of samples "
                                   f"saturated, the full decode {full_sat:.2%}")
            line += (f"; the full bf16 decode: share |pcm| > 0.99 "
                     f"{full_sat:.2e}, corr {corr(pcm, full):.6f}")
        log(line)

    for name, secs, batch, dt, chunk in STREAM_ENCODES:
        model = mimi_models[dt]
        pcm = (srng.standard_normal((batch, secs * cfg.sample_rate))
               * 0.3).astype(np.float32)
        stream_pcm[name] = pcm
        codes, read = stream(model.streaming_encoder(batch=batch), pcm,
                             chunk * cfg.hop_size, enc_step, 1, counts)
        stream_launches += read["flash_sdpa_window"]
        want = model.encode(pcm)
        if codes.shape != want.shape or codes.dtype != np.int32:
            raise RuntimeError(f"mimi stream encode {name}: codes "
                               f"{codes.shape} {codes.dtype}, want "
                               f"{want.shape} int32")
        with torch.inference_mode(), f32_precision(True):
            lat = f64(mimi.mimi_encode_latent_fn(
                model.params, torch.from_numpy(pcm).cuda(), model.cfg))
        ties = [t for bi in range(batch) for t in near_ties(
            codes[bi], want[bi],
            encode_margin("mimi", model, lat[bi], want[bi], codes[bi]))]
        log(f"[stream] encode {name}: {secs * cfg.sample_rate // (chunk * cfg.hop_size)} "
            f"pushes of {chunk} hop(s), launches per push "
            f"{enc_step['flash_sdpa_window']} flash_sdpa_window + "
            f"{enc_step['rvq_encode_fused']} rvq_encode_fused; codes "
            f"{codes.shape} " + ("equal to the full encode's on the card"
                                 if not ties else
                                 f"vs the full encode: {len(ties)} frames "
                                 f"differ, each a near-tie (margins "
                                 f"{', '.join(f'{m:.1e}' for _, _, m in ties)})"))
    log(f"[stream] main path launches: {stream_launches} flash_sdpa_window "
        f"with carried keys over {len(STREAM_DECODES)} decode and "
        f"{len(STREAM_ENCODES)} encode streams "
        f"({time.monotonic() - t0:.2f} s)")

    # decode_many over three Mimi sequences of two lengths (two decodes), and
    # decode_async + PendingPcm.gather over two DAC requests, each output
    # held to its own decode
    from codec_tpu_torch.runtime.model import PendingPcm

    def held(label, got, want):
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if got.shape != want.shape or not err <= 1e-4 * peak:
            raise RuntimeError(f"{label}: {got.shape} against {want.shape}, "
                               f"max abs err {err} (peak {peak})")
        return f"max abs err {err:.3e} (peak {peak:.4f})"

    seqs = [stream_codes["20s_b1_f32_c1"][0], stream_codes["20s_b1_f32_c5"][0],
            stream_codes["60s_b1_f32_c5"][0, :125]]
    zero_counts()
    many = mimi_models["float32"].decode_many(seqs)
    if counts() != {**none, "flash_sdpa_window": 2 * MIMI_LAYERS}:
        raise RuntimeError(f"decode_many: launches {counts()}")
    log("[runtime] mimi decode_many of 3 sequences (250, 250, 125 frames; "
        "two batched decodes, 16 attention launches): " + "; ".join(
            held(f"decode_many {i}", g, mimi_models["float32"].decode(s))
            for i, (g, s) in enumerate(zip(many, seqs))))
    dac_f32 = dac_models["float32"]
    dseqs = [dac_reqs[0][4][0], dac_reqs[0][4][0, :300]]
    zero_counts()
    pending = [dac_f32.decode_async(s) for s in dseqs]
    gathered = PendingPcm.gather(pending)
    if counts() != {k: 2 * v for k, v in per_decode[torch.float32].items()}:
        raise RuntimeError(f"decode_async: launches {counts()}")
    log(f"[runtime] dac decode_async x2 ({', '.join(str(len(x)) for x in dseqs)} "
        f"frames) + PendingPcm.gather: " + "; ".join(held(f"decode_async {i}", g, dac_f32.decode(s))
                    for i, (g, s) in enumerate(zip(gathered, dseqs))))

    # -- 8b. the iSTFT-head codecs ----------------------------------------------
    log(f"[phase] 8b starts at {time.monotonic() - t_start:.1f} s")
    istft_counts = istft_codecs(name_limit, zero_counts, counts, none)

    # -- 8c. the windowed-transformer codecs -------------------------------------
    log(f"[phase] 8c starts at {time.monotonic() - t_start:.1f} s")
    windowed_counts = windowed_codecs(name_limit, zero_counts, counts, none)

    # -- 8d. the NeuCodec family ------------------------------------------------
    log(f"[phase] 8d starts at {time.monotonic() - t_start:.1f} s")
    neu_codecs(name_limit, zero_counts, counts, none)

    # -- 8e. the last small codecs ----------------------------------------------
    log(f"[phase] 8e starts at {time.monotonic() - t_start:.1f} s")
    small_counts = small_codecs(name_limit, zero_counts, counts, none)

    # -- 8f. Chatterbox S3Gen ---------------------------------------------------
    log(f"[phase] 8f starts at {time.monotonic() - t_start:.1f} s")
    s3g_codec(name_limit, zero_counts, counts, none)

    # -- 9. the CSM TTS path ---------------------------------------------------
    log(f"[phase] 9 starts at {time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tts_")
    try:
        csm_path = write_random_csm_gguf(Path(tmp.name) / "csm_random.gguf",
                                         seed=SEED)
        bb_paths = {q: write_random_backbone_gguf(
            Path(tmp.name) / f"backbone_{q}.gguf", seed=SEED, qtype=q)
            for q in ("Q4_K", "Q8_0")}
        log("[tts] wrote " + ", ".join(
            f"{path.name} ({path.stat().st_size / 2**20:.1f} MiB)"
            for path in [csm_path, *bb_paths.values()])
            + f" in {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        csm = codec_tpu_torch.load_model(csm_path, device="cuda")
        reader = GGUFReader(csm_path)
        lm = create_lm(reader, device="cuda")
        backbones, growth = {}, {}
        for qtype, path in bb_paths.items():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            backbones[qtype] = create_backbone(path, quantized=True,
                                               device="cuda")
            torch.cuda.synchronize()
            growth[qtype] = torch.cuda.memory_allocated() - before
    finally:
        tmp.cleanup()
    bcfg = backbones["Q4_K"].cfg
    log(f"[tts] loaded in {time.monotonic() - t0:.2f} s: backbone hidden "
        f"{bcfg.hidden}, {bcfg.n_layers} layers, {bcfg.n_heads} heads x "
        f"{bcfg.head_dim}, {bcfg.n_kv_heads} KV heads, FFN {bcfg.ffn_dim}, "
        f"vocab {bcfg.vocab_size}, rope_theta {bcfg.rope_theta:g} with llama3 "
        f"factors, max_ctx {bcfg.max_ctx}; adaptor {lm.depth_layers} depth "
        f"layers at {lm.depth_hidden}, {lm.n_heads} heads x {lm.head_dim}, "
        f"{lm.info.n_codebook} codebooks x {lm.info.codebook_sizes[0]}")
    for qtype, bb in backbones.items():
        mats = [v for lw in bb.params["layers"] for v in lw.values()
                if isinstance(v, dict)]
        if len(mats) != 7 * bcfg.n_layers:
            raise RuntimeError(f"{qtype} backbone: {len(mats)} packed "
                               f"matrices, want {7 * bcfg.n_layers}")
        packed = sum(t.numel() * t.element_size() for qt in mats
                     for t in qt.values())
        emb = bb.params["tok_embd"]
        log(f"[tts] {qtype} backbone load added {growth[qtype] / 1e9:.3f} GB "
            f"on the card (packed matrices {packed / 1e9:.3f}, f32 tok_embd "
            f"{emb.numel() * emb.element_size() / 1e9:.3f}, KV cache "
            f"{bb.kv.numel() * bb.kv.element_size() / 1e9:.3f})")
    if not growth["Q4_K"] < Q4K_LOAD_LIMIT:
        raise RuntimeError(f"the Q4_K backbone load added {growth['Q4_K']} "
                           f"bytes, the limit is {Q4K_LOAD_LIMIT:.0f}")

    prompt = list(backbones["Q4_K"].embed_tokens(np.random.default_rng(
        SEED + 130).integers(0, bcfg.vocab_size, TTS_PROMPT)))
    kernel_of = {"Q4_K": "q4_k_matmul", "Q8_0": "q8_0_matmul"}

    def tts_request(bb, bucket):
        """One greedy request through run_codebook_ar and the Mimi decode
        → (result, pcm, recorder, times in ms)."""
        bb.reset()
        alm = AudioLM(reader, codec=csm, lm=lm)
        rec = Recorder(bb)
        t = time.perf_counter()
        res = run_codebook_ar(alm, rec, prompt, max_steps=TTS_FRAMES,
                              decode=False, prefill_bucket=bucket)
        gen = time.perf_counter() - t
        t = time.perf_counter()
        pcm = _decode_transformed(alm, res.codes)
        dec = time.perf_counter() - t
        n_pre = 1 if bucket else TTS_PROMPT
        pre = sum(c[3] for c in rec.calls[:n_pre])
        steps = [c[3] for c in rec.calls[n_pre:]]
        return res, pcm, rec, {
            "prefill": pre * 1e3, "step": statistics.mean(steps) * 1e3,
            "frame": (gen - pre - sum(steps)) / TTS_FRAMES * 1e3,
            "decode": dec * 1e3, "total": (gen + dec) * 1e3}

    plain_bbs = {q: LlamaBackbone.from_params(bb.cfg, bb.params,
                                              qmm=qmat.qmatmul_plain)
                 for q, bb in backbones.items()}
    tts_counts = dict(none)
    host_codes = {}                 # the per-token requests' greedy codes
    for name, qtype, bucket in TTS_REQUESTS:
        n_pre = 1 if bucket else TTS_PROMPT
        want = {**none, "flash_sdpa_window": MIMI_LAYERS,
                kernel_of[qtype]: 7 * bcfg.n_layers * (n_pre + TTS_FRAMES)}
        zero_counts()
        res, pcm, rec, _ = tts_request(backbones[qtype], bucket)
        step = counts()
        if not bucket:
            host_codes[qtype] = res.codes
        if step != want:
            raise RuntimeError(f"tts {name}: launches {step}, want {want}")
        tts_counts = {k: v + step[k] for k, v in tts_counts.items()}
        if res.codes.shape != (TTS_FRAMES, lm.info.n_codebook) \
                or res.stopped_by_eos:
            raise RuntimeError(f"tts {name}: codes {res.codes.shape}, "
                               f"eos {res.stopped_by_eos}")
        if pcm.shape != (TTS_FRAMES * csm.hop_size,) or not np.isfinite(pcm).all():
            raise RuntimeError(f"tts {name}: pcm {pcm.shape}, finite "
                               f"{np.isfinite(pcm).all()}")
        # the backbone hiddens through the plain packed product on the
        # card, teacher-forced on the same inputs
        plain = plain_bbs[qtype]
        plain.reset()
        want_h = np.stack([plain.prefill(rows, bucket=bucket) if kind == "prefill"
                           else plain.step(rows) for kind, rows, _, _ in rec.calls])
        got_h = np.stack([c[2] for c in rec.calls])
        c = corr(got_h, want_h)
        rel = float(np.abs(got_h - want_h).max() / np.abs(want_h).max())
        if not (c > 0.99999 and rel <= 1e-4):
            raise RuntimeError(f"tts {name}: hiddens vs the plain product: "
                               f"corr {c}, max rel err {rel}")
        # the greedy codes of the plain path; at a first difference, the
        # kernel path's top-2 margin decides (near-tie rule)
        pres = tts_request(plain, bucket)[0]
        diff = np.argwhere(pres.codes != res.codes)
        line = (f"[tts] {name}: launches {step[kernel_of[qtype]]} "
                f"{kernel_of[qtype]} + {step['flash_sdpa_window']} "
                f"flash_sdpa_window; {len(rec.calls)} backbone calls, hiddens "
                f"vs the plain product: corr {c:.9f}, max rel err {rel:.3e}; "
                f"pcm {pcm.shape} finite, peak {np.abs(pcm).max():.4f}; ")
        if len(diff):
            f, k = (int(v) for v in diff[0])
            st = lm.new_state()
            st.step_begin(rec.calls[n_pre - 1 + f][2])
            for j in range(k):
                st.step_logits()
                st.step_push_code(int(res.codes[f, j]))
            top = np.sort(st.step_logits()[0])[-2:]
            if not top[1] - top[0] <= 1e-4 * abs(top[1]):
                raise RuntimeError(f"tts {name}: greedy codes differ from the "
                                   f"plain path at frame {f} codebook {k}, "
                                   f"top-2 margin {top[1] - top[0]}")
            line += (f"codes first differ from the plain path at frame {f} "
                     f"codebook {k}: a near-tie, top-2 margin "
                     f"{top[1] - top[0]:.3e} (allowed)")
        else:
            line += f"greedy codes equal the plain path's ({res.codes.shape})"
        log(line)
    log(f"[tts] main path launches: {tts_counts} over {len(TTS_REQUESTS)} "
        f"requests")
    del plain_bbs

    # -- 9b. the on-device TTS path: chunks as CUDA graphs ----------------------
    log(f"[phase] 9b starts at {time.monotonic() - t_start:.1f} s")
    # run_codebook_ar(on_device=...) at the full CSM width: the prompt's
    # per-token prefill on the host path, then chunks of TTS_CHUNK frames,
    # each one replay of a captured graph (fused frame with in-graph
    # sampling, EOS gate, feedback compose, backbone step: 112 packed
    # products a frame), one copy of the packed codes a chunk, and the Mimi
    # decode. A first request captures the graph; the checked request's
    # wrapper counts are then the prefill's products and the decode's
    # attention, and the replays' kernels are counted by name under
    # torch.profiler.
    t0 = time.monotonic()
    per_step = 7 * bcfg.n_layers
    greedy = OnDeviceSampling(chunk_frames=TTS_CHUNK)
    ctx = chunk_ctx(backbones["Q4_K"], TTS_PROMPT + -(-TTS_FRAMES // TTS_CHUNK)
                    * TTS_CHUNK + 1)

    def dev_request(qtype, ods, decode=True):
        bb = backbones[qtype]
        bb.reset()
        return run_codebook_ar(AudioLM(reader, codec=csm, lm=lm), bb, prompt,
                               max_steps=TTS_FRAMES, on_device=ods,
                               decode=decode)

    def same_or_near_tie(label, got, want, qtype, rows):
        """got == want, or the first difference (frame f, codebook k) is a
        near-tie: the relative top-2 margin of those logits on `qtype`'s host
        path, teacher-forced on want's codes before it (prompt `rows`, None
        for the shared prompt) → a note for the log."""
        diff = np.argwhere(got != want)
        if not len(diff):
            return f"codes equal ({got.shape})"
        f, k = (int(v) for v in diff[0])
        bb = backbones[qtype]
        bb.reset()
        h = prefill_prompt(bb, prompt if rows is None else rows)
        for i in range(f):
            h = bb.step(lm.compose_audio_embd([int(c) for c in want[i]]))
        st = lm.new_state()
        st.step_begin(h)
        for j in range(k):
            st.step_logits()
            st.step_push_code(int(want[f, j]))
        top = np.sort(st.step_logits()[0])[-2:]
        margin = float((top[1] - top[0]) / abs(top[1]))
        if not margin < NEAR_TIE:
            raise RuntimeError(f"tts-dev {label}: codes first differ at frame "
                               f"{f} codebook {k}, relative top-2 margin "
                               f"{margin:.3e}")
        return (f"codes first differ at frame {f} codebook {k}: a near-tie, "
                f"relative top-2 margin {margin:.3e} (allowed)")

    def replay_profile(runner, want: int = 0):
        """One replay under torch.profiler → (device busy ms, kernel
        launches, packed-product launches) from the trace's kernels. A
        replay runs every node of its graph, but CUPTI drops a few records
        now and then from a trace of ~62 000 kernels (885 of 896 products
        once): with `want`, up to four replays are traced and the first
        that shows `want` products (else the fullest) is returned."""
        from torch.profiler import ProfilerActivity, profile

        best = None
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                runner.run()
                torch.cuda.synchronize()
            dev = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and not e.key.startswith("aten::")
                   and not e.key.startswith(("Memcpy", "Memset"))]
            if dev:
                got = (sum(e.self_device_time_total for e in dev) / 1e3,
                       sum(e.count for e in dev),
                       sum(e.count for e in dev if "matmul_kernel" in e.key))
                if best is None or got[2] > best[2]:
                    best = got
                if not want or got[2] == want:
                    return got
        if best is None:
            raise RuntimeError("torch.profiler reported no device time in a "
                               "replay")
        return best

    def chunk_state(runner, qtype, ods):
        """The runner's state at the request's first chunk: the prompt's
        prefill, frame 0, the first chunk's noise."""
        bb = backbones[qtype]
        bb.reset()
        h = prefill_prompt(bb, prompt)
        runner.h.copy_(torch.as_tensor(np.asarray(h, np.float32)).reshape(1, -1))
        runner.pos.fill_(bb.pos)
        runner.base.fill_(0)
        runner.text_ctx.fill_(0)
        runner.draw_noise([torch.Generator(device="cuda").manual_seed(ods.seed)
                           if ods.temperature > 0 else None])

    tts_dev_counts = dict(none)
    tts_dev_times = {}
    for qtype, ods in (("Q4_K", greedy), ("Q8_0", greedy),
                       ("Q4_K", OnDeviceSampling(chunk_frames=TTS_CHUNK,
                                                 **TTS_SAMPLED))):
        name = f"{qtype} chunk {TTS_CHUNK} " + (
            "greedy" if ods.temperature <= 0 else
            f"temperature {ods.temperature} top-k {ods.top_k}")
        t1 = time.monotonic()
        dev_request(qtype, ods, decode=False)            # captures the chunk
        capture_s = time.monotonic() - t1
        zero_counts()
        res = dev_request(qtype, ods)
        step = counts()
        want = {**none, "flash_sdpa_window": MIMI_LAYERS,
                kernel_of[qtype]: per_step * TTS_PROMPT}
        if step != want:
            raise RuntimeError(f"tts-dev {name}: wrapper launches {step}, "
                               f"want {want} (prefill + decode; the chunks "
                               f"are replays)")
        tts_dev_counts = {k: v + step[k] for k, v in tts_dev_counts.items()}
        if res.codes.shape != (TTS_FRAMES, lm.info.n_codebook) \
                or res.stopped_by_eos:
            raise RuntimeError(f"tts-dev {name}: codes {res.codes.shape}, eos "
                               f"{res.stopped_by_eos}")
        if res.pcm.shape != (TTS_FRAMES * csm.hop_size,) \
                or not np.isfinite(res.pcm).all():
            raise RuntimeError(f"tts-dev {name}: pcm {res.pcm.shape}")
        if ods.temperature <= 0:
            note = same_or_near_tie(name, res.codes, host_codes[qtype], qtype,
                                    None)
        else:
            again = dev_request(qtype, ods, decode=False)
            if not np.array_equal(again.codes, res.codes):
                raise RuntimeError(f"tts-dev {name}: two runs with one seed "
                                   f"gave other codes")
            note = (f"two runs with seed {ods.seed:#x} give the same codes; "
                    f"{(res.codes != host_codes[qtype]).mean():.1%} of them "
                    f"differ from greedy")
        # the captured chunk against the eager chunk from the same state
        runner = gen_chunk_cached(lm, bb, n_frames=TTS_CHUNK, ctx=ctx,
                                  temperature=ods.temperature,
                                  top_k=ods.top_k, top_p=ods.top_p,
                                  min_p=ods.min_p)
        chunk_state(runner, qtype, ods)
        saved = [t.clone() for t in (runner.h, runner.pos,
                                     runner.kv[..., :ctx, :])]
        eager = runner.graphed.eager().clone()
        eager_state = [runner.h.clone(), runner.pos.clone()]
        for t, v in zip((runner.h, runner.pos, runner.kv[..., :ctx, :]), saved):
            t.copy_(v)
        graph = runner.run().clone()
        torch.cuda.synchronize()
        if not (torch.equal(eager, graph) and torch.equal(eager_state[0], runner.h)
                and torch.equal(eager_state[1], runner.pos)):
            raise RuntimeError(f"tts-dev {name}: the captured chunk's packed "
                               f"result, hidden or position differ from the "
                               f"eager chunk's")
        for t, v in zip((runner.h, runner.pos, runner.kv[..., :ctx, :]), saved):
            t.copy_(v)
        busy, kernels, products = replay_profile(
            runner, per_step * TTS_CHUNK)
        if products != per_step * TTS_CHUNK:
            raise RuntimeError(f"tts-dev {name}: {products} packed-product "
                               f"launches in a replay, want "
                               f"{per_step * TTS_CHUNK}")
        replay = cuda_ms(runner.run)
        totals = []
        for _ in range(1 + TTS_TIMED_RUNS):
            t1 = time.perf_counter()
            dev_request(qtype, ods)
            totals.append((time.perf_counter() - t1) * 1e3)
        total = statistics.median(totals[1:])
        tts_dev_times[name] = (replay / TTS_CHUNK, total, 1 - busy / replay)
        log(f"[tts-dev] {name}: {note}; captured chunk == eager chunk bit for "
            f"bit (packed codes and meta, hidden, position); one replay: "
            f"{kernels} kernels, {products} {kernel_of[qtype]} "
            f"({per_step} a frame), device busy {busy:.3f} ms of "
            f"{replay:.3f} ms (idle share {1 - busy / replay:.3f}); per frame "
            f"{replay / TTS_CHUNK:.3f} ms ({80 * TTS_CHUNK / replay:.2f}x "
            f"realtime); request (prefill, {TTS_FRAMES} frames, Mimi decode) "
            f"{total:.1f} ms, median of {TTS_TIMED_RUNS} after a warm-up "
            f"({2000 / total:.2f}x realtime for 2 s); first request with the "
            f"capture {capture_s:.2f} s; wrapper launches {step} "
            f"[{name_limit}]")

    # B streams through one batched chunk (the products at m = B): each
    # stream against its own single-stream device run
    rng_b = np.random.default_rng(SEED + 131)
    rows = [list(backbones["Q4_K"].embed_tokens(rng_b.integers(
        0, bcfg.vocab_size, TTS_PROMPT))) for _ in range(TTS_STREAMS)]

    def batch_request(decode=True):
        return run_codebook_ar_batch(
            [AudioLM(reader, codec=csm, lm=lm) for _ in rows],
            backbones["Q4_K"], rows, greedy, max_steps=TTS_FRAMES,
            decode=decode)

    batch_request(decode=False)                            # captures
    zero_counts()
    bres = batch_request()
    step = counts()
    # the batch's runner, the backbone's newest batched entry
    bkey = [k for k in backbones["Q4_K"]._gen_chunks if k[4]]
    brunner = backbones["Q4_K"]._gen_chunks[bkey[-1]][1]
    want = {**none, "flash_sdpa_window": MIMI_LAYERS * TTS_STREAMS,
            "q4_k_matmul": per_step * TTS_PROMPT * TTS_STREAMS}
    if step != want:
        raise RuntimeError(f"tts-dev batch: wrapper launches {step}, want {want}")
    tts_dev_counts = {k: v + step[k] for k, v in tts_dev_counts.items()}
    notes = []
    for s_, (r, p) in enumerate(zip(bres, rows)):
        bb = backbones["Q4_K"]
        bb.reset()
        one = run_codebook_ar(AudioLM(reader, codec=csm, lm=lm), bb, p,
                              max_steps=TTS_FRAMES, on_device=greedy,
                              decode=False)
        if r.pcm.shape != (TTS_FRAMES * csm.hop_size,) \
                or not np.isfinite(r.pcm).all():
            raise RuntimeError(f"tts-dev batch stream {s_}: pcm {r.pcm.shape}")
        notes.append(same_or_near_tie(f"batch stream {s_}", r.codes, one.codes,
                                      "Q4_K", p))
    busy, kernels, products = replay_profile(
        brunner, per_step * TTS_CHUNK)
    if products != per_step * TTS_CHUNK:
        raise RuntimeError(f"tts-dev batch: {products} packed-product launches "
                           f"in a replay, want {per_step * TTS_CHUNK}")
    replay = cuda_ms(brunner.run)
    totals = []
    for _ in range(1 + TTS_TIMED_RUNS):
        t1 = time.perf_counter()
        batch_request()
        totals.append((time.perf_counter() - t1) * 1e3)
    total = statistics.median(totals[1:])
    tts_dev_times["batch"] = (replay / TTS_CHUNK, total, 1 - busy / replay)
    log(f"[tts-dev] Q4_K batch of {TTS_STREAMS} streams, chunk {TTS_CHUNK} "
        f"greedy: per stream vs its single-stream run: {notes}; one replay: "
        f"{kernels} kernels, {products} q4_k_matmul at m = {TTS_STREAMS}, "
        f"device busy {busy:.3f} ms of {replay:.3f} ms (idle share "
        f"{1 - busy / replay:.3f}); per frame {replay / TTS_CHUNK:.3f} ms for "
        f"{TTS_STREAMS} streams; request {total:.1f} ms, median of "
        f"{TTS_TIMED_RUNS} after a warm-up ({TTS_STREAMS * 2000 / total:.2f}x "
        f"realtime in all); wrapper launches {step} [{name_limit}]")
    # one backbone step at m = 1, 8 and 32 rows (streams) as a captured
    # graph: the packed products (Q4_K) against F.linear on the same
    # weights dequantized to f32, the rest of the step the same; per-launch
    # device time of the products by name under torch.profiler
    from codec_tpu_torch.lm.backbone import backbone_step
    from codec_tpu_torch.lm.fused_gen import Graphed

    bb = backbones["Q4_K"]
    dense = {**bb.params, "layers": [
        {k: qmat.dequant_ref(v) if isinstance(v, dict) else v
         for k, v in lw.items()} for lw in bb.params["layers"]]}
    for m in (1, 8, 32):
        kv = torch.zeros((m, bcfg.n_layers, 2, bcfg.n_kv_heads, ctx,
                          bcfg.head_dim), device="cuda")
        pos = torch.full((m,), TTS_PROMPT, dtype=torch.long, device="cuda")
        x = randn((m, bcfg.hidden), torch.float32, SEED + 140 + m)
        line = f"[tts-dev] backbone step m = {m} as a graph:"
        for label, params in (("packed Q4_K", bb.params), ("F.linear f32", dense)):
            g = Graphed(lambda p=params: backbone_step(p, kv, pos, x, bcfg, ctx,
                                                       qmat.qmatmul),
                        torch.device("cuda"), restore=(kv,))
            g.run()
            step_ms = cuda_ms(g.run)
            busy, kernels, products = replay_profile(g)
            line += (f" {label} {step_ms:.4f} ms a step (device busy "
                     f"{busy:.4f}, {kernels} kernels")
            if products:
                per = profiled_ms(g.run, products,
                                  lambda key: "matmul_kernel" in key)
                line += f", {products} q4_k_matmul at {fmt_ms(per)} each"
            line += ");"
            del g
        log(line + f" [{name_limit}]")
    del dense

    log(f"[tts-dev] main path launches (wrappers; the replays' kernels are "
        f"counted above): {tts_dev_counts}; phase {time.monotonic() - t0:.1f} s")

    # -- 10. times -------------------------------------------------------------
    log(f"[phase] 10 starts at {time.monotonic() - t_start:.1f} s")
    log(f"[time] card: {name_limit}; CUDA events, median of {TIMED_RUNS} "
        f"runs after 2 warm-ups; turns plain, kernel, kernel, plain")
    times, extra = {}, {}
    for (b, h, t, d, w), dtype in [(s, torch.float32) for s in ATTN_SHAPES_F32[:3]] + \
            [(ATTN_SHAPE_BF16, dt) for dt in HALF_DTYPES]:
        q, k, v = (randn((b, h, t, d), dtype, SEED + j) for j in range(3))
        kern, plain, s = turns(lambda: flash_sdpa_window(q, k, v, window=w),
                               lambda: flash_sdpa_window_ref(q, k, v, window=w),
                               reps=20)
        line = (f"[time] flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                f"(samples k {s[0]:.4f} {s[1]:.4f}, p {s[2]:.4f} {s[3]:.4f})")
        if (b, h, t, d, w) == ATTN_SHAPES_F32[0] and dtype == torch.float32:
            # the library's call for the same function: SDPA with the band
            # mask (key j visible to query i iff i - w < j <= i)
            i = torch.arange(t, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=band)
            diff = (sdpa() - flash_sdpa_window(q, k, v, window=w)).abs().max()
            lib = cuda_ms(sdpa, reps=20)
            work = attn_work(b, h, t, d, w, dtype)
            # the bound of the unit the kernel uses, three TF32 passes per
            # f32 product; the f32 FMA bound beside it
            b_tc, b_by = least_time([(3 * work[0][0][0], "tf32")], work[1])
            b_fma = least_time(*work)[0]
            times["flash_sdpa_window"] = (kern, plain, b_tc, b_by, lib)
            extra["flash_sdpa_window"] = {
                "bound_fma_ms": b_fma,
                "device_ms": device_ms(lambda: flash_sdpa_window(q, k, v,
                                                                 window=w))}
            line += (f"; F.scaled_dot_product_attention with the band mask "
                     f"{lib:.4f} ms (max abs diff to the kernel "
                     f"{diff.item():.2e}); bound {b_tc:.4f} ms (3 TF32 "
                     f"passes, {b_by}; {b_tc / kern:.1%} of it), {b_fma:.4f} "
                     f"ms (f32 FMA); device time (torch.profiler) "
                     f"{fmt_ms(extra['flash_sdpa_window']['device_ms'])}")
        log(line + f" [{name_limit}]")

    # the windowed codecs' attention (phase 8c's shapes): kernel and plain in
    # turns, F.scaled_dot_product_attention with the same mask, device time
    # (torch.profiler), and the bound of the kernel's passes (f32: three
    # TF32 passes a product; 16-bit: one for QK^T, two for PV) beside the
    # bytes' alone
    for b, h, t, d, w in WINDOWED_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn((b, h, t, d), dtype, SEED + 700 + j)
                       for j in range(3))
            kern, plain, smp = turns(
                lambda: flash_sdpa_window(q, k, v, window=w),
                lambda: flash_sdpa_window_ref(q, k, v, window=w), reps=20)
            i = torch.arange(t, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - (w or t))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band), reps=20)
            dev = device_ms(lambda: flash_sdpa_window(q, k, v, window=w))
            work = attn_work(b, h, t, d, w, dtype)
            flop = work[0][0][0]
            passes = ([(3 * flop, "tf32")] if dtype == torch.float32
                      else [(3 * flop // 2, dtype)])
            b_ms, b_by = least_time(passes, work[1])
            log(f"[time] flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                f"(samples k {smp[0]:.4f} {smp[1]:.4f}, p {smp[2]:.4f} "
                f"{smp[3]:.4f}), F.scaled_dot_product_attention with the same "
                f"mask {lib:.4f} ms, device time (torch.profiler) "
                f"{fmt_ms(dev)}; bound {b_ms:.5f} ms ({b_by}; the kernel's "
                f"passes), bytes alone {least_time([], work[1])[0]:.5f} ms"
                + (f", f32 FMA {least_time(*work)[0]:.5f} ms"
                   if dtype == torch.float32 else "") + f" [{name_limit}]")

    # MOSS's attention (phase 8e's shapes) the same way; SDPA with the band
    # mask only where its mask fits (T <= 15 000: its memory-efficient
    # kernel takes the mask as an additive tensor of the inputs' dtype,
    # [T, T]; at T 120 000 that is 57.6 GB in f32, and the math path's
    # logits 172.8 GB)
    for b, h, t, d, w in (*MOSS_ATTN_SHAPES, MOSS_LONG_ATTN):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn((b, h, t, d), dtype, SEED + 900 + j)
                       for j in range(3))
            kern, plain, smp = turns(
                lambda: flash_sdpa_window(q, k, v, window=w),
                lambda: flash_sdpa_window_ref(q, k, v, window=w),
                reps=20 if t <= 2500 else 1,
                runs=3 if t > 200000 else TIMED_RUNS)
            if t <= 15000:
                i = torch.arange(t, device="cuda")
                band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
                lib = (f"{cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band), reps=20 if t <= 2500 else 1):.4f} ms")
                del band
            else:
                lib = (f"not run: its [T, T] mask is {t * t * dtype.itemsize / 1e9:.1f}"
                       f" GB as an additive {str(dtype)[6:]} tensor, the "
                       f"math path's f32 logits {b * h * t * t * 4 / 1e9:.1f} GB")
            dev = device_ms(lambda: flash_sdpa_window(q, k, v, window=w),
                            n=10 if t > 15000 else 50)
            work = attn_work(b, h, t, d, w, dtype)
            flop = work[0][0][0]
            passes = ([(3 * flop, "tf32")] if dtype == torch.float32
                      else [(3 * flop // 2, dtype)])
            b_ms, b_by = least_time(passes, work[1])
            log(f"[time] flash_sdpa_window MOSS B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, banded plain "
                f"{plain:.4f} ms (samples k {smp[0]:.4f} {smp[1]:.4f}, p "
                f"{smp[2]:.4f} {smp[3]:.4f}), F.scaled_dot_product_attention "
                f"with the same mask {lib}, device time (torch.profiler) "
                f"{fmt_ms(dev)}; bound {b_ms:.5f} ms ({b_by}; the kernel's "
                f"passes; {b_ms / kern:.1%} of it), bytes alone "
                f"{least_time([], work[1])[0]:.5f} ms [{name_limit}]")
            del q, k, v
    torch.cuda.empty_cache()

    # the DAC residual units at every decoder and encoder width, d = 1, 3
    # and 9, in f32 and bf16, and the chain against three unit launches
    # (tools/seanet_times.py); the kernels line takes the f32 unit at block
    # 1 (C768, d = 1) and the f32 chain at block 4 (C96)
    unit_rows = seanet_times.unit_rows(log=lambda m: log(f"{m} [{name_limit}]"))
    chain_rows = seanet_times.chain_rows(log=lambda m: log(f"{m} [{name_limit}]"))
    row = next(r for r in unit_rows
               if (r["c"], r["d"], r["dtype"]) == (768, 1, "float32"))
    times["seanet_res_unit"] = (row["ms"], row["plain_ms"], row["bound_ms"],
                                row["bound_by"], None)
    row = next(r for r in chain_rows if (r["c"], r["dtype"]) == (96, "float32"))
    times["seanet_res_chain"] = (row["ms"], row["plain_ms"], row["bound_ms"],
                                 row["bound_by"], None)
    for row in chain_rows:
        if row["gate_takes_chain"] != (row["ms"] < row["units_ms"]):
            log(f"[time] note: at C{row['c']} {row['dtype']} the gate takes "
                f"{'the chain' if row['gate_takes_chain'] else 'three units'}"
                f", the faster in this run is the other")

    for dtype in (torch.float32, *HALF_DTYPES):
        for bi, (c, t) in enumerate(SNAC_BLOCKS, start=1):
            p = dw_params(3, c, dtype, SEED + 90 + bi)
            x = randn((1, t, c), dtype, SEED + 100 + bi, scale=0.3)
            flops, nbytes = res_work(3, 1, t, c, dtype, depthwise=True)
            b_ms, b_by = least_time(flops, nbytes)
            flop = sum(f for f, _ in flops)
            # the rows a loaded model passes (built once at load)
            vec = seanet_cuda.unit_vec(p["a1s"], p["b1s"], p["a2s"], p["b2s"])
            label = f"snac block {bi} C{c} T{t} {dtype}"
            with f32_precision(dtype == torch.float32):
                settled(f"{label}: the kernels", seanet_cuda.snac_res_units(
                    x, **p, vec=vec))
                settled(f"{label}: the plain version",
                        seanet_cuda.snac_res_chain_ref(x, **p))
                kern, plain, s = turns(
                    lambda: seanet_cuda.snac_res_units(x, **p, vec=vec),
                    lambda: seanet_cuda.snac_res_chain_ref(x, **p))
            line = (f"[time] snac block {bi} C{c} T{t} {str(dtype)[6:]}: "
                    f"three units as 3 N=1 launches {kern:.3f} ms "
                    f"({flop / kern / 1e9:.2f} TFLOP/s, "
                    f"{nbytes / kern / 1e6:.1f} GB/s, {b_ms / kern:.1%} of the "
                    f"bound {b_ms:.4f} ms, {b_by}), plain"
                    f" {plain:.3f} ms "
                    f"(samples k {s[0]:.3f} {s[1]:.3f}, p {s[2]:.3f} "
                    f"{s[3]:.3f})")
            # SNAC's chain kernel (N > 1, on no request path) is f32/bf16
            if dtype != torch.float16 and seanet_cuda.dw_chain_tile(
                    c, 7, DILATIONS, dtype, smem):
                chain = cuda_ms(lambda: snac_res_chain(x, **p))
                line += f"; chain N=3 {chain:.3f} ms"
            if bi == 3 and dtype == torch.float32:
                times["snac_res_chain"] = (kern, plain, b_ms, b_by, None)
            log(line + f" [{name_limit}]")
            del x, p

    # the packed products at m = 1 (one decode step) on every backbone
    # shape: device time per call from torch.profiler, and the CUDA-event
    # time of back-to-back calls, which includes the host's launch work
    for out_d, in_d in QMAT_SHAPES:
        x = randn((1, in_d), torch.float32, SEED + 140)
        for name in ("q8_0_matmul", "q4_k_matmul"):
            qt = qmat_weights[name, out_d, in_d]
            dense = qmat.dequant_ref(qt)
            kern = lambda: packed_product(name, x, qt)
            plain = lambda: qmat.qmatmul_plain(x, qt)
            lib = lambda: F.linear(x, dense)
            dev = [device_ms(fn) for fn in (kern, plain, lib)]
            k_ev, p_ev, s = turns(kern, plain, reps=20)
            l_ev = cuda_ms(lib, reps=20)
            b_ms, b_by = least_time(*qmat_work(out_d, in_d, 1, qt))
            log(f"[time] {name} out {out_d} in {in_d} m1 f32: device time "
                f"kernel {fmt_ms(dev[0])}, plain (dequant + matmul) "
                f"{fmt_ms(dev[1])}, F.linear on the dequantized f32 weight "
                f"{fmt_ms(dev[2])}; bound {b_ms:.4f} ms ({b_by}); CUDA events "
                f"per call kernel {k_ev:.4f} ms, plain {p_ev:.4f} ms, "
                f"F.linear {l_ev:.4f} ms [{name_limit}]")
            if (out_d, in_d) == QMAT_MAIN:
                times[name] = (dev[0] or k_ev, dev[1] or p_ev, b_ms, b_by,
                               dev[2] or l_ev)
            del dense

    # the packed products cold, as a forward finds them: each shape's line
    # cycles over the 16 layers' matrices of that shape in the loaded
    # backbone (a 64 MB buffer written between launches where the cycle
    # would stay in L2), at m = 1 and m = 16 (a bucketed prefill); then one
    # forward's 112 products at m = 1 in forward order. Device times by the
    # kernel's name under torch.profiler, F.linear on the same dequantized
    # f32 weights measured the same way
    cold = {}
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for qtype, bb in backbones.items():
        name = kernel_of[qtype]
        layers = bb.params["layers"]
        dense = [{k: qmat.dequant_ref(lw[k]) for k in FORWARD_ORDER}
                 for lw in layers]
        xs = {d: randn((1, d), torch.float32, SEED + 150 + d)
              for d in (bcfg.hidden, bcfg.ffn_dim)}
        for out_d, in_d in QMAT_SHAPES:
            pairs = [(lw[k], dw[k]) for lw, dw in zip(layers, dense)
                     for k in FORWARD_ORDER if tuple(lw[k]["qs"].shape)[0] == out_d
                     and qmat.in_features(lw[k]) == in_d]
            wbytes = sum(t.numel() * t.element_size() for qt, _ in pairs
                         for t in qt.values())
            flush = wbytes < 2 * L2_BYTES
            for m in (1, 16):
                x = randn((m, in_d), torch.float32, SEED + 160 + m)

                def cycle(use_dense):
                    for qt, dw in pairs:
                        if flush:
                            flush_buf.fill_(1.0)
                        if use_dense:
                            F.linear(x, dw)
                        else:
                            packed_product(name, x, qt)
                k_ms = profiled_ms(lambda: cycle(False), len(pairs),
                                   lambda key: "matmul_kernel" in key)
                l_ms = profiled_ms(lambda: cycle(True), len(pairs),
                                   lambda key: "FillFunctor" not in key)
                b_ms, b_by = least_time(*qmat_work(out_d, in_d, m, pairs[0][0]))
                if m == 1 and (out_d, in_d) == QMAT_MAIN:
                    cold[name] = k_ms
                log(f"[time] {name} cold {SHAPE_NAMES[out_d, in_d]} out {out_d} "
                    f"in {in_d} m{m} f32 ({len(pairs)} matrices, "
                    f"{wbytes / 1e6:.1f} MB{', 64 MB written between launches' if flush else ''}): "
                    f"device time kernel {fmt_ms(k_ms)}, F.linear on the "
                    f"dequantized f32 weight {fmt_ms(l_ms)}; bound {b_ms:.4f} ms "
                    f"({b_by})" + (f", {b_ms / k_ms:.1%} of it" if k_ms else "")
                    + f" [{name_limit}]")
        order = [(lw[k], dw[k]) for lw, dw in zip(layers, dense)
                 for k in FORWARD_ORDER]

        def forward(use_dense):
            for qt, dw in order:
                x = xs[dw.shape[1]]
                if use_dense:
                    F.linear(x, dw)
                else:
                    packed_product(name, x, qt)
        reps = 3
        k_ms = profiled_ms(lambda: [forward(False) for _ in range(reps)], reps,
                           lambda key: "matmul_kernel" in key,
                           launches=reps * len(order))
        l_ms = profiled_ms(lambda: [forward(True) for _ in range(reps)], reps,
                           lambda key: True, launches=reps * len(order))
        b_sum = sum(least_time(*qmat_work(qt["qs"].shape[0], dw.shape[1], 1,
                                          qt))[0] for qt, dw in order)
        log(f"[time] {name} one backbone forward, {len(order)} products at m1 "
            f"in forward order (cold): device time kernel {fmt_ms(k_ms)}, "
            f"F.linear on the dequantized f32 weights {fmt_ms(l_ms)}; summed "
            f"bound {b_sum:.4f} ms" + (f", {b_sum / k_ms:.1%} of it"
                                       if k_ms else "") + f" [{name_limit}]")
        del dense, order
    del flush_buf

    for name, qtype, bucket in TTS_REQUESTS:
        runs = [tts_request(backbones[qtype], bucket)[3]
                for _ in range(TTS_TIMED_RUNS)]
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        audio_s = TTS_FRAMES * csm.hop_size / csm.sample_rate
        log(f"[time] tts {name}: prefill {med['prefill']:.2f} ms, backbone "
            f"step {med['step']:.3f} ms, frame (c0 head + "
            f"{lm.info.n_codebook - 1} depth forwards + host sampling + "
            f"compose) {med['frame']:.3f} ms, Mimi decode "
            f"{med['decode']:.2f} ms, total {med['total']:.1f} ms, "
            f"{audio_s / (med['total'] / 1e3):.3f}x realtime ({audio_s:.0f} s "
            f"of audio; median of {TTS_TIMED_RUNS} runs after a warm-up) "
            f"[{name_limit}]")

    decode_fns = {"dac": dac.dac_decode_fn, "snac": snac.snac_decode_fn}
    for label, reqs, plain_units in (
            ("mimi", mimi_reqs, None), ("dac", dac_reqs, dac.plain_res_units),
            ("snac", snac_reqs, snac.plain_res_units)):
        for name, secs, batch, model, codes in reqs:
            ms = cuda_ms(lambda: model.decode(codes))
            xrt = secs * batch / (ms / 1000.0)
            line = (f"[time] {label} decode {name}: {ms:.3f} ms per request, "
                    f"{xrt:.1f}x realtime ({secs * batch} s of audio)")
            if model.compute_dtype == torch.float32:
                c = torch.from_numpy(codes.astype(np.int64)).cuda()

                if label == "mimi":
                    def dev(plain=False):
                        with torch.inference_mode(), f32_precision(True):
                            mimi_decode_fn(model.params, c, model.cfg,
                                           attention=flash_sdpa_window_ref
                                           if plain else None)
                    what = "plain attention"
                else:
                    def dev(plain=False):
                        with torch.inference_mode(), f32_precision(True):
                            decode_fns[label](model.params, c, model.cfg,
                                              res_units=plain_units
                                              if plain else None)
                    what = "plain res units"
                d_kern = cuda_ms(dev)
                d_plain = cuda_ms(lambda: dev(True))
                line += (f"; decode fn alone (codes already on the card, no "
                         f"copy back) {d_kern:.3f} ms with the kernels, "
                         f"{d_plain:.3f} ms with {what}")
            log(line + f" [{name_limit}]")

    # the RVQ search at Mimi's shapes (20 s b1 acoustic and semantic, b4,
    # and a streaming encode's 1- and 5-frame acoustic pushes) and the
    # iSTFT-head codecs' (WavTokenizer's and XY-Tokenizer's 20 s b1), with
    # the norms given, as the model passes them from load
    for b, t, d, n_q, v in (RVQ_SHAPES[:3] + [RVQ_QWEN3] + RVQ_ISTFT_SHAPES
                            + RVQ_SHAPES[-2:]):
        x, cb = rvq_inputs(b, t, d, n_q, v, "normal", SEED + 210)
        nrm = codebook_norms(cb)
        kern, plain, s = turns(lambda: rvq_encode_fused(x, cb, norms=nrm),
                               lambda: rvq_encode(x, cb, nrm), reps=5)
        work = rvq_work(b * t, d, n_q, v)
        flop = work[0][0][0]
        # the unit the kernel uses, three TF32 passes per f32 product, and
        # the f32 FMA bound beside it
        b_tc, b_by = least_time([(3 * flop, "tf32")], work[1])
        b_fma = least_time(*work)[0]
        frames = rvq_cuda.plan(b * t, d, smem)
        # at n_q 1 the search is one library product and an argmax: cuBLAS's
        # addmm (2·x·cbᵀ - ||cb||²) then torch.argmax, the library time
        lib = ""
        if n_q == 1:
            x2, cbt, neg = x.reshape(-1, d), cb[0].t(), -nrm[0]
            lib = (f", library (one cuBLAS addmm + argmax) "
                   f"{cuda_ms(lambda: torch.argmax(torch.addmm(neg, x2, cbt, alpha=2.0), dim=-1), reps=5):.4f} ms")
        log(f"[time] rvq_encode_fused N{b * t} D{d} n_q{n_q} V{v} f32 (plan: "
            f"{frames} frames x {rvq_cuda.CLUSTER} blocks a cluster): kernel "
            f"{kern:.4f} ms ({flop / kern / 1e9:.2f} TFLOP/s, {b_tc / kern:.1%} "
            f"of the bound {b_tc:.4f} ms for three TF32 passes, {b_by}; "
            f"{b_fma / kern:.1%} of {b_fma:.4f} ms at the f32 FMA rate), plain "
            f"(n_q matmuls + argmaxes) {plain:.4f} ms (samples k {s[0]:.4f} "
            f"{s[1]:.4f}, p {s[2]:.4f} {s[3]:.4f}){lib} [{name_limit}]")
        if (b, t, d, n_q, v) == RVQ_MAIN:
            times["rvq_encode_fused"] = (kern, plain, b_tc, b_by, None)
            extra["rvq_encode_fused"] = {"bound_fma_ms": b_fma}
        del x, cb

    # the encode requests, host PCM to host codes; for f32, the encode
    # function alone (PCM already on the card) with the kernels and with
    # the plain path
    enc_fns = {"mimi": (lambda m, x, plain: mimi.mimi_encode_fn(
                   m.params, x, m.cfg, attention=flash_sdpa_window_ref
                   if plain else None, quantize=rvq_encode if plain else None)),
               "dac": (lambda m, x, plain: dac.dac_encode_fn(
                   m.params, x, m.cfg, res_units=dac.plain_res_units
                   if plain else None)),
               "snac": (lambda m, x, plain: snac.snac_encode_fn(
                   m.params, x, m.cfg, res_units=snac.plain_res_units
                   if plain else None))}
    for arch, name, secs, batch, model, pcm in enc_reqs:
        ms = cuda_ms(lambda: model.encode(pcm))
        line = (f"[time] {arch} encode {name}: {ms:.3f} ms per request, "
                f"{secs * batch / (ms / 1000.0):.1f}x realtime ({secs * batch} "
                f"s of audio)")
        if model.compute_dtype == torch.float32:
            n = pcm.shape[1]
            x = torch.from_numpy(np.pad(pcm, ((0, 0), (0, enc_outs[
                arch, name].shape[1] * model.hop_size - n)))
                if arch == "snac" else pcm).cuda()

            def dev(plain=False):
                with torch.inference_mode(), f32_precision(True):
                    enc_fns[arch](model, x, plain)
            d_kern = cuda_ms(dev)
            d_plain = cuda_ms(lambda: dev(True))
            line += (f"; encode fn alone (PCM already on the card) "
                     f"{d_kern:.3f} ms with the kernels, {d_plain:.3f} ms "
                     f"with the plain path")
        log(line + f" [{name_limit}]")

    # the streaming sessions: per step, after warm-up pushes, the median
    # CUDA-event time of a push (host codes to host PCM), the audio it
    # gives, and one warm push under torch.profiler (device busy time,
    # kernel launches, copies); time to first audio: a fresh session's
    # first push, host-timed
    step_ms = {}
    for name, secs, batch, dt, chunk in STREAM_DECODES:
        if name not in STREAM_TIMED:
            continue
        model, codes = mimi_models[dt], stream_codes[name]
        t = time.perf_counter()
        session = model.streaming_decoder(batch=batch)
        t_open = time.perf_counter() - t
        t = time.perf_counter()
        session.push(codes[:, :chunk])
        ttfa = time.perf_counter() - t
        pos = [chunk]

        def push():
            lo = pos[0] % (codes.shape[1] - chunk + 1)
            session.push(codes[:, lo:lo + chunk])
            pos[0] += chunk
        ms = cuda_ms(push, runs=STREAM_TIMED_STEPS, warmup=5)
        busy, kernels, copies = profiled_step(push)
        audio_ms = chunk * cfg.hop_size / cfg.sample_rate * 1e3
        step_ms[name] = ms
        log(f"[time] mimi stream decode {name}: {ms:.3f} ms a push "
            f"(median of {STREAM_TIMED_STEPS} after 5 warm-ups) for "
            f"{audio_ms * batch:.0f} ms of audio ({batch} x {audio_ms:.0f}), "
            f"{audio_ms * batch / ms:.1f}x realtime; time to first audio "
            f"{ttfa * 1e3:.3f} ms (first push; opening the session "
            f"{t_open * 1e3:.3f} ms); one warm push under torch.profiler: "
            f"device busy {busy:.3f} ms, idle share {1 - busy / ms:.3f} of "
            f"the unprofiled push, {kernels} kernel launches and {copies} "
            f"copies/fills [{name_limit}]")
    for name, secs, batch, dt, chunk in STREAM_ENCODES:
        model, pcm = mimi_models[dt], stream_pcm[name]
        n = chunk * cfg.hop_size
        session = model.streaming_encoder(batch=batch)
        t = time.perf_counter()
        session.push(pcm[:, :n])
        ttfa = time.perf_counter() - t
        pos = [n]

        def push():
            lo = pos[0] % (pcm.shape[1] - n + 1)
            session.push(pcm[:, lo:lo + n])
            pos[0] += n
        ms = cuda_ms(push, runs=STREAM_TIMED_STEPS, warmup=5)
        busy, kernels, copies = profiled_step(push)
        audio_ms = n / cfg.sample_rate * 1e3
        log(f"[time] mimi stream encode {name}: {ms:.3f} ms a push "
            f"(median of {STREAM_TIMED_STEPS} after 5 warm-ups) for "
            f"{audio_ms * batch:.0f} ms of audio, {audio_ms * batch / ms:.1f}x "
            f"realtime; first push {ttfa * 1e3:.3f} ms; one warm push under "
            f"torch.profiler: device busy {busy:.3f} ms, idle share "
            f"{1 - busy / ms:.3f}, {kernels} kernel launches and {copies} "
            f"copies/fills [{name_limit}]")

    # flash_sdpa_window with carried keys at the sessions' shapes: kernel and
    # plain in turns, F.scaled_dot_product_attention with the same mask, the
    # bound of the pairs this mask leaves visible, device time
    for b, h, tq, tk, d, w, ks in STREAM_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((b, h, tq, d), dtype, SEED + 500)
            k, v = (randn((b, h, tk, d), dtype, SEED + 501 + j)
                    for j in range(2))
            kern, plain, smp = turns(
                lambda: flash_sdpa_window(q, k, v, window=w, k_start=ks),
                lambda: flash_sdpa_window_ref(q, k, v, window=w, k_start=ks),
                reps=20)
            band = stream_mask(tq, tk, w, ks)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band), reps=20)
            dev = device_ms(lambda: flash_sdpa_window(q, k, v, window=w,
                                                      k_start=ks))
            work = stream_attn_work(b, h, tq, tk, d, w, ks, dtype)
            flop = work[0][0][0]
            # the kernel's passes: f32 three TF32 passes per product; bf16
            # one pass for QK^T and two for PV
            passes = ([(3 * flop, "tf32")] if dtype == torch.float32
                      else [(3 * flop // 2, dtype)])
            b_ms, b_by = least_time(passes, work[1])
            log(f"[time] flash_sdpa_window carried keys B{b} H{h} Tq{tq} "
                f"Tk{tk} D{d} w{w} k_start={ks} {str(dtype)[6:]}: kernel "
                f"{kern:.4f} ms, plain {plain:.4f} ms (samples k {smp[0]:.4f} "
                f"{smp[1]:.4f}, p {smp[2]:.4f} {smp[3]:.4f}), "
                f"F.scaled_dot_product_attention with the same mask "
                f"{lib:.4f} ms, device time (torch.profiler) {fmt_ms(dev)}; "
                f"bound {b_ms:.5f} ms ({b_by}; the kernel's passes) "
                f"[{name_limit}]")
            if (b, h, tq, tk, d, w, ks) == STREAM_ATTN_MAIN \
                    and dtype == torch.float32:
                times["flash_sdpa_window (carried keys)"] = (
                    kern, plain, b_ms, b_by, lib)
                extra["flash_sdpa_window (carried keys)"] = {
                    "device_ms": dev,
                    "bound_fma_ms": least_time(*work)[0]}

    main_counts = {"flash_sdpa_window": mimi_counts["flash_sdpa_window"]
                   + tts_counts["flash_sdpa_window"]
                   + tts_dev_counts["flash_sdpa_window"]
                   + enc_counts["flash_sdpa_window"]
                   + windowed_counts["flash_sdpa_window"]
                   + small_counts["flash_sdpa_window"],
                   "seanet_res_unit": dac_counts["seanet_res_unit"]
                   + enc_counts["seanet_res_unit"],
                   "seanet_res_chain": dac_counts["seanet_res_chain"]
                   + enc_counts["seanet_res_chain"],
                   "snac_res_chain": snac_counts["snac_res_chain"]
                   + enc_counts["snac_res_chain"],
                   "q8_0_matmul": tts_counts["q8_0_matmul"]
                   + tts_dev_counts["q8_0_matmul"],
                   "q4_k_matmul": tts_counts["q4_k_matmul"]
                   + tts_dev_counts["q4_k_matmul"],
                   "rvq_encode_fused": enc_counts["rvq_encode_fused"]
                   + istft_counts["rvq_encode_fused"]
                   + windowed_counts["rvq_encode_fused"],
                   "flash_sdpa_window (carried keys)": stream_launches
                   + windowed_counts["flash_sdpa_window (carried keys)"]}
    sources = {"flash_sdpa_window": ("codec_tpu_torch/csrc/flash_sdpa_window.cu",
                                     "codec_tpu/ops/attn_pallas.py:82"),
               "seanet_res_unit": ("codec_tpu_torch/csrc/seanet_res.cu",
                                   "codec_tpu/ops/seanet_pallas.py:92"),
               "seanet_res_chain": ("codec_tpu_torch/csrc/seanet_res.cu",
                                    "codec_tpu/ops/seanet_pallas.py:218"),
               "snac_res_chain": ("codec_tpu_torch/csrc/snac_res.cu",
                                  "codec_tpu/ops/seanet_pallas.py:328"),
               "q8_0_matmul": ("codec_tpu_torch/csrc/qmat.cu",
                               "codec_tpu/ops/qmat_pallas.py:171"),
               "q4_k_matmul": ("codec_tpu_torch/csrc/qmat.cu",
                               "codec_tpu/ops/qmat_pallas.py:200"),
               "rvq_encode_fused": ("codec_tpu_torch/csrc/rvq_encode.cu",
                                    "codec_tpu/ops/rvq_pallas.py:76"),
               "flash_sdpa_window (carried keys)": (
                   "codec_tpu_torch/csrc/flash_sdpa_window.cu",
                   "codec_tpu/ops/attn_pallas.py:82")}
    # times at: attention B1 H8 T500 D64 w250, the DAC unit at block 1
    # (d=1), the DAC chain at block 4, SNAC's three units at block 3 (the
    # N=1 launches a decode makes), the packed products at m = 1 on the
    # gate matrix (device times), the RVQ search at Mimi's 20 s b1
    # acoustic shape (N 250, D 256, n_q 31, V 2048, norms given); all f32.
    # The attention's and the RVQ search's bound_ms is that of three TF32
    # passes per f32 product at 495 TFLOP/s, the unit they use; their rows
    # also carry bound_fma_ms (the f32 FMA rate); the attention's device_ms
    # (torch.profiler), where back-to-back calls are bound by the wrapper's
    # host time. No single
    # PyTorch call computes a residual unit or an n_q-level search, so
    # those rows have no library time; the packed products' library time
    # is F.linear on the dequantized f32 weight (no PyTorch call multiplies
    # GGUF-packed weights); their cold_ms is the same shape cold (the
    # cycle over the backbone's gate/up matrices). Launches: all paths of
    # this run (the attention:
    # Mimi decodes, the TTS requests' Mimi decodes and Mimi encodes; the
    # residual units: decodes and encodes). The carried-key attention row is
    # the same kernel as a streaming step launches it (B1 H8 Tq2 Tk251 D64
    # w250 k_start 0, f32; its bound over the pairs the mask leaves
    # visible), its launches those of the streaming sessions.
    result = {"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": main_counts[name], "max_abs_err": max_err[name],
        **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                   times[name])), **({"cold_ms": cold[name]} if name in cold
                                     else {}), **extra.get(name, {})}
        for name, (src, rep) in sources.items()]}
    log(f"[time] chip_smoke.py ran {time.monotonic() - t_start:.1f} s")
    print(json.dumps(result), flush=True)
    print(f"card: {card()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
