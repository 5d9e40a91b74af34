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
     block's second row tile a copy of its first; the packed products at
     m = 1, 4, 8, 16 and 32 on the Llama-3.2-1B shapes, also at the
     MOSS-TTSD backbone's four layer shapes at m = 1 and 8 and the
     Chatterbox T3 backbone's three at m = 1, 2 and 8, with the launch
     plan each takes)
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
     the f32 one profiled once (device busy time, idle share, top
     kernels); the NSF
     phase at 20 s summed in f32 on the card and the CPU against the
     port's float64 sum
  9. CSM-style TTS: write a random CSM codec GGUF (full-width Mimi + a
     residual_depth_ar adaptor at CSM-1B's depth-decoder widths) and
     backbones at Llama-3.2-1B's widths cut to 4 of its 16 layers in Q4_K
     and Q8_0, load each backbone
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
     near-tie, 224 packed-product launches in one replay (torch.profiler),
     per-frame and request times and a replay's idle share; one backbone
     step as a graph at m = 1, 8 and 32, packed Q4_K against F.linear on
     the dequantized weights
  9c. the LM flows past CSM's at full width (models/lm_tts_init.py):
     Pocket-TTS (flow_lm over Pocket-Mimi with its encoder), MOSS-TTSD
     (parallel_heads_delay over XY-Tokenizer and a Q4_K Qwen3-1.7B-wide
     backbone cut to 4 of its 28 layers) and BlueMagpie
     (continuous_latent_cfm over the AudioVAE and an f32 backbone of
     hidden 1024 cut to 4 of 24 layers), each loaded on the card (f32;
     Pocket's codec also bf16) and on the CPU (f32); each request with the
     launch counts set to 0 just before and read just after. Pocket:
     run_flow_synthesize of 125 frames batch, streamed, with a 5 s voice
     prompt and with the bf16 codec (flash_sdpa_window 2 a decode_latent,
     a push and an encode_latent), streamed PCM against batch, the first
     16 frames' latents and EOS logits and their decode against the CPU's
     with the same noise; MOSS: 25 greedy frames on the host path
     (q4_k_matmul 7 a layer a backbone call) and in on-device chunks of 8
     (one CUDA graph replay each, its products counted under the
     profiler), codes against the CPU's and each other (near-tie rule);
     BlueMagpie: 10 patches through run_continuous with fixed noise against
     the CPU (FSQ near-tie rule), PCM shape and finite samples, and the
     same request with --on-device (chunks of 8 patches, one graph replay
     each) against it on the card within 1e-5 of peak (FSQ near-tie rule),
     the stop head's stop at the same patch both ways, a replay against the
     eager run of the same chunk bit for bit; ms a frame and a patch, time
     to first audio, one frame, replay and patch under torch.profiler
  9d. the Chatterbox TTS path at full width (models/chatterbox_init.py):
     the full-width S3Gen with a T3 section (text vocab 704, speech vocab
     8194, the perceiver and the VoiceEncoder) and a Llama-520M backbone
     (30 layers of 1024) in Q4_K, loaded packed and dense f32 on the card
     and dense on the CPU; tts_cli's run_chatterbox_synthesize on the host
     path (f32) and with --on-device --quant-exec (chunks of 8), 50 greedy
     frames at CFG weight 0.5 into the S3Gen decode (PCM length and
     finite samples; the prefill's q4_k_matmul launches counted, 210 a
     lane a prompt row at m = 1); run_chatterbox's codes on the card
     against the CPU, each device chunk (f32, Q4_K) against the host path
     (near-tie rule on the CFG logits); one chunk run eagerly (210 a frame
     at m = 2, counted) and its replay against it bit for bit;
     run_chatterbox(ref_pcm=) with a 10 s 16 kHz voice, the VoiceEncoder's
     embedding and conditioning rows, and a Qwen3-TTS ECAPA embedding of
     10 s of 24 kHz, against the CPU (1e-5 of peak); ms a frame host and
     chunked, the S3Gen share, a frame and a replay under torch.profiler
  9e. the rest of the LM layer at full width (models/lm_tts_init.py):
     LFM2-Audio (its depthformer and compose table over the full-width
     Mimi; a llama backbone at LFM2-1.2B's widths, 4 of 16 layers, Q4_K and
     Q8_0) and MOSS-TTS-Realtime (its local transformer and compose table
     over the full-width MOSS-Audio-Tokenizer; phase 9c's Qwen3 backbone),
     each through tts_cli's branch: 25 greedy frames on the host path
     (q4_k_matmul 7 a layer a step; flash_sdpa_window 8 in the Mimi decode,
     15 in the MOSS decode) and in chunks of 8 (one replay each, its
     products counted under the profiler), card vs CPU and chunks vs host
     path (near-tie rule), a replay against the eager chunk bit for bit, one
     LFM2 request on Q8_0, one sampled realtime request with repetition
     penalty 1.2 over 16 codes (its ring after the first chunk, its codes
     against the CPU's with the same host noise); a Qwen3-MoE backbone
     (Qwen3-30B-A3B's widths, 1 of 48 layers: attention Q4_K, 128 experts
     dense) teacher-forced against the CPU (1e-5 of peak; q4_k_matmul 4 a
     layer a call) and a MOSS-TTSD request over it against the CPU; ms a
     frame host and replayed, kernels a frame, idle share, time to first
     audio, a frame and a replay under torch.profiler
  9f. serving (codec_tpu_torch/serve) over the files of phases 9, 9c and
     9d, each server in this process on 127.0.0.1, every response 200:
     the codec endpoints on the CSM file's Mimi (/health; /decode of 20 s
     byte-equal to model.decode(pcm_format="i16"), 8 flash_sdpa_window;
     /decode_stream in pushes of 25 frames within phase 8's stream bound
     of it;
     /batch_decode of 4 mixed lengths; /encode of 20 s equal to
     model.encode, 8 + 2 rvq_encode_fused); /decode requests running while
     the engine's server is built and captures its graph; a greedy
     25-frame /synthesize on the serialized server (Q4_K --quant-exec,
     on_device, chunks of 8) against the 4-slot engine (equal bytes, else
     the library calls' codes first differ at a near-tie); 8 concurrent
     sampled requests over the 4 slots, two replayed alone byte-equal; a
     streamed engine request (time to first audio); one Q8_0 engine
     request; /synthesize_batch of 4 CSM texts and of 4 Chatterbox texts
     (greedy, CFG 0.5), each stream against its single-stream chunked run
     (near-tie rule); a streamed Pocket-TTS /synthesize; each request's
     launch counts exact (its graph's capture run beforehand); the
     engine's ms a chunk and frames a second at 1, 2 and 4 active slots,
     one engine step under torch.profiler, q4_k_matmul launches by row
     bucket in one replay of the engine's graph (m = 4), the CSM batch's
     (m = 4) and the Chatterbox batch's (m = 8)
  10. CUDA-event times (median of TIMED_RUNS = 5 after 2 warm-ups), each kernel
     beside its plain version, its bound on this card and, for the
     attention and the packed products, one PyTorch call that computes
     the same function; the DAC residual unit at every decoder and
     encoder width, d = 1, f32 and bf16, and the chain against three unit
     launches at C96, C64 and C128 (tools/seanet_times.py, medians of
     TIMED_RUNS); SNAC's
     four decoder blocks' three units beside their bound; device
     times of the packed products from torch.profiler on the gate shape
     at m = 1, warm and cold (cycling over the loaded backbones' gate and
     up matrices), beside F.linear and the bound; CUDA events of
     back-to-back calls at the Llama-3.2-1B shapes at m = 4 and 8 and the
     Chatterbox T3 backbone's three at m = 8 (the serving rows);
     the Q4_K per-token TTS
     request's time (median of 2 runs after phase 9's); per-request
     encode times (median of 5 after 2 warm-ups);
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
     beside the banded plain version, SDPA with the band mask where that
     mask fits, and the bound;
     at n_q 1 the RVQ search also beside one cuBLAS product and an argmax
  11. the device mesh on one card (mesh_phase; codec_tpu_torch/parallel):
     meshes that name the card twice; data parallelism over Mimi 20 s b4
     decode and encode and DAC 20 s b4 decode, the pipeline-parallel
     Q4_K backbone of phase 9 (two stages), the same file dense and
     tensor-parallel, and phase 9e's Qwen3-MoE expert-parallel (64 + 64
     experts), each against the model unsharded; tts-cli-torch synthesize
     --pp 2 and codec-serve-torch --pp 2 byte-equal to their unsharded
     runs; launch counts of every sharded call
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
# CUDA-event timings: the median of this many runs after 2 warm-ups (5 keeps
# the whole smoke near 700 s on an H100 host, near 1000 s on one 1.5x slower)
TIMED_RUNS = 5

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
# (out, in) q/o, k/v, gate/up and down, at m = 1, 4 (the serving engine's
# and /synthesize_batch's step over 4 streams), 8, 16 and 32 rows with x in
# f32 and at m = 1 in bf16. The kernel and its plain version multiply the
# same dequantized weights in f32 with sums in another order: max abs err
# <= 1e-4 * max|plain|. One-hot rows must give the dequantized weights bit
# for bit.
QMAT_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
QMAT_MS = (1, 4, 8, 16, 32)
# timed in phase 10 beside F.linear and the bound at the serving rows
QMAT_SERVE_MS = (4, 8)
QMAT_MAIN = (8192, 2048)                # gate/up, the kernels' line shape
SHAPE_NAMES = {(2048, 2048): "q/o", (512, 2048): "k/v", (8192, 2048): "gate/up",
               (2048, 8192): "down"}
FORWARD_ORDER = ("q", "k", "v", "o", "gate", "up", "down")
L2_BYTES = 50 * 2 ** 20
FLUSH_BYTES = 64 * 2 ** 20
# -- the CSM TTS path: (name, backbone qtype, prefill bucket); each request
# is a 16-token prompt (ids from SEED) to 25 greedy frames (2 s at 12.5 Hz);
# the backbone is Llama-3.2-1B's widths cut to TTS_LAYERS of its 16 layers
# (28 packed products a forward, 224 in a replay of 8 frames)
TTS_REQUESTS = [("q4_k_per_token", "Q4_K", 0), ("q4_k_bucket16", "Q4_K", 16),
                ("q8_0_per_token", "Q8_0", 0)]
TTS_PROMPT, TTS_FRAMES, TTS_TIMED_RUNS, TTS_LAYERS = 16, 25, 2, 4
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
# -- the LM flows past CSM's at full width (phase 9c). Pocket-TTS: 125
# frames (10 s of speech at 12.5 Hz; EOS held off by min_len, random
# weights' EOS being arbitrary) in batch, streamed and with a 5 s voice
# prompt; its first 16 frames held against the CPU with the CPU's noise.
# MOSS-TTSD: 25 greedy frames, its Qwen3-1.7B-wide backbone cut to 4 of 28
# layers, Q4_K packed, the prompt prefilled in buckets of 64, the
# on-device chunk at 8 frames. BlueMagpie: 10 patches of 4 latent frames
# (10 Euler steps, 9 after the zero-init skip) with the state's fixed
# noise, its hidden-1024 backbone cut to 4 of 24 layers
LM_TEXT = "Hello there, this is the port speaking on the card."
POCKET_TTS_FRAMES, POCKET_TTS_REF_SECONDS, POCKET_TTS_CPU_FRAMES = 125, 5, 16
MOSS_TTSD_FRAMES, MOSS_TTSD_LAYERS, MOSS_TTSD_BUCKET = 25, 4, 64
MOSS_TTSD_CHUNK = 8
BM_TTS_PATCHES, BM_BACKBONE_LAYERS = 10, 4
# phase 9d's BlueMagpie request with --on-device: chunks of 8 patches (one
# CUDA graph replay each), its latents within this share of their peak of
# the eager path's on the card with the same noise (f32, TF32 off; the
# backbone step is another reduction than the host step's)
BM_CHUNK, BM_DEVICE_REL = 8, 1e-5
# AR drift between the card's and the CPU's f32 sums: latents and EOS
# logits within this share of their peak (Pocket's 16 frames, BlueMagpie's
# patches before any FSQ near-tie); decodes of the same latents corr >
# 0.99999, of each side's own latents > 0.9999
LM_AR_REL = 1e-3
# -- phase 9d, the Chatterbox TTS path at full width (models/chatterbox_init
# .py): T3 over a Llama-520M backbone (Q4_K; its dense f32 form for the
# host path and the CPU) into the full-width S3Gen. Greedy requests of
# CBX_FRAMES speech tokens (2 s of speech at 25 Hz) at CFG weight 0.5, the
# device path in chunks of CBX_CHUNK frames; a 10 s 16 kHz voice prompt
# through the VoiceEncoder (CBX_VOICE_FRAMES frames); a Qwen3-TTS ECAPA
# embedding of 10 s of 24 kHz. Speaker embeddings on the card within
# SPEAKER_REL of their peak of the CPU's (f32, TF32 off)
CBX_FRAMES, CBX_CHUNK, CBX_VOICE_FRAMES = 50, 8, 10
# the direct run_chatterbox requests prefill each lane's prompt in one
# forward padded to this bucket (the CLI's requests step it per token)
CBX_BUCKET = 128
CBX_VOICE_SECONDS = ECAPA_SECONDS = 10
SPEAKER_REL = 1e-5
# -- phase 9f, serving (codec_tpu_torch/serve): servers in this process
# over phase 9's CSM file and backbones, phase 9d's Chatterbox files and
# phase 9c's Pocket-TTS file. The codec endpoints on SERVE_SECONDS of codes
# (/decode_stream in pushes of SERVE_STREAM_CHUNK frames); greedy requests
# of SERVE_FRAMES frames, serialized (on_device, chunks of TTS_CHUNK) and
# through a SERVE_SLOTS-slot engine; SERVE_CONCURRENT sampled requests at
# once; the engine's chunk timed over SERVE_TIMED steps at 1, 2 and 4
# active slots; /synthesize_batch of SERVE_SLOTS CSM texts and of
# SERVE_SLOTS Chatterbox texts (SERVE_CBX_FRAMES frames, CFG 0.5: the
# products at m = 8)
SERVE_SLOTS, SERVE_FRAMES, SERVE_SECONDS, SERVE_STREAM_CHUNK = 4, 25, 20, 25
SERVE_CONCURRENT, SERVE_TIMED, SERVE_CBX_FRAMES = 8, 5, 24
SERVE_TEXTS = ("hello there", "hello", "there hello there", "he lo he")
# -- the packed products at the MOSS-TTSD backbone's (Qwen3-1.7B's) layer
# shapes (out, in): q/o, k/v, gate/up, down, at m = 1 and 8
QWEN3_QMAT_SHAPES = [(2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144)]
QWEN3_QMAT_MS = (1, 8)
# and at the Chatterbox T3 backbone's (Llama-520M's): q/k/v/o, gate/up,
# down, at m = 1 (a host step, one CFG lane), 2 (the device chunk's step,
# both lanes as one batch), 4 (phase 12's data-parallel share: 2 streams x
# 2 lanes) and 8 (/synthesize_batch's chunk: 4 streams x 2 lanes)
T3_QMAT_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096)]
T3_QMAT_MS = (1, 2, 4, 8)
# and at the Qwen3-MoE backbone's (Qwen3-30B-A3B's) attention shapes that
# no other backbone has: q (32 heads x 128 from 2048) and o, at m = 1 and 8
MOE_QMAT_SHAPES = [(4096, 2048), (2048, 4096)]
MOE_QMAT_MS = (1, 8)
# -- phase 9e, the rest of the LM layer at full width (models/lm_tts_init.py):
# LFM2-Audio (its depthformer and compose table over the full-width Mimi's 8
# first codebooks; a llama backbone at LFM2-1.2B's widths cut to 4 of 16
# layers, Q4_K, and Q8_0 for one request), MOSS-TTS-Realtime (its local
# transformer and compose table over the full-width MOSS-Audio-Tokenizer;
# phase 9c's Qwen3-1.7B-wide Q4_K backbone, 4 of 28 layers) and a Qwen3-MoE
# backbone (Qwen3-30B-A3B's widths cut to 1 of 48 layers: attention Q4_K,
# router and 128 experts dense) under phase 9c's MOSS-TTSD file. Greedy
# requests of FLOW_FRAMES frames (EOS held off past them), the prompts
# prefilled in one forward padded to FLOW_BUCKET rows, the device paths in
# chunks of FLOW_CHUNK frames (one replay each); the CPU's requests (the
# same files, f32) run the first FLOW_CPU_FRAMES frames. LFM2's text phase
# is cut to LFM2_TEXT_TOKENS greedy tokens (codec.lm.max_text_tokens; 64 is
# the published default). The sampled realtime request: the family's chain
# (temperature 0.8, top_k 30, top_p 0.6) with repetition penalty 1.2 over
# 16 codes a codebook, RT_SAMPLED_FRAMES frames on the card, its first frames
# on the CPU in a chunk of FLOW_CPU_FRAMES (the noise is drawn on the host,
# one draw a frame, so both draw the same).
FLOW_FRAMES, FLOW_CHUNK, FLOW_BUCKET, FLOW_CPU_FRAMES = 25, 8, 64, 4
LFM2_LAYERS, LFM2_TEXT_TOKENS = 4, 4
RT_SAMPLED = dict(temperature=0.8, top_k=30, top_p=0.6,
                  repetition_penalty=1.2, repetition_window=16, seed=7)
RT_SAMPLED_FRAMES = 24
# the MoE backbone's hiddens on the card within MOE_REL of their peak of the
# CPU's, teacher-forced over a MOE_PROMPT-row prefill and MOE_STEPS steps
MOE_LAYERS, MOE_PROMPT, MOE_STEPS, MOE_REL = 1, 16, 8, 1e-5
# -- phase 11, the mesh on one card (codec_tpu_torch/parallel): every mesh
# names the card twice, make_mesh(2, devices=["cuda:0"] * 2), so each
# device's share runs on it in turn (a time here is no scaling number). DP:
# Mimi 20 s b4 f32 decode and encode, DAC 20 s b4 f32 decode (decodes
# within MESH_REL of the unsharded model's peak, corr > 0.99999; encodes
# the near-tie rule); PP: phase 9's Q4_K backbone (4 of 16 layers, 2
# stages) and TP: the same file dense, split 2 ways, each a MESH_PROMPT-row
# prefill and MESH_STEPS teacher-forced steps (hiddens within MESH_BB_REL of
# the unsharded peak) and one greedy host-path request of MESH_FRAMES
# frames; EP: phase 9e's Qwen3-MoE (128 experts, 64 + 64) the same way;
# tts-cli-torch synthesize --pp 2 and codec-serve-torch --pp 2's /synthesize
# of MESH_FRAMES greedy frames against their unsharded runs
MESH_N, MESH_SECONDS, MESH_BATCH, MESH_REL = 2, 20, 4, 1e-4
MESH_PROMPT, MESH_STEPS, MESH_BB_REL, MESH_FRAMES = 16, 25, 1e-5, 10
# -- phase 12, the CUDA-graph paths on the mesh (one card named 2 or 4
# times): GRAPH_STREAMS CSM streams over dp 2 (the packed products at m =
# 4 a share, 8 unsharded: rows phase 10 times) and over dp 2 x tp 2 (the
# backbone dense), GRAPH_FRAMES greedy frames in chunks of GRAPH_CHUNK
# after a bucketed prefill of GRAPH_PROMPT tokens; TP and EP single-stream
# chunks, MOSS-TTS-Realtime's stream chunk and BlueMagpie's continuous
# chunk over TP 2; GRAPH_CBX_STREAMS Chatterbox streams over dp 2 (T3's
# products at m = 4 a share: 2 streams x 2 lanes); codec-serve-torch --dp 2
# --tp 2's /synthesize_batch and --dp 2 --cont-batch GRAPH_SLOTS's
# /synthesize against their unsharded servers
GRAPH_STREAMS, GRAPH_FRAMES, GRAPH_PROMPT, GRAPH_CHUNK = 8, 16, 16, 8
GRAPH_CBX_STREAMS, GRAPH_SLOTS, GRAPH_BM_PATCHES = 4, 8, 10


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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def write_files(*jobs):
    """Run the zero-argument writers at once, a thread each (their random
    draws, quantization and file writes leave the GIL) → their results in
    order; a writer's error raises here."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return [f.result() for f in [pool.submit(job) for job in jobs]]


_AHEAD: dict = {}    # phase → (its directory, its writers' future)


def write_ahead(key: str, prefix: str, jobs, sizes=None) -> None:
    """Start phase `key`'s random GGUF writes on a background thread: a new
    temporary directory (`prefix`) and jobs(its path, sizes) → the
    zero-argument writers (write_files runs them). The phase before it
    goes on running on the card meanwhile; the phase itself takes its
    files with `ahead`."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.TemporaryDirectory(prefix=prefix)
    pool = ThreadPoolExecutor(max_workers=1)
    _AHEAD[key] = (tmp, pool.submit(write_files,
                                    *jobs(Path(tmp.name), sizes or {})))
    pool.shutdown(wait=False)


def ahead(key: str, prefix: str, jobs, sizes=None):
    """Phase `key`'s files → (their temporary directory, the writers'
    results, the seconds the phase waited for them): the writes
    `write_ahead` started, or where none was (a phase run alone, as the
    CPU rehearsals do) written now. A writer's error raises here, after
    its directory is removed."""
    t0 = time.monotonic()
    tmp, fut = _AHEAD.pop(key, (None, None))
    if fut is None:
        tmp = tempfile.TemporaryDirectory(prefix=prefix)
    try:
        out = fut.result() if fut is not None else \
            write_files(*jobs(Path(tmp.name), sizes or {}))
    except BaseException:
        tmp.cleanup()
        raise
    return tmp, out, time.monotonic() - t0


def wrote(tag: str, paths, waited: float) -> None:
    log(f"[{tag}] wrote " + ", ".join(
        f"{p.name} ({p.stat().st_size / 2**20:.1f} MiB)" for p in paths)
        + f" (waited {waited:.2f} s for the writes)")


def model_files(d: Path, sizes: dict) -> list:
    """Phases 4-5's writers: Mimi, DAC and SNAC at full width, each with
    its encoder."""
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf

    return [(lambda w=w, n=n: w(d / f"{n}_random.gguf", seed=SEED,
                                encoder=True))
            for w, n in ((write_random_mimi_gguf, "mimi"),
                         (write_random_dac_gguf, "dac"),
                         (write_random_snac_gguf, "snac"))]


def tts_files(d: Path, sizes: dict) -> list:
    """Phase 9's writers: the CSM codec (with its Mimi encoder, for phase
    9f's /encode) and Q4_K and Q8_0 backbones at Llama-3.2-1B's widths,
    TTS_LAYERS of its 16 layers, one draw of the weights for both types
    quantized on a pool of threads, the byte-fallback vocabulary (phase
    9f's server tokenizes with it)."""
    import dataclasses

    from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B,
                                                byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_ggufs,
                                                write_random_csm_gguf)

    return [lambda: write_random_csm_gguf(d / "csm_random.gguf", seed=SEED,
                                          encoder=True),
            lambda: write_random_backbone_ggufs(
                {q: d / f"backbone_{q}.gguf" for q in ("Q4_K", "Q8_0")},
                seed=SEED, cfg=dataclasses.replace(LLAMA_3_2_1B,
                                                   n_layers=TTS_LAYERS),
                spm_b64=spm_model_b64(byte_fallback_vocab()))]


def istft_files(d: Path, sizes: dict) -> list:
    """Phase 8b's writers: WavTokenizer, Soprano and XY-Tokenizer at full
    width."""
    from codec_tpu_torch.models.soprano_init import write_random_soprano_gguf
    from codec_tpu_torch.models.wavtokenizer_init import write_random_wt_gguf
    from codec_tpu_torch.models.xy_init import write_random_xy_gguf

    return [lambda: write_random_wt_gguf(d / "wavtokenizer_random.gguf",
                                         seed=SEED, encoder=True),
            lambda: write_random_soprano_gguf(d / "soprano_random.gguf",
                                              seed=SEED),
            lambda: write_random_xy_gguf(d / "xy_tokenizer_random.gguf",
                                         seed=SEED, encoder=True)]


def windowed_files(d: Path, sizes: dict) -> list:
    """Phase 8c's writers: Qwen3-TTS-Tokenizer and Pocket-Mimi."""
    from codec_tpu_torch.models.pocket_init import write_random_pocket_gguf
    from codec_tpu_torch.models.qwen3_tts_init import write_random_q3t_gguf

    return [lambda: write_random_q3t_gguf(d / "qwen3_random.gguf", seed=SEED),
            lambda: write_random_pocket_gguf(d / "pocket_random.gguf",
                                             seed=SEED)]


def neu_files(d: Path, sizes: dict) -> list:
    """Phase 8d's writers: NeuCodec, DistillNeuCodec and XCodec2."""
    from codec_tpu_torch.models.neucodec_init import write_random_neu_gguf
    from codec_tpu_torch.models.xcodec2_init import write_random_x2_gguf

    return [lambda: write_random_neu_gguf(d / "neucodec_random.gguf",
                                          seed=SEED),
            lambda: write_random_neu_gguf(d / "distill_neucodec_random.gguf",
                                          seed=SEED, encoder=True),
            lambda: write_random_x2_gguf(d / "xcodec2_random.gguf", seed=SEED,
                                         encoder=True)]


def small_files(d: Path, sizes: dict) -> list:
    """Phase 8e's writers: MOSS, NeMo nano, BlueMagpie, S3T."""
    from codec_tpu_torch.models.bluemagpie_init import write_random_bm_gguf
    from codec_tpu_torch.models.moss_init import write_random_moss_gguf
    from codec_tpu_torch.models.nemo_init import write_random_nemo_gguf
    from codec_tpu_torch.models.s3t_init import write_random_s3t_gguf

    writers = {"moss": write_random_moss_gguf, "nemo": write_random_nemo_gguf,
               "bluemagpie": write_random_bm_gguf,
               "s3t": write_random_s3t_gguf}
    return [(lambda a=arch, w=write: w(
        d / f"{a}_random.gguf", seed=SEED,
        **({} if a == "s3t" else {"encoder": True})))
        for arch, write in writers.items()]


def s3g_files(d: Path, sizes: dict) -> list:
    """Phase 8f's writer: Chatterbox S3Gen."""
    from codec_tpu_torch.models.s3g_init import write_random_s3g_gguf

    return [lambda: write_random_s3g_gguf(d / "s3g_random.gguf", seed=SEED)]


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
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    files, _, waited = ahead("istft", "chip_smoke_istft_", istft_files)
    with files as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf"
                 for a in ("wavtokenizer", "soprano", "xy_tokenizer")}
        wrote("istft", paths.values(), waited)
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
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref
    from codec_tpu_torch.ops.rvq import rvq_encode
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    files, _, waited = ahead("windowed", "chip_smoke_windowed_",
                             windowed_files)
    with files as tmp:
        paths = {"qwen3": Path(tmp) / "qwen3_random.gguf",
                 "pocket": Path(tmp) / "pocket_random.gguf"}
        wrote("windowed", paths.values(), waited)
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
    the CPU from the same file (a batch on its first row, and each of its
    rows against the card's one-row decode of it; corr > 0.99999, max abs
    err <= 1e-4 x peak), the distill decode against the base file's bit
    for bit, each f16
    decode against the f32 model on the card (corr > 0.9999); each f32
    encode against the CPU on a NEU_CPU_ENCODE_SECONDS request run both
    ways (the FSQ near-tie rule: fsq_near_ties); one encode → decode round
    trip an encoding arch. Each request's median time (CUDA events, 5
    after 2 warm-ups). → this phase's launch counts (all 0)."""
    import codec_tpu_torch
    from codec_tpu_torch import CodecError
    from codec_tpu_torch.models import neucodec as neu
    from codec_tpu_torch.models import xcodec2 as x2
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    files, _, waited = ahead("neu", "chip_smoke_neu_", neu_files)
    with files as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf"
                 for a in ("neucodec", "distill_neucodec", "xcodec2")}
        wrote("neu", paths.values(), waited)
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
            # a batch: its first row against the CPU's decode of that row,
            # and every row against the card's one-row decode of it (a
            # fault that mixes rows shows there; the CPU's b4 decode costs
            # the smoke ~20 s)
            ref = models[arch, "cpu", dt].decode(codes[:1])
            c = corr(pcm[:1], ref)
            err, peak = np.abs(pcm[:1] - ref).max(), np.abs(ref).max()
            if not (c > 0.99999 and err <= 1e-4 * peak):
                raise RuntimeError(f"{arch} decode {name}: corr {c}, max abs "
                                   f"err {err} (peak {peak}) vs the CPU")
            line += (f"; {'row 0 ' if batch > 1 else ''}vs the same function "
                     f"on the CPU: corr {c:.9f}, max abs err {err:.3e} "
                     f"({err / peak:.2e} of peak {peak:.4f})")
            if batch > 1:
                rows = []
                for i in range(batch):
                    one = model.decode(codes[i:i + 1])
                    c = corr(pcm[i:i + 1], one)
                    err, peak = (np.abs(pcm[i:i + 1] - one).max(),
                                 np.abs(one).max())
                    if not (c > 0.99999 and err <= 1e-4 * peak):
                        raise RuntimeError(
                            f"{arch} decode {name}: row {i} corr {c}, max "
                            f"abs err {err} (peak {peak}) vs its one-row "
                            f"decode on the card")
                    rows.append((c, err / peak))
                line += (f"; each row vs its one-row decode on the card: "
                         f"corr >= {min(r[0] for r in rows):.9f}, max abs "
                         f"err <= {max(r[1] for r in rows):.2e} of peak")
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
    arch that decodes. Each request's median time (CUDA events, 5 after
    2 warm-ups). → this phase's launch counts."""
    import codec_tpu_torch
    from codec_tpu_torch.models import bluemagpie, chatterbox_s3t, moss_audio
    from codec_tpu_torch.models import nemo_nano
    from codec_tpu_torch.models.nemo_init import LEVELS
    from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    models = {}
    writers = ("moss", "nemo", "bluemagpie", "s3t")
    files, _, waited = ahead("small", "chip_smoke_small_", small_files)
    with files as tmp:
        paths = {a: Path(tmp) / f"{a}_random.gguf" for a in writers}
        wrote("small", paths.values(), waited)
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
        S3G_BF16_CORR); each request's median time (CUDA events, 5 after 2
        warm-ups), x realtime, and the f32 call's device busy time, idle
        share and top kernels under torch.profiler;
      - the NSF phase of the 20 s request's f0 summed in float32 on the
        card and on the CPU (how far two f32 running sums drift) and as
        the port sums it (float64, rounded once).
    → this phase's launch counts (all 0)."""
    import codec_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    from codec_tpu_torch.models import chatterbox_s3g as s3g
    from codec_tpu_torch.runtime.model import f32_precision

    t_phase = time.monotonic()
    files, _, waited = ahead("s3g", "chip_smoke_s3g_", s3g_files)
    with files as tmp:
        path = Path(tmp) / "s3g_random.gguf"
        wrote("s3g", [path], waited)
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
        # one f32 call under the profiler (the bf16 call's trace costs the
        # smoke more than it tells); a trace that lost device events (far
        # fewer launches than the ~18 500 a request makes) is taken again
        if dt == "float32":
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                         f"{busy:.3f} ms, idle share "
                         f"{max(0.0, 1 - busy / ms):.3f}, "
                         f"{sum(e.count for e in kern)} kernel launches; top "
                         f"kernels " + "; ".join(
                             f"{e.self_device_time_total / 1e3:.3f} ms "
                             f"x{e.count} {e.key[:60]}" for e in top))
            else:
                line += ("; device busy time not measured (short profiler "
                         "traces)")
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


def call_profile(fn, cuda: bool):
    """(device busy ms, kernels, wall ms, idle share) of one call, the wall
    time of a call without the profiler; None ("not measured") on the CPU
    or when 5 traces in a row hold no device time (CUPTI's trace loses
    events now and then)."""
    if not cuda:
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in trace.key_averages()
                if e.self_device_time_total > 0
                and not e.key.startswith(("aten::", "Memcpy", "Memset"))]
        if kern:
            busy = sum(e.self_device_time_total for e in kern) / 1e3
            return (busy, sum(e.count for e in kern), wall,
                    max(0.0, 1 - busy / wall))
    return None


def fmt_profile(p) -> str:
    if p is None:
        return "not measured"
    return (f"{p[1]} kernels, device busy {p[0]:.3f} ms of {p[2]:.3f} ms "
            f"(idle share {p[3]:.3f})")


def _cleanup(tmp, reuse=None, key: str = "", keep=()):
    """Remove a phase's temporary files, or with `reuse` keep the files in
    `keep` for phase 9f (reuse[key] = (tmp, *keep); the directory goes when
    that entry does) and remove the rest."""
    if reuse is None:
        tmp.cleanup()
        return
    for p in Path(tmp.name).iterdir():
        if p not in keep:
            p.unlink()
    reuse[key] = (tmp, *keep)


def lm_files(d: Path, sizes: dict) -> list:
    """Phase 9c's writers: Pocket-TTS, MOSS-TTSD, its Q4_K Qwen3 backbone
    (MOSS_TTSD_LAYERS layers), BlueMagpie and its f32 MiniCPM backbone
    (BM_BACKBONE_LAYERS); `sizes` as lm_flows takes them."""
    import dataclasses

    from codec_tpu_torch.models import lm_tts_init as lti
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_ggufs)

    spm = spm_model_b64(byte_fallback_vocab())
    qcfg = sizes.get("qwen3", dataclasses.replace(
        lti.QWEN3_1_7B, n_layers=MOSS_TTSD_LAYERS))
    mcfg = sizes.get("minicpm", dataclasses.replace(
        lti.MINICPM4_0_5B, n_layers=BM_BACKBONE_LAYERS))
    return [
        lambda: lti.write_pocket_tts_gguf(
            d / "pocket_tts_random.gguf", seed=SEED,
            **sizes.get("pocket", {})),
        lambda: lti.write_moss_ttsd_gguf(
            d / "moss_ttsd_random.gguf", seed=SEED,
            **sizes.get("moss", {"phd": lti.PhdConfig(
                eos_min_step=MOSS_TTSD_FRAMES)})),
        lambda: write_random_backbone_ggufs(
            {"Q4_K": d / "qwen3_Q4_K.gguf"}, seed=SEED + 1, cfg=qcfg,
            rope_scaling=None, spm_b64=spm)["Q4_K"],
        lambda: lti.write_bluemagpie_tts_gguf(
            d / "bluemagpie_tts_random.gguf", seed=SEED,
            **sizes.get("bluemagpie", {})),
        lambda: write_random_backbone_ggufs(
            {"F32": d / "minicpm_F32.gguf"}, seed=SEED + 2, cfg=mcfg,
            rope_scaling=None, spm_b64=spm)["F32"]]


def lm_flows(name_limit: str, zero_counts, counts, none: dict,
             dev: str = "cuda", sizes=None, reuse=None) -> dict:
    """Phase 9c: the three LM flows past CSM's, each written at full width
    (models/lm_tts_init.py) and run through the entry points a user calls,
    with every launch count set to 0 just before each request and read just
    after; the card's results held against the CPU's on the same file.
      - Pocket-TTS (flow_lm over Pocket-Mimi, f32 and a bf16 codec):
        run_flow_synthesize batch, streamed, with a voice prompt, and bf16
        (flash_sdpa_window: 2 a decode_latent, 2 a push, 2 an
        encode_latent); streamed PCM against batch; the first 16 frames'
        latents and EOS logits against the CPU's with the same host noise,
        the decode of those latents against the CPU's; ms an AR frame,
        time to first audio, x realtime; one frame under the profiler.
      - MOSS-TTSD (parallel_heads_delay over a Q4_K Qwen3 backbone and
        XY-Tokenizer): 25 greedy frames on the host path (q4_k_matmul: 7 a
        layer a backbone call) and on the device in chunks (one replay a
        chunk, its products counted under the profiler), codes against
        the CPU's and each other (near-tie rule); ms a frame.
      - BlueMagpie (continuous_latent_cfm over an f32 backbone and the
        AudioVAE): 10 patches through run_continuous with the state's
        fixed noise, latents against the CPU's (FSQ near-tie rule), PCM
        shape and finite samples; ms a patch; one patch under the
        profiler.
    `dev` and `sizes` (the writers' keyword arguments, the requests'
    lengths) let the phase run small on the CPU
    (tests/test_torch_flow_lm.py), where the plain versions count nothing
    and the launch counts are those the card is held to. `reuse`, a dict,
    receives what phase 9e reuses: the MOSS-TTSD adaptor, codec and prompt
    ("ttsd") and the Qwen3 backbone on the card and the CPU ("qwen3"); and
    phase 9f's Pocket-TTS file ("pocket" = (its directory, the file)).
    → (launch counts, times)."""
    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import (flow_prepare_text,
                                             run_flow_synthesize)
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import create_backbone
    from codec_tpu_torch.lm.fused_gen import chunk_ctx, gen_chunk_cached
    from codec_tpu_torch.lm.prompt_info import build_prompt_info
    from codec_tpu_torch.lm.spm import SpmUnigram
    from codec_tpu_torch.lm.tts_runner import (_decode_transformed,
                                               run_codebook_ar,
                                               run_continuous)
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64)
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    sizes = sizes or {}
    cuda = dev == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def held(label, got, want, rel):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if got.shape != want.shape or not np.isfinite(got).all() \
                or not err <= rel * peak:
            raise RuntimeError(f"{label}: shape {got.shape} vs {want.shape}, "
                               f"max abs err {err} (peak {peak}, bound "
                               f"{rel} x peak)")
        return err / peak

    def launches(label, want):
        """The counts since zero_counts(), which must be `want` (a CPU
        rehearsal runs the plain versions, which count nothing)."""
        want = {**none, **want}
        got = counts() if cuda else want
        if got != want:
            raise RuntimeError(f"{label}: launches {got}, want {want}")
        return got

    def frame_profile(fn):
        return call_profile(fn, cuda)

    fmt_prof = fmt_profile

    t_phase = time.monotonic()
    carried = "flash_sdpa_window (carried keys)"
    phase_counts, times = dict(none, **{carried: 0}), {}
    spm = spm_model_b64(byte_fallback_vocab())
    tmp, (pt_path, ttsd_path, q_path, bm_path, m_path), waited = ahead(
        "lm", "chip_smoke_lm_", lm_files, sizes)
    try:
        paths = (pt_path, ttsd_path, q_path, bm_path, m_path)
        wrote("lm", paths, waited)
        t0 = time.monotonic()
        load = codec_tpu_torch.load_model
        pt = {dt: load(pt_path, compute_dtype=dt, device=dev)
              for dt in ("float32", "bfloat16")}
        pt_cpu = load(pt_path, device="cpu")
        pt_reader = GGUFReader(pt_path)
        flm, flm_cpu = (create_lm(pt_reader, device=x) for x in (dev, "cpu"))
        xy = load(ttsd_path, device=dev)
        ttsd_reader = GGUFReader(ttsd_path)
        plm, plm_cpu = (create_lm(ttsd_reader, device=x) for x in (dev, "cpu"))
        qbb, qbb_cpu = (create_backbone(q_path, quantized=True, device=x)
                        for x in (dev, "cpu"))
        vae, vae_cpu = (load(bm_path, device=x) for x in (dev, "cpu"))
        bm_reader = GGUFReader(bm_path)
        clm, clm_cpu = (create_lm(bm_reader, device=x) for x in (dev, "cpu"))
        mbb, mbb_cpu = (create_backbone(m_path, device=x)
                        for x in (dev, "cpu"))
        sync()
    finally:
        _cleanup(tmp, reuse, "pocket", (pt_path,))
    log(f"[lm] loaded (card f32, Pocket also bf16; CPU f32) in "
        f"{time.monotonic() - t0:.2f} s: Pocket-TTS flow_lm d_model "
        f"{flm.d_model}, {flm.n_layers} layers, {flm.n_heads} heads x "
        f"{flm.head_dim}, ldim {flm.ldim}, flow {flm.flow_dim} x "
        f"{flm.flow_depth}, {flm.lsd_steps} LSD steps; MOSS-TTSD "
        f"{plm.info.n_codebook} heads of {plm.info.codebook_sizes} (tied), "
        f"backbone hidden {qbb.cfg.hidden}, {qbb.cfg.n_layers} layers, "
        f"{qbb.cfg.n_heads} heads x {qbb.cfg.head_dim}, {qbb.cfg.n_kv_heads} "
        f"KV heads, FFN {qbb.cfg.ffn_dim}, qk-norm {qbb.cfg.has_qk_norm}, "
        f"vocab {qbb.cfg.vocab_size}; BlueMagpie CFM hidden {clm.h_barbet}, "
        f"h_vox {clm.h_vox}, LocDiT {clm.n_locdit} / LocEnc {clm.n_locenc} x "
        f"{clm.h_dit}, RALM {clm.n_ralm} x {clm.h_vox}, {clm.n_heads} / "
        f"{clm.n_kv} heads x {clm.head_dim}, patch {clm.patch_size} x "
        f"{clm.latent_dim}, backbone hidden {mbb.cfg.hidden}, "
        f"{mbb.cfg.n_layers} layers")

    # -- Pocket-TTS ------------------------------------------------------------
    frames = sizes.get("pocket_frames", POCKET_TTS_FRAMES)
    hop, sr = pt["float32"].hop_size, pt["float32"].sample_rate
    audio_s = frames * hop / sr
    rng = np.random.default_rng(SEED + 1000)
    ref = (rng.standard_normal(int(sizes.get(
        "ref_seconds", POCKET_TTS_REF_SECONDS) * sr)) * 0.1).astype(np.float32)

    class FirstPush:
        """The model with its streaming decoder's first push timed."""

        def __init__(self, model):
            self.model, self.first = model, None

        def __getattr__(self, name):
            return getattr(self.model, name)

        def streaming_decoder(self):
            sess, outer = self.model.streaming_decoder(), self

            class Timed:
                def push(self, z):
                    out = sess.push(z)
                    if outer.first is None:
                        outer.first = time.perf_counter()
                    return out
            return Timed()

    def flow_request(dt="float32", stream=False, ref_pcm=None, model=None):
        t = time.perf_counter()
        pcm, n, stop = run_flow_synthesize(
            model or pt[dt], flm, LM_TEXT, seed=SEED, ref_pcm=ref_pcm,
            max_frames=frames, min_len=frames, stream=stream)
        total = time.perf_counter() - t
        if (n, stop) != (frames, "max_frames") or pcm.shape != (frames * hop,) \
                or not np.isfinite(pcm).all():
            raise RuntimeError(f"pocket-tts {dt} stream={stream}: {n} frames, "
                               f"stop {stop}, pcm {pcm.shape}")
        return pcm, total, t

    pocket_runs = {}
    for name, kw, want in (
            ("batch f32", {}, 2), ("stream f32", {"stream": True}, 2 * frames),
            ("voice prompt f32", {"ref_pcm": ref}, 4),
            ("batch bf16", {"dt": "bfloat16"}, 2)):
        zero_counts()
        pcm, total, _ = flow_request(**kw)
        got = launches(f"pocket-tts {name}", {"flash_sdpa_window": want})
        # a push's launches take the window's carried keys (the kernels
        # line's second attention row)
        phase_counts[carried if "stream" in kw else "flash_sdpa_window"] += want
        pocket_runs[name] = pcm
        log(f"[lm] pocket-tts {name}: {frames} frames, pcm {pcm.shape} finite, "
            f"peak {np.abs(pcm).max():.4f}; launches {want} "
            f"flash_sdpa_window; {total:.3f} s")
    c_stream = corr(pocket_runs["stream f32"], pocket_runs["batch f32"])
    c_bf16 = corr(pocket_runs["batch bf16"], pocket_runs["batch f32"])
    if not (c_stream > 0.99999 and c_bf16 > 0.99):
        raise RuntimeError(f"pocket-tts: streamed vs batch corr {c_stream}, "
                           f"bf16 vs f32 corr {c_bf16}")
    # the card's first frames against the CPU's, the same host noise
    ids = flm.tokenize(flow_prepare_text(LM_TEXT)[0])
    n_cpu = min(POCKET_TTS_CPU_FRAMES, frames)
    noises = (np.random.default_rng(SEED).standard_normal((n_cpu, flm.ldim))
              * math.sqrt(flm.temperature)).astype(np.float32)
    outs = []
    for lm_ in (flm, flm_cpu):
        st = lm_.new_state()
        lm_.flow_prefill(st, ids)
        outs.append(lm_.flow_run(st, noises))
    (lat, eos), (lat_c, eos_c) = outs
    lat_rel = max(held(f"pocket-tts frame {i} latent", lat[i], lat_c[i],
                       LM_AR_REL) for i in range(n_cpu))
    eos_err = float(np.abs(eos - eos_c).max())
    if not eos_err <= LM_AR_REL * max(1.0, float(np.abs(eos_c).max())):
        raise RuntimeError(f"pocket-tts EOS logits card vs CPU: {eos_err}")
    z = flm.denorm_latent(lat_c)
    zero_counts()
    dec = pt["float32"].decode_latent(z)
    launches("pocket-tts decode_latent", {"flash_sdpa_window": 2})
    c_dec = corr(dec, pt_cpu.decode_latent(z))
    if not c_dec > 0.99999:
        raise RuntimeError(f"pocket-tts decode card vs CPU: corr {c_dec}")
    # times: an AR frame (16 frames a flow_run call, one copy to the host),
    # a request, time to first audio when streaming
    st = flm.new_state()
    ar = []
    for _ in range(4):
        flm.flow_reset(st)
        flm.flow_prefill(st, ids)
        t = time.perf_counter()
        flm.flow_run(st, noises)
        ar.append((time.perf_counter() - t) * 1e3 / n_cpu)
    ar_ms = statistics.median(ar[1:])
    reqs, ttfa = [], []
    for _ in range(3):
        reqs.append(flow_request()[1])
        timed = FirstPush(pt["float32"])
        _, _, t_start = flow_request(stream=True, model=timed)
        ttfa.append((timed.first - t_start) * 1e3)
    req_s, ttfa_ms = statistics.median(reqs), statistics.median(ttfa)
    flm.flow_reset(st)
    flm.flow_prefill(st, ids)
    prof = frame_profile(lambda: flm.flow_step(st, noise=noises[0]))
    times["pocket"] = dict(ar_ms=ar_ms, request_s=req_s, ttfa_ms=ttfa_ms,
                           xrt=audio_s / req_s, profile=prof)
    log(f"[lm] pocket-tts: streamed vs batch corr {c_stream:.9f}, bf16 codec "
        f"vs f32 corr {c_bf16:.6f}; first {n_cpu} frames vs the CPU (same "
        f"noise): latents max rel err {lat_rel:.2e}, EOS logits max abs err "
        f"{eos_err:.2e}; decode of those latents card vs CPU corr "
        f"{c_dec:.9f}; AR {ar_ms:.3f} ms a frame ({n_cpu} frames a flow_run, "
        f"median of 3), request {req_s * 1e3:.1f} ms for {audio_s:.0f} s "
        f"({audio_s / req_s:.2f}x realtime, median of 3), time to first "
        f"audio streaming {ttfa_ms:.1f} ms (median of 3); one AR frame "
        f"(flow_step) under torch.profiler: {fmt_prof(prof)} [{name_limit}]")

    # -- MOSS-TTSD -------------------------------------------------------------
    n_fr = sizes.get("moss_frames", MOSS_TTSD_FRAMES)
    pi = build_prompt_info(ttsd_reader, plm.info)
    tok = SpmUnigram.from_b64(spm)            # the backbones' baked vocab
    ttsd_ids = tok.encode(pi.prompt_prefix + LM_TEXT + pi.prompt_suffix)
    per_call = 7 * qbb.cfg.n_layers
    cb0 = (pi.cb0_speech_range_start, pi.cb0_speech_range_end)

    def ttsd_request(lm_, codec_, bb_, on_device=None, decode=True):
        bb_.reset()
        alm = AudioLM(ttsd_reader, codec=codec_, lm=lm_)
        rows = [alm.compose_prompt_embd(t) for t in ttsd_ids]
        rec = Recorder(bb_) if on_device is None else bb_
        t = time.perf_counter()
        res = run_codebook_ar(alm, rec, rows, max_steps=n_fr, pi=pi,
                              on_device=on_device, decode=False,
                              prefill_bucket=MOSS_TTSD_BUCKET)
        gen = time.perf_counter() - t
        if res.codes.shape != (n_fr, plm.info.n_codebook) \
                or res.stopped_by_eos:
            raise RuntimeError(f"moss-ttsd: codes {res.codes.shape}, eos "
                               f"{res.stopped_by_eos}")
        t = time.perf_counter()
        pcm = _decode_transformed(alm, res.codes) if decode else None
        return res, pcm, rec, gen, time.perf_counter() - t

    def same_or_tie(label, got, want, rec):
        """Equal codes, or the first difference a near-tie on the card's
        host path (relative top-2 margin of that head's masked logits)."""
        diff = np.argwhere(got != want)
        if not len(diff):
            return "codes equal"
        f, k = (int(v) for v in diff[0])
        h = torch.as_tensor(rec.calls[f][2]).to(dev)
        lg = (plm.heads[k] @ h).float().cpu().numpy()
        if k == 0:
            keep = np.zeros(lg.shape, bool)
            keep[cb0[0]:cb0[1]] = True
            if plm.info.eos_code_c0 >= 0:
                keep[plm.info.eos_code_c0] = True
            lg = np.where(keep, lg, -np.inf)
        top = np.sort(lg)[-2:]
        margin = float((top[1] - top[0]) / abs(top[1]))
        if not margin < NEAR_TIE:
            raise RuntimeError(f"moss-ttsd {label}: codes first differ at "
                               f"frame {f} codebook {k}, margin {margin}")
        return (f"codes first differ at frame {f} codebook {k}: a near-tie "
                f"(relative top-2 margin {margin:.2e})")

    # the packed products launch the kernel at m <= 32 (ops/qmat.py): the
    # steps, not a prefill of the whole prompt's rows, which dequantizes
    pre_launches = per_call if len(ttsd_ids) <= 32 else 0
    zero_counts()
    res, pcm, rec, gen_s, dec_s = ttsd_request(plm, xy, qbb)
    calls = len(rec.calls) - 1
    got = launches("moss-ttsd host", {"q4_k_matmul": per_call * calls
                                      + pre_launches})
    for k in got:
        phase_counts[k] += got[k]
    if not np.isfinite(pcm).all():
        raise RuntimeError("moss-ttsd: pcm not finite")
    cres, _, _, cpu_s, _ = ttsd_request(plm_cpu, None, qbb_cpu,
                                        decode=False)
    note_cpu = same_or_tie("card vs CPU", res.codes, cres.codes, rec)
    pre_s = rec.calls[0][3]
    host_ms = (gen_s - pre_s) / n_fr * 1e3
    # the device path: chunks of MOSS_TTSD_CHUNK frames, one replay each
    ods = OnDeviceSampling(chunk_frames=MOSS_TTSD_CHUNK)
    ttsd_request(plm, xy, qbb, on_device=ods)                    # captures
    zero_counts()
    dres, dpcm, _, dgen_s, _ = ttsd_request(plm, xy, qbb, on_device=ods)
    got = launches("moss-ttsd device", {"q4_k_matmul": pre_launches})
    for k in got:
        phase_counts[k] += got[k]
    note_dev = same_or_tie("device vs host", dres.codes, res.codes, rec)
    line = (f"[lm] moss-ttsd {n_fr} greedy frames, prompt {len(ttsd_ids)} "
            f"tokens (one bucketed prefill): host path launches "
            f"{per_call * calls + pre_launches} q4_k_matmul ({calls} backbone "
            f"steps; the prefill's {len(ttsd_ids)} rows "
            f"{'launch' if pre_launches else 'dequantize'}), pcm "
            f"{pcm.shape} finite; card vs CPU: {note_cpu} (CPU "
            f"{cpu_s:.1f} s); device path (chunks of "
            f"{MOSS_TTSD_CHUNK}): {note_dev}, wrapper launches "
            f"{pre_launches} q4_k_matmul (the chunks are replays); host path "
            f"{host_ms:.3f} ms a frame (backbone step, 8 heads, host "
            f"sampling, compose), device path {dgen_s / n_fr * 1e3:.3f} ms "
            f"a frame (the request's generation / frames), XY decode "
            f"{dec_s * 1e3:.1f} ms")
    times["moss"] = dict(host_ms=host_ms, dev_ms=dgen_s / n_fr * 1e3)
    if cuda:
        runner = gen_chunk_cached(
            plm, qbb, n_frames=MOSS_TTSD_CHUNK,
            ctx=chunk_ctx(qbb, len(ttsd_ids) + -(-n_fr // MOSS_TTSD_CHUNK)
                          * MOSS_TTSD_CHUNK + 1),
            cb0_range=(*cb0, plm.info.eos_code_c0))
        replay = cuda_ms(runner.run)
        from torch.profiler import ProfilerActivity, profile

        # CUPTI drops records now and then from a trace of a replay (135 of
        # 224 products once): up to 6 traces, the first that shows every
        # product, else the fullest
        want_p, best = per_call * MOSS_TTSD_CHUNK, None
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                runner.run()
                torch.cuda.synchronize()
            kern = [e for e in trace.key_averages()
                    if e.self_device_time_total > 0
                    and not e.key.startswith("aten::")]
            got_p = (sum(e.self_device_time_total for e in kern) / 1e3,
                     sum(e.count for e in kern),
                     sum(e.count for e in kern if "matmul_kernel" in e.key))
            if best is None or got_p[2] > best[2]:
                best = got_p
            if got_p[2] == want_p:
                break
        busy, kernels, products = best
        times["moss"].update(replay_frame_ms=replay / MOSS_TTSD_CHUNK,
                             idle=1 - busy / replay)
        line += (f"; one replay {replay:.3f} ms ({replay / MOSS_TTSD_CHUNK:.3f}"
                 f" ms a frame), {kernels} kernels, {products} q4_k_matmul "
                 f"(want {want_p}"
                 + ("" if products == want_p else
                    "; the profiler lost records in 6 traces")
                 + f"), device busy {busy:.3f} ms (idle share "
                 f"{1 - busy / replay:.3f})")
        h0 = rec.calls[-1][2]
        st = plm.new_state()

        def host_frame():
            st.reset()
            st.step_begin(h0)
            for _ in range(plm.info.n_codebook):
                lg, _ = st.step_logits()
                st.step_push_code(int(np.argmax(lg)))
            st.step_finish()
        times["moss"]["heads"] = frame_profile(host_frame)
        line += f"; the 8 heads of one host frame: {fmt_prof(times['moss']['heads'])}"
    log(line + f" [{name_limit}]")

    # -- BlueMagpie ------------------------------------------------------------
    n_p = sizes.get("bm_patches", BM_TTS_PATCHES)
    bm_pi = build_prompt_info(bm_reader, clm.info)
    bm_ids = tok.encode(bm_pi.prompt_prefix + LM_TEXT + bm_pi.prompt_suffix)

    def bm_request(lm_, vae_, bb_):
        bb_.reset()
        alm = AudioLM(bm_reader, codec=vae_, lm=lm_)
        rec = Recorder(bb_)
        t = time.perf_counter()
        res = run_continuous(alm, rec, list(bb_.embed_tokens(bm_ids)),
                             max_steps=n_p, min_len=n_p, decode=False)
        gen = time.perf_counter() - t
        if res.codes.shape != (n_p * lm_.patch_size, lm_.latent_dim) \
                or res.stopped_by_eos:
            raise RuntimeError(f"bluemagpie: latents {res.codes.shape}, stop "
                               f"{res.stopped_by_eos}")
        return res, rec, gen

    def fsq_vals(lm_, h):
        with torch.inference_mode():
            x = lm_._lin(lm_.w["fsq_in"], lm_._tslm_adapter(
                torch.as_tensor(np.asarray(h, np.float32)).to(lm_.device)))
            return f64(torch.tanh(x) * lm_.fsq_scale)

    zero_counts()
    bres, brec, bgen_s = bm_request(clm, vae, mbb)
    launches("bluemagpie", {})
    t = time.perf_counter()
    bpcm = vae.decode_latent(bres.codes)
    vae_ms = (time.perf_counter() - t) * 1e3
    want_len = bres.codes.shape[0] * vae.cfg.decode_hop
    if bpcm.shape != (want_len,) or not np.isfinite(bpcm).all():
        raise RuntimeError(f"bluemagpie pcm {bpcm.shape}, want ({want_len},)")
    cbres, cbrec, cbgen_s = bm_request(clm_cpu, vae_cpu, mbb_cpu)
    # the patches before the first FSQ near-tie (step k reads the k-th
    # hidden from the prompt's last row on)
    n_pr = len(bm_ids)
    tie = None
    for k in range(n_p):
        a = fsq_vals(clm, brec.calls[n_pr - 1 + k][2])
        b = fsq_vals(clm_cpu, cbrec.calls[n_pr - 1 + k][2])
        bad = np.flatnonzero(np.round(a) != np.round(b))
        if len(bad):
            frac = np.abs(b[bad] - np.floor(b[bad]) - 0.5)
            if not (frac < 1e-3).all():
                raise RuntimeError(f"bluemagpie patch {k}: FSQ digits {bad} "
                                   f"differ, not near-ties ({frac})")
            tie = k
            break
    rows = (n_p if tie is None else tie) * clm.patch_size
    b_rel = held("bluemagpie latents card vs CPU", bres.codes[:rows],
                 cbres.codes[:rows], LM_AR_REL) if rows else 0.0
    c_bm = None
    if tie is None:
        c_bm = corr(bpcm, vae_cpu.decode_latent(cbres.codes))
        if not c_bm > 0.9999:
            raise RuntimeError(f"bluemagpie PCM card vs CPU corr {c_bm}")
    bb_s = sum(c[3] for c in brec.calls[n_pr:])
    patch_ms = (bgen_s - sum(c[3] for c in brec.calls)) / n_p * 1e3
    st = clm.new_state()
    h0 = brec.calls[-1][2]
    prof = frame_profile(lambda: clm.step_generate(st, h0))
    times["bluemagpie"] = dict(patch_ms=patch_ms,
                               step_ms=bb_s / max(1, n_p - 1) * 1e3,
                               profile=prof)
    dev_line = bm_on_device(clm, vae, mbb, bm_reader, bm_ids, bres.codes,
                            brec, n_p, fsq_vals, launches,
                            times["bluemagpie"], cuda)
    log(f"[lm] bluemagpie {n_p} patches ({bres.codes.shape[0]} latent frames, "
        f"prompt {n_pr} tokens): launches none; pcm {bpcm.shape} finite, "
        f"peak {np.abs(bpcm).max():.4f}; latents card vs CPU (same noise): "
        + (f"max rel err {b_rel:.2e} over all {n_p} patches, PCM corr "
           f"{c_bm:.9f}" if tie is None else
           f"max rel err {b_rel:.2e} over the {tie} patches before an FSQ "
           f"near-tie at patch {tie}")
        + f" (CPU {cbgen_s:.1f} s); {patch_ms:.2f} ms a patch (CFM step, "
        f"{clm.n_locdit}-layer LocDiT x 2 x 9 Euler steps, LocEnc, RALM), "
        f"backbone step {times['bluemagpie']['step_ms']:.3f} ms, AudioVAE "
        f"decode {vae_ms:.1f} ms; one patch (step_generate) under "
        f"torch.profiler: {fmt_prof(prof)}; {dev_line} [{name_limit}]")
    if reuse is not None:
        reuse["ttsd"] = (ttsd_reader, plm, plm_cpu, xy, ttsd_ids, pi)
        reuse["qwen3"] = (qbb, qbb_cpu)
        reuse["bm"] = (clm, bm_reader, bm_ids, mbb)     # phase 12's
    del pt, pt_cpu, flm, flm_cpu, xy, plm, plm_cpu, qbb, qbb_cpu
    del vae, vae_cpu, clm, clm_cpu, mbb, mbb_cpu
    if cuda:
        torch.cuda.empty_cache()
    log(f"[lm] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts, times


def bm_on_device(clm, vae, mbb, bm_reader, bm_ids, want, brec, n_p, fsq_vals,
                 launches, times, cuda) -> str:
    """Phase 9d's BlueMagpie request with --on-device (run_continuous with
    chunk_steps=BM_CHUNK: the first patch per step, then K-step chunks, on
    the card one graph replay each) against the eager path's request on
    the card (`want`, its latents; `brec`, its Recorder) with the same
    noise: latents within BM_DEVICE_REL of peak up to the first FSQ
    near-tie (a digit of round(tanh(x)·9) within 1e-3 of a half on the
    eager side), then the stop at the same patch in a request that lets the
    stop head end it, one replay against the eager run of the same chunk
    bit for bit, and the replay's time, kernels and idle share. → a log
    line's part."""
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.tts_runner import run_continuous

    def request(bb_, min_len, chunk):
        bb_.reset()
        alm = AudioLM(bm_reader, codec=vae, lm=clm)
        t = time.perf_counter()
        res = run_continuous(alm, bb_, list(bb_.embed_tokens(bm_ids)),
                             max_steps=n_p, min_len=min_len, decode=False,
                             chunk_steps=chunk)
        return res, time.perf_counter() - t

    res, gen_s = request(mbb, n_p, BM_CHUNK)        # captures its graph
    launches("bluemagpie on-device", {})
    n_pr = len(bm_ids)
    peak = float(np.abs(want).max())
    err = np.abs(res.codes - want).reshape(n_p, -1).max(axis=1)
    bad = np.flatnonzero(err > BM_DEVICE_REL * peak)
    note = f"latents within {err.max() / peak:.2e} of peak over all {n_p}"
    if len(bad):
        k = int(bad[0])
        v = fsq_vals(clm, brec.calls[n_pr - 1 + k][2])
        frac = np.abs(v - np.floor(v) - 0.5)
        if not frac.min() < 1e-3:
            raise RuntimeError(f"bluemagpie on-device: patch {k} off by "
                               f"{err[k]} (peak {peak}), no FSQ near-tie")
        note = (f"latents within {err[:k].max() / peak if k else 0:.2e} of "
                f"peak over the {k} patches before an FSQ near-tie")
    # the stop head ends both requests at the same patch
    host_stop = request(mbb, -1, 1)[0]
    dev_stop = request(mbb, -1, BM_CHUNK)[0]
    if (dev_stop.n_steps, dev_stop.stopped_by_eos) != \
            (host_stop.n_steps, host_stop.stopped_by_eos):
        raise RuntimeError(f"bluemagpie stop: on-device {dev_stop.n_steps} "
                           f"{dev_stop.stopped_by_eos}, eager "
                           f"{host_stop.n_steps} {host_stop.stopped_by_eos}")
    times["dev_request_s"] = gen_s
    line = (f"on-device (chunks of {BM_CHUNK} patches): {note}, stop at "
            f"patch {dev_stop.n_steps} ({'stop head' if dev_stop.stopped_by_eos else 'max'}) "
            f"as the eager path; the request (the prompt's host steps, one "
            f"eager patch, the capture) {gen_s:.3f} s")
    if cuda:
        runner = next(reversed(mbb._cont_chunks.values()))[1]
        saved = [t.clone() for t in runner.graphed.restore]
        a = runner.run().clone()
        for t, s in zip(runner.graphed.restore, saved):
            t.copy_(s)
        b = runner.graphed.eager().clone()
        if not torch.equal(a, b):
            raise RuntimeError("bluemagpie chunk: replay != eager run")
        replay = cuda_ms(runner.run, runs=5)
        prof = call_profile(runner.run, cuda)
        times.update(replay_patch_ms=replay / BM_CHUNK, replay_profile=prof)
        line += (f"; one replay equals its eager run bit for bit, "
                 f"{replay:.3f} ms ({replay / BM_CHUNK:.3f} ms a patch), "
                 f"under torch.profiler: {fmt_profile(prof)}")
    return line


def _moved(tree, dev):
    """A parameter tree with every tensor moved to `dev`."""
    if isinstance(tree, dict):
        return {k: _moved(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_moved(v, dev) for v in tree]
    return tree.to(dev) if torch.is_tensor(tree) else tree


def cbx_files(d: Path, sizes: dict) -> list:
    """Phase 9d's writers: the Chatterbox file (S3Gen + T3), its Q4_K
    Llama-520M backbone and the Qwen3-TTS speaker encoder; `sizes` as
    chatterbox_flow takes them."""
    from codec_tpu_torch.models import chatterbox_init as cbi
    from codec_tpu_torch.models.lm_init import write_random_backbone_ggufs

    bcfg = sizes.get("backbone", cbi.LLAMA_520M)
    return [
        lambda: cbi.write_chatterbox_tts_gguf(
            d / "chatterbox_random.gguf", seed=SEED,
            **sizes.get("chatterbox", {})),
        lambda: write_random_backbone_ggufs(
            {"Q4_K": d / "t3_Q4_K.gguf"}, seed=SEED + 3, cfg=bcfg,
            rope_scaling=cbi.T3_ROPE_SCALING)["Q4_K"],
        lambda: cbi.write_qwen3_speaker_gguf(
            d / "ecapa_random.gguf", seed=SEED + 4,
            **sizes.get("ecapa", {}))]


def chatterbox_flow(name_limit: str, zero_counts, counts, none: dict,
                    dev: str = "cuda", sizes=None, reuse=None) -> dict:
    """Phase 9d: the Chatterbox TTS path at full width (text → T3 → S3
    speech tokens → S3Gen → PCM) through the entry points a user calls,
    with every launch count set to 0 just before each request and read
    just after:
      - tts_cli's run_chatterbox_synthesize on the host path (the dense f32
        backbone, two lanes a step, host sampling; launches none) and with
        --on-device --quant-exec (Q4_K packed: the prompt's per-token
        prefill launches q4_k_matmul 7 a layer a lane a row at m = 1, the
        chunks are replays), each request's PCM checked for length and
        finite samples, its S3Gen decode timed;
      - run_chatterbox's greedy codes on the card's host path against the
        CPU's on the same weights, the device chunk (dense and Q4_K)
        against the host path (the near-tie rule on the CFG logits of the
        recorded hiddens); one chunk run eagerly (q4_k_matmul 7 a layer a
        frame at m = 2, counted) and its replay bit for bit against it;
      - run_chatterbox(ref_pcm=) with a 10 s 16 kHz voice (the
        VoiceEncoder's embedding and the conditioning rows against the
        CPU's, SPEAKER_REL of peak);
      - a Qwen3-TTS ECAPA embedding (create_speaker_encoder) of 10 s of
        24 kHz against the CPU's.
    Times: ms a frame on the host path and in the chunk (a replay / K),
    each frame under torch.profiler (busy, idle share), the S3Gen share of
    a request. `dev` and `sizes` let the phase run small on the CPU
    (tests/test_torch_chatterbox.py). `reuse`, a dict, receives phase 9f's
    files: "cbx" = (their directory, the Chatterbox file, the Q4_K
    backbone). → (launch counts, times)."""
    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import run_chatterbox_synthesize
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm, create_speaker_encoder
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.chatterbox_t3 import ChatterboxT3
    from codec_tpu_torch.lm.tts_runner import run_chatterbox
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    sizes = sizes or {}
    cuda = dev == "cuda"
    frames = sizes.get("frames", CBX_FRAMES)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches(label, want):
        want = {**none, **want}
        got = counts() if cuda else want
        if got != want:
            raise RuntimeError(f"{label}: launches {got}, want {want}")
        return got

    def held(label, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if got.shape != want.shape or not err <= SPEAKER_REL * peak:
            raise RuntimeError(f"{label}: shape {got.shape} vs {want.shape}, "
                               f"max abs err {err} (peak {peak})")
        return err / peak

    t_phase = time.monotonic()
    phase_counts, times = dict(none), {}
    tmp, (path, q_path, e_path), waited = ahead("cbx", "chip_smoke_cbx_",
                                                 cbx_files, sizes)
    try:
        wrote("cbx", (path, q_path, e_path), waited)
        t0 = time.monotonic()
        reader, e_reader = GGUFReader(path), GGUFReader(e_path)
        s3g = codec_tpu_torch.load_model(path, device=dev)
        t3, t3_cpu = (ChatterboxT3(reader, device=x) for x in (dev, "cpu"))
        lm, lm_cpu = (create_lm(reader, device=x) for x in (dev, "cpu"))
        bb_cpu = create_backbone(q_path, device="cpu")       # dequantized
        bb = LlamaBackbone.from_params(bb_cpu.cfg, _moved(bb_cpu.params, dev))
        bb_q = create_backbone(q_path, quantized=True, device=dev)
        ecapa, ecapa_cpu = (create_speaker_encoder(e_reader, device=x)
                            for x in (dev, "cpu"))
        sync()
    finally:
        _cleanup(tmp, reuse, "cbx", (path, q_path))
    cfg = bb.cfg
    per_step = 7 * cfg.n_layers
    log(f"[cbx] loaded in {time.monotonic() - t0:.2f} s (S3Gen and T3 on the "
        f"card f32; the backbone dense f32 on the card and the CPU, Q4_K "
        f"packed on the card): T3 text vocab {t3.info.text_vocab_size}, "
        f"speech vocab {t3.info.speech_vocab_size}, {len(t3.text_pos_emb)} "
        f"text / {len(t3.speech_pos_emb)} speech positions; backbone hidden "
        f"{cfg.hidden}, {cfg.n_layers} layers, {cfg.n_heads} heads x "
        f"{cfg.head_dim} ({cfg.n_kv_heads} KV), FFN {cfg.ffn_dim}, rope "
        f"theta {cfg.rope_theta:g} (llama3 factor 8); VoiceEncoder "
        f"{t3.speaker.cfg.n_mels} mels, LSTM {t3.speaker.cfg.num_layers} x "
        f"{t3.speaker.cfg.hidden_size}; ECAPA channels "
        f"{ecapa.cfg.enc_channels}, embedding {ecapa.cfg.enc_dim}")

    head = np.asarray(reader.get("lm.heads_0.weight"), np.float64)
    greedy = lambda lg: int(np.argmax(lg))
    second = {}

    def lanes(b, record=False):
        """Both CFG lanes over b's weights (lane 1 made once a backbone)."""
        b.reset()
        other = second.setdefault(id(b), LlamaBackbone.from_params(
            b.cfg, b.params, b.dtype, b.qmm))
        other.reset()
        return [Recorder(b), Recorder(other)] if record else [b, other]

    def request(t3_, lm_, b, on_device=None, record=False, n=frames,
                ref_pcm=None):
        ls = lanes(b, record)
        t = time.perf_counter()
        res = run_chatterbox(AudioLM(reader, lm=lm_), t3_, ls, LM_TEXT,
                             max_frames=n, cfg_weight=0.5, sampler=greedy,
                             on_device=on_device, decode=False,
                             ref_pcm=ref_pcm, prefill_bucket=CBX_BUCKET)
        return res, ls, time.perf_counter() - t

    rows = t3.build_prompt(t3.tokenize(LM_TEXT)).shape[1]

    def same_or_tie(label, got, want, rec):
        """Equal codes, or the first difference a near-tie of the CFG
        logits on the recorded hiddens of `want`'s run."""
        n = min(len(got), len(want))
        diff = np.flatnonzero(got[:n, 0] != want[:n, 0])
        if not len(diff) and len(got) == len(want):
            return "codes equal"
        f = int(diff[0]) if len(diff) else n
        # a lane's calls: its bucketed prefill, then one step a frame
        hs = [np.asarray(r.calls[f][2], np.float64) for r in rec]
        cond, unc = head @ hs[0], head @ hs[1]
        top = np.sort(cond + 0.5 * (cond - unc))[-2:]
        margin = float((top[1] - top[0]) / abs(top[1]))
        if not margin < NEAR_TIE:
            raise RuntimeError(f"chatterbox {label}: codes first differ at "
                               f"frame {f}, margin {margin}")
        return (f"codes first differ at frame {f}: a near-tie (relative "
                f"top-2 margin {margin:.2e})")

    # -- tts_cli's function: the host path and --on-device --quant-exec ------
    # the CLI's function loads its own adaptor a call, so its chunk is a new
    # graph: its warm-up runs the chunk once and its capture records it
    # (both launch through the wrappers); the replays count nothing
    graph_launches = 2 * per_step * CBX_CHUNK
    cli = {}
    for name, b, kw, want in (
            ("host f32", bb, {}, {}),
            ("on-device Q4_K", bb_q, dict(on_device=True,
                                          chunk_frames=CBX_CHUNK),
             {"q4_k_matmul": 2 * rows * per_step + graph_launches})):
        sync()
        zero_counts()
        t = time.perf_counter()
        pcm, n, stop = run_chatterbox_synthesize(
            s3g, reader, None, LM_TEXT, seed=SEED, max_frames=frames,
            temperature=0.0, device=dev, bb=b, **kw)
        sync()
        total = time.perf_counter() - t
        got = launches(f"chatterbox {name}", want)
        for k in got:
            phase_counts[k] += got[k]
        if (n, stop) != (frames, "max_frames") \
                or pcm.shape != (frames * s3g.hop_size,) \
                or not np.isfinite(pcm).all():
            raise RuntimeError(f"chatterbox {name}: {n} frames, stop {stop}, "
                               f"pcm {pcm.shape}")
        cli[name] = (total, pcm)
    codes = np.random.default_rng(SEED).integers(0, t3.info.start_speech_token,
                                                 (frames, 1))
    dec = []
    for _ in range(3):
        sync()
        t = time.perf_counter()
        s3g.decode(codes)
        sync()
        dec.append(time.perf_counter() - t)
    dec_s = statistics.median(dec)

    # -- codes: card host vs CPU, the chunk (dense, Q4_K) vs the host path ----
    host, hrec, host_s = request(t3, lm, bb, record=True)
    cpu, crec, cpu_s = request(t3_cpu, lm_cpu, bb_cpu, record=True)
    note_cpu = same_or_tie("card vs CPU", host.codes, cpu.codes, crec)
    prefill_s = sum(r.calls[0][3] for r in hrec)
    host_ms = (host_s - prefill_s) / frames * 1e3
    ods = OnDeviceSampling(chunk_frames=CBX_CHUNK)
    notes = {}
    for name, b in (("f32", bb), ("Q4_K", bb_q)):
        # this run captures the chunk's graph (the warm-up's state restored)
        res, _, gen_s = request(t3, lm, b, on_device=ods)
        notes[name] = (same_or_tie(f"device {name} vs host", res.codes,
                                   host.codes, hrec), gen_s)
    line = (f"[cbx] {frames} greedy frames, prompt {rows} rows a lane (34 "
            f"conditioning, {rows - 38} text + 2, 2 BOS): tts_cli host f32 "
            f"{cli['host f32'][0]:.3f} s (the T3, adaptor and lane loads and "
            f"the one-shot chunk capture included), launches none; "
            f"on-device Q4_K "
            f"{cli['on-device Q4_K'][0]:.3f} s, launches "
            f"{2 * rows * per_step + graph_launches} q4_k_matmul (the "
            f"per-token prefill, 2 lanes x {rows} rows x {per_step} at m = 1, "
            f"and the new graph's warm-up and capture, 2 x {per_step} x "
            f"{CBX_CHUNK} at m = 2; the chunks are replays); pcm "
            f"{(frames * s3g.hop_size,)} finite; S3Gen decode of "
            f"{frames} tokens {dec_s * 1e3:.1f} ms (median of 3), "
            f"{dec_s / cli['host f32'][0]:.1%} of the host request, "
            f"{dec_s / cli['on-device Q4_K'][0]:.1%} of the on-device one; "
            f"card host vs CPU: {note_cpu} (CPU {cpu_s:.1f} s); device "
            f"chunks of {CBX_CHUNK} vs host: f32 {notes['f32'][0]}, Q4_K "
            f"{notes['Q4_K'][0]}; host path {host_ms:.3f} ms a frame (2 "
            f"lane steps, the head, host sampling; the 2 lanes' prefills in "
            f"buckets of {CBX_BUCKET} {prefill_s:.3f} s), device request "
            f"{notes['Q4_K'][1]:.3f} s Q4_K, {notes['f32'][1]:.3f} s f32 "
            f"(the prefill and the chunk's capture included)")
    times.update(host_ms=host_ms, dec_ms=dec_s * 1e3,
                 request_s={k: v[0] for k, v in cli.items()})

    # one chunk eagerly (its m = 2 launches counted) and its replay
    runner = next(reversed(bb_q._cbx_chunks.values()))[2]
    saved = [t.clone() for t in runner.graphed.restore]
    zero_counts()
    eager = runner.graphed.eager().clone()
    got = launches("chatterbox chunk (eager)",
                   {"q4_k_matmul": per_step * CBX_CHUNK})
    for k in got:
        phase_counts[k] += got[k]
    line += (f"; one Q4_K chunk run eagerly launches {per_step * CBX_CHUNK} "
             f"q4_k_matmul at m = 2")
    if cuda:
        for t, sv in zip(runner.graphed.restore, saved):
            t.copy_(sv)
        if not torch.equal(runner.run(), eager):
            raise RuntimeError("chatterbox chunk: replay != eager run")
        line += ", its replay equals it bit for bit"
        for name, b in (("f32", bb), ("Q4_K", bb_q)):
            rn = next(reversed(b._cbx_chunks.values()))[2]
            replay = cuda_ms(rn.run, runs=5)
            prof = call_profile(rn.run, cuda)
            times[f"replay_{name}"] = (replay / CBX_CHUNK, prof)
            line += (f"; {name} replay {replay:.3f} ms ({replay / CBX_CHUNK:.3f}"
                     f" ms a frame), {fmt_profile(prof)}")
        ls = lanes(bb)
        h0 = hrec[0].calls[-1][2]
        alm = AudioLM(reader, lm=lm)

        def host_frame():
            st = alm.state
            for lane in ls:
                st.step_begin(h0)
                st.step_logits()
                st.step_push_code(0)
                st.step_finish()
                lane.step(t3.compose_speech_embd(5, 1))
        times["host_profile"] = call_profile(host_frame, cuda)
        line += (f"; one host frame (2 lane steps and heads): "
                 f"{fmt_profile(times['host_profile'])}")
    log(line + f" [{name_limit}]")

    # -- a voice prompt through the VoiceEncoder ------------------------------
    vr = np.random.default_rng(SEED + 2000)
    voice = (vr.standard_normal(int(sizes.get("voice_seconds",
                                               CBX_VOICE_SECONDS) * 16000))
             * 0.1).astype(np.float32)
    emb = t3.speaker.embed_ref(voice)
    e_rel = held("VoiceEncoder embedding card vs CPU", emb,
                 t3_cpu.speaker.embed_ref(voice))
    toks = t3.builtin_cond_tokens
    c_rel = held("conditioning rows card vs CPU",
                 t3.speaker.cond_emb(emb, toks, 0.5),
                 t3_cpu.speaker.cond_emb(emb, toks, 0.5))
    zero_counts()
    vres, _, v_s = request(t3, lm, bb, n=CBX_VOICE_FRAMES, ref_pcm=voice)
    launches("chatterbox voice prompt", {})
    if vres.codes.shape != (CBX_VOICE_FRAMES, 1):
        raise RuntimeError(f"chatterbox voice prompt: codes {vres.codes.shape}")
    # -- the Qwen3-TTS ECAPA embedding ----------------------------------------
    er = np.random.default_rng(SEED + 2001)
    ref24 = (er.standard_normal(int(sizes.get("ecapa_seconds", ECAPA_SECONDS)
                                    * ecapa.cfg.sample_rate))
             * 0.1).astype(np.float32)
    sync()
    t = time.perf_counter()
    row = ecapa.encode(ref24)
    ecapa_ms = (time.perf_counter() - t) * 1e3
    x_rel = held("ECAPA embedding card vs CPU", row, ecapa_cpu.encode(ref24))
    log(f"[cbx] VoiceEncoder on a {len(voice) / 16000:.0f} s 16 kHz voice: "
        f"embedding card vs CPU {e_rel:.2e} of peak, conditioning rows "
        f"{c_rel:.2e}; run_chatterbox(ref_pcm=) {CBX_VOICE_FRAMES} frames "
        f"in {v_s:.3f} s, launches none; Qwen3-TTS ECAPA on "
        f"{len(ref24) / ecapa.cfg.sample_rate:.0f} s of 24 kHz: row "
        f"{row.shape}, card vs CPU {x_rel:.2e} of peak, {ecapa_ms:.1f} ms "
        f"(mel on the host included) [{name_limit}]")
    del s3g, t3, t3_cpu, lm, lm_cpu, bb, bb_cpu, bb_q, ecapa, ecapa_cpu, second
    del runner
    if cuda:
        torch.cuda.empty_cache()
    log(f"[cbx] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts, times


def rest_files(d: Path, sizes: dict) -> list:
    """Phase 9e's writers: LFM2-Audio and its Q4_K and Q8_0 backbones
    (LFM2_LAYERS layers), MOSS-TTS-Realtime, the Qwen3-MoE backbone
    (MOE_LAYERS); `sizes` as rest_lm_flows takes them."""
    import dataclasses

    from codec_tpu_torch.models import lm_tts_init as lti
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_ggufs)

    spm = spm_model_b64(byte_fallback_vocab())
    n_fr = sizes.get("frames", FLOW_FRAMES)
    lfm2_cfg = sizes.get("lfm2", lti.Lfm2Config(
        eos_min_step=n_fr, max_text_tokens=LFM2_TEXT_TOKENS))
    return [
        lambda: lti.write_lfm2_audio_gguf(
            d / "lfm2_audio_random.gguf", seed=SEED, lfm2=lfm2_cfg,
            **sizes.get("mimi", {})),
        lambda: write_random_backbone_ggufs(
            {q: d / f"lfm2_{q}.gguf" for q in ("Q4_K", "Q8_0")},
            seed=SEED + 3, rope_scaling=None, spm_b64=spm,
            cfg=sizes.get("lfm2_bb", dataclasses.replace(
                lti.LFM2_1_2B, n_layers=LFM2_LAYERS))),
        lambda: lti.write_moss_realtime_gguf(
            d / "moss_realtime_random.gguf", seed=SEED,
            rt=sizes.get("rt", lti.RealtimeConfig(eos_min_step=n_fr)),
            **sizes.get("moss", {})),
        lambda: write_random_backbone_ggufs(
            {"Q4_K": d / "qwen3moe_Q4_K.gguf"}, seed=SEED + 4,
            rope_scaling=None, spm_b64=spm,
            cfg=sizes.get("moe", dataclasses.replace(
                lti.QWEN3_30B_A3B, n_layers=MOE_LAYERS)))["Q4_K"]]


def rest_lm_flows(name_limit: str, zero_counts, counts, none: dict,
                  reuse: dict, dev: str = "cuda", sizes=None) -> tuple:
    """Phase 9e: the rest of the LM layer, each written at full width and
    run through the entry points a user calls (the tts-cli branch
    `run_text_audio_flow`, run_codebook_ar, the backbone), every launch
    count set to 0 just before a request and read just after; the card's
    results held against the CPU's on the same files.
      - LFM2-Audio: the sequential flow, greedy (a short text phase, then
        FLOW_FRAMES frames), on the host path (q4_k_matmul: 7 a layer a
        backbone step; flash_sdpa_window: 8 in the Mimi decode) and in
        chunks (the products of one replay counted under the profiler);
        one Q8_0 request; card vs CPU and chunks vs host path under the
        near-tie rule; the captured chunk against the eager chunk bit for
        bit.
      - MOSS-TTS-Realtime: the streaming interleave the same way
        (flash_sdpa_window: 15 in the MOSS decode), and a sampled request
        with the repetition penalty: its ring after the first chunk equals
        the window of the host SamplerChain's history over the same codes,
        and the card's codes equal the CPU's or first differ at a near-tie
        of the penalized, filtered, noised logits.
      - Qwen3-MoE: the backbone's hiddens on the card against the CPU,
        teacher-forced (q4_k_matmul: 4 a layer a call), and a MOSS-TTSD
        request on the host path over it, its codes against the CPU's.
    `reuse` holds phase 9c's MOSS-TTSD pieces and Qwen3 backbones
    (lm_flows(reuse=)). `dev` and `sizes` (the writers' configurations and
    the requests' lengths) let the phase run small on the CPU
    (tests/test_torch_realtime.py), where the plain versions count nothing
    and the launch counts are those the card is held to. → (launch counts,
    times)."""
    import dataclasses

    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import run_text_audio_flow
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.fused_gen import chunk_ctx, gen_chunk_cached
    from codec_tpu_torch.lm.prompt_info import build_prompt_info
    from codec_tpu_torch.lm.spm import SpmUnigram
    from codec_tpu_torch.lm.tts_runner import (_decode_transformed,
                                               run_codebook_ar,
                                               run_realtime_streaming)
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64)

    sizes = sizes or {}
    cuda = dev == "cuda"
    n_fr = sizes.get("frames", FLOW_FRAMES)
    n_cpu = sizes.get("cpu_frames", FLOW_CPU_FRAMES)
    k_ch = sizes.get("chunk", FLOW_CHUNK)
    bucket = sizes.get("bucket", FLOW_BUCKET)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches(label, want):
        """The counts since zero_counts(), which must be `want` (a CPU
        rehearsal runs the plain versions, which count nothing)."""
        want = {**none, **want}
        got = counts() if cuda else want
        if got != want:
            raise RuntimeError(f"{label}: launches {got}, want {want}")
        for key in got:
            phase_counts[key] += got[key]
        return got

    def near_tie(label, got, want, lm, hiddens):
        """Greedy codes equal, or the first difference (frame f, codebook k)
        a near-tie of want's run: the relative top-2 margin of codebook k's
        logits on the card's host step machine at frame f's hidden, want's
        codes of that frame pushed before it → a note."""
        diff = np.argwhere(got != want[: len(got)])
        if not len(diff):
            return "codes equal"
        f, k = (int(v) for v in diff[0])
        st = lm.new_state()
        st.step_begin(hiddens[f])
        for j in range(k):
            st.step_logits()
            st.step_push_code(int(want[f, j]))
        top = np.sort(np.asarray(st.step_logits()[0], np.float64))[-2:]
        margin = float((top[1] - top[0]) / abs(top[1]))
        if not margin < NEAR_TIE:
            raise RuntimeError(f"{label}: codes first differ at frame {f} "
                               f"codebook {k}, relative top-2 margin {margin}")
        return (f"codes first differ at frame {f} codebook {k}: a near-tie "
                f"(relative top-2 margin {margin:.2e})")

    def frame_hiddens(rec, frames):
        """The hidden each frame of a host-path run read: the backbone call
        before it (every frame is followed by one step)."""
        return [c[2] for c in rec.calls[-frames - 1:-1]]

    def replay_check(label, runner, restore):
        """The captured chunk against the eager chunk from the same state
        (the end of the last request, its position moved back a chunk):
        packed result and every state tensor bit for bit. On the CPU both
        run eagerly."""
        runner.pos.sub_(runner.k)
        saved = [t.clone() for t in restore]
        eager = runner.graphed.eager().clone()
        after = [t.clone() for t in restore]
        for t, v in zip(restore, saved):
            t.copy_(v)
        graph = runner.run().clone()
        sync()
        if not (torch.equal(eager, graph)
                and all(torch.equal(a, t) for a, t in zip(after, restore))):
            raise RuntimeError(f"{label}: the captured chunk's packed result "
                               f"or state differ from the eager chunk's")
        for t, v in zip(restore, saved):
            t.copy_(v)

    def replay_profile(runner, want_products):
        """Replay ms, and one replay under torch.profiler: (device busy ms,
        kernels, q4_k_matmul launches), the first of up to 6 traces that
        shows every product (CUPTI drops records now and then), else the
        fullest; None on the CPU."""
        if not cuda:
            return None, None
        from torch.profiler import ProfilerActivity, profile

        replay = cuda_ms(runner.run)
        best = None
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CUDA]) as trace:
                runner.run()
                torch.cuda.synchronize()
            kern = [e for e in trace.key_averages()
                    if e.self_device_time_total > 0
                    and not e.key.startswith(("aten::", "Memcpy", "Memset"))]
            got = (sum(e.self_device_time_total for e in kern) / 1e3,
                   sum(e.count for e in kern),
                   sum(e.count for e in kern if "matmul_kernel" in e.key))
            if best is None or got[2] > best[2]:
                best = got
            if got[2] == want_products:
                break
        return replay, best

    t_phase = time.monotonic()
    phase_counts, times = dict(none), {}
    spm = spm_model_b64(byte_fallback_vocab())
    tok = SpmUnigram.from_b64(spm)
    ttsd_reader, plm, plm_cpu, xy, ttsd_ids, ttsd_pi = reuse["ttsd"]
    qbb, qbb_cpu = reuse["qwen3"]
    tmp, (lfm2_path, lbb_paths, rt_path, moe_path), waited = ahead(
        "rest", "chip_smoke_rest_", rest_files, sizes)
    try:
        paths = (lfm2_path, *lbb_paths.values(), rt_path, moe_path)
        wrote("rest", paths, waited)
        t0 = time.monotonic()
        load = codec_tpu_torch.load_model
        mimi, mimi_cpu = (load(lfm2_path, device=x) for x in (dev, "cpu"))
        lfm2_reader = GGUFReader(lfm2_path)
        lbb = {q: create_backbone(p, quantized=True, device=dev)
               for q, p in lbb_paths.items()}
        # the CPU's copy dense: the same dequantized weights, dequantized
        # once at load instead of a call at a time by the plain product
        lbb_cpu = create_backbone(lbb_paths["Q4_K"], device="cpu")
        moss, moss_cpu = (load(rt_path, device=x) for x in (dev, "cpu"))
        rt_reader = GGUFReader(rt_path)
        # the MoE read once, its tensors copied to the card
        moe_cpu = create_backbone(moe_path, quantized=True, device="cpu")
        moe = LlamaBackbone.from_params(moe_cpu.cfg,
                                        _moved(moe_cpu.params, dev))
        sync()
    finally:
        tmp.cleanup()
    llm, rlm = (create_lm(r, device=dev) for r in (lfm2_reader, rt_reader))
    mcfg = moe.cfg
    log(f"[rest] loaded (card and CPU, f32) in {time.monotonic() - t0:.2f} s: "
        f"LFM2-Audio depthformer {llm.depth_layers} layers at "
        f"{llm.depth_hidden}, {llm.n_heads} heads x {llm.head_dim}, "
        f"{llm.n_kv_heads} KV heads, {llm.info.n_codebook} codebooks x "
        f"{llm.info.codebook_sizes[0]}, compose table "
        f"{tuple(llm.compose_table.shape)}, backbone hidden "
        f"{lbb['Q4_K'].cfg.hidden}, {lbb['Q4_K'].cfg.n_layers} layers, vocab "
        f"{lbb['Q4_K'].cfg.vocab_size}; MOSS-TTS-Realtime local transformer "
        f"{rlm.depth_layers} layers at {rlm.depth_hidden}, {rlm.n_heads} heads "
        f"x {rlm.head_dim}, {rlm.info.n_codebook} codebooks x "
        f"{rlm.info.codebook_sizes[0]}, compose table "
        f"{tuple(rlm.compose_table.shape)}, backbone {qbb.cfg.n_layers} "
        f"layers; Qwen3-MoE hidden {mcfg.hidden}, {mcfg.n_layers} layers, "
        f"{mcfg.n_heads} heads x {mcfg.head_dim}, {mcfg.n_kv_heads} KV heads, "
        f"{mcfg.n_experts} experts ({mcfg.n_experts_used} used) of "
        f"{mcfg.moe_ffn_dim}, vocab {mcfg.vocab_size}")

    # -- LFM2-Audio and MOSS-TTS-Realtime ---------------------------------------
    flows = {"lfm2": dict(lm=llm, lm_cpu=create_lm(lfm2_reader, device="cpu"),
                          codec=mimi, bb=lbb["Q4_K"], bb_cpu=lbb_cpu,
                          reader=lfm2_reader, attn=MIMI_LAYERS),
             "rt": dict(lm=rlm, lm_cpu=create_lm(rt_reader, device="cpu"),
                        codec=moss, bb=qbb, bb_cpu=qbb_cpu, reader=rt_reader,
                        attn=MOSS_LAYERS)}
    for fl in flows.values():
        fl["pi"] = build_prompt_info(fl["reader"], fl["lm"].info)
        fl["ids"] = tok.encode(fl["pi"].prompt_prefix + LM_TEXT
                               + fl["pi"].prompt_suffix)

    def request(name, bb, frames, on_device=False, cpu=False, decode=True,
                pi=None, chunk=None, **chain):
        """One request → (result, seconds): through the tts-cli branch
        (run_text_audio_flow), except the realtime host path, which that
        branch samples at the family's chain: there run_realtime_streaming
        with greedy samplers."""
        fl = flows[name]
        lm = fl["lm_cpu" if cpu else "lm"]
        a = AudioLM(fl["reader"], codec=fl["codec"] if decode else None, lm=lm)
        getattr(bb, "bb", bb).reset()
        pi = pi or fl["pi"]
        t = time.perf_counter()
        if name == "rt" and not on_device:
            split = max(1, len(fl["ids"]) - pi.prefill_text_len)
            res = run_realtime_streaming(
                a, bb, lambda x: bb.embed_tokens([x])[0], fl["ids"][:split],
                fl["ids"][split:], pi, max_frames=frames,
                samplers=[lambda lg: int(np.argmax(lg))] * lm.info.n_codebook,
                prefill_bucket=bucket)
        else:
            res = run_text_audio_flow(a, bb, pi, fl["ids"], max_steps=frames,
                                      on_device=on_device,
                                      chunk_frames=chunk or k_ch,
                                      prefill_bucket=bucket, **chain)
        sync()
        return res, time.perf_counter() - t

    def calls_of(rec, bucket=bucket):
        """(backbone steps, prefill calls that launch the kernel: their
        bucket-padded rows m <= 32) of a recorded request."""
        steps = sum(1 for c in rec.calls if c[0] == "step")
        pre = sum(1 for c in rec.calls if c[0] == "prefill"
                  and -(-len(c[1]) // bucket) * bucket <= 32)
        return steps, pre

    greedy = dict(temperature=0.0)
    for name, fl in flows.items():
        label = {"lfm2": "lfm2-audio", "rt": "moss-realtime"}[name]
        lm, bb = fl["lm"], fl["bb"]
        per_step = 7 * bb.cfg.n_layers
        # the host path on the card, every backbone call recorded
        rec = Recorder(bb)
        zero_counts()
        res, host_s = request(name, rec, n_fr, **greedy)
        n_steps, n_pre = calls_of(rec)
        got = launches(f"{label} host", {
            "q4_k_matmul": per_step * (n_steps + n_pre),
            "flash_sdpa_window": fl["attn"]})
        hop = fl["codec"].hop_size
        if res.codes.shape != (n_fr, lm.info.n_codebook) \
                or res.stopped_by_eos or res.pcm.shape[0] != n_fr * hop \
                or not np.isfinite(res.pcm).all():
            raise RuntimeError(f"{label}: codes {res.codes.shape}, eos "
                               f"{res.stopped_by_eos}, pcm {res.pcm.shape}")
        hid = frame_hiddens(rec, n_fr)
        n_text = len(rec.calls) - 1 - n_fr      # LFM2: text + audio_start steps
        pre_s = sum(c[3] for c in rec.calls[:1 + n_text])
        host_ms = (host_s - pre_s) / n_fr * 1e3
        # the CPU's host path, its first frames
        crec = Recorder(fl["bb_cpu"])
        cres, cpu_s = request(name, crec, n_cpu, cpu=True, decode=False,
                              **greedy)
        for a, b in zip(rec.calls[:1 + n_text], crec.calls[:1 + n_text]):
            if not np.array_equal(a[1], b[1]):
                raise RuntimeError(f"{label}: the prompt's or the text "
                                   f"phase's rows on the card differ from the "
                                   f"CPU's")
        note_cpu = near_tie(f"{label} card vs CPU", cres.codes, res.codes, lm,
                            hid)
        # the device path: chunks of k_ch frames, one replay each
        request(name, bb, n_fr, on_device=True, decode=False, **greedy)
        zero_counts()
        dres, dev_s = request(name, bb, n_fr, on_device=True, **greedy)
        launches(f"{label} device", {"q4_k_matmul": per_step * (n_text + n_pre),
                                     "flash_sdpa_window": fl["attn"]})
        note_dev = near_tie(f"{label} device vs host", dres.codes, res.codes,
                            lm, hid)
        pos0 = len(rec.calls[0][1]) + n_text
        ctx = chunk_ctx(bb, pos0 + -(-n_fr // k_ch) * k_ch + 1)
        # the request's runner: the family's chain at temperature 0 (and the
        # realtime one's penalty over its window)
        pi = fl["pi"]
        chain = dict(temperature=0.0, top_k=pi.default_top_k,
                     top_p=pi.default_top_p)
        if name == "lfm2":
            runner = gen_chunk_cached(lm, bb, n_frames=k_ch, ctx=ctx, **chain)
            state = (runner.h, runner.pos, runner.kv[..., :ctx, :])
        else:
            runner = gen_chunk_cached(
                lm, bb, n_frames=k_ch, ctx=ctx, stream=True,
                rep=(pi.default_repetition_penalty, pi.repetition_window),
                **chain)
            state = (runner.h, runner.pos, *runner.hist,
                     runner.kv[..., :ctx, :])
        if cuda and runner.graphed.graph is None:
            raise RuntimeError(f"{label}: the request's chunk was not captured")
        replay_check(label, runner, state)
        want_p = per_step * k_ch
        replay, prof = replay_profile(runner, want_p)
        # time to first audio: the prompt's prefill (and the text phase),
        # one replay, the decode of its frames
        t = time.perf_counter()
        _decode_transformed(AudioLM(fl["reader"], codec=fl["codec"], lm=lm),
                            dres.codes[:k_ch])
        sync()
        first_dec = time.perf_counter() - t
        times[name] = dict(host_ms=host_ms, dev_ms=dev_s / n_fr * 1e3)
        line = (f"[rest] {label} {n_fr} greedy frames, prompt "
                f"{len(fl['ids'])} tokens (one forward of "
                f"{-(-len(fl['ids']) // bucket) * bucket} rows)"
                + (f", {n_text - 1} text tokens and audio_start" if name ==
                   "lfm2" else "") + f": host path launches "
                f"{got['q4_k_matmul']} q4_k_matmul ({per_step} a step, "
                f"{n_steps} steps) and {got['flash_sdpa_window']} "
                f"flash_sdpa_window in the decode, pcm {res.pcm.shape} finite; "
                f"card vs CPU ({n_cpu} frames, {cpu_s:.1f} s): {note_cpu}; "
                f"device path (chunks of {k_ch}): {note_dev}, captured chunk "
                f"== eager chunk bit for bit; host path {host_ms:.3f} ms a "
                f"frame (backbone step, {lm.info.n_codebook} depth steps, "
                f"host sampling, compose), device path "
                f"{times[name]['dev_ms']:.3f} ms a frame (the whole request, "
                f"its prompt and decode included, / frames)")
        if prof is not None:
            busy, kernels, products = prof
            ttfa = pre_s * 1e3 + replay + first_dec * 1e3
            times[name].update(replay_frame_ms=replay / k_ch,
                               idle=1 - busy / replay, ttfa_ms=ttfa,
                               kernels_frame=kernels / k_ch)
            h0 = hid[-1]

            def host_frame(lm=lm, h0=h0):
                st = lm.new_state()
                st.step_begin(h0)
                while st.step_pending:
                    lg, _ = st.step_logits()
                    st.step_push_code(int(np.argmax(lg)))
                st.step_finish()
            fprof = call_profile(host_frame, cuda)
            line += (f"; one replay {replay:.3f} ms ({replay / k_ch:.3f} ms a "
                     f"frame), {kernels} kernels ({kernels / k_ch:.0f} a "
                     f"frame), {products} q4_k_matmul (want {want_p}"
                     + ("" if products == want_p else
                        "; the profiler lost records in 6 traces")
                     + f"), device busy {busy:.3f} ms (idle share "
                     f"{1 - busy / replay:.3f}); time to first audio "
                     f"{ttfa:.1f} ms (prompt"
                     + (" and text phase" if name == "lfm2" else "")
                     + f" {pre_s * 1e3:.1f} ms, one replay, the decode of "
                     f"{k_ch} frames {first_dec * 1e3:.1f} ms); one host "
                     f"frame's depth steps under torch.profiler: "
                     f"{fmt_profile(fprof)}")
        log(line + f" [{name_limit}]")
        fl.update(codes=res.codes)

    # one LFM2 request over the Q8_0 backbone (host path)
    rec = Recorder(lbb["Q8_0"])
    zero_counts()
    res, _ = request("lfm2", rec, n_fr, **greedy)
    n_steps, n_pre = calls_of(rec)
    got = launches("lfm2-audio Q8_0", {
        "q8_0_matmul": 7 * lbb["Q8_0"].cfg.n_layers * (n_steps + n_pre),
        "flash_sdpa_window": MIMI_LAYERS})
    if res.codes.shape != (n_fr, llm.info.n_codebook) \
            or not np.isfinite(res.pcm).all():
        raise RuntimeError(f"lfm2-audio Q8_0: codes {res.codes.shape}")
    log(f"[rest] lfm2-audio Q8_0 backbone: {got['q8_0_matmul']} q8_0_matmul, "
        f"pcm {res.pcm.shape} finite; "
        f"{(res.codes != flows['lfm2']['codes']).mean():.1%} of the codes "
        f"differ from the Q4_K backbone's (the same draws in another type) "
        f"[{name_limit}]")

    # the sampled realtime request: its first chunk, its whole length, and
    # its first frames on the CPU, all from one seed (the noise drawn on the
    # host, one draw a frame, so a chunk of another length draws the same)
    fl = flows["rt"]
    w = RT_SAMPLED["repetition_window"]
    pi_s = dataclasses.replace(fl["pi"], repetition_window=w)
    chain = dict(temperature=RT_SAMPLED["temperature"],
                 top_k=RT_SAMPLED["top_k"], top_p=RT_SAMPLED["top_p"])
    sampled = dict(chain, rep_penalty=RT_SAMPLED["repetition_penalty"],
                   seed=RT_SAMPLED["seed"], pi=pi_s)
    first, _ = request("rt", qbb, k_ch, on_device=True, decode=False,
                       **sampled)
    runner = gen_chunk_cached(
        rlm, qbb, n_frames=k_ch, ctx=chunk_ctx(qbb, len(fl["ids"]) + k_ch + 1),
        stream=True, rep=(RT_SAMPLED["repetition_penalty"], w), **chain)
    ring, ptr = runner.hist
    for cb in range(rlm.info.n_codebook):
        want = chain_history(first.codes[:, cb], w)
        slots = [(int(ptr[0]) + j) % w for j in range(w)]
        held = [int(v) for v in ring[cb, slots].tolist() if v >= 0]
        if held != want:
            raise RuntimeError(f"moss-realtime sampled: the ring of codebook "
                               f"{cb} after the first chunk holds {held}, the "
                               f"host chain {want}")
    zero_counts()
    sres, _ = request("rt", qbb, RT_SAMPLED_FRAMES, on_device=True, **sampled)
    launches("moss-realtime sampled", {"flash_sdpa_window": MOSS_LAYERS})
    if not np.array_equal(sres.codes[:k_ch], first.codes):
        raise RuntimeError("moss-realtime sampled: one seed, other codes")
    cres, cpu_s = request("rt", qbb_cpu, n_cpu, on_device=True, cpu=True,
                          decode=False, chunk=n_cpu, **sampled)
    note = sampled_tie(rlm, qbb, fl["reader"], fl["ids"], pi_s, cres.codes,
                       sres.codes, bucket)
    log(f"[rest] moss-realtime sampled (temperature "
        f"{RT_SAMPLED['temperature']}, top_k {RT_SAMPLED['top_k']}, top_p "
        f"{RT_SAMPLED['top_p']}, repetition penalty "
        f"{RT_SAMPLED['repetition_penalty']} over {w} codes, seed "
        f"{RT_SAMPLED['seed']}): the first chunk's ring equals the host "
        f"chain's window of its codes; {RT_SAMPLED_FRAMES} frames on the card, "
        f"{(sres.codes[:n_fr] != fl['codes'][:len(sres.codes)]).mean():.1%} "
        f"of its first {min(n_fr, len(sres.codes))} frames' codes other than "
        f"greedy's; card vs CPU (its first {n_cpu} frames, one chunk, "
        f"{cpu_s:.1f} s): {note} [{name_limit}]")

    # -- Qwen3-MoE ----------------------------------------------------------------
    per_moe = 4 * mcfg.n_layers
    rng = np.random.default_rng(SEED + 140)
    ids = rng.integers(0, mcfg.vocab_size, sizes.get("moe_prompt", MOE_PROMPT)
                       + sizes.get("moe_steps", MOE_STEPS))
    n_p = sizes.get("moe_prompt", MOE_PROMPT)
    rows = moe.embed_tokens(ids)
    hs = {}
    for side, bb in (("card", moe), ("cpu", moe_cpu)):
        bb.reset()
        if side == "card":
            zero_counts()
        t = time.perf_counter()
        out = [bb.prefill(rows[:n_p], bucket=n_p)]
        out += [bb.step(r) for r in rows[n_p:]]
        sync()
        hs[side] = (np.stack(out), time.perf_counter() - t)
        if side == "card":
            got = launches("qwen3-moe hiddens", {
                "q4_k_matmul": per_moe * (1 + len(rows) - n_p)})
    err = float(np.abs(hs["card"][0] - hs["cpu"][0]).max())
    peak = float(np.abs(hs["cpu"][0]).max())
    if not err <= MOE_REL * peak:
        raise RuntimeError(f"qwen3-moe: hiddens on the card vs the CPU max abs "
                           f"err {err} (peak {peak}, bound {MOE_REL} x peak)")

    def ttsd(lm_, codec_, bb_, frames):
        """A MOSS-TTSD request over `bb_` on the host path, recorded."""
        bb_.reset()
        a = AudioLM(ttsd_reader, codec=codec_, lm=lm_)
        r = Recorder(bb_)
        t = time.perf_counter()
        out = run_codebook_ar(a, r, [a.compose_prompt_embd(i) for i in ttsd_ids],
                              max_steps=frames, pi=ttsd_pi, decode=False,
                              prefill_bucket=MOSS_TTSD_BUCKET)
        pcm = _decode_transformed(a, out.codes) if codec_ is not None else None
        sync()
        return out, pcm, r, time.perf_counter() - t

    zero_counts()
    tres, tpcm, trec, tts_s = ttsd(plm, xy, moe, n_fr)
    steps_m, pre_m = calls_of(trec, MOSS_TTSD_BUCKET)
    got = launches("moss-ttsd on qwen3-moe", {"q4_k_matmul": per_moe
                                              * (steps_m + pre_m)})
    if tres.codes.shape != (n_fr, plm.info.n_codebook) or tres.stopped_by_eos \
            or not np.isfinite(tpcm).all():
        raise RuntimeError(f"moss-ttsd on qwen3-moe: codes {tres.codes.shape}")
    cres, _, _, cpu_s = ttsd(plm_cpu, None, moe_cpu, n_fr)
    cb0 = (ttsd_pi.cb0_speech_range_start, ttsd_pi.cb0_speech_range_end)
    diff = np.argwhere(cres.codes != tres.codes)
    note = "codes equal"
    if len(diff):
        f, k = (int(v) for v in diff[0])
        h = torch.as_tensor(trec.calls[f][2]).to(dev)
        lg = (plm.heads[k] @ h).float().cpu().numpy()
        if k == 0:
            keep = np.zeros(lg.shape, bool)
            keep[cb0[0]:cb0[1]] = True
            keep[plm.info.eos_code_c0] = True
            lg = np.where(keep, lg, -np.inf)
        top = np.sort(lg)[-2:]
        margin = float((top[1] - top[0]) / abs(top[1]))
        if not margin < NEAR_TIE:
            raise RuntimeError(f"moss-ttsd on qwen3-moe: codes first differ at "
                               f"frame {f} codebook {k}, margin {margin}")
        note = (f"codes first differ at frame {f} codebook {k}: a near-tie "
                f"(relative top-2 margin {margin:.2e})")
    step_ms = statistics.mean(c[3] for c in trec.calls[1:]) * 1e3
    expert_b = 3 * mcfg.n_experts * mcfg.moe_ffn_dim * mcfg.hidden
    times["moe"] = dict(step_ms=step_ms, prefill_ms=trec.calls[0][3] * 1e3)
    line = (f"[rest] qwen3-moe: hiddens on the card vs the CPU (a {n_p}-row "
            f"prefill and {len(rows) - n_p} steps, teacher-forced) max abs err "
            f"{err:.3e} (peak {peak:.3f}, {err / peak:.2e} of it; bound "
            f"{MOE_REL}), {got['q4_k_matmul']} q4_k_matmul ({per_moe} a call "
            f"of {mcfg.n_layers} layers: q, k, v, o; experts dense); "
            f"moss-ttsd {n_fr} greedy frames over it on the host path: "
            f"{per_moe * (steps_m + pre_m)} q4_k_matmul, pcm {tpcm.shape} "
            f"finite, card vs CPU: {note} (CPU {cpu_s:.1f} s); backbone step "
            f"{step_ms:.3f} ms (the chosen experts gathered: "
            f"{mcfg.n_experts_used} of {mcfg.n_experts} a token), the "
            f"{len(ttsd_ids)}-row prompt's prefill (every expert, the dense "
            f"form) {times['moe']['prefill_ms']:.1f} ms; experts "
            f"{expert_b / 1e6:.0f} M parameters a layer, "
            f"{expert_b * 4 / 1e9:.2f} GB f32 on the card; all 48 layers "
            f"{48 * expert_b * 2 / 1e9:.1f} GB in bf16 (not run)")
    if cuda:
        x = rows[n_p]
        sprof = call_profile(lambda: moe.step(x), cuda)
        times["moe"]["profile"] = sprof
        line += f"; one step under torch.profiler: {fmt_profile(sprof)}"
    log(line + f" [{name_limit}]")
    reuse["moe"] = moe_cpu          # phase 11's EP backbone
    # phase 12's TP stream chunk: the realtime LM, reader, PromptInfo and
    # prompt, and its Qwen3 backbone's packed weights on the CPU
    reuse["rt"] = (rlm, rt_reader, flows["rt"]["pi"], flows["rt"]["ids"],
                   qbb_cpu)
    del mimi, mimi_cpu, lbb, lbb_cpu, moss, moss_cpu, moe, moe_cpu, flows
    del llm, rlm, runner
    if cuda:
        torch.cuda.empty_cache()
    log(f"[rest] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts, times


def _near_tie_csm(label, lm, bb, prompt, got, want):
    """got == want, or the first difference (frame f, codebook k) is a
    near-tie: the relative top-2 margin of those logits on `bb`'s host path,
    teacher-forced on want's codes before it → a note for the log."""
    from codec_tpu_torch.lm.tts_runner import prefill_prompt

    diff = np.argwhere(got != want) if got.shape == want.shape else None
    if diff is not None and not len(diff):
        return f"codes equal ({got.shape})"
    if diff is None or not len(diff):
        raise RuntimeError(f"{label}: codes {got.shape} vs {want.shape}")
    f, k = (int(v) for v in diff[0])
    bb.reset()
    h = prefill_prompt(bb, prompt)
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
        raise RuntimeError(f"{label}: codes first differ at frame {f} "
                           f"codebook {k}, relative top-2 margin {margin:.3e}")
    return (f"codes first differ at frame {f} codebook {k}: a near-tie, "
            f"relative top-2 margin {margin:.3e} (allowed)")


def _mb_launches(keys_counts, kind: str) -> dict:
    """{m bucket: launches} of the packed product `kind` (q4_k / q8_0) in a
    profiler's (kernel name, count) pairs: the kernel's first template
    argument is its row bucket (csrc/qmat.cu: 1, 2, 4, 8, 16 or 32)."""
    out = {}
    for key, n in keys_counts:
        m = (re.search(rf"{kind}_matmul_kernel<(?:(?:true|false), )?(\d+)", key)
             or re.search(rf"{kind}_matmul_kernelI(?:Lb[01]E)?Li(\d+)E", key))
        if m:
            out[int(m.group(1))] = out.get(int(m.group(1)), 0) + n
    return out


def _profile_mb(fn, kind: str, mb: int, want: int):
    """One call of fn under torch.profiler → (device busy ms, kernels,
    {row bucket: launches} of the packed product `kind`, its device µs a
    launch at bucket `mb`). A trace is taken again (up to three) while it
    shows fewer than `want` launches at `mb` (CUPTI drops a record now and
    then); the fullest is returned."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0
                and not e.key.startswith(("aten::", "Memcpy", "Memset"))]
        at_mb = [(n, t) for k, n, t in kern
                 if _mb_launches([(k, n)], kind).get(mb)]
        got = (sum(t for _, _, t in kern) / 1e3, sum(n for _, n, _ in kern),
               _mb_launches([(k, n) for k, n, _ in kern], kind),
               sum(t for _, t in at_mb) / max(1, sum(n for n, _ in at_mb)))
        if best is None or got[2].get(mb, 0) > best[2].get(mb, 0):
            best = got
        if got[2].get(mb, 0) >= want:
            break
    return best


def serving(name_limit: str, zero_counts, counts, none: dict, paths: dict,
            dev: str = "cuda", sizes=None) -> tuple:
    """Phase 9f: the HTTP server and the continuous-batching engine
    (codec_tpu_torch/serve) on the card, over the files phases 9, 9c and
    9d wrote (paths: "csm", "Q4_K", "Q8_0", "cbx", "cbx_bb", "pocket"):
    each server in this process on 127.0.0.1 (port 0), every response
    200, every request's launch counts set to 0 just before and read just
    after (its first run of a new graph shape beforehand, uncounted).
      - codec endpoints (the CSM file's Mimi, f32): /health; /decode of 20 s
        of codes byte-equal to model.decode(pcm_format="i16") (8
        flash_sdpa_window); /decode_stream in chunks of 25 frames within
        the stream bound of it (8 with carried keys a push: max abs err
        <= 1e-4 x peak, corr > 0.99999); /batch_decode of 4 mixed lengths,
        each within it of its /decode; /encode of a 20 s WAV equal to
        model.encode (8 + 2 rvq_encode_fused);
      - while the engine's server is built (its graph captured), /decode
        requests run on the other server: all 200 and equal;
      - serialized against continuous (Q4_K, --quant-exec, 4 slots, chunks
        of 8): a greedy 25-frame /synthesize on both, equal bytes, else the
        codes of a library ContinuousBatcher and run_codebook_ar first
        differ at a near-tie and each response is its codes' decode; 8
        concurrent sampled requests over the 4 slots, two replayed alone
        byte-equal; one streamed request (time to first audio, within the
        stream bound of its plain response); one request on the Q8_0
        backbone;
      - /synthesize_batch: 4 CSM texts greedy and 4 Chatterbox texts greedy
        with CFG (m = 8 in the T3 graph), each stream's codes (the library
        call the endpoint makes) against its single-stream chunked run
        (near-tie rule), the responses' frame counts and stops equal;
      - a streamed /synthesize on the Pocket-TTS server (2
        flash_sdpa_window with carried keys a frame).
    Measured: each endpoint's latency, the engine's ms a chunk and frames
    a second at 1, 2 and 4 active slots, one engine step under
    torch.profiler, q4_k_matmul launches by row bucket in a replay of the
    engine's graph (m = 4), the CSM batch's (m = 4) and the Chatterbox
    batch's (m = 8). `dev` and `sizes` let it run small on the CPU
    (tests/test_torch_serve.py), where the plain versions count nothing
    and the launch counts are those the card is held to.
    → (launch counts, times)."""
    import base64
    import http.client
    import threading

    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.lm.tts_runner import (_decode_transformed,
                                               run_chatterbox,
                                               run_chatterbox_batch,
                                               run_codebook_ar,
                                               run_codebook_ar_batch)
    from codec_tpu_torch.ops.sample import OnDeviceSampling
    from codec_tpu_torch.serve.cont_batch import ContinuousBatcher
    from codec_tpu_torch.serve.server import (CodecHTTPServer, _pcm16,
                                              _wav_header)

    sizes = sizes or {}
    cuda = dev == "cuda"
    frames = sizes.get("frames", SERVE_FRAMES)
    secs = sizes.get("seconds", SERVE_SECONDS)
    carried = "flash_sdpa_window (carried keys)"
    phase_counts, times = dict(none, **{carried: 0}), {}
    t_phase = time.monotonic()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches(label, want):
        """The counts since zero_counts() against `want`; the request's
        attention launches are `want`'s plain ones plus its carried-key
        ones (one wrapper counts both). On the CPU the plain versions count
        nothing: `want` is what the card is held to."""
        want = {**none, **want}
        n_carried = want.pop(carried, 0)
        total = dict(want, flash_sdpa_window=want.get("flash_sdpa_window", 0)
                     + n_carried)
        got = {**total, **counts()} if cuda else total
        if got != total:
            raise RuntimeError(f"serve {label}: launches {got}, want {total} "
                               f"({n_carried} of the attention's with "
                               f"carried keys)")
        for k, v in want.items():
            phase_counts[k] = phase_counts.get(k, 0) + v
        phase_counts[carried] += n_carried

    def post(srv, path, body, first_byte=False):
        """→ (status, body bytes, seconds, seconds to the first PCM
        bytes after the WAV header when `first_byte`)."""
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        t = time.perf_counter()
        conn.request("POST", path, body=data)
        r = conn.getresponse()
        ttfb = None
        if first_byte and r.status == 200:
            head = r.read(44)
            first = r.read(2)
            ttfb = time.perf_counter() - t
            out = head + first + r.read()
        else:
            out = r.read()
        conn.close()
        if r.status != 200:
            raise RuntimeError(f"serve {path}: status {r.status}: "
                               f"{out[:300]!r}")
        return r.status, out, time.perf_counter() - t, ttfb

    def pcm_of(wav: bytes) -> np.ndarray:
        return np.frombuffer(wav[44:], dtype="<i2").astype(np.int32)

    def lsb(label, a: bytes, b: bytes) -> int:
        """The largest difference of two PCM16 responses in LSB, held to
        phase 8's bound of a stream against its whole decode: corr >
        0.99999 and max abs err <= 1e-4 x peak (at least 1 LSB; on the card
        the attention's tiles follow the push's length, so the sums run in
        another order than the whole decode's)."""
        x, y = pcm_of(a), pcm_of(b)
        if x.shape != y.shape or not len(x):
            raise RuntimeError(f"serve {label}: PCM {x.shape} vs {y.shape}")
        err, peak = int(np.abs(x - y).max()), int(np.abs(y).max())
        if err and not (corr(x, y) > 0.99999 and err <= max(1, 1e-4 * peak)):
            raise RuntimeError(f"serve {label}: {err} LSB from its reference "
                               f"(peak {peak}, corr {corr(x, y)})")
        return err

    def start(srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    servers = []
    try:
        # -- the serialized server: the codec endpoints and the backbone --
        t0 = time.monotonic()
        ser = start(CodecHTTPServer(str(paths["csm"]), port=0,
                                    backbone_path=str(paths["Q4_K"]),
                                    quant_exec=True, device=dev))
        servers.append(ser)
        sync()
        model, lm, bb = ser.model, ser.lm, ser.backbone
        per_step = 7 * bb.cfg.n_layers
        log(f"[serve] serialized server (CSM Mimi f32 + Q4_K backbone "
            f"packed, {bb.cfg.n_layers} layers) up in "
            f"{time.monotonic() - t0:.2f} s on port {ser.port}")
        conn = http.client.HTTPConnection(ser.host, ser.port, timeout=60)
        conn.request("GET", "/health")
        r = conn.getresponse()
        health = json.loads(r.read())
        conn.close()
        if r.status != 200 or health["arch"] != model.arch:
            raise RuntimeError(f"serve /health: {r.status} {health}")

        rng = np.random.default_rng(SEED + 900)
        n_fr = secs * model.sample_rate // model.hop_size
        codes = rng.integers(0, model.codebook_size, (n_fr, model.n_q))
        lat = {}
        post(ser, "/decode", {"codes": codes[:8].tolist()})     # warm
        zero_counts()
        _, wav, lat["/decode"], _ = post(ser, "/decode",
                                         {"codes": codes.tolist()})
        launches("/decode", {"flash_sdpa_window": MIMI_LAYERS})
        want = model.decode(codes.astype(np.int32), pcm_format="i16")
        if wav[44:] != want.astype("<i2").tobytes():
            raise RuntimeError("serve /decode: bytes differ from "
                               "model.decode(pcm_format='i16')")
        chunk = SERVE_STREAM_CHUNK
        n_push = -(-n_fr // chunk)
        zero_counts()
        _, swav, lat["/decode_stream"], ttfb = post(
            ser, "/decode_stream", {"codes": codes.tolist(),
                                    "chunk_frames": chunk}, first_byte=True)
        launches("/decode_stream", {carried: MIMI_LAYERS * n_push})
        d_stream = lsb("/decode_stream vs /decode", swav, wav)
        lens = [n_fr, n_fr // 2, n_fr, max(1, n_fr // 4)]
        seqs = [rng.integers(0, model.codebook_size, (t, model.n_q))
                for t in lens]
        zero_counts()
        _, body, lat["/batch_decode"], _ = post(
            ser, "/batch_decode", {"sequences": [s.tolist() for s in seqs]})
        launches("/batch_decode",
                 {"flash_sdpa_window": MIMI_LAYERS * len(set(lens))})
        d_batch = 0
        for s, w in zip(seqs, json.loads(body)["wavs"]):
            one = post(ser, "/decode", {"codes": s.tolist()})[1]
            d_batch = max(d_batch, lsb("/batch_decode vs /decode",
                                       base64.b64decode(w), one))
        pcm = (np.clip(rng.standard_normal(secs * model.sample_rate) * 0.1,
                       -1, 1) * 32767).astype("<i2")
        wav_in = _wav_header(len(pcm), model.sample_rate) + pcm.tobytes()
        n_warm = 4 * model.hop_size
        post(ser, "/encode", _wav_header(n_warm, model.sample_rate)
             + pcm[:n_warm].tobytes())                           # warm
        zero_counts()
        _, body, lat["/encode"], _ = post(ser, "/encode", wav_in)
        launches("/encode", {"flash_sdpa_window": MIMI_LAYERS,
                             "rvq_encode_fused": 2})
        enc = np.asarray(json.loads(body)["codes"])
        if not np.array_equal(enc, model.encode(pcm)):
            raise RuntimeError("serve /encode: codes differ from model.encode")
        log(f"[serve] codec endpoints: /decode {secs} s byte-equal to "
            f"model.decode (i16); /decode_stream in {n_push} pushes of "
            f"{chunk} frames {d_stream} LSB from it, first audio after "
            f"{ttfb * 1e3:.1f} ms; /batch_decode of {lens} frames at most "
            f"{d_batch} LSB from each /decode; /encode of {secs} s equal to "
            f"model.encode {enc.shape}; latency ms "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in lat.items())
            + f"; at {time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- the engine's server, built while /decode requests run --------
        stop, during, errors = threading.Event(), [], []

        def decodes():
            while not stop.is_set():
                try:
                    during.append(post(ser, "/decode",
                                       {"codes": codes[:50].tolist()})[1])
                except Exception as e:                # noqa: BLE001
                    errors.append(e)
                    return
        t = threading.Thread(target=decodes)
        t.start()
        t0 = time.monotonic()
        try:
            cont = start(CodecHTTPServer(
                str(paths["csm"]), port=0, backbone_path=str(paths["Q4_K"]),
                quant_exec=True, cont_batch=SERVE_SLOTS,
                chunk_frames=TTS_CHUNK, device=dev))
            servers.append(cont)
            sync()
        finally:
            stop.set()
            t.join(timeout=600)
        build_s = time.monotonic() - t0
        if errors or not during or any(w != during[0] for w in during):
            raise RuntimeError(f"serve: {len(during)} /decode requests "
                               f"while the engine was built, not all equal, "
                               f"errors {errors}")
        log(f"[serve] engine server ({SERVE_SLOTS} slots, chunks of "
            f"{TTS_CHUNK}) built and its graph captured in {build_s:.2f} s "
            f"while {len(during)} /decode requests ran on the other server, "
            f"all 200 and equal; at {time.monotonic() - t_phase:.1f} s")

        # -- serialized against continuous, greedy --------------------------
        greedy = {"text": SERVE_TEXTS[0], "seed": SEED, "max_frames": frames,
                  "temperature": 0.0}
        tok = cont._cont_tok
        pi = cont._cont_pi
        prompt_len = {x: len(tok.encode(pi.prompt_prefix + x
                                        + pi.prompt_suffix))
                      for x in SERVE_TEXTS}
        want_ser = {"flash_sdpa_window": MIMI_LAYERS,
                    "q4_k_matmul": per_step * prompt_len[SERVE_TEXTS[0]]}
        # the serialized server's first on_device request captures its
        # chunk: the capture's warm-up and recording launch through the
        # wrappers (2 x 28 x 8), the replays count nothing
        graph = 2 * per_step * TTS_CHUNK
        zero_counts()
        _, wav_ser, lat["/synthesize serialized"], _ = post(
            ser, "/synthesize", dict(greedy, on_device=True,
                                     chunk_frames=TTS_CHUNK))
        launches("/synthesize serialized (its capture)",
                 dict(want_ser, q4_k_matmul=want_ser["q4_k_matmul"] + graph))
        zero_counts()
        _, wav_cont, lat["/synthesize engine"], _ = post(
            cont, "/synthesize", greedy)
        launches("/synthesize engine", want_ser)
        prompt = list(bb.embed_tokens(tok.encode(
            pi.prompt_prefix + SERVE_TEXTS[0] + pi.prompt_suffix)))
        gods = OnDeviceSampling(chunk_frames=TTS_CHUNK)
        lane = LlamaBackbone.from_params(bb.cfg, bb.params, bb.dtype, bb.qmm)
        if wav_ser == wav_cont:
            note = "equal bytes"
        else:
            # the library calls the two endpoints make, on the same weights:
            # their codes first differ at a near-tie, and each response is
            # its call's decode
            eng = ContinuousBatcher(lane, lm, n_slots=SERVE_SLOTS,
                                    on_device=gods, pi=pi, decode=False)
            h = eng.submit(AudioLM(ser.reader, codec=model, lm=lm), prompt,
                           seed=SEED, max_steps=frames)
            eng.drain()
            e_res = h.wait(timeout=0)
            bb.reset()
            s_res = run_codebook_ar(AudioLM(ser.reader, codec=model, lm=lm),
                                    bb, prompt, max_steps=frames, pi=pi,
                                    on_device=gods, decode=False)
            note = "bytes differ; library codes: " + _near_tie_csm(
                "serve engine vs serialized", lm, bb, prompt, e_res.codes,
                s_res.codes)
            for label, w, res in (("engine", wav_cont, e_res),
                                  ("serialized", wav_ser, s_res)):
                if w[44:] != _pcm16(_decode_transformed(
                        AudioLM(ser.reader, codec=model, lm=lm), res.codes)):
                    raise RuntimeError(f"serve {label}: the response is not "
                                       f"its library call's decode")
        log(f"[serve] greedy {frames}-frame /synthesize, serialized "
            f"(on_device, chunks of {TTS_CHUNK}) against the engine: {note}; "
            f"at {time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- 8 concurrent sampled requests over the 4 slots -----------------
        reqs = [{"text": SERVE_TEXTS[i % len(SERVE_TEXTS)], "seed": 100 + i,
                 "max_frames": frames} for i in range(SERVE_CONCURRENT)]
        out = {}

        def worker(i):
            out[i] = post(cont, "/synthesize", reqs[i])
        zero_counts()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(len(reqs))]
        for x in ts:
            x.start()
        for x in ts:
            x.join(timeout=600)
        conc_s = time.perf_counter() - t0
        if sorted(out) != list(range(len(reqs))):
            raise RuntimeError(f"serve concurrent: {len(out)} of {len(reqs)} "
                               f"answered")
        launches("/synthesize x8 concurrent", {
            "flash_sdpa_window": MIMI_LAYERS * len(reqs),
            "q4_k_matmul": per_step * sum(prompt_len[r["text"]]
                                          for r in reqs)})
        for i in (0, len(reqs) - 1):
            again = post(cont, "/synthesize", reqs[i])[1]
            if again != out[i][1]:
                raise RuntimeError(f"serve concurrent request {i}: replayed "
                                   f"alone it gives other bytes")
        lat["/synthesize engine x8"] = conc_s
        log(f"[serve] {len(reqs)} concurrent sampled /synthesize (chain of "
            f"the family, distinct seeds) over {SERVE_SLOTS} slots: all 200 "
            f"in {conc_s * 1e3:.1f} ms ({len(reqs) * frames / conc_s:.1f} "
            f"frames/s); requests 0 and {len(reqs) - 1} replayed alone give "
            f"the same bytes; per request "
            + ", ".join(f"{out[i][2] * 1e3:.0f}" for i in sorted(out))
            + f" ms; at {time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- one streamed engine request ------------------------------------
        sreq = dict(reqs[0], seed=7)
        plain = post(cont, "/synthesize", sreq)[1]
        n_push = -(-(len(plain) - 44) // 2 // model.hop_size // TTS_CHUNK)
        zero_counts()
        _, swav, lat["/synthesize engine stream"], ttfa = post(
            cont, "/synthesize", dict(sreq, stream=True), first_byte=True)
        # the engine decodes the whole request at its end (as codec_tpu's
        # does, streamed or not) beside the handler's pushes
        launches("/synthesize engine stream", {
            "flash_sdpa_window": MIMI_LAYERS,
            "q4_k_matmul": per_step * prompt_len[sreq["text"]],
            carried: MIMI_LAYERS * n_push})
        d_st = lsb("streamed vs plain /synthesize", swav, plain)
        times["ttfa_ms"] = ttfa * 1e3
        # the same request submitted to the engine directly: when it was
        # admitted (its prompt prefilled) and when its first frame came
        seen = []
        t = time.perf_counter()
        h = cont._cont_batcher.submit(
            AudioLM(cont.reader, codec=model, lm=cont.lm), list(
                bb.embed_tokens(tok.encode(pi.prompt_prefix + sreq["text"]
                                           + pi.prompt_suffix))),
            seed=sreq["seed"], max_steps=frames,
            frame_cb=lambda c: seen.append(time.perf_counter()))
        h.wait(timeout=600)
        done_s = time.perf_counter() - t
        log(f"[serve] streamed engine /synthesize: time to first audio "
            f"{ttfa * 1e3:.1f} ms, {d_st} LSB from its plain response, "
            f"{n_push} pushes of up to {TTS_CHUNK} frames; the same request "
            f"submitted directly: admitted after "
            f"{(h.admitted_at - h.submitted_at) * 1e3:.1f} ms, its first frame "
            f"after {(seen[0] - t) * 1e3:.1f} ms, done after "
            f"{done_s * 1e3:.1f} ms; at {time.monotonic() - t_phase:.1f} s "
            f"[{name_limit}]")

        # -- one request on the Q8_0 backbone -------------------------------
        t0 = time.monotonic()
        q8 = start(CodecHTTPServer(
            str(paths["csm"]), port=0, backbone_path=str(paths["Q8_0"]),
            quant_exec=True, device=dev))
        servers.append(q8)
        zero_counts()
        _, wav_q8, lat["/synthesize Q8_0"], _ = post(
            q8, "/synthesize", dict(greedy, max_frames=TTS_CHUNK))
        # the host path: a step a prompt row and a step a frame
        launches("/synthesize Q8_0", {
            "flash_sdpa_window": MIMI_LAYERS,
            "q8_0_matmul": per_step * (prompt_len[SERVE_TEXTS[0]]
                                       + TTS_CHUNK)})
        if len(wav_q8) != 44 + 2 * TTS_CHUNK * model.hop_size:
            raise RuntimeError(f"serve Q8_0: {len(wav_q8)} bytes")
        q8.shutdown()
        servers.remove(q8)
        log(f"[serve] Q8_0 server (--quant-exec) up and a greedy {TTS_CHUNK}-frame "
            f"/synthesize on its host path 200 in {time.monotonic() - t0:.2f} "
            f"s (the request {lat['/synthesize Q8_0'] * 1e3:.1f} ms); at "
            f"{time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- the engine's chunk at 1, 2 and 4 active slots ------------------
        # the engine server's own batcher (its thread stopped: no request
        # is left for it), its default chain (sampled)
        cont.cont_engine.stop()
        eng = cont._cont_batcher
        rate, prof = {}, None
        for n_act in (1, 2, SERVE_SLOTS):
            hs = [eng.submit(AudioLM(cont.reader, codec=model, lm=cont.lm),
                             prompt,
                             seed=200 + i,
                             max_steps=TTS_CHUNK * (SERVE_TIMED + 2))
                  for i in range(n_act)]
            eng.step()                                  # admissions
            samples = []
            for _ in range(SERVE_TIMED):
                sync()
                t = time.perf_counter()
                eng.step()
                sync()
                samples.append(time.perf_counter() - t)
            ms = statistics.median(samples) * 1e3
            rate[n_act] = (ms, n_act * TTS_CHUNK / ms * 1e3)
            if n_act == SERVE_SLOTS and cuda:
                # one step, its replay and host work, in one trace
                prof = _profile_mb(eng.step, "q4_k", 4, per_step * TTS_CHUNK)
            eng.drain()
            for x in hs:
                x.wait(timeout=0)
        times["engine"] = rate
        line = (f"[serve] engine chunk (the engine server's batcher, its "
                f"default chain, host clock, median of {SERVE_TIMED} steps): "
                + "; ".join(f"{n} active {ms:.2f} ms a chunk, {fps:.1f} "
                            f"frames/s" for n, (ms, fps) in rate.items()))
        if prof is not None:
            busy, n_kern, mb, mb_us = prof
            step_ms = rate[SERVE_SLOTS][0]
            times["engine_mb"] = mb
            if mb.get(4, 0) != per_step * TTS_CHUNK:
                raise RuntimeError(f"serve engine step: q4_k_matmul by row "
                                   f"bucket {mb}, want {per_step * TTS_CHUNK} "
                                   f"at m = 4")
            line += (f"; one step at {SERVE_SLOTS} active under torch.profiler:"
                     f" {n_kern} kernels ({n_kern / TTS_CHUNK:.0f} a frame), "
                     f"device busy {busy:.3f} ms (idle share "
                     f"{max(0.0, 1 - busy / step_ms):.3f} of the timed step), "
                     f"q4_k_matmul by row bucket {mb}, {mb_us:.2f} µs a "
                     f"launch at m = 4")
        log(line + f"; at {time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- /synthesize_batch: 4 CSM texts, greedy -------------------------
        breq = {"texts": SERVE_TEXTS[:SERVE_SLOTS], "seed": SEED,
                "max_frames": frames, "chunk_frames": TTS_CHUNK,
                "sampling": [{"temperature": 0.0}] * SERVE_SLOTS}
        zero_counts()
        _, body, lat["/synthesize_batch CSM"], _ = post(
            ser, "/synthesize_batch", breq)
        # its first request captures the batched chunk (m = 4)
        launches("/synthesize_batch CSM (its capture)", {
            "flash_sdpa_window": MIMI_LAYERS * SERVE_SLOTS,
            "q4_k_matmul": per_step * sum(prompt_len[x]
                                          for x in breq["texts"]) + graph})
        got = json.loads(body)
        prompts = [list(bb.embed_tokens(tok.encode(
            pi.prompt_prefix + x + pi.prompt_suffix))) for x in breq["texts"]]
        shared = ser._shared_lm
        # each stream's single-stream chunked run: the serialized greedy
        # request's chain on its LM (its graph); equal bytes mean equal
        # codes (the decode is deterministic), else the codes of the
        # library call the endpoint makes first differ at a near-tie
        ser_ods = OnDeviceSampling(temperature=0.0, top_k=pi.default_top_k,
                                   top_p=pi.default_top_p,
                                   chunk_frames=TTS_CHUNK)
        ones, lib, notes = [], None, []
        for p in prompts:
            bb.reset()
            ones.append(run_codebook_ar(
                AudioLM(ser.reader, codec=model, lm=lm), bb, p,
                max_steps=frames, pi=pi, on_device=ser_ods))
        for i, (w, one) in enumerate(zip(got["wavs"], ones)):
            if base64.b64decode(w)[44:] == _pcm16(one.pcm) \
                    and got["n_frames"][i] == len(one.codes):
                notes.append("equal bytes")
                continue
            if lib is None:
                lib = run_codebook_ar_batch(
                    [AudioLM(ser.reader, codec=model, lm=shared)
                     for _ in prompts], bb, prompts,
                    OnDeviceSampling(chunk_frames=TTS_CHUNK),
                    max_steps=frames, pi=pi, decode=False,
                    sampling=[OnDeviceSampling(chunk_frames=TTS_CHUNK)]
                    * SERVE_SLOTS)
            notes.append(_near_tie_csm(f"serve batch stream {i}", shared, bb,
                                       prompts[i], lib[i].codes, one.codes))
        log(f"[serve] /synthesize_batch of {SERVE_SLOTS} CSM texts greedy: "
            f"200 in {lat['/synthesize_batch CSM'] * 1e3:.1f} ms, frames "
            f"{got['n_frames']}; each stream vs its single-stream chunked run: "
            f"{notes}; at {time.monotonic() - t_phase:.1f} s [{name_limit}]")

        # -- /synthesize_batch: 4 Chatterbox texts, greedy with CFG ----------
        t0 = time.monotonic()
        cbx = start(CodecHTTPServer(str(paths["cbx"]), port=0,
                                    backbone_path=str(paths["cbx_bb"]),
                                    quant_exec=True, prefill_bucket=CBX_BUCKET,
                                    device=dev))
        servers.append(cbx)
        cframes = sizes.get("cbx_frames", SERVE_CBX_FRAMES)
        creq = {"texts": SERVE_TEXTS[:SERVE_SLOTS], "seed": SEED,
                "max_frames": cframes, "chunk_frames": CBX_CHUNK,
                "sampling": [{"temperature": 0.0}] * SERVE_SLOTS}
        c_step = 7 * cbx.backbone.cfg.n_layers
        zero_counts()
        _, body, lat["/synthesize_batch Chatterbox"], _ = post(
            cbx, "/synthesize_batch", creq)
        # each lane's prompt prefills in one forward of CBX_BUCKET rows (past
        # the kernels' 32, so the dequantized product); the first request
        # captures the chunk (its warm-up and recording at m = 8), the
        # replays count nothing
        launches("/synthesize_batch Chatterbox (its capture)",
                 {"q4_k_matmul": 2 * c_step * CBX_CHUNK})
        got = json.loads(body)
        t3, cbb, clm = cbx._t3, cbx.backbone, cbx._shared_lm
        cods = OnDeviceSampling(temperature=0.0, chunk_frames=CBX_CHUNK,
                                repetition_penalty=1.2, repetition_window=-1,
                                seed=SEED)
        lib = run_chatterbox_batch(
            [AudioLM(cbx.reader, lm=clm) for _ in creq["texts"]], t3, cbb,
            creq["texts"], cods, max_frames=cframes, decode=False,
            prefill_bucket=CBX_BUCKET)
        head = np.asarray(cbx.reader.get("lm.heads_0.weight"), np.float64)
        notes = []
        for i, (text, r) in enumerate(zip(creq["texts"], lib)):
            if (got["n_frames"][i], got["stops"][i]) != (
                    len(r.codes), "eos" if r.stopped_by_eos else "max_frames"):
                raise RuntimeError(f"serve cbx stream {i}: the response's "
                                   f"frames and stop differ from the library "
                                   f"call's")
            lanes = [cbb, LlamaBackbone.from_params(cbb.cfg, cbb.params,
                                                    cbb.dtype, cbb.qmm)]
            for x in lanes:
                x.reset()
            one = run_chatterbox(AudioLM(cbx.reader, lm=clm), t3, lanes, text,
                                 max_frames=cframes, on_device=cods,
                                 decode=False, prefill_bucket=CBX_BUCKET)
            if np.array_equal(r.codes, one.codes):
                notes.append("equal")
                continue
            n = min(len(r.codes), len(one.codes))
            diff = np.flatnonzero(r.codes[:n, 0] != one.codes[:n, 0])
            f = int(diff[0]) if len(diff) else n
            rec = [Recorder(x) for x in lanes]
            for x in lanes:
                x.reset()
            host = run_chatterbox(AudioLM(cbx.reader, lm=clm), t3, rec, text,
                                  max_frames=f + 1,
                                  sampler=lambda lg: int(np.argmax(lg)),
                                  decode=False, prefill_bucket=CBX_BUCKET)
            if not np.array_equal(host.codes[:f], one.codes[:f]):
                raise RuntimeError(f"serve cbx stream {i}: differs from its "
                                   f"single-stream run at frame {f}, and the "
                                   f"host path before it")
            hs = [np.asarray(x.calls[f][2], np.float64) for x in rec]
            cond, unc = head @ hs[0], head @ hs[1]
            top = np.sort(cond + 0.5 * (cond - unc))[-2:]
            margin = float((top[1] - top[0]) / abs(top[1]))
            if not margin < NEAR_TIE:
                raise RuntimeError(f"serve cbx stream {i}: first differs at "
                                   f"frame {f}, margin {margin:.3e}")
            notes.append(f"frame {f} a near-tie ({margin:.2e})")
        mb = {}
        if cuda:
            ckey = [k for k in cbb._batch_chunks if k[1] == SERVE_SLOTS]
            _, _, mb, mb_us = _profile_mb(
                cbb._batch_chunks[ckey[-1]][2].runner.run, "q4_k", 8,
                c_step * CBX_CHUNK)
            if mb.get(8, 0) != c_step * CBX_CHUNK:
                raise RuntimeError(f"serve cbx batch replay: q4_k_matmul by "
                                   f"row bucket {mb}, want "
                                   f"{c_step * CBX_CHUNK} at m = 8")
        times["cbx_mb"] = mb
        log(f"[serve] Chatterbox server up in {time.monotonic() - t0:.2f} s "
            f"(prefill in buckets of {CBX_BUCKET}); /synthesize_batch of "
            f"{SERVE_SLOTS} texts greedy, CFG 0.5: 200 in "
            f"{lat['/synthesize_batch Chatterbox'] * 1e3:.1f} ms, frames "
            f"{got['n_frames']}, stops {got['stops']}; each stream vs its "
            f"single-stream chunk: {notes}; one replay's q4_k_matmul by row "
            f"bucket {mb} ({SERVE_SLOTS} streams x 2 lanes"
            + (f", {mb_us:.2f} µs a launch at m = 8" if mb else "") + "); at "
            f"{time.monotonic() - t_phase:.1f} s [{name_limit}]")
        cbx.shutdown()
        servers.remove(cbx)

        # -- the flow path: a streamed /synthesize on Pocket-TTS ------------
        pt = start(CodecHTTPServer(str(paths["pocket"]), port=0, device=dev))
        servers.append(pt)
        preq = {"text": SERVE_TEXTS[0], "seed": SEED, "max_frames": frames,
                "stream": True}
        post(pt, "/synthesize", dict(preq, max_frames=2))          # warm
        zero_counts()
        _, fwav, lat["/synthesize flow stream"], f_ttfa = post(
            pt, "/synthesize", preq, first_byte=True)
        n_flow = (len(fwav) - 44) // 2 // pt.model.hop_size
        launches("/synthesize flow stream",
                 {carried: pt.model.cfg.tf_layers * n_flow})
        if n_flow < 1:
            raise RuntimeError("serve flow stream: no PCM")
        log(f"[serve] streamed Pocket-TTS /synthesize: {n_flow} frames, time "
            f"to first audio {f_ttfa * 1e3:.1f} ms, "
            f"{lat['/synthesize flow stream'] * 1e3:.1f} ms in all; at "
            f"{time.monotonic() - t_phase:.1f} s [{name_limit}]")
    finally:
        for srv in servers:
            srv.shutdown()
    times["latency_ms"] = {k: v * 1e3 for k, v in lat.items()}
    log(f"[serve] main path launches: {phase_counts}; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    return phase_counts, times


def mesh_phase(name_limit: str, zero_counts, counts, none: dict, models,
               paths: dict, moe_cpu, dev: str = "cuda", sizes=None) -> tuple:
    """Phase 11: the device mesh on one card (codec_tpu_torch/parallel),
    every mesh make_mesh(MESH_N, devices=[dev] * MESH_N): one card named
    twice, so the shares run on it one after the other and the times of
    sharded against unsharded calls are no scaling number. Each sharded
    call goes through the entry a user calls, its launch counts set to 0
    just before and read just after, and is held against the same model
    unsharded:
      - DP (CodecModel.set_mesh): models "mimi" and "dac" (f32, loaded in
        phase 4) replicated twice; Mimi b4 decode (8 flash_sdpa_window a
        slice) and encode (8 + 2 rvq_encode_fused a slice), DAC b4 decode
        (12 seanet_res_unit a slice); decodes within MESH_REL of the peak
        at corr > 0.99999, encodes under the near-tie rule;
      - PP (set_mesh_pp): paths["Q4_K"], phase 9's backbone, packed, two
        stages of two layers: a MESH_PROMPT-row prefill and MESH_STEPS
        teacher-forced steps (28 q4_k_matmul a step, as unsharded), hiddens
        within MESH_BB_REL of the unsharded peak; a greedy host-path request
        (the unsharded codes, or a near-tie); `tts-cli-torch synthesize
        --pp 2` and `codec-serve-torch --pp 2`'s serialized /synthesize,
        byte-equal to their unsharded runs, with the same launches;
      - TP (set_mesh): the same file loaded dense, split two ways, the same
        checks (no packed products: TP takes dense weights);
      - EP (set_mesh_ep): `moe_cpu`, phase 9e's Qwen3-MoE (1 layer, 128
        experts: 64 a share) copied to the card, the prefill and steps.
    `dev` and `sizes` let it run small on the CPU, where the plain
    versions count nothing and the counts are what the card is held to.
    → (launch counts, times)."""
    import http.client
    import threading

    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import main as tts_cli
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.tts_runner import run_codebook_ar
    from codec_tpu_torch.models import mimi
    from codec_tpu_torch.parallel.mesh import make_mesh
    from codec_tpu_torch.runtime.model import f32_precision
    from codec_tpu_torch.serve.server import CodecHTTPServer

    sizes = sizes or {}
    cuda = dev == "cuda"
    entry = "cuda:0" if cuda else dev
    devs = [entry] * MESH_N
    secs = sizes.get("seconds", MESH_SECONDS)
    n_steps = sizes.get("steps", MESH_STEPS)
    n_prompt = sizes.get("prompt", MESH_PROMPT)
    frames = sizes.get("frames", MESH_FRAMES)
    phase_counts, times = dict(none), {}
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 1100)

    def mesh(axis):
        return make_mesh(MESH_N, axis=axis, devices=devs)

    def launched(label, fn, want):
        """fn() with the counts set to 0 just before and read just after,
        held to `want` (on the CPU the plain versions count nothing)."""
        zero_counts()
        out = fn()
        want = {**none, **want}
        got = counts() if cuda else want
        if got != want:
            raise RuntimeError(f"mesh {label}: launches {got}, want {want}")
        for k, v in want.items():
            phase_counts[k] += v
        return out

    def ms(fn):
        """Median CUDA-event ms of one call (host clock on the CPU)."""
        if cuda:
            return cuda_ms(fn)
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    def pcm_held(label, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        c, err = corr(got, want), float(np.abs(got - want).max())
        peak = float(np.abs(want).max())
        if got.shape != want.shape or not (c > 0.99999
                                           and err <= MESH_REL * peak):
            raise RuntimeError(f"mesh {label}: {got.shape} vs {want.shape}, "
                               f"corr {c}, max abs err {err} (peak {peak})")
        return f"corr {c:.9f}, max abs err {err:.3e} (peak {peak:.4f})"

    # -- DP: one replica of the weights a mesh entry, the batch split -------
    for arch in ("mimi", "dac"):
        base = models[arch]
        dp = type(base)(base.reader, compute_dtype=base.compute_dtype,
                        device=entry)
        dp.set_mesh(mesh("dp"))
        n_fr = secs * base.sample_rate // base.hop_size
        codes = rng.integers(0, base.codebook_size,
                             (MESH_BATCH, n_fr, base.n_q)).astype(np.int32)
        per = ({"flash_sdpa_window": MIMI_LAYERS} if arch == "mimi"
               else {"seanet_res_unit": 12})
        got = launched(f"{arch} dp decode", lambda: dp.decode(codes),
                       {k: MESH_N * v for k, v in per.items()})
        if [str(d) for d in dp.last_out_devices] != devs:
            raise RuntimeError(f"mesh {arch} dp decode: slices on "
                               f"{dp.last_out_devices}")
        note = pcm_held(f"{arch} dp decode", got, base.decode(codes))
        t_dp, t_one = ms(lambda: dp.decode(codes)), ms(lambda: base.decode(codes))
        times[f"{arch}_dp_decode"] = (t_dp, t_one)
        log(f"[mesh] dp {arch} {secs} s b{MESH_BATCH} f32 decode over "
            f"{MESH_N} replicas on {entry}: launches {MESH_N} x {per}; vs the "
            f"model unsharded {note}; {t_dp:.3f} ms sharded, {t_one:.3f} ms "
            f"unsharded (one card runs the slices in turn: no scaling "
            f"number) [{name_limit}]")
        if arch == "mimi":
            pcm = (rng.standard_normal((MESH_BATCH, secs * base.sample_rate))
                   * 0.3).astype(np.float32)
            got = launched("mimi dp encode", lambda: dp.encode(pcm),
                           {"flash_sdpa_window": MESH_N * MIMI_LAYERS,
                            "rvq_encode_fused": MESH_N * 2})
            want = base.encode(pcm)
            if got.shape != want.shape or got.dtype != np.int32:
                raise RuntimeError(f"mesh mimi dp encode: codes {got.shape} "
                                   f"{got.dtype}, want {want.shape}")
            with torch.inference_mode(), f32_precision(True):
                lat = f64(mimi.mimi_encode_latent_fn(
                    base.params, torch.from_numpy(pcm).to(base.device),
                    base.cfg))
            ties = [t for bi in range(MESH_BATCH) for t in near_ties(
                got[bi], want[bi],
                mimi_margin(base.params, base.cfg, lat[bi], want[bi],
                            got[bi]))]
            t_dp, t_one = ms(lambda: dp.encode(pcm)), ms(lambda: base.encode(pcm))
            times["mimi_dp_encode"] = (t_dp, t_one)
            log(f"[mesh] dp mimi {secs} s b{MESH_BATCH} f32 encode: launches "
                f"{MESH_N} x (8 flash_sdpa_window + 2 rvq_encode_fused); codes "
                + ("equal to the unsharded encode's" if not ties else
                   f"{len(ties)} frames differ, each a near-tie (margins "
                   f"{', '.join(f'{m:.1e}' for _, _, m in ties)})")
                + f"; {t_dp:.3f} ms sharded, {t_one:.3f} ms unsharded "
                f"[{name_limit}]")
        del dp

    # -- the backbones: PP (packed), TP (dense), EP (the MoE) ----------------
    def teacher(bb, rows, steps):
        bb.reset()
        hs = [bb.prefill(rows)] + [bb.step(x) for x in steps]
        return np.stack(hs)

    def held_bb(label, got, want):
        err, peak = float(np.abs(got - want).max()), float(np.abs(want).max())
        if got.shape != want.shape or not err <= MESH_BB_REL * peak:
            raise RuntimeError(f"mesh {label}: hiddens max abs err {err} "
                               f"(peak {peak}, bound {MESH_BB_REL} x peak)")
        return f"max abs err {err:.3e} ({err / peak:.2e} of peak {peak:.3f})"

    csm = codec_tpu_torch.load_model(paths["csm"], device=entry)
    reader = GGUFReader(paths["csm"])
    lm = create_lm(reader, device=entry)

    def request(bb):
        bb.reset()
        alm = AudioLM(reader, codec=csm, lm=lm)
        return run_codebook_ar(alm, bb, prompt_rows, max_steps=frames,
                               decode=False)

    # the sharded backbones over the unsharded ones' weights: PP's stages
    # share them (one card), TP's shares are copies of their slices
    ref_q = create_backbone(paths["Q4_K"], quantized=True, device=entry)
    bcfg = ref_q.cfg
    ids = rng.integers(0, bcfg.vocab_size, n_prompt + n_steps)
    rows = ref_q.embed_tokens(ids)
    prompt_rows = list(rows[:n_prompt])
    per_step = 7 * bcfg.n_layers
    for kind in ("pp", "tp"):
        quant = kind == "pp"
        ref = ref_q if quant else create_backbone(paths["Q4_K"], device=entry)
        bb = LlamaBackbone.from_params(ref.cfg, ref.params)
        (bb.set_mesh_pp if kind == "pp" else bb.set_mesh)(mesh(kind))
        want = teacher(ref, rows[:n_prompt], rows[n_prompt:])
        n_k = per_step if quant else 0
        bb.reset()
        h = [launched(f"{kind} prefill", lambda: bb.prefill(rows[:n_prompt]),
                      {"q4_k_matmul": n_k * min(4, n_prompt)})]
        h += [launched(f"{kind} step", lambda x=x: bb.step(x),
                       {"q4_k_matmul": n_k}) for x in rows[n_prompt:]]
        note = held_bb(f"{kind} hiddens", np.stack(h), want)
        x = rows[0]
        bb.reset()
        ref.reset()
        t_sh, t_one = ms(lambda: bb.step(x)), ms(lambda: ref.step(x))
        times[f"{kind}_step"] = (t_sh, t_one)
        res = launched(f"{kind} request", lambda: request(bb),
                       {"q4_k_matmul": n_k * (n_prompt + frames)})
        code_note = _near_tie_csm(f"mesh {kind} request", lm, ref,
                                  prompt_rows, res.codes, request(ref).codes)
        shares = [len(s["layers"]) for s in bb.shards] if kind == "pp" else \
            [tuple(s["layers"][0]["q"].shape) for s in bb.shards]
        log(f"[mesh] {kind} backbone ({'Q4_K packed' if quant else 'dense f32'}"
            f", {bcfg.n_layers} layers; shares {shares}): a {n_prompt}-row "
            f"prefill and {len(rows) - n_prompt} steps vs unsharded: {note}; "
            f"{n_k} q4_k_matmul a step"
            + (f", {bb.reductions} reductions" if kind == "tp" else "")
            + f"; a step {t_sh:.3f} ms sharded, {t_one:.3f} ms unsharded; a "
            f"greedy {frames}-frame host-path request: {code_note} "
            f"[{name_limit}]")
        del bb
        if not quant:
            del ref

    # EP: the MoE's router and attention on each share, 64 experts each
    mcfg = moe_cpu.cfg
    ref_m = LlamaBackbone.from_params(mcfg, _moved(moe_cpu.params, entry))
    ep = LlamaBackbone.from_params(mcfg, ref_m.params)
    ep.set_mesh_ep(mesh("ep"))
    ids = rng.integers(0, mcfg.vocab_size, n_prompt + sizes.get("moe_steps",
                                                                MOE_STEPS))
    mrows = ref_m.embed_tokens(ids)
    want = teacher(ref_m, mrows[:n_prompt], mrows[n_prompt:])
    per_moe = 4 * mcfg.n_layers * MESH_N      # the attention's, replicated
    ep.reset()
    h = [launched("ep prefill", lambda: ep.prefill(mrows[:n_prompt]),
                  {"q4_k_matmul": per_moe})]
    h += [launched("ep step", lambda x=x: ep.step(x), {"q4_k_matmul": per_moe})
          for x in mrows[n_prompt:]]
    note = held_bb("ep hiddens", np.stack(h), want)
    x = mrows[0]
    ep.reset()
    ref_m.reset()
    t_sh, t_one = ms(lambda: ep.step(x)), ms(lambda: ref_m.step(x))
    times["ep_step"] = (t_sh, t_one)
    log(f"[mesh] ep qwen3-moe ({mcfg.n_layers} layer, {mcfg.n_experts} "
        f"experts, {[s['layers'][0]['gate_exps'].shape[0] for s in ep.shards]}"
        f" a share): a {n_prompt}-row prefill (the dense form) and "
        f"{len(mrows) - n_prompt} steps (the gathered form) vs unsharded: "
        f"{note}; {per_moe} q4_k_matmul a call (the attention on each share); "
        f"a step {t_sh:.3f} ms sharded, {t_one:.3f} ms unsharded "
        f"[{name_limit}]")
    del ep, ref_m

    # -- the surfaces: codec-serve-torch and tts-cli-torch with --pp 2 -------
    def synth(srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
            conn.request("POST", "/synthesize", body=json.dumps(
                {"text": "hello there", "seed": 0, "temperature": 0.0,
                 "max_frames": frames}).encode())
            r = conn.getresponse()
            body = r.read()
            conn.close()
            if r.status != 200:
                raise RuntimeError(f"mesh /synthesize: status {r.status}: "
                                   f"{body[:300]!r}")
            return body
        finally:
            srv.shutdown()

    kw = dict(port=0, backbone_path=str(paths["Q4_K"]), quant_exec=True,
              device=entry)
    srv = CodecHTTPServer(str(paths["csm"]), **kw)
    zero_counts()
    want_b = synth(srv)
    want_c = counts()
    srv = CodecHTTPServer(str(paths["csm"]), backbone_mesh=("pp", MESH_N),
                          **kw)
    got_b = launched("serve --pp 2", lambda: synth(srv),
                     want_c if cuda else {})
    if got_b != want_b:
        raise RuntimeError("mesh: codec-serve-torch --pp 2's /synthesize is "
                           "not the unsharded server's bytes")
    del srv
    log(f"[mesh] codec-serve-torch --pp {MESH_N}: serialized /synthesize "
        f"({frames} greedy frames, {len(got_b)} bytes) byte-equal to the "
        f"unsharded server's; launches {want_c}, as unsharded")
    # tts-cli-torch --pp 2 against the same command unsharded
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    try:
        d = Path(tmp.name)
        args = ["synthesize", "--model", str(paths["csm"]), "--backbone",
                str(paths["Q4_K"]), "--text", "hello there", "--quant-exec",
                "--temp", "0", "--max-frames", str(frames), "--device",
                entry]
        zero_counts()
        if tts_cli(args + ["--out", str(d / "one.wav")]) != 0:
            raise RuntimeError("mesh: tts-cli-torch synthesize failed")
        want_c = counts()
        rc = launched("tts-cli --pp 2", lambda: tts_cli(
            args + ["--out", str(d / "pp.wav"), "--pp", str(MESH_N)]),
            want_c if cuda else {})
        if rc != 0 or (d / "pp.wav").read_bytes() != \
                (d / "one.wav").read_bytes():
            raise RuntimeError("mesh: tts-cli-torch synthesize --pp 2's WAV "
                               "is not the unsharded run's")
    finally:
        tmp.cleanup()
    log(f"[mesh] tts-cli-torch synthesize --pp {MESH_N} --device {entry} "
        f"--quant-exec --temp 0 ({frames} frames, host path): the WAV "
        f"byte-equal to the unsharded run's; launches {want_c}, as "
        f"unsharded")
    log(f"[mesh] phase 11 launches {phase_counts}; "
        f"{time.monotonic() - t_phase:.1f} s (every mesh names one card "
        f"twice: the sharded times are no scaling number)")
    return phase_counts, times


def _dense(bb, dev):
    """A dense f32 LlamaBackbone on `dev` over `bb`'s weights, its packed
    Q8_0/Q4_K matrices dequantized (TP takes dense weights)."""
    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.ops import qmat

    def dq(v):
        if isinstance(v, dict) and "qs" in v:
            return qmat.dequant_ref(v).to(dev)
        if isinstance(v, dict):
            return {k: dq(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dq(x) for x in v]
        return v.to(dev) if torch.is_tensor(v) else v
    return LlamaBackbone.from_params(bb.cfg, dq(bb.params))


def graphs_phase(name_limit: str, zero_counts, counts, none: dict,
                 paths: dict, moe_cpu, flows: dict, dev: str = "cuda",
                 sizes=None) -> tuple:
    """Phase 12: the CUDA-graph paths on the mesh (lm/fused_gen.py's chunks
    over a TP or EP backbone's shares and over data-parallel shares of
    streams), every mesh one card named 2 or 4 times (the shares run in
    turn: a sharded time is no scaling number). Each case goes through the
    entry a user calls, its launch counts set to 0 just before and read
    just after (a first run of the same shape beforehand captures the
    graphs), and is held to the same call unsharded:
      - DP: run_codebook_ar_batch over paths["Q4_K"] (phase 9's CSM
        backbone, packed) with GRAPH_STREAMS streams over dp 2, one graph a
        share; greedy codes, q4_k_matmul and flash_sdpa_window (the Mimi
        decodes) launched; q4_k_matmul's launches by row bucket in one
        share's replay (m = 4) under torch.profiler;
      - dp x tp on make_mesh_2d(2, 2): the same file dense, TP-split over
        each dp row;
      - a TP gen chunk (run_codebook_ar(on_device=...) over the dense
        backbone split 2 ways) and an EP gen chunk (phase 9e's Qwen3-MoE,
        `moe_cpu`, 64 experts a share);
      - a TP stream chunk (MOSS-TTS-Realtime through run_text_audio_flow,
        flows["rt"] = (its LM, reader, PromptInfo, ids, backbone), greedy)
        and a TP continuous chunk (BlueMagpie through run_continuous,
        flows["bm"] = (its LM, reader, ids, dense backbone)), each over
        its backbone split 2 ways;
      - DP run_chatterbox_batch (paths["cbx"], paths["cbx_bb"], Q4_K)
        with GRAPH_CBX_STREAMS greedy streams over dp 2;
      - codec-serve-torch --dp 2 --tp 2's /synthesize_batch and --dp 2
        --cont-batch GRAPH_SLOTS's /synthesize (packed), byte-equal to
        their unsharded servers.
    Codes equal the unsharded run's, or (CSM) first differ at a near-tie;
    the latents within 1e-4 of the unsharded peak. `dev` and `sizes` let
    it run small on the CPU (tests/test_torch_parallel_graphs.py), where
    the plain versions count nothing. → (launch counts, times)."""
    import http.client
    import threading

    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import run_text_audio_flow
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone, create_backbone
    from codec_tpu_torch.lm.chatterbox_t3 import ChatterboxT3
    from codec_tpu_torch.lm.tts_runner import (run_chatterbox_batch,
                                               run_codebook_ar,
                                               run_codebook_ar_batch,
                                               run_continuous)
    from codec_tpu_torch.ops.sample import OnDeviceSampling
    from codec_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from codec_tpu_torch.serve.server import CodecHTTPServer

    sizes = sizes or {}
    cuda = dev == "cuda"
    entry = "cuda:0" if cuda else dev
    n_str = sizes.get("streams", GRAPH_STREAMS)
    n_fr = sizes.get("frames", GRAPH_FRAMES)
    n_prompt = sizes.get("prompt", GRAPH_PROMPT)
    k_ch = sizes.get("chunk", GRAPH_CHUNK)
    n_cbx = sizes.get("cbx_streams", GRAPH_CBX_STREAMS)
    n_slots = sizes.get("slots", GRAPH_SLOTS)
    n_bm = sizes.get("bm_patches", GRAPH_BM_PATCHES)
    phase_counts, times = dict(none), {}
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 1200)
    greedy = OnDeviceSampling(chunk_frames=k_ch)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mesh(n, axis="dp"):
        return make_mesh(n, axis=axis, devices=[entry] * n)

    def launched(label, fn, need=()):
        """fn() with the counts set to 0 just before and read just after;
        each kernel in `need` launched at least once (on the CPU the plain
        versions count nothing) → (its result, the counts, its host-clock
        ms, the device's work included)."""
        sync()
        zero_counts()
        t = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        got = counts()
        if cuda and any(got[k] == 0 for k in need):
            raise RuntimeError(f"graphs {label}: launches {got}, want "
                               f"{need} above 0")
        for k, v in got.items():
            phase_counts[k] += v
        return out, {k: v for k, v in got.items() if v}, ms

    def at():
        return f"at {time.monotonic() - t_phase:.1f} s"

    def timed(fn):
        """One call's host-clock ms, the device's work included."""
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t) * 1e3

    def same(label, got, want, tie=None):
        """Codes stream for stream: equal, or (with `tie(s)` → (lm, bb,
        prompt)) first differing at a near-tie of the unsharded host
        path's logits → a note."""
        notes = []
        for s, (g, w) in enumerate(zip(got, want)):
            if (g.n_steps, g.stopped_by_eos) != (w.n_steps, w.stopped_by_eos):
                raise RuntimeError(f"graphs {label} stream {s}: {g.n_steps} "
                                   f"steps (eos {g.stopped_by_eos}), "
                                   f"unsharded {w.n_steps} "
                                   f"({w.stopped_by_eos})")
            if g.codes.shape == w.codes.shape and np.array_equal(g.codes,
                                                                 w.codes):
                continue
            if tie is None:
                raise RuntimeError(f"graphs {label} stream {s}: codes differ "
                                   f"from the unsharded run's")
            notes.append(f"stream {s}: " + _near_tie_csm(
                f"graphs {label} stream {s}", *tie(s), g.codes, w.codes))
        if notes:
            return "; ".join(notes)
        return ("codes equal the unsharded run's" if len(got) == 1 else
                f"codes of all {len(got)} streams equal the unsharded run's")

    # -- DP and dp x tp over phase 9's CSM backbone ---------------------------
    csm = codec_tpu_torch.load_model(paths["csm"], device=entry)
    reader = GGUFReader(paths["csm"])
    lm = create_lm(reader, device=entry)
    packed = create_backbone(paths["Q4_K"], quantized=True, device=entry)
    bcfg = packed.cfg
    prompts = [list(packed.embed_tokens(rng.integers(0, bcfg.vocab_size,
                                                     n_prompt)))
               for _ in range(n_str)]

    def batch(bb, mesh_=None, decode=True):
        bb.reset()
        return run_codebook_ar_batch(
            [AudioLM(reader, codec=csm, lm=lm) for _ in prompts], bb,
            prompts, greedy, max_steps=n_fr, decode=decode,
            prefill_bucket=n_prompt, mesh=mesh_)

    def tie_of(bb):
        return lambda s: (lm, bb, prompts[s])

    dp = mesh(MESH_N)
    want = batch(packed)
    batch(packed, dp, decode=False)                # captures the shares
    got, c, _ = launched("dp batch", lambda: batch(packed, dp),
                         ("q4_k_matmul", "flash_sdpa_window"))
    note = same("dp batch", got, want, tie_of(packed))
    for r in got:
        if r.pcm is None or not np.isfinite(r.pcm).all():
            raise RuntimeError("graphs dp batch: no finite PCM")
    t_sh, t_one = (timed(lambda: batch(packed, dp, decode=False)),
                   timed(lambda: batch(packed, decode=False)))
    times["dp_batch"] = (t_sh, t_one)
    line = (f"[graphs] dp run_codebook_ar_batch ({n_str} streams over dp "
            f"{MESH_N} on {entry}, Q4_K packed, {n_fr} greedy frames in "
            f"chunks of {k_ch}): {note}; launches {c}; a request without "
            f"the decode {t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded "
            f"(one card runs the shares in turn: no scaling number)")
    if cuda:
        # the shares' replays count no launch: a share's replay under the
        # profiler must launch every packed product of its K frames at m = 4
        share = next(v[2] for k, v in packed._batch_chunks.items()
                     if k[2] == id(dp)).runner
        n_mm = 7 * bcfg.n_layers * k_ch
        _, kern, by_m, us = _profile_mb(share.run, "q4_k", 4, n_mm)
        if by_m.get(4, 0) < n_mm:
            raise RuntimeError(f"graphs dp batch: a share's replay launches "
                               f"q4_k_matmul by row bucket {by_m}, want "
                               f"{n_mm} at m = 4")
        times["dp_share_replay"] = dict(kernels=kern, q4_k_by_m=by_m,
                                        us_at_m4=us)
        line += (f"; one share's replay under torch.profiler: {kern} "
                 f"kernels, q4_k_matmul launches by row bucket {by_m} "
                 f"({us:.2f} us a launch at m = 4)")
    log(line + f"; {at()} [{name_limit}]")

    dense = _dense(packed, entry)
    mesh2 = make_mesh_2d(MESH_N, MESH_N, devices=[entry] * MESH_N ** 2)
    tp2 = LlamaBackbone.from_params(dense.cfg, dense.params)
    tp2.set_mesh(mesh2, axis="tp")
    want = batch(dense, decode=False)
    batch(tp2, mesh2, decode=False)
    got, c, t_sh = launched("dp x tp batch", lambda: batch(tp2, mesh2,
                                                           decode=False))
    note = same("dp x tp batch", got, want, tie_of(dense))
    t_one = timed(lambda: batch(dense, decode=False))
    times["dp_tp_batch"] = (t_sh, t_one)
    log(f"[graphs] dp x tp run_codebook_ar_batch (make_mesh_2d({MESH_N}, "
        f"{MESH_N}) on {entry}, dense f32, rows {[len(r) for r in tp2.row_devices]}"
        f" devices): {note}; launches {c} (TP takes dense weights); a "
        f"request {t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded; "
        f"{at()} [{name_limit}]")
    del tp2

    # -- TP and EP single-stream chunks ---------------------------------------
    def one(bb, lm_=lm, rows=None):
        bb.reset()
        return run_codebook_ar(AudioLM(reader, lm=lm_), bb, rows or prompts[0],
                               max_steps=n_fr, decode=False, on_device=greedy,
                               prefill_bucket=n_prompt)

    tp = LlamaBackbone.from_params(dense.cfg, dense.params)
    tp.set_mesh(mesh(MESH_N, "tp"), axis="tp")
    want = one(dense)
    one(tp)
    got, c, t_sh = launched("tp chunk", lambda: one(tp))
    note = same("tp chunk", [got], [want], tie_of(dense))
    t_one = timed(lambda: one(dense))
    times["tp_chunk"] = (t_sh, t_one)
    log(f"[graphs] tp gen chunk (run_codebook_ar on the device, dense "
        f"backbone split {MESH_N} ways, {tp.reductions} reductions counted: "
        f"the captures' runs, not the replays): {note}; a request "
        f"{t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded; {at()} "
        f"[{name_limit}]")
    del tp, dense

    mcfg = moe_cpu.cfg
    ref_m = LlamaBackbone.from_params(mcfg, _moved(moe_cpu.params, entry))
    ep = LlamaBackbone.from_params(mcfg, ref_m.params)
    ep.set_mesh_ep(mesh(MESH_N, "ep"))
    mrows = list(ref_m.embed_tokens(rng.integers(0, mcfg.vocab_size,
                                                 n_prompt)))
    want = one(ref_m, rows=mrows)
    one(ep, rows=mrows)
    got, c, t_sh = launched("ep chunk", lambda: one(ep, rows=mrows),
                            ("q4_k_matmul",))
    note = same("ep chunk", [got], [want],
                lambda s: (lm, ref_m, mrows))
    t_one = timed(lambda: one(ref_m, rows=mrows))
    times["ep_chunk"] = (t_sh, t_one)
    log(f"[graphs] ep gen chunk (Qwen3-MoE, {mcfg.n_experts} experts, "
        f"{mcfg.n_experts // MESH_N} a share, all k chosen slots gathered, "
        f"clamped into each share): {note}; launches {c} (the prefill's "
        f"packed attention; the chunk's replays are not counted); a request "
        f"{t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded; {at()} "
        f"[{name_limit}]")
    del ep, ref_m

    # -- the stream and continuous chunks over TP ------------------------------
    rt_lm, rt_reader, rt_pi, rt_ids, rt_bb = flows["rt"]
    rt_dense = _dense(rt_bb, entry)
    rt_tp = LlamaBackbone.from_params(rt_dense.cfg, rt_dense.params)
    rt_tp.set_mesh(mesh(MESH_N, "tp"), axis="tp")

    def rt(bb):
        bb.reset()
        return run_text_audio_flow(
            AudioLM(rt_reader, lm=rt_lm), bb, rt_pi, rt_ids, max_steps=n_fr,
            on_device=True, chunk_frames=k_ch, temperature=0.0,
            prefill_bucket=sizes.get("bucket", FLOW_BUCKET))

    want = rt(rt_dense)
    rt(rt_tp)
    got, c, t_sh = launched("tp stream chunk", lambda: rt(rt_tp))
    note = same("tp stream chunk", [got], [want])
    t_one = timed(lambda: rt(rt_dense))
    times["tp_stream_chunk"] = (t_sh, t_one)
    log(f"[graphs] tp stream chunk (MOSS-TTS-Realtime through "
        f"run_text_audio_flow --on-device, its Qwen3 backbone dense, split "
        f"{MESH_N} ways, greedy with the repetition penalty's history): "
        f"{note}; a request {t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded; "
        f"{at()} [{name_limit}]")
    del rt_tp, rt_dense

    bm_lm, bm_reader, bm_ids, bm_bb = flows["bm"]
    bm_tp = LlamaBackbone.from_params(bm_bb.cfg, bm_bb.params)
    bm_tp.set_mesh(mesh(MESH_N, "tp"), axis="tp")

    def bm(bb):
        bb.reset()
        return run_continuous(AudioLM(bm_reader, lm=bm_lm), bb,
                              list(bb.embed_tokens(bm_ids)), max_steps=n_bm,
                              min_len=n_bm, decode=False, chunk_steps=k_ch)

    want = bm(bm_bb)
    bm(bm_tp)
    got, c, t_sh = launched("tp continuous chunk", lambda: bm(bm_tp))
    peak = float(np.abs(want.codes).max())
    err = float(np.abs(got.codes - want.codes).max()) \
        if got.codes.shape == want.codes.shape else float("inf")
    if got.n_steps != want.n_steps or not err <= 1e-4 * peak:
        raise RuntimeError(f"graphs tp continuous chunk: {got.n_steps} "
                           f"patches, latents max abs err {err} (peak "
                           f"{peak}), unsharded {want.n_steps}")
    t_one = timed(lambda: bm(bm_bb))
    times["tp_continuous_chunk"] = (t_sh, t_one)
    log(f"[graphs] tp continuous chunk (BlueMagpie through run_continuous "
        f"in chunks of {k_ch}, its MiniCPM backbone split {MESH_N} ways): "
        f"{got.n_steps} patches, latents within {err / peak:.2e} of the "
        f"unsharded run's peak; a request {t_sh:.1f} ms sharded, "
        f"{t_one:.1f} ms unsharded; {at()} [{name_limit}]")
    del bm_tp

    # -- DP batched Chatterbox --------------------------------------------------
    cbx_reader = GGUFReader(paths["cbx"])
    t3 = ChatterboxT3(cbx_reader, device=entry)
    cbx_lm = create_lm(cbx_reader, device=entry)
    cbx_bb = create_backbone(paths["cbx_bb"], quantized=True, device=entry)
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(n_cbx)]
    cbx_greedy = OnDeviceSampling(chunk_frames=k_ch, repetition_penalty=1.2)

    def cbx(mesh_=None):
        return run_chatterbox_batch(
            [AudioLM(cbx_reader, lm=cbx_lm) for _ in texts], t3, cbx_bb,
            texts, cbx_greedy, max_frames=n_fr, decode=False, mesh=mesh_,
            prefill_bucket=sizes.get("cbx_bucket", CBX_BUCKET))

    want = cbx()
    # the shares' first call captures their graphs: its counts are the
    # products the captures ran (a bucketed prefill of more than 32 rows
    # dequantizes, and a replay counts none)
    got, c, _ = launched("dp chatterbox", lambda: cbx(dp), ("q4_k_matmul",))
    note = same("dp chatterbox", got, want)
    t_sh, t_one = timed(lambda: cbx(dp)), timed(cbx)
    times["dp_chatterbox"] = (t_sh, t_one)
    log(f"[graphs] dp run_chatterbox_batch ({n_cbx} greedy streams with "
        f"CFG over dp {MESH_N}: T3's products at m = {2 * n_cbx // MESH_N} a "
        f"share, {2 * n_cbx} unsharded): {note}; launches {c} (the shares' "
        f"captures); a request "
        f"{t_sh:.1f} ms sharded, {t_one:.1f} ms unsharded; {at()} "
        f"[{name_limit}]")
    del t3, cbx_lm, cbx_bb

    # -- the server's --dp --------------------------------------------------------
    def post(srv, path, body):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)
        conn.request("POST", path, body=json.dumps(body).encode())
        r = conn.getresponse()
        data = r.read()
        conn.close()
        if r.status != 200:
            raise RuntimeError(f"graphs {path}: status {r.status}: "
                               f"{data[:300]!r}")
        return data

    def served(label, srv, path, bodies, need=(), warm=True):
        """Each body posted in turn (with `warm` the first once more
        beforehand, its graphs captured) → (responses, launches, ms a
        response)."""
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            if warm:
                post(srv, path, bodies[0])
            out, c, ms = launched(label, lambda: [post(srv, path, b)
                                                  for b in bodies], need)
            return out, c, ms / len(bodies)
        finally:
            srv.shutdown()

    kw = dict(port=0, backbone_path=str(paths["Q4_K"]), device=entry)
    bodies = [{"texts": list(SERVE_TEXTS), "seed": 0, "max_frames": n_fr,
               "chunk_frames": k_ch}]
    want, _, t_one = served("serve", CodecHTTPServer(str(paths["csm"]), **kw),
                            "/synthesize_batch", bodies)
    srv = CodecHTTPServer(str(paths["csm"]), backbone_mesh=("tp", MESH_N),
                          dp=MESH_N, **kw)
    shape = dict(srv.batch_mesh.shape)
    got, c, t_sh = served("serve --dp --tp", srv, "/synthesize_batch",
                          bodies, ("flash_sdpa_window",))
    if got != want:
        raise RuntimeError("graphs: codec-serve-torch --dp 2 --tp 2's "
                           "/synthesize_batch is not the unsharded server's")
    times["serve_dp_tp_batch"] = (t_sh, t_one)
    log(f"[graphs] codec-serve-torch --dp {MESH_N} --tp {MESH_N} (mesh "
        f"{shape}, dense backbone): /synthesize_batch of {len(SERVE_TEXTS)} "
        f"texts x {n_fr} frames byte-equal to the unsharded server's "
        f"({len(got[0])} bytes); launches {c}; {t_sh:.1f} ms sharded, "
        f"{t_one:.1f} ms unsharded; {at()} [{name_limit}]")
    del srv

    kw = dict(kw, quant_exec=True, cont_batch=n_slots, chunk_frames=k_ch)
    bodies = [{"text": t, "seed": 3, "max_frames": n_fr,
               **({"temperature": 0.0} if i % 2 else {})}
              for i, t in enumerate(SERVE_TEXTS[:2])]
    # the engine captures its graphs when it is built: no warm-up request
    want, _, t_one = served("serve engine",
                            CodecHTTPServer(str(paths["csm"]), **kw),
                            "/synthesize", bodies, warm=False)
    srv = CodecHTTPServer(str(paths["csm"]), dp=MESH_N, **kw)
    per = [r.h.shape[0] for r in srv._cont_batcher.chunks.runners]
    got, c, t_sh = served("serve --dp --cont-batch", srv, "/synthesize",
                          bodies, ("q4_k_matmul", "flash_sdpa_window"),
                          warm=False)
    if got != want:
        raise RuntimeError("graphs: codec-serve-torch --dp 2 --cont-batch's "
                           "/synthesize is not the unsharded engine's")
    times["serve_dp_engine"] = (t_sh, t_one)
    eng_mb = ""
    if cuda:
        # the engine stopped with the server: one share's replay under the
        # profiler, every packed product of its K frames at m = slots a share
        mb_e, n_mm = per[0], 7 * bcfg.n_layers * k_ch
        _, _, by_m, _ = _profile_mb(srv._cont_batcher.runner.run, "q4_k",
                                    mb_e, n_mm)
        if by_m.get(mb_e, 0) < n_mm:
            raise RuntimeError(f"graphs --dp engine: a share's replay "
                               f"launches q4_k_matmul by row bucket {by_m}, "
                               f"want {n_mm} at m = {mb_e}")
        times["serve_dp_engine_share"] = by_m
        eng_mb = (f"; one share's replay under torch.profiler: q4_k_matmul "
                  f"by row bucket {by_m}")
    log(f"[graphs] codec-serve-torch --dp {MESH_N} --cont-batch {n_slots} "
        f"--quant-exec (slots a share {per}): /synthesize of "
        f"{len(bodies)} requests (the family's chain, then greedy) "
        f"byte-equal to the unsharded engine's; launches {c} (the engine's "
        f"replays are not counted){eng_mb}; {t_sh:.1f} ms sharded, "
        f"{t_one:.1f} ms unsharded a request; {at()} [{name_limit}]")
    del srv, csm, lm, packed
    if cuda:
        torch.cuda.empty_cache()
    log(f"[graphs] phase 12 launches {phase_counts}; "
        f"{time.monotonic() - t_phase:.1f} s (every mesh names one card "
        f"2 or 4 times: the sharded times are no scaling number)")
    return phase_counts, times


def chain_history(codes, window: int) -> list:
    """What a host SamplerChain with this repetition window holds for the
    penalty after it picked `codes` (its history's last `window`)."""
    from codec_tpu_torch.lm.tts_runner import SamplerChain

    chain = SamplerChain(temperature=0.0, repetition_window=window)
    for c in codes:
        lg = np.zeros(int(c) + 1)
        lg[int(c)] = 1.0
        chain(lg)
    return chain.history[-window:]


def sampled_tie(lm, bb, reader, ids, pi, got, want, bucket) -> str:
    """Sampled realtime codes `got` (the CPU's) against `want` (the card's,
    the chain of RT_SAMPLED): equal, or the first difference (frame f,
    codebook k) a near-tie of the card's sampling objective there: the
    host path teacher-forced on want's codes (run_realtime_streaming with
    samplers that replay them, keeping the logits of (f, k)), the
    repetition penalty over the ring of want's codes of codebook k before
    f (empty slots marking the last id, as the chunk's ring does), then
    temperature, top_k and top_p, plus the noise the request drew for
    (f, k) → a note."""
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.tts_runner import run_realtime_streaming
    from codec_tpu_torch.ops import sample as smp

    diff = np.argwhere(got != want[: len(got)])
    if not len(diff):
        return "codes equal"
    f, k = (int(v) for v in diff[0])
    kept = {}

    class Replay:
        def __init__(self, cb):
            self.cb, self.n = cb, 0

        def __call__(self, lg):
            if (self.n, self.cb) == (f, k):
                kept["lg"] = np.asarray(lg, np.float32)
            self.n += 1
            return int(want[self.n - 1, self.cb])

    n_cb = lm.info.n_codebook
    bb.reset()
    split = max(1, len(ids) - pi.prefill_text_len)
    run_realtime_streaming(
        AudioLM(reader, codec=None, lm=lm), bb,
        lambda t: bb.embed_tokens([t])[0], ids[:split], ids[split:], pi,
        max_frames=f + 1, samplers=[Replay(cb) for cb in range(n_cb)],
        decode=False, prefill_bucket=bucket)
    w = RT_SAMPLED["repetition_window"]
    ring = [-1] * w
    for i in range(f):
        ring[i % w] = int(want[i, k])
    lg = torch.from_numpy(kept["lg"])
    seen = smp.seen_mask_from_ring(torch.tensor(ring),
                                   max(lm.info.codebook_sizes))
    lg = smp.apply_repetition_penalty(lg, seen[: lg.shape[0]],
                                      RT_SAMPLED["repetition_penalty"])
    lg = smp._apply_top_p(smp._apply_top_k(lg / RT_SAMPLED["temperature"],
                                           RT_SAMPLED["top_k"]),
                          RT_SAMPLED["top_p"])
    gen = torch.Generator().manual_seed(RT_SAMPLED["seed"])
    for _ in range(f + 1):
        noise = smp.gumbel((n_cb, lm.noise_width()), gen, "cpu")
    obj = (lg + noise[k, : lg.shape[0]]).double().numpy()
    top = np.sort(obj[np.isfinite(obj)])[-2:]
    margin = float((top[1] - top[0]) / abs(top[1]))
    if not margin < NEAR_TIE:
        raise RuntimeError(f"moss-realtime sampled: card and CPU codes first "
                           f"differ at frame {f} codebook {k}, relative "
                           f"top-2 margin {margin}")
    return (f"codes first differ at frame {f} codebook {k}: a near-tie "
            f"(relative top-2 margin {margin:.2e})")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


class Recorder:
    """The Backbone protocol around a LlamaBackbone that records each call:
    (kind, input rows, returned hidden, host seconds). Every call ends in
    a copy of the hidden to the host, so its time covers the device work.
    It shows the backbone's `params` and `embed_tokens` (the flows read the
    text table) but not its cache: no chunk runs on it."""

    def __init__(self, bb):
        self.bb, self.calls = bb, []
        self.params = bb.params

    def embed_tokens(self, ids):
        return self.bb.embed_tokens(ids)

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
    from codec_tpu_torch.models.mimi import mimi_decode_fn
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
    from codec_tpu_torch.ops import qmat
    from codec_tpu_torch.ops import qmat_cuda
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
    # phases 4-5's files, written while phase 3 runs on the card
    write_ahead("model", "chip_smoke_", model_files)
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
    # the MOSS-TTSD backbone's (Qwen3-1.7B's) layer shapes at m = 1 and 8,
    # the Chatterbox T3 backbone's (Llama-520M's) at m = 1 and 2 and the
    # Qwen3-MoE attention's q and o at m = 1 and 8, each with the launch
    # plan it takes
    for out_d, in_d, ms, tag in (
            [(o, i, QWEN3_QMAT_MS, "Qwen3") for o, i in QWEN3_QMAT_SHAPES]
            + [(o, i, T3_QMAT_MS, "T3") for o, i in T3_QMAT_SHAPES]
            + [(o, i, MOE_QMAT_MS, "MoE") for o, i in MOE_QMAT_SHAPES]):
        w = qrng.standard_normal((out_d, in_d), dtype=np.float32) * 0.02
        for name, quantize, pack in (
                ("q8_0_matmul", quantize_q8_0, qmat.pack_q8_0),
                ("q4_k_matmul", quantize_q4_k, qmat.pack_q4_k)):
            if (name, out_d, in_d) not in qmat_weights:     # q/o: above
                qmat_weights[name, out_d, in_d] = qmat.to_device(pack(
                    np.frombuffer(quantize(w), np.uint8), w.shape), "cuda")
            qt = qmat_weights[name, out_d, in_d]
            dense = qmat.dequant_ref(qt)
            for m in ms:
                x = randn((m, in_d), torch.float32, SEED + 170 + m)
                got = settled(f"{name} {out_d}x{in_d} m{m}",
                              packed_product(name, x, qt))
                want = x @ dense.T
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                if not err <= 1e-4 * peak:
                    raise RuntimeError(f"{name} {out_d}x{in_d} m{m}: max abs "
                                       f"err {err} (peak {peak})")
                max_err[name] = max(max_err[name], err)
                log(f"[kernel] {name} {tag} out {out_d} in {in_d} m{m} f32: "
                    f"max abs err {err:.3e} (peak {peak:.3f}; bound 1e-4 "
                    f"peak) ok; plan {qmat_cuda.plan(name[:4], m, in_d, out_d)}")
            del dense

    # -- 4, 5. full-width models through load_model ---------------------------
    tmp, _, waited = ahead("model", "chip_smoke_", model_files)
    # phase 8b's files, written while phases 4-8 run on the card
    write_ahead("istft", "chip_smoke_istft_", istft_files)
    try:
        paths = {name: Path(tmp.name) / f"{name}_random.gguf"
                 for name in ("mimi", "dac", "snac")}
        wrote("model", paths.values(), waited)
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
    write_ahead("windowed", "chip_smoke_windowed_", windowed_files)
    istft_counts = istft_codecs(name_limit, zero_counts, counts, none)

    # -- 8c. the windowed-transformer codecs -------------------------------------
    log(f"[phase] 8c starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("neu", "chip_smoke_neu_", neu_files)
    windowed_counts = windowed_codecs(name_limit, zero_counts, counts, none)

    # -- 8d. the NeuCodec family ------------------------------------------------
    log(f"[phase] 8d starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("small", "chip_smoke_small_", small_files)
    neu_codecs(name_limit, zero_counts, counts, none)

    # -- 8e. the last small codecs ----------------------------------------------
    log(f"[phase] 8e starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("s3g", "chip_smoke_s3g_", s3g_files)
    small_counts = small_codecs(name_limit, zero_counts, counts, none)

    # -- 8f. Chatterbox S3Gen ---------------------------------------------------
    log(f"[phase] 8f starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("tts", "chip_smoke_tts_", tts_files)
    s3g_codec(name_limit, zero_counts, counts, none)

    # -- 9. the CSM TTS path ---------------------------------------------------
    log(f"[phase] 9 starts at {time.monotonic() - t_start:.1f} s")
    tmp, (csm_path, bb_paths), waited = ahead("tts", "chip_smoke_tts_",
                                              tts_files)
    # phase 9c's files, written while phases 9 and 9b run on the card
    write_ahead("lm", "chip_smoke_lm_", lm_files)
    try:
        wrote("tts", [csm_path, *bb_paths.values()], waited)
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
    except BaseException:
        tmp.cleanup()
        raise
    tts_tmp = tmp                   # its files serve phase 9f
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
    # sampling, EOS gate, feedback compose, backbone step: 28 packed
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
        now and then from a trace of many kernels (885 of 896 products
        once): with `want`, up to four replays are traced and the first
        that shows `want` products (else the fullest) is returned."""
        from torch.profiler import ProfilerActivity, profile

        best = None
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    brunner = next(reversed(
        backbones["Q4_K"]._batch_chunks.values()))[2].runner
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
    # weights dequantized to f32, the rest of the step the same (CUDA
    # events; the steps' traces and their products' device times are in
    # PERF.md from earlier runs)
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
            line += f" {label} {cuda_ms(g.run):.4f} ms a step;"
            del g
        log(line + f" [{name_limit}]")
    del dense

    log(f"[tts-dev] main path launches (wrappers; the replays' kernels are "
        f"counted above): {tts_dev_counts}; phase {time.monotonic() - t0:.1f} s")

    # -- 9c. the LM flows past CSM's: Pocket-TTS, MOSS-TTSD, BlueMagpie ---------
    log(f"[phase] 9c starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("cbx", "chip_smoke_cbx_", cbx_files)
    reuse = {}
    lm_counts, _ = lm_flows(name_limit, zero_counts, counts, none,
                            reuse=reuse)

    # -- 9d. Chatterbox TTS: T3 on Llama-520M into S3Gen; the speaker encoders
    log(f"[phase] 9d starts at {time.monotonic() - t_start:.1f} s")
    write_ahead("rest", "chip_smoke_rest_", rest_files)
    cbx_counts, _ = chatterbox_flow(name_limit, zero_counts, counts, none,
                                    reuse=reuse)

    # -- 9e. LFM2-Audio, MOSS-TTS-Realtime, the Qwen3-MoE backbone ---------------
    log(f"[phase] 9e starts at {time.monotonic() - t_start:.1f} s")
    rest_counts, _ = rest_lm_flows(name_limit, zero_counts, counts, none,
                                   reuse)

    # -- 9f. serving: the HTTP server, the engine, batched Chatterbox ----------
    log(f"[phase] 9f starts at {time.monotonic() - t_start:.1f} s")
    _, cbx_path, cbx_bb_path = reuse["cbx"]
    serve_counts, _ = serving(
        name_limit, zero_counts, counts, none,
        {"csm": csm_path, **bb_paths, "cbx": cbx_path,
         "cbx_bb": cbx_bb_path, "pocket": reuse["pocket"][1]})
    moe_cpu = reuse.pop("moe")
    # phase 12's: the Chatterbox files, the realtime and BlueMagpie pieces
    graph_keep = {k: reuse.pop(k) for k in ("cbx", "rt", "bm")}
    del reuse                        # and with it 9c's directory

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

    log(f"[phase] 10: windowed attention at {time.monotonic() - t_start:.1f} s")
    # the windowed codecs' attention (phase 8c's shapes): kernel and plain in
    # turns, F.scaled_dot_product_attention with the same mask, and the
    # bound of the kernel's passes (f32: three TF32 passes a product;
    # 16-bit: one for QK^T, two for PV) beside the bytes' alone (their
    # device times are in PERF.md from earlier runs: the profiler's traces
    # cost the smoke more than these kernels)
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
            work = attn_work(b, h, t, d, w, dtype)
            flop = work[0][0][0]
            passes = ([(3 * flop, "tf32")] if dtype == torch.float32
                      else [(3 * flop // 2, dtype)])
            b_ms, b_by = least_time(passes, work[1])
            log(f"[time] flash_sdpa_window B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, plain {plain:.4f} ms "
                f"(samples k {smp[0]:.4f} {smp[1]:.4f}, p {smp[2]:.4f} "
                f"{smp[3]:.4f}), F.scaled_dot_product_attention with the same "
                f"mask {lib:.4f} ms; bound {b_ms:.5f} ms ({b_by}; the "
                f"kernel's passes), bytes alone "
                f"{least_time([], work[1])[0]:.5f} ms"
                + (f", f32 FMA {least_time(*work)[0]:.5f} ms"
                   if dtype == torch.float32 else "") + f" [{name_limit}]")

    log(f"[phase] 10: MOSS attention at {time.monotonic() - t_start:.1f} s")
    # MOSS's attention (phase 8e's shapes) the same way; SDPA with the band
    # mask only where its mask fits (T <= 15 000: its memory-efficient
    # kernel takes the mask as an additive tensor of the inputs' dtype,
    # [T, T]; at T 120 000 that is 57.6 GB in f32, and the math path's
    # logits 172.8 GB)
    # (the 200 s stage, T 1 200 000, is checked in phase 3, not timed here)
    for b, h, t, d, w in MOSS_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn((b, h, t, d), dtype, SEED + 900 + j)
                       for j in range(3))
            kern, plain, smp = turns(
                lambda: flash_sdpa_window(q, k, v, window=w),
                lambda: flash_sdpa_window_ref(q, k, v, window=w),
                reps=20 if t <= 2500 else 1)
            if t <= 15000:
                i = torch.arange(t, device="cuda")
                band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
                lib = (f"{cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band), reps=20 if t <= 2500 else 1):.4f} ms")
                del band
            else:
                lib = (f"not run: its [T, T] mask is {t * t * dtype.itemsize / 1e9:.1f}"
                       f" GB as an additive {str(dtype)[6:]} tensor, the "
                       f"math path's f32 logits {b * h * t * t * 4 / 1e9:.1f} GB")
            work = attn_work(b, h, t, d, w, dtype)
            flop = work[0][0][0]
            passes = ([(3 * flop, "tf32")] if dtype == torch.float32
                      else [(3 * flop // 2, dtype)])
            b_ms, b_by = least_time(passes, work[1])
            log(f"[time] flash_sdpa_window MOSS B{b} H{h} T{t} D{d} w{w} "
                f"{str(dtype)[6:]}: kernel {kern:.4f} ms, banded plain "
                f"{plain:.4f} ms (samples k {smp[0]:.4f} {smp[1]:.4f}, p "
                f"{smp[2]:.4f} {smp[3]:.4f}), F.scaled_dot_product_attention "
                f"with the same mask {lib}; bound {b_ms:.5f} ms ({b_by}; the "
                f"kernel's "
                f"passes; {b_ms / kern:.1%} of it), bytes alone "
                f"{least_time([], work[1])[0]:.5f} ms [{name_limit}]")
            del q, k, v
    torch.cuda.empty_cache()

    log(f"[phase] 10: DAC units at {time.monotonic() - t_start:.1f} s")
    # the DAC residual units at every decoder and encoder width, d = 1, 3
    # and 9, in f32 and bf16, and the chain against three unit launches
    # (tools/seanet_times.py); the kernels line takes the f32 unit at block
    # 1 (C768, d = 1) and the f32 chain at block 4 (C96)
    # d = 1 only: the dilation moves a unit's time by under 2% at every
    # width, and the kernels line takes d = 1
    unit_rows = seanet_times.unit_rows(
        runs=TIMED_RUNS, log=lambda m: log(f"{m} [{name_limit}]"),
        dilations=(1,))
    chain_rows = seanet_times.chain_rows(
        runs=TIMED_RUNS, log=lambda m: log(f"{m} [{name_limit}]"))
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

    log(f"[phase] 10: SNAC blocks at {time.monotonic() - t_start:.1f} s")
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

    log(f"[phase] 10: packed products m1 at {time.monotonic() - t_start:.1f} s")
    # the packed products at m = 1 (one decode step) on the gate shape (the
    # kernels line's): device time per call from torch.profiler, and the
    # CUDA-event time of back-to-back calls, which includes the host's
    # launch work (the m = 4 and 8 rows below)
    out_d, in_d = QMAT_MAIN
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
        times[name] = (dev[0] or k_ev, dev[1] or p_ev, b_ms, b_by,
                       dev[2] or l_ev)
        del dense

    log(f"[phase] 10: packed products sweep at {time.monotonic() - t_start:.1f} s")
    # the packed products at the CSM backbone's shapes, m = 4 and 8 (the
    # serving engine's and /synthesize_batch's rows, and phase 12's
    # data-parallel shares'), and at the Chatterbox T3 backbone's, m = 4
    # (phase 12's share: 2 streams x 2 lanes) and 8 (batched Chatterbox's
    # 4 streams x 2 lanes):
    # CUDA events of back-to-back calls of the kernel and of F.linear on
    # the dequantized f32 weight, each beside the bound (their device times
    # are in PERF.md from earlier runs: the profiler's traces cost the smoke
    # more than these rows' kernels; Qwen3's, the MoE's and T3's m = 1 and 2
    # rows are checked in phase 3, not timed here)
    for out_d, in_d, ms, tag in (
            [(o, i, QMAT_SERVE_MS, "CSM") for o, i in QMAT_SHAPES]
            + [(o, i, (4, 8), "T3") for o, i in T3_QMAT_SHAPES]):
        for name in ("q8_0_matmul", "q4_k_matmul"):
            qt = qmat_weights[name, out_d, in_d]
            dense = qmat.dequant_ref(qt)
            for m in ms:
                x = randn((m, in_d), torch.float32, SEED + 180 + m)
                kern = lambda: packed_product(name, x, qt)
                lib = lambda: F.linear(x, dense)
                # the wrapper's host time included
                k_ev, l_ev = cuda_ms(kern, reps=20), cuda_ms(lib, reps=20)
                b_ms, b_by = least_time(*qmat_work(out_d, in_d, m, qt))
                log(f"[time] {name} {tag} out {out_d} in {in_d} m{m} f32: "
                    f"CUDA events a call kernel {k_ev:.4f} ms, F.linear on "
                    f"the dequantized f32 weight {l_ev:.4f} ms; bound "
                    f"{b_ms:.4f} ms ({b_by}) [{name_limit}]")
            del dense

    log(f"[phase] 10: packed products cold at {time.monotonic() - t_start:.1f} s")
    # the packed products cold, as a forward finds them: the gate shape's
    # line cycles over the TTS_LAYERS layers' gate and up matrices in the loaded
    # backbone (a 64 MB buffer written between launches where the cycle
    # would stay in L2) at m = 1 (the kernels line's cold_ms). Device times
    # by the kernel's name under torch.profiler, F.linear on the same
    # dequantized f32 weights measured the same way (the other shapes, m =
    # 16 and one forward's 28 products in forward order are in PERF.md from
    # earlier runs: their traces cost the smoke up to a minute)
    cold = {}
    flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for qtype, bb in backbones.items():
        name = kernel_of[qtype]
        out_d, in_d = QMAT_MAIN
        pairs = [(lw[k], qmat.dequant_ref(lw[k])) for lw in bb.params["layers"]
                 for k in FORWARD_ORDER if tuple(lw[k]["qs"].shape)[0] == out_d
                 and qmat.in_features(lw[k]) == in_d]
        wbytes = sum(t.numel() * t.element_size() for qt, _ in pairs
                     for t in qt.values())
        flush = wbytes < 2 * L2_BYTES
        x = randn((1, in_d), torch.float32, SEED + 161)

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
        b_ms, b_by = least_time(*qmat_work(out_d, in_d, 1, pairs[0][0]))
        cold[name] = k_ms
        log(f"[time] {name} cold {SHAPE_NAMES[out_d, in_d]} out {out_d} "
            f"in {in_d} m1 f32 ({len(pairs)} matrices, "
            f"{wbytes / 1e6:.1f} MB{', 64 MB written between launches' if flush else ''}): "
            f"device time kernel {fmt_ms(k_ms)}, F.linear on the "
            f"dequantized f32 weight {fmt_ms(l_ms)}; bound {b_ms:.4f} ms "
            f"({b_by})" + (f", {b_ms / k_ms:.1%} of it" if k_ms else "")
            + f" [{name_limit}]")
        del pairs
    del flush_buf

    log(f"[phase] 10: TTS requests at {time.monotonic() - t_start:.1f} s")
    for name, qtype, bucket in TTS_REQUESTS[:1]:    # (phase 9 ran all three)
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

    log(f"[phase] 10: decodes at {time.monotonic() - t_start:.1f} s")
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

    log(f"[phase] 10: RVQ search at {time.monotonic() - t_start:.1f} s")
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

    log(f"[phase] 10: encodes at {time.monotonic() - t_start:.1f} s")
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

    log(f"[phase] 10: streams at {time.monotonic() - t_start:.1f} s")
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

    log(f"[phase] 10: carried-key attention at {time.monotonic() - t_start:.1f} s")
    # flash_sdpa_window with carried keys at the sessions' shapes: kernel and
    # plain in turns, F.scaled_dot_product_attention with the same mask, the
    # bound of the pairs this mask leaves visible; device time at the
    # kernels line's shape only (the other shapes' traces cost the smoke up
    # to 20 s; their device times are in PERF.md from earlier runs)
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
            main = ((b, h, tq, tk, d, w, ks) == STREAM_ATTN_MAIN
                    and dtype == torch.float32)
            dev = device_ms(lambda: flash_sdpa_window(
                q, k, v, window=w, k_start=ks)) if main else None
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
                f"{lib:.4f} ms"
                + (f", device time (torch.profiler) {fmt_ms(dev)}" if main
                   else "")
                + f"; bound {b_ms:.5f} ms ({b_by}; the kernel's passes) "
                f"[{name_limit}]")
            if main:
                times["flash_sdpa_window (carried keys)"] = (
                    kern, plain, b_ms, b_by, lib)
                extra["flash_sdpa_window (carried keys)"] = {
                    "device_ms": dev,
                    "bound_fma_ms": least_time(*work)[0]}

    # -- 11. the mesh on one card ----------------------------------------------
    log(f"[phase] 11 starts at {time.monotonic() - t_start:.1f} s")
    try:
        mesh_counts, _ = mesh_phase(
            name_limit, zero_counts, counts, none,
            {"mimi": mimi_models["float32"], "dac": dac_models["float32"]},
            {"csm": csm_path, **bb_paths}, moe_cpu)
        # -- 12. the CUDA-graph paths on the mesh ------------------------------
        log(f"[phase] 12 starts at {time.monotonic() - t_start:.1f} s")
        _, cbx_path, cbx_bb_path = graph_keep["cbx"]
        graph_counts, _ = graphs_phase(
            name_limit, zero_counts, counts, none,
            {"csm": csm_path, **bb_paths, "cbx": cbx_path,
             "cbx_bb": cbx_bb_path}, moe_cpu,
            {"rt": graph_keep["rt"], "bm": graph_keep["bm"]})
    finally:
        tts_tmp.cleanup()
        graph_keep.clear()
    del moe_cpu

    main_counts = {"flash_sdpa_window": mimi_counts["flash_sdpa_window"]
                   + tts_counts["flash_sdpa_window"]
                   + lm_counts["flash_sdpa_window"]
                   + tts_dev_counts["flash_sdpa_window"]
                   + rest_counts["flash_sdpa_window"]
                   + enc_counts["flash_sdpa_window"]
                   + windowed_counts["flash_sdpa_window"]
                   + small_counts["flash_sdpa_window"]
                   + serve_counts["flash_sdpa_window"]
                   + mesh_counts["flash_sdpa_window"]
                   + graph_counts["flash_sdpa_window"],
                   "seanet_res_unit": dac_counts["seanet_res_unit"]
                   + enc_counts["seanet_res_unit"]
                   + mesh_counts["seanet_res_unit"],
                   "seanet_res_chain": dac_counts["seanet_res_chain"]
                   + enc_counts["seanet_res_chain"],
                   "snac_res_chain": snac_counts["snac_res_chain"]
                   + enc_counts["snac_res_chain"],
                   "q8_0_matmul": tts_counts["q8_0_matmul"]
                   + tts_dev_counts["q8_0_matmul"]
                   + lm_counts["q8_0_matmul"] + cbx_counts["q8_0_matmul"]
                   + rest_counts["q8_0_matmul"]
                   + serve_counts["q8_0_matmul"]
                   + graph_counts["q8_0_matmul"],
                   "q4_k_matmul": tts_counts["q4_k_matmul"]
                   + tts_dev_counts["q4_k_matmul"]
                   + lm_counts["q4_k_matmul"] + cbx_counts["q4_k_matmul"]
                   + rest_counts["q4_k_matmul"]
                   + serve_counts["q4_k_matmul"]
                   + mesh_counts["q4_k_matmul"]
                   + graph_counts["q4_k_matmul"],
                   "rvq_encode_fused": enc_counts["rvq_encode_fused"]
                   + istft_counts["rvq_encode_fused"]
                   + windowed_counts["rvq_encode_fused"]
                   + serve_counts["rvq_encode_fused"]
                   + mesh_counts["rvq_encode_fused"],
                   "flash_sdpa_window (carried keys)": stream_launches
                   + windowed_counts["flash_sdpa_window (carried keys)"]
                   + lm_counts["flash_sdpa_window (carried keys)"]
                   + serve_counts["flash_sdpa_window (carried keys)"]}
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
