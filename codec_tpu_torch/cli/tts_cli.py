"""tts-cli-torch: info / decode / synthesize over a codec(+LM) GGUF with the
port (counterpart of codec_tpu/cli/tts_cli.py).

`synthesize` runs, by the GGUF's codec.lm.kind:
  - flow_lm (Pocket-TTS), self-contained: no backbone; the AR transformer,
    text LUT, LSD flow head and EOS head live in the codec GGUF
    (`run_flow_synthesize`; `--stream` vocodes every frame through the
    streaming decoder, `--ref-audio` conditions on a voice prompt);
  - with `--backbone` (a llama-family backbone GGUF, dense or Qwen3-MoE,
    with a baked SPM or byte-level BPE tokenizer): the codebook-AR flow of
    residual_depth_ar (CSM-style) and parallel_heads_delay (MOSS-TTSD)
    models on the host sampling path (`--grammar` constrains cb0 with a
    GBNF grammar), or with `--on-device` on the device (the whole frame
    with in-graph sampling, `--chunk-frames` K frames per device call, on
    CUDA one CUDA graph replay per chunk); LFM2-Audio's sequential
    text→audio flow and MOSS-TTS-Realtime's streaming interleave (host
    path, or with `--on-device` K-frame chunks); the continuous-latent flow of
    continuous_latent_cfm (BlueMagpie) models, one step a call or with
    `--on-device` K steps a graph replay; and the Chatterbox flow (an
    S3Gen GGUF with a T3 section: `run_chatterbox_synthesize`, two CFG
    lanes at `--cfg-weight` on the host or as one batch on the device,
    vocoded by S3Gen with its built-in conditioning).
`--quant-exec` keeps a Q8_0 or Q4_K backbone's layer matrices packed on
the device, multiplied by the dequantizing CUDA kernels. `--tp/--pp/--ep
N` shard the backbone over N devices (lm/backbone.py::set_mesh,
set_mesh_pp, set_mesh_ep; the first N cards, or with `--device cpu` or
`cuda:K` N entries of that device): the host path, or with `--on-device`
the chunks over a --tp/--ep backbone's shares; a --pp one generates
through the host per-frame loop, and the Chatterbox flow refuses all
three, as codec_tpu's does.

Usage:
  tts-cli-torch info --model pocket.gguf
  tts-cli-torch decode --model csm.gguf --codes c.npy --out o.wav \
      [--device cuda]
  tts-cli-torch synthesize --model pocket.gguf \
      --text "Hello there." --out o.wav [--stream] [--ref-audio voice.wav]
      [--max-frames N] [--min-len N] [--temp T] [--seed 0]
  tts-cli-torch synthesize --model csm.gguf \
      --backbone bb.gguf --text "Hello there." --out o.wav \
      [--quant-exec] [--max-frames N] [--seed 0] [--device cuda|cpu]
      [--on-device [--chunk-frames 8]] [--min-len N --timesteps N]
      [--grammar g.gbnf] [--cfg-weight 0.5] [--tp N | --pp N | --ep N]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tts-cli-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info")
    p.add_argument("--model", required=True)

    p = sub.add_parser("decode")
    p.add_argument("--model", required=True)
    p.add_argument("--codes", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--nq", type=int, default=0)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("synthesize")
    p.add_argument("--model", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backbone", default=None,
                   help="backbone GGUF (llama_backbone) for codebook-AR kinds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--quant-exec", action="store_true",
                   help="keep Q8_0/Q4_K backbone matrices packed on the "
                        "device and multiply them with the dequantizing "
                        "kernels (0.75-1.125 bytes per weight)")
    p.add_argument("--prefill-bucket", type=int, default=0,
                   help="prefill the whole prompt in one forward padded to "
                        "a multiple of N tokens (0 = one step per token)")
    p.add_argument("--temp", type=float, default=None,
                   help="sampling temperature (default: the model family's "
                        "preset; 0 = greedy)")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--rep-penalty", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the codec, the adaptor and the "
                        "backbone (cuda or cpu)")
    p.add_argument("--on-device", action="store_true", dest="on_device",
                   help="sample on the device (fused frame; the "
                        "temperature/top-k chain then applies to every "
                        "codebook, not just cb0) and chain --chunk-frames "
                        "whole frames per device call")
    p.add_argument("--chunk-frames", type=int, default=8,
                   help="frames per device call (one CUDA graph replay) "
                        "with --on-device")
    p.add_argument("--grammar", default="",
                   help="GBNF constraint on the cb0 backbone sampler: a "
                        ".gbnf file path or a literal grammar string "
                        "(codebook-AR kinds; forces host sampling)")
    p.add_argument("--cfg-weight", type=float, default=None,
                   help="Chatterbox CFG guidance weight (default 0.5; 0 = "
                        "one lane, no guidance)")
    p.add_argument("--ref-audio", dest="ref_audio", default=None,
                   help="flow_lm: a voice prompt WAV at the codec's rate")
    p.add_argument("--stream", action="store_true",
                   help="flow_lm: vocode each AR frame through the "
                        "streaming decoder as it is generated (reports "
                        "time-to-first-audio); other flows ignore it")
    p.add_argument("--min-len", type=int, default=-1,
                   help="minimum frames before EOS / stop is honoured "
                        "(flow_lm and continuous-CFM kinds; -1 = the model "
                        "default)")
    p.add_argument("--timesteps", type=int, default=None,
                   help="continuous-CFM Euler steps per patch (BlueMagpie "
                        "family; default 10)")
    p.add_argument("--tp", type=int, default=0,
                   help="shard the backbone tensor-parallel over N devices "
                        "(Megatron column/row split; --on-device runs the "
                        "chunks over its shares)")
    p.add_argument("--pp", type=int, default=0,
                   help="shard the backbone pipeline-parallel over N "
                        "stages (n_layers/N layers per device; generation "
                        "runs the host per-frame loop)")
    p.add_argument("--ep", type=int, default=0,
                   help="shard a MoE backbone expert-parallel over N "
                        "devices (n_experts/N experts per device)")
    return ap


def backbone_mesh_flag(args):
    """(kind, n) of --tp/--pp/--ep (mutually exclusive), or None."""
    given = [(k, n) for k, n in (("tp", args.tp), ("pp", args.pp),
                                 ("ep", args.ep)) if n > 1]
    if len(given) > 1:
        raise ValueError("--tp, --pp and --ep are mutually exclusive")
    return given[0] if given else None


def load_backbone_tokenizer(bb_reader):
    """The tokenizer baked into a backbone GGUF: SPM-unigram
    (`backbone.tokenizer.spm_b64`, lm/spm.py) or byte-level BPE
    (`backbone.tokenizer.bpe_json_zb64`, lm/bpe.py: Llama-3 / Qwen
    backbones). The reference gets this from llama.cpp's vocab
    (common/tts_runner.cpp:1096-1113)."""
    spm_b64 = bb_reader.get_str("backbone.tokenizer.spm_b64", "")
    if spm_b64:
        from ..lm.spm import SpmUnigram

        return SpmUnigram.from_b64(spm_b64)
    bpe_zb64 = bb_reader.get_str("backbone.tokenizer.bpe_json_zb64", "")
    if bpe_zb64:
        from ..lm.bpe import BpeByteLevel

        return BpeByteLevel.from_zb64(bpe_zb64)
    raise ValueError("backbone GGUF has no baked tokenizer "
                     "(backbone.tokenizer.spm_b64 / "
                     "backbone.tokenizer.bpe_json_zb64)")


def read_grammar(arg: str) -> str:
    """A --grammar argument: the text of the file it names, else the
    argument itself as a literal grammar (reference: tts-cli.cpp
    load_grammar_arg tries fopen first)."""
    try:
        with open(arg) as f:
            return f.read()
    except OSError:
        return arg


def flow_prepare_text(text: str):
    """pocket_tts prepare_text_prompt (tts_runner_flow.cpp:34-56): strip,
    collapse spaces, uppercase the first letter, ensure trailing
    punctuation → (text, frames_after_eos guess). A copy of codec_tpu's."""
    text = " ".join(text.split())
    if not text:
        return text, 3
    words = len(text.split(" "))
    guess = 3 if words <= 4 else 1
    if text[0].islower() and text[0].isascii():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text += "."
    return text, guess


def run_flow_synthesize(model, lm, text: str, seed: int = 0, ref_pcm=None,
                        max_frames: int = 0, min_len: int = 0,
                        stream: bool = False, temperature=None):
    """Self-contained FlowLM synthesize (reference:
    tts_runner_synthesize_selfcontained) → (pcm, n_frames, stop reason).

    The AR loop runs in chunks of 16 frames (4 with `stream`) through
    `lm.flow_run`: one device call and one copy to the host a chunk; the
    frames past the stop are computed and dropped (causal AR keeps the
    kept prefix the same as single steps). The flow noise is drawn per
    chunk from np.random.default_rng(seed) on the host, as codec_tpu draws
    it, so both packages (and both chunk sizes) see the same noise.
    `stream` vocodes each frame through the Pocket-Mimi streaming decoder
    as the loop emits it (time to first audio: one AR chunk + one push);
    else one decode_latent at the end. `ref_pcm`: a voice prompt, encoded
    (encode_latent) into speaker rows. `temperature` overrides the GGUF's
    flow noise variance (0: a deterministic flow). EOS counts from frame
    `min_len` on."""
    text, fae_guess = flow_prepare_text(text)
    fae_guess += 2                                       # reference adds +2
    ids = lm.tokenize(text)
    print(f'flow_lm: text="{text}" -> {len(ids)} tokens; '
          f"d_model={lm.info.hidden_dim} ldim={lm.ldim}")

    voice_rows = None
    if ref_pcm is not None:
        mu = model.encode_latent(np.asarray(ref_pcm, np.float32))
        voice_rows = lm.speaker_rows(mu)
        print(f"flow_lm: voice conditioning -> {len(voice_rows)} rows")

    st = lm.new_state()
    lm.flow_prefill(st, ids, voice_rows=voice_rows)
    fae = lm.frames_after_eos if lm.frames_after_eos >= 0 else fae_guess
    max_gen = max_frames if max_frames > 0 else \
        max(8, int(math.ceil((len(ids) / 3.0 + 2.0) * 12.5)))

    rng = np.random.default_rng(seed)
    noise_std = math.sqrt(lm.temperature if temperature is None
                          else float(temperature))
    dec = model.streaming_decoder() if stream else None
    t_start = time.monotonic()
    ttfa = None
    latents, chunks = [], []
    prev = None
    eos_step = -1
    stop = "max_frames"
    ar_chunk = 4 if stream else 16
    max_gen = min(max_gen, lm.max_T - st.kind_state["kv_pos"])
    step = 0
    done = False
    while step < max_gen and not done:
        # the last chunk shrinks to the KV capacity left
        cur_chunk = min(ar_chunk, lm.max_T - st.kind_state["kv_pos"])
        noises = (rng.standard_normal((cur_chunk, lm.ldim)) *
                  noise_std).astype(np.float32)
        lats, eos_logits = lm.flow_run(st, noises, prev_latent=prev)
        for i in range(cur_chunk):
            if step >= max_gen:
                break
            if eos_logits[i] > lm.eos_threshold and eos_step < 0 \
                    and step >= min_len:
                eos_step = step
            if eos_step >= 0 and step >= eos_step + fae:
                stop = "eos_head"
                done = True
                break
            frame = lm.denorm_latent(lats[i])
            latents.append(frame)
            if dec is not None:
                chunks.append(dec.push(frame[None]))
                if ttfa is None:
                    ttfa = time.monotonic() - t_start
            step += 1
        prev = lats[-1]
    print(f"flow_lm: AR done: {len(latents)} frames, eos_step={eos_step}, "
          f"stop={stop}")
    if not latents:
        raise ValueError("flow_lm: no frames generated")
    if dec is not None:
        print(f"flow_lm: streaming vocoder — time-to-first-audio "
              f"{ttfa * 1e3:.0f} ms "
              f"({model.hop_size / model.sample_rate * 1e3:.0f} ms of audio "
              f"per frame)")
        return np.concatenate(chunks), len(latents), stop
    return model.decode_latent(np.stack(latents)), len(latents), stop


def run_chatterbox_synthesize(model, reader, backbone_path, text: str,
                              seed: int = 0, max_frames: int = 0,
                              cfg_weight: float = 0.5,
                              on_device: bool = False, chunk_frames: int = 8,
                              prefill_bucket: int = 0, temperature=None,
                              top_p=None, min_p=None, rep_penalty=None,
                              quantized: bool = False, device="cuda",
                              bb=None, lm=None, t3=None):
    """Chatterbox T3 flow (reference: run_chatterbox, tts_runner.cpp:876;
    codec_tpu's run_chatterbox_synthesize): text → the baked BPE tokenizer
    → T3 (two CFG lanes over one backbone's weights, each with its own KV
    cache; one lane at `cfg_weight` 0) → S3 speech tokens → `model`'s
    S3Gen decode with its built-in conditioning. The GGUF's built-in
    speaker embedding and prompt tokens condition T3 (through the
    perceiver's conditioning encoder).

    The T3Sampler preset (temperature 0.8, min_p 0.05, repetition penalty
    1.2 over the whole history) with the CLI's overrides; `on_device`:
    the loop in K-frame device chunks (`chunk_frames`, at least 2), the
    chain in the graph. `bb`: a loaded backbone to reuse (packed when
    `quantized`); `lm` and `t3`: the CodecLM and ChatterboxT3 to reuse (a
    server's, so that its graphs are replayed). → (pcm, n_frames, stop
    reason)."""
    from ..lm.audio_lm import AudioLM
    from ..lm.backbone import create_backbone
    from ..lm.chatterbox_t3 import ChatterboxT3
    from ..lm.tts_runner import T3Sampler, run_chatterbox
    from ..ops.sample import OnDeviceSampling

    t3 = t3 if t3 is not None else ChatterboxT3(reader, device=device)
    if t3.tokenizer is None:
        raise ValueError("chatterbox GGUF has no baked tokenizer "
                         "(codec.lm.chatterbox.tokenizer.*)")
    if bb is None:
        bb = create_backbone(backbone_path, quantized=quantized,
                             device=device)
    if getattr(bb, "mesh_kind", None) is not None:
        raise ValueError("--tp/--pp/--ep do not support the chatterbox "
                         "dual-lane flow")
    bb.reset()
    if bb.cfg.hidden != t3.info.hidden_dim:
        raise ValueError(f"backbone hidden {bb.cfg.hidden} != "
                         f"t3 hidden {t3.info.hidden_dim}")
    n_lanes = 2 if cfg_weight > 0.0 else 1
    lanes = [bb] + [bb.lane() for _ in range(n_lanes - 1)]
    audio_lm = AudioLM(reader, codec=model, lm=lm, device=device)
    s_temp = 0.8 if temperature is None else float(temperature)
    s_top_p = 1.0 if top_p is None else float(top_p)
    s_min_p = 0.05 if min_p is None else float(min_p)
    s_rep = 1.2 if rep_penalty is None else float(rep_penalty)
    sampler = T3Sampler(seed=seed, seed_token=t3.info.start_speech_token,
                        temperature=s_temp, top_p=s_top_p, min_p=s_min_p,
                        repetition_penalty=s_rep)
    ods = None
    if on_device:
        ods = OnDeviceSampling(temperature=s_temp, top_p=s_top_p,
                               min_p=s_min_p, repetition_penalty=s_rep,
                               seed=seed, chunk_frames=max(2, chunk_frames))
    res = run_chatterbox(audio_lm, t3, lanes, text,
                         max_frames=max_frames if max_frames > 0 else 512,
                         cfg_weight=cfg_weight, sampler=sampler,
                         on_device=ods, prefill_bucket=prefill_bucket)
    print(f"chatterbox AR done: {res.n_steps} steps, eos={res.stopped_by_eos}, "
          f"codes {res.codes.shape}")
    if res.pcm is None:
        raise ValueError("no audio frames generated")
    return res.pcm, res.codes.shape[0], \
        "eos" if res.stopped_by_eos else "max_frames"


def sampling_overrides(base, sampling, n: int):
    """One OnDeviceSampling a text: `base` with each text's
    {"temperature", "top_k", "top_p", "min_p"} overrides (None: none)."""
    import dataclasses

    if sampling is None:
        return None
    if len(sampling) != n:
        raise ValueError("sampling needs one entry per text")
    return [dataclasses.replace(
        base, temperature=float(s.get("temperature", base.temperature)),
        top_k=int(s.get("top_k", base.top_k)),
        top_p=float(s.get("top_p", base.top_p)),
        min_p=float(s.get("min_p", base.min_p))) for s in sampling]


def _outcomes(results):
    return [(r.pcm, int(r.codes.shape[0]),
             "eos" if r.stopped_by_eos else "max_frames") for r in results]


def run_chatterbox_synthesize_batch(model, reader, backbone_path, texts,
                                    seed: int = 0, max_frames: int = 0,
                                    bb=None, chunk_frames: int = 8, lm=None,
                                    prefill_bucket: int = 0, sampling=None,
                                    cfg_weight: float = 0.5, mesh=None,
                                    t3=None, quantized: bool = False,
                                    device="cuda"):
    """Batched Chatterbox synthesize (codec_tpu's
    run_chatterbox_synthesize_batch): B texts, each with its CFG lanes,
    through one chunk (lm/tts_runner.run_chatterbox_batch), stream i
    seeded `seed + i`; `mesh`: the streams data-parallel over its "dp"
    axis, one chunk a share. The T3 preset chain (temperature 0.8, top_p 1.0,
    min_p 0.05, repetition penalty 1.2); `sampling` dicts override the
    chain per text (the penalty stays the preset). `lm` and `t3`: the
    CodecLM and ChatterboxT3 to reuse (a server's, so that its graphs are
    replayed); `bb` a loaded backbone (else one from `backbone_path`,
    packed when `quantized`). → [(pcm, n_frames, stop reason)] a text."""
    from ..lm import create_lm
    from ..lm.audio_lm import AudioLM
    from ..lm.backbone import create_backbone
    from ..lm.chatterbox_t3 import ChatterboxT3
    from ..lm.tts_runner import run_chatterbox_batch
    from ..ops.sample import OnDeviceSampling

    t3 = t3 if t3 is not None else ChatterboxT3(reader, device=device)
    if t3.tokenizer is None:
        raise ValueError("chatterbox GGUF has no baked tokenizer "
                         "(codec.lm.chatterbox.tokenizer.*)")
    if bb is None:
        bb = create_backbone(backbone_path, quantized=quantized,
                             device=device)
    if bb.cfg.hidden != t3.info.hidden_dim:
        raise ValueError(f"backbone hidden {bb.cfg.hidden} != "
                         f"t3 hidden {t3.info.hidden_dim}")
    shared = lm if lm is not None else create_lm(reader, device=device)
    alms = [AudioLM(reader, codec=model, lm=shared) for _ in texts]
    base = OnDeviceSampling(temperature=0.8, top_p=1.0, min_p=0.05,
                            repetition_penalty=1.2, repetition_window=-1,
                            seed=seed, chunk_frames=max(2, chunk_frames))
    return _outcomes(run_chatterbox_batch(
        alms, t3, bb, texts, base,
        max_frames=max_frames if max_frames > 0 else 512,
        cfg_weight=cfg_weight,
        sampling=sampling_overrides(base, sampling, len(texts)),
        prefill_bucket=prefill_bucket, mesh=mesh))


def run_backbone_synthesize_batch(model, reader, backbone_path, texts,
                                  seed: int = 0, max_frames: int = 0,
                                  bb=None, chunk_frames: int = 8, lm=None,
                                  mesh=None, prefill_bucket: int = 0,
                                  sampling=None, t3=None,
                                  quantized: bool = False, device="cuda"):
    """Batched codebook-AR synthesize (codec_tpu's
    run_backbone_synthesize_batch): B texts through one batched chunk on
    shared codec, LM and backbone weights, stream i seeded `seed + i`.
    Plain codebook-AR families (CSM / Qwen3-TTS / MOSS-TTSD:
    lm/tts_runner.run_codebook_ar_batch, the family's default chain) and
    the Chatterbox T3 family (run_chatterbox_synthesize_batch, `t3` passed
    on); continuous, LFM2-sequential and streaming-interleave kinds raise.
    `lm`: a CodecLM to share across calls; `bb`: a loaded backbone (its KV
    state is reset), else one from `backbone_path` (packed when
    `quantized`). `sampling`: one dict a text ({"temperature", "top_k",
    "top_p", "min_p"}, missing keys the defaults), the chains data in the
    graph. `mesh`: the streams data-parallel over its "dp" axis (B a
    multiple of its size; a 2-D dp x tp mesh with `bb` TP-split over it),
    codec_tpu's --dp. → [(pcm, n_frames, stop reason)] a text."""
    from ..io.gguf import GGUFReader
    from ..lm import create_lm
    from ..lm.audio_lm import AudioLM
    from ..lm.backbone import create_backbone
    from ..lm.chatterbox_t3 import is_chatterbox
    from ..lm.prompt_info import build_prompt_info
    from ..lm.tts_runner import run_codebook_ar_batch
    from ..ops.sample import OnDeviceSampling

    if is_chatterbox(reader):
        return run_chatterbox_synthesize_batch(
            model, reader, backbone_path, texts, seed=seed,
            max_frames=max_frames, bb=bb, chunk_frames=chunk_frames, lm=lm,
            prefill_bucket=prefill_bucket, sampling=sampling, t3=t3,
            quantized=quantized, device=device, mesh=mesh)
    shared = lm if lm is not None else create_lm(reader, device=device)
    pi = build_prompt_info(reader, shared.info)
    if pi.is_continuous or pi.sequential_text_audio or pi.streaming_interleave:
        raise ValueError(f"batched synthesize supports plain codebook-AR "
                         f"kinds only (model family: {pi.host_arch})")
    if bb is None:
        bb = create_backbone(backbone_path, quantized=quantized, device=device)
    else:
        bb.reset()
    if pi.hidden_dim and bb.cfg.hidden != pi.hidden_dim:
        raise ValueError(f"backbone hidden {bb.cfg.hidden} != "
                         f"codec.lm hidden {pi.hidden_dim}")
    tok = load_backbone_tokenizer(GGUFReader(backbone_path))
    alms = [AudioLM(reader, codec=model, lm=shared) for _ in texts]
    prompts = []
    for text, alm in zip(texts, alms):
        ids = tok.encode(pi.prompt_prefix + text + pi.prompt_suffix)
        if alm.prompt_needs_composed:
            prompts.append([alm.compose_prompt_embd(t) for t in ids])
        else:
            prompts.append(list(bb.embed_tokens(np.asarray(ids))))
    ods = OnDeviceSampling(**sampler_chain(pi), seed=seed,
                           chunk_frames=max(2, chunk_frames))
    return _outcomes(run_codebook_ar_batch(
        alms, bb, prompts, ods,
        max_steps=max_frames if max_frames > 0 else 512, pi=pi,
        prefill_bucket=prefill_bucket,
        sampling=sampling_overrides(ods, sampling, len(texts)), mesh=mesh))


def sampler_chain(pi, temperature=None, top_k=None, top_p=None,
                  min_p=None) -> dict:
    """The sampler chain of a request: the CLI's overrides over the model
    family's PromptInfo defaults (None = default; reference:
    tts-cli.cpp:266-275)."""
    return dict(
        temperature=pi.default_temperature if temperature is None
        else float(temperature),
        top_k=pi.default_top_k if top_k is None else int(top_k),
        top_p=pi.default_top_p if top_p is None else float(top_p),
        min_p=0.0 if min_p is None else float(min_p))


def run_text_audio_flow(audio_lm, bb, pi, ids, *, max_steps: int = 512,
                        seed: int = 0, temperature=None, top_k=None,
                        top_p=None, min_p=None, rep_penalty=None,
                        on_device: bool = False, chunk_frames: int = 8,
                        prefill_bucket: int = 0):
    """The two flows whose backbone carries text and audio (codec_tpu's
    tts_cli.py:410-443): LFM2-Audio's sequential text→audio
    (run_lfm2_sequential; one SamplerChain at the family's defaults with
    the overrides drives the text phase and every codebook) and
    MOSS-TTS-Realtime's streaming interleave (run_realtime_streaming; the
    last pi.prefill_text_len prompt tokens are the spoken text, the rest
    its context; a SamplerChain a codebook at the family's defaults).
    `on_device`: the audio frames in `chunk_frames`-frame device chunks
    with the chain and overrides (the realtime chunk with the repetition
    penalty over pi.repetition_window codes). `bb` is a LlamaBackbone (or
    the Backbone protocol with its `params` and `embed_tokens`). →
    SynthesisResult."""
    from ..lm.tts_runner import (SamplerChain, run_lfm2_sequential,
                                 run_realtime_streaming)
    from ..ops.sample import OnDeviceSampling

    chain = sampler_chain(pi, temperature, top_k, top_p, min_p)
    s_rep = pi.default_repetition_penalty if rep_penalty is None \
        else float(rep_penalty)
    if pi.sequential_text_audio:        # LFM2-Audio (text→audio switch)
        ods = OnDeviceSampling(**chain, seed=seed,
                               chunk_frames=max(1, chunk_frames)) \
            if on_device else None
        return run_lfm2_sequential(
            audio_lm, bb, bb.params["tok_embd"], ids, pi, max_frames=max_steps,
            sampler=SamplerChain(seed=seed, **chain), on_device=ods,
            prefill_bucket=prefill_bucket)
    ods = OnDeviceSampling(**chain, repetition_penalty=s_rep,
                           repetition_window=pi.repetition_window, seed=seed,
                           chunk_frames=max(1, chunk_frames)) \
        if on_device else None
    split = max(1, len(ids) - pi.prefill_text_len)
    return run_realtime_streaming(                # MOSS-TTS-Realtime
        audio_lm, bb, lambda t: bb.embed_tokens([t])[0],
        ctx_tokens=ids[:split], text_tokens=ids[split:] or ids, pi=pi,
        max_frames=max_steps, on_device=ods, prefill_bucket=prefill_bucket)


def run_backbone_synthesize(model, reader, backbone_path, text: str,
                            seed: int = 0, max_frames: int = 0, bb=None,
                            prefill_bucket: int = 0, temperature=None,
                            top_k=None, top_p=None, min_p=None,
                            rep_penalty=None, quantized: bool = False,
                            device="cuda", on_device: bool = False,
                            chunk_frames: int = 8, timesteps=None,
                            min_len: int = -1, grammar: str = "",
                            cfg_weight=None, lm=None, t3=None):
    """Synthesize with the llama backbone (reference: tts-cli over
    tts_runner_synthesize, tts_runner.cpp:1043; backbone n_embd check at
    :1096-1113): the codebook-AR flow of CSM-style and MOSS-TTSD models
    (run_codebook_ar, tts_runner.cpp:707), LFM2-Audio's sequential flow
    (run_lfm2_sequential, :609; the sampler chain drives the text phase
    and every codebook) and MOSS-TTS-Realtime's streaming interleave
    (run_realtime_streaming, :490; the last pi.prefill_text_len prompt
    tokens are the spoken text, the rest its context, sampled per codebook
    at the family's defaults; `on_device` adds the CLI's repetition
    penalty over pi.repetition_window codes), the continuous-latent flow
    of BlueMagpie models (run_continuous, :450; `timesteps` Euler steps a
    patch, `min_len` the stop guard; `on_device`: `chunk_frames` steps a
    device call), or the Chatterbox flow (`run_chatterbox_synthesize`,
    `cfg_weight` default 0.5).

    `bb`: a loaded LlamaBackbone to reuse (its KV state is reset); by
    default one is loaded from `backbone_path` (packed when `quantized`).
    `lm` (and for Chatterbox `t3`): the CodecLM to reuse, whose graphs a
    later request replays (a server's); by default one is loaded.
    Sampler overrides (None = the model family's defaults) apply to cb0;
    the depth codebooks are greedy, as in the reference. `on_device`:
    sample every codebook on the device with that chain (no repetition
    penalty), `chunk_frames` frames per device call. `grammar` (GBNF
    text) constrains the cb0 sampler of the codebook-AR flow with the
    baked tokenizer's pieces, on the host sampling path.
    → (pcm, n_frames, stop reason)."""
    from ..io.gguf import GGUFReader
    from ..lm.audio_lm import AudioLM
    from ..lm.backbone import create_backbone
    from ..lm.chatterbox_t3 import is_chatterbox
    from ..lm.prompt_info import build_prompt_info
    from ..lm.tts_runner import SamplerChain, run_codebook_ar, run_continuous
    from ..ops.sample import OnDeviceSampling

    if is_chatterbox(reader):
        return run_chatterbox_synthesize(
            model, reader, backbone_path, text, seed=seed,
            max_frames=max_frames,
            cfg_weight=0.5 if cfg_weight is None else float(cfg_weight),
            on_device=on_device, chunk_frames=chunk_frames,
            prefill_bucket=prefill_bucket, temperature=temperature,
            top_p=top_p, min_p=min_p, rep_penalty=rep_penalty,
            quantized=quantized, device=device, bb=bb, lm=lm, t3=t3)
    audio_lm = AudioLM(reader, codec=model, lm=lm, device=device)
    pi = build_prompt_info(reader, audio_lm.lm.info)
    if bb is None:
        bb = create_backbone(backbone_path, quantized=quantized, device=device)
    else:
        bb.reset()
    if bb.cfg.hidden != pi.hidden_dim:
        raise ValueError(f"backbone hidden {bb.cfg.hidden} != "
                         f"codec.lm hidden {pi.hidden_dim}")

    tok = load_backbone_tokenizer(GGUFReader(backbone_path))
    ids = tok.encode(pi.prompt_prefix + text + pi.prompt_suffix)
    print(f"backbone: {len(ids)} prompt tokens; "
          f"hidden={bb.cfg.hidden} layers={bb.cfg.n_layers}")

    if pi.is_continuous:                # BlueMagpie continuous-latent CFM
        if timesteps is not None:
            audio_lm.set_continuous_params(n_timesteps=int(timesteps))
        res = run_continuous(audio_lm, bb, list(bb.embed_tokens(ids)),
                             max_steps=max_frames if max_frames > 0 else 512,
                             min_len=min_len,
                             chunk_steps=chunk_frames if on_device else 1)
        print(f"continuous AR done: {res.n_steps} steps, "
              f"eos={res.stopped_by_eos}, latents {res.codes.shape}")
        if res.pcm is None:
            raise ValueError("no latents generated")
        return res.pcm, res.codes.shape[0], \
            "eos" if res.stopped_by_eos else "max_frames"

    chain = sampler_chain(pi, temperature, top_k, top_p, min_p)
    max_steps = max_frames if max_frames > 0 else 512

    if pi.sequential_text_audio or pi.streaming_interleave:
        res = run_text_audio_flow(
            audio_lm, bb, pi, ids, max_steps=max_steps, seed=seed,
            temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            rep_penalty=rep_penalty, on_device=on_device,
            chunk_frames=chunk_frames, prefill_bucket=prefill_bucket)
        print(f"backbone AR done: {res.n_steps} steps, "
              f"eos={res.stopped_by_eos}, codes {res.codes.shape}")
        if res.pcm is None:
            raise ValueError("no audio frames generated")
        return res.pcm, res.codes.shape[0], \
            "eos" if res.stopped_by_eos else "max_frames"

    ods = None
    if on_device and not grammar:
        ods = OnDeviceSampling(**chain, seed=seed,
                               chunk_frames=max(1, chunk_frames))
    chain = SamplerChain(
        seed=seed, **chain, repetition_penalty=pi.default_repetition_penalty
        if rep_penalty is None else float(rep_penalty))
    token_pieces = None
    if grammar:
        # every token's detokenized text for the pushdown matcher
        token_pieces = [tok.decode_piece(i) for i in range(tok.vocab_size)]

    def sampler(cb_idx, logits):
        return chain(logits) if cb_idx == 0 else int(logits.argmax())

    if audio_lm.prompt_needs_composed:
        # merged-cb0 (MOSS-TTSD): each prompt row sums the per-codebook
        # tables, cb0 = the raw text token, cb1..N-1 = speech_pad
        prompt_embeds = [audio_lm.compose_prompt_embd(t) for t in ids]
    else:
        prompt_embeds = list(bb.embed_tokens(ids))
    res = run_codebook_ar(audio_lm, bb, prompt_embeds,
                          max_steps=max_steps, sampler=sampler, pi=pi,
                          on_device=ods, prefill_bucket=prefill_bucket,
                          grammar=grammar,
                          token_pieces=token_pieces)
    print(f"backbone AR done: {res.n_steps} steps, "
          f"eos={res.stopped_by_eos}, codes {res.codes.shape}")
    if res.pcm is None:
        raise ValueError("no audio frames generated")
    return res.pcm, res.codes.shape[0], \
        "eos" if res.stopped_by_eos else "max_frames"


def _run(args) -> int:
    from ..io.gguf import GGUFReader

    if args.cmd == "info":
        r = GGUFReader(args.model)
        print(f"architecture: {r.architecture}")
        print(f"lm kind:      {r.get_str('codec.lm.kind', '<none>')}")
        print(f"host arch:    {r.get_str('codec.lm.host_arch', '<none>')}")
        for k in sorted(r.kv):
            if k.startswith(("codec.lm.", "codec.speaker.")) and \
                    not k.endswith("_b64"):
                v = r.kv[k]
                if isinstance(v, str) and len(v) > 60:
                    v = v[:57] + "..."
                print(f"  {k} = {v}")
        return 0

    import codec_tpu_torch

    from ..io.wav import write_wav

    if args.cmd == "decode":
        model = codec_tpu_torch.load_model(args.model, device=args.device)
        pcm = model.decode(np.load(args.codes), n_q=args.nq, pcm_format="i16")
        write_wav(args.out, pcm, model.sample_rate)
        print(f"wrote {args.out}: {pcm.shape[0]} samples @ {model.sample_rate} Hz")
        return 0

    reader = GGUFReader(args.model)
    if not reader.get_bool("codec.lm.has_adaptor", False):
        raise ValueError("GGUF has no codec.lm.* adaptor section")
    kind = reader.get_str("codec.lm.kind")
    if kind != "flow_lm" and not args.backbone:
        raise ValueError(f"kind {kind!r} needs a backbone — pass --backbone "
                         f"bb.gguf (flow_lm models are self-contained)")
    model = codec_tpu_torch.load_model(args.model, device=args.device)
    if kind == "flow_lm":
        from ..io.wav import read_wav, to_mono
        from ..lm import create_lm

        ref = None
        if args.ref_audio:
            x, sr = read_wav(args.ref_audio)
            if sr != model.sample_rate:
                raise ValueError(f"ref audio rate {sr} != {model.sample_rate}")
            ref = to_mono(x)
        pcm, n_frames, stop = run_flow_synthesize(
            model, create_lm(reader, device=args.device), args.text,
            seed=args.seed, ref_pcm=ref, max_frames=args.max_frames,
            min_len=args.min_len, stream=args.stream, temperature=args.temp)
        write_wav(args.out, pcm, model.sample_rate)
        print(f"wrote {args.out}: {pcm.shape[0]} samples "
              f"({n_frames} frames, stop={stop})")
        return 0
    bb = None
    mesh = backbone_mesh_flag(args)
    if mesh is not None:
        from ..lm.backbone import apply_backbone_mesh, create_backbone
        from ..parallel.mesh import named_devices

        bb = create_backbone(args.backbone, quantized=args.quant_exec,
                             device=args.device)
        apply_backbone_mesh(bb, *mesh,
                            devices=named_devices(args.device, mesh[1]))
    pcm, n_frames, stop = run_backbone_synthesize(
        model, reader, args.backbone, args.text, seed=args.seed, bb=bb,
        max_frames=args.max_frames, prefill_bucket=args.prefill_bucket,
        temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, rep_penalty=args.rep_penalty,
        quantized=args.quant_exec, device=args.device,
        on_device=args.on_device, chunk_frames=args.chunk_frames,
        timesteps=args.timesteps, min_len=args.min_len,
        grammar=read_grammar(args.grammar) if args.grammar else "",
        cfg_weight=args.cfg_weight)
    write_wav(args.out, pcm, model.sample_rate)
    print(f"wrote {args.out}: {pcm.shape[0]} samples "
          f"({n_frames} frames, stop={stop})")
    return 0


def main(argv=None) -> int:
    from ..lm.base import LmError
    from ..runtime.model import CodecError

    try:
        return _run(build_parser().parse_args(argv))
    except BrokenPipeError:
        return 0
    except (CodecError, LmError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
