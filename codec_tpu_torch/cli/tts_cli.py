"""tts-cli-torch: info / decode / synthesize over a codec(+LM) GGUF with the
port (counterpart of codec_tpu/cli/tts_cli.py).

`synthesize` runs the codebook-AR flow of CSM-style models (a
residual_depth_ar adaptor driven by a llama backbone GGUF with a baked
SPM tokenizer) on the host sampling path, or with `--on-device` on the
device: the whole frame with in-graph sampling, `--chunk-frames` K whole
frames per device call (on CUDA one CUDA graph replay per chunk).
`--quant-exec` keeps a Q8_0 or Q4_K backbone's layer matrices packed on
the device, multiplied by the dequantizing CUDA kernels. The other kinds
and flows, and the flags below marked so, raise "not ported yet".

Usage:
  python -m codec_tpu_torch.cli.tts_cli info --model csm.gguf
  python -m codec_tpu_torch.cli.tts_cli decode --model csm.gguf \
      --codes c.npy --out o.wav [--device cuda]
  python -m codec_tpu_torch.cli.tts_cli synthesize --model csm.gguf \
      --backbone bb.gguf --text "Hello there." --out o.wav \
      [--quant-exec] [--max-frames N] [--seed 0] [--device cuda|cpu]
      [--on-device [--chunk-frames 8]]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# flags of the reference CLI whose paths are not ported yet
_NOT_PORTED = {"grammar": "--grammar", "ref_audio": "--ref-audio",
               "stream": "--stream"}


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
    p.add_argument("--grammar", default="", help="not ported yet")
    p.add_argument("--ref-audio", dest="ref_audio", default=None,
                   help="not ported yet")
    p.add_argument("--stream", action="store_true",
                   help="streams FlowLM audio; waits for the FlowLM kind, "
                        "its only user, which is not ported yet")
    return ap


def load_backbone_tokenizer(bb_reader):
    """The SPM-unigram tokenizer baked into a backbone GGUF
    (`backbone.tokenizer.spm_b64`, lm/spm.py). Byte-level BPE is not
    ported yet."""
    spm_b64 = bb_reader.get_str("backbone.tokenizer.spm_b64", "")
    if spm_b64:
        from ..lm.spm import SpmUnigram

        return SpmUnigram.from_b64(spm_b64)
    if bb_reader.get_str("backbone.tokenizer.bpe_json_zb64", ""):
        raise ValueError("backbone GGUF bakes a BPE tokenizer: not ported yet")
    raise ValueError("backbone GGUF has no baked tokenizer "
                     "(backbone.tokenizer.spm_b64)")


def run_backbone_synthesize(model, reader, backbone_path, text: str,
                            seed: int = 0, max_frames: int = 0, bb=None,
                            prefill_bucket: int = 0, temperature=None,
                            top_k=None, top_p=None, min_p=None,
                            rep_penalty=None, quantized: bool = False,
                            device="cuda", on_device: bool = False,
                            chunk_frames: int = 8):
    """Codebook-AR synthesize of a CSM-style model with the llama backbone
    (reference: tts-cli over tts_runner_synthesize → run_codebook_ar,
    tts_runner.cpp:707,1043; backbone n_embd check at :1096-1113).

    `bb`: a loaded LlamaBackbone to reuse (its KV state is reset); by
    default one is loaded from `backbone_path` (packed when `quantized`).
    Sampler overrides (None = the model family's defaults) apply to cb0;
    the depth codebooks are greedy, as in the reference. `on_device`:
    sample every codebook on the device with that chain (no repetition
    penalty), `chunk_frames` frames per device call.
    → (pcm, n_frames, stop reason)."""
    from ..io.gguf import GGUFReader
    from ..lm.audio_lm import AudioLM
    from ..lm.backbone import create_backbone
    from ..lm.prompt_info import build_prompt_info
    from ..lm.tts_runner import SamplerChain, run_codebook_ar
    from ..ops.sample import OnDeviceSampling

    audio_lm = AudioLM(reader, codec=model, device=device)
    pi = build_prompt_info(reader, audio_lm.lm.info)
    if pi.is_continuous or pi.sequential_text_audio or pi.streaming_interleave \
            or "codec.lm.chatterbox.start_speech_token" in reader.kv:
        raise ValueError(f"{pi.host_arch or pi.model_kind} flow: not ported "
                         f"yet (codebook-AR models only)")
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

    s_temp = pi.default_temperature if temperature is None else float(temperature)
    s_top_k = pi.default_top_k if top_k is None else int(top_k)
    s_top_p = pi.default_top_p if top_p is None else float(top_p)
    s_min_p = 0.0 if min_p is None else float(min_p)
    chain = SamplerChain(
        seed=seed, temperature=s_temp, top_k=s_top_k, top_p=s_top_p,
        min_p=s_min_p, repetition_penalty=pi.default_repetition_penalty
        if rep_penalty is None else float(rep_penalty))
    ods = None
    if on_device:
        ods = OnDeviceSampling(temperature=s_temp, top_k=s_top_k,
                               top_p=s_top_p, min_p=s_min_p, seed=seed,
                               chunk_frames=max(1, chunk_frames))

    def sampler(cb_idx, logits):
        return chain(logits) if cb_idx == 0 else int(logits.argmax())

    if audio_lm.prompt_needs_composed:
        # merged-cb0 (MOSS-TTSD): each prompt row sums the per-codebook
        # tables, cb0 = the raw text token, cb1..N-1 = speech_pad
        prompt_embeds = [audio_lm.compose_prompt_embd(t) for t in ids]
    else:
        prompt_embeds = list(bb.embed_tokens(ids))
    res = run_codebook_ar(audio_lm, bb, prompt_embeds,
                          max_steps=max_frames if max_frames > 0 else 512,
                          sampler=sampler, pi=pi, on_device=ods,
                          prefill_bucket=prefill_bucket)
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

    for attr, flag in _NOT_PORTED.items():
        if getattr(args, attr):
            raise ValueError(f"{flag}: not ported yet")
    reader = GGUFReader(args.model)
    if not reader.get_bool("codec.lm.has_adaptor", False):
        raise ValueError("GGUF has no codec.lm.* adaptor section")
    if not args.backbone:
        raise ValueError("synthesize needs a backbone: pass --backbone "
                         "bb.gguf (self-contained flow_lm models are not "
                         "ported yet)")
    model = codec_tpu_torch.load_model(args.model, device=args.device)
    pcm, n_frames, stop = run_backbone_synthesize(
        model, reader, args.backbone, args.text, seed=args.seed,
        max_frames=args.max_frames, prefill_bucket=args.prefill_bucket,
        temperature=args.temp, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, rep_penalty=args.rep_penalty,
        quantized=args.quant_exec, device=args.device,
        on_device=args.on_device, chunk_frames=args.chunk_frames)
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
