"""codec-cli-torch: `info`, `encode`, `decode`, `e2e` and `decode-latent`
over a codec GGUF with the port (counterpart of
codec_tpu/cli/codec_cli.py). Codes are .npy int32 [T, n_q]; latents .npy
float32 [T, latent_dim]; audio is 16-bit PCM WAV.

Usage:
  python -m codec_tpu_torch.cli.codec_cli info   --model mimi.gguf
  python -m codec_tpu_torch.cli.codec_cli encode --model mimi.gguf \
      --in in.wav --codes c.npy [--device cuda] [--dtype float32]
  python -m codec_tpu_torch.cli.codec_cli decode --model mimi.gguf \
      --codes c.npy --out out.wav [--device cuda] [--dtype float32]
  python -m codec_tpu_torch.cli.codec_cli e2e    --model mimi.gguf \
      --in in.wav --out out.wav [--device cuda] [--dtype float32]
  python -m codec_tpu_torch.cli.codec_cli decode-latent --model dac.gguf \
      --latent z.npy --out out.wav [--device cuda] [--dtype float32]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="codec-cli-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--model", required=True, help="codec GGUF path")
        p.add_argument("--nq", type=int, default=0,
                       help="codebooks to use (0=all)")
        p.add_argument("--dtype", default="auto",
                       choices=["float32", "bfloat16", "float16", "auto"],
                       help="compute dtype (float32 = parity, bfloat16 or float16 = "
                            "fast, auto = follow checkpoint)")
        p.add_argument("--device", default="cuda",
                       help="torch device for the weights and the work")
        p.add_argument("--exact-encode", action="store_true",
                       dest="exact_encode",
                       help="encode with TF32 off for every matmul and conv "
                            "(already on for float32 compute)")

    p = sub.add_parser("encode")
    common(p)
    p.add_argument("--in", dest="infile", required=True, help="input WAV")
    p.add_argument("--codes", required=True, help="output codes .npy")

    p = sub.add_parser("decode")
    common(p)
    p.add_argument("--codes", required=True, help="input codes .npy [T, n_q]")
    p.add_argument("--out", required=True, help="output WAV")

    p = sub.add_parser("e2e")
    common(p)
    p.add_argument("--in", dest="infile", required=True, help="input WAV")
    p.add_argument("--out", required=True, help="output WAV")

    p = sub.add_parser("decode-latent")
    common(p)
    p.add_argument("--latent", required=True,
                   help="input latent .npy [T, latent_dim]")
    p.add_argument("--out", required=True, help="output WAV")

    p = sub.add_parser("info")
    p.add_argument("--model", required=True)
    return ap


def _read_pcm(model, path) -> np.ndarray:
    """Mono PCM from a WAV at the rate the model encodes
    (`encode_sample_rate` where it has one, e.g. XY-Tokenizer's 16 kHz,
    else `sample_rate`): mono PCM16 stays int16 (encode converts it on the
    device), anything else becomes mono float32."""
    from ..io.wav import read_wav, to_mono
    from ..runtime.model import CodecError

    x, sr = read_wav(path, keep_i16=True)
    want = getattr(model, "encode_sample_rate", 0) or model.sample_rate
    if sr != want:
        raise CodecError(f"input sample rate {sr} != model {want}")
    if x.dtype == np.int16:
        if x.shape[1] == 1:
            return x[:, 0]
        x = x.astype(np.float32) / 32768.0
    return to_mono(x)


def main(argv=None) -> int:
    from ..runtime.model import CodecError

    try:
        return _run(build_parser().parse_args(argv))
    except BrokenPipeError:
        return 0                      # e.g. `... | head` closed stdout
    except (CodecError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _run(args) -> int:
    if args.cmd == "info":
        from ..io.gguf import GGUFReader

        r = GGUFReader(args.model)
        print(f"architecture: {r.architecture}")
        print(f"name:         {r.get_str('general.name')}")
        print(f"tensors:      {len(r.tensors)}")
        for k in sorted(r.kv):
            if k.startswith("codec."):
                print(f"  {k} = {r.kv[k]}")
        return 0

    import codec_tpu_torch

    from ..io.wav import write_wav

    model = codec_tpu_torch.load_model(
        args.model, compute_dtype=args.dtype, device=args.device,
        exact_encode=args.exact_encode or None)
    if args.cmd == "encode":
        codes = model.encode(_read_pcm(model, args.infile), n_q=args.nq)
        np.save(args.codes, codes.astype(np.int32))
        print(f"wrote {args.codes}: {codes.shape} codes")
    elif args.cmd == "decode":
        codes = np.load(args.codes)
        pcm = model.decode(codes, n_q=args.nq, pcm_format="i16")
        write_wav(args.out, pcm, model.sample_rate)
        print(f"wrote {args.out}: {pcm.shape[0]} samples @ "
              f"{model.sample_rate} Hz")
    elif args.cmd == "e2e":
        codes = model.encode(_read_pcm(model, args.infile), n_q=args.nq)
        pcm = model.decode(codes, n_q=args.nq, pcm_format="i16")
        write_wav(args.out, pcm, model.sample_rate)
        print(f"wrote {args.out}: {pcm.shape[0]} samples ({codes.shape} "
              f"codes)")
    else:                                               # decode-latent
        pcm = model.decode_latent(np.load(args.latent), pcm_format="i16")
        write_wav(args.out, pcm, model.sample_rate)
        print(f"wrote {args.out}: {pcm.shape[0]} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
