"""codec-cli-torch: `info` and `decode` over a codec GGUF with the port
(counterpart of codec_tpu/cli/codec_cli.py). Codes are .npy int [T, n_q];
audio is 16-bit PCM WAV.

Usage:
  python -m codec_tpu_torch.cli.codec_cli info   --model mimi.gguf
  python -m codec_tpu_torch.cli.codec_cli decode --model mimi.gguf \
      --codes c.npy --out out.wav [--device cuda] [--dtype float32]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="codec-cli-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("decode")
    p.add_argument("--model", required=True, help="codec GGUF path")
    p.add_argument("--codes", required=True, help="input codes .npy [T, n_q]")
    p.add_argument("--out", required=True, help="output WAV")
    p.add_argument("--nq", type=int, default=0, help="codebooks to use (0=all)")
    p.add_argument("--dtype", default="auto",
                   choices=["float32", "bfloat16", "auto"],
                   help="compute dtype (float32 = parity, bfloat16 = fast, "
                        "auto = follow checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the weights and the decode")

    p = sub.add_parser("info")
    p.add_argument("--model", required=True)
    return ap


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

    model = codec_tpu_torch.load_model(args.model, compute_dtype=args.dtype,
                                       device=args.device)
    codes = np.load(args.codes)
    pcm = model.decode(codes, n_q=args.nq, pcm_format="i16")
    write_wav(args.out, pcm, model.sample_rate)
    print(f"wrote {args.out}: {pcm.shape[0]} samples @ {model.sample_rate} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
