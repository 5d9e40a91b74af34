"""codec-batch-decode-torch: decode several code (or latent) files in one
batch with the port (counterpart of codec_tpu/cli/batch_decode.py).

The sequences are zero-padded to the longest and decoded as one batch;
with --pipeline, or when their lengths differ, they go through
CodecModel.decode_many instead (one batched decode per length, one sync),
which gives each sequence what its own decode gives. Each output is
written as <out-dir>/<input stem>.wav, cut to its own length. --dp N
splits the padded batch over N devices (the first N cards, or with
--device cpu or cuda:K N entries of that device), one replica of the
weights each.

Usage:
  python -m codec_tpu_torch.cli.batch_decode --model mimi.gguf \\
      --codes a.npy b.npy c.npy --out-dir outs/ [--pipeline] \\
      [--device cuda] [--dtype float32] [--dp N]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..runtime.model import CodecError


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="codec-batch-decode-torch")
    ap.add_argument("--model", required=True, help="codec GGUF path")
    ap.add_argument("--codes", nargs="+", required=True,
                    help=".npy code files [T, n_q]")
    ap.add_argument("--latent", action="store_true",
                    help="inputs are latents [T, latent_dim], not codes")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--nq", type=int, default=0,
                    help="codebooks to use (0=all)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data parallelism: split the batch over N devices "
                         "(the first N cards; with --device cpu or cuda:K, N "
                         "entries of that device)")
    ap.add_argument("--sp", type=int, default=0,
                    help="sequence parallelism over devices (not ported "
                         "yet: the next slice)")
    ap.add_argument("--pipeline", action="store_true",
                    help="decode through decode_many (one batched decode per "
                         "length, one sync) instead of padding to one batch; "
                         "taken whenever the lengths differ")
    ap.add_argument("--dtype", default="auto",
                    choices=["float32", "bfloat16", "float16", "auto"],
                    help="compute dtype (float32 = parity, bfloat16 or "
                         "float16 = fast, auto = follow checkpoint)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the weights and the work")
    return ap


def main(argv=None) -> int:
    try:
        return _run(build_parser().parse_args(argv))
    except (CodecError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _run(args) -> int:
    if args.dp > 1 and args.sp > 1:
        raise CodecError("--dp and --sp are mutually exclusive")
    if args.sp > 1:
        raise CodecError("sequence parallelism is not ported yet (--sp): "
                         "it comes in the next slice, with its op-level "
                         "halo design")
    import codec_tpu_torch

    from ..io.wav import write_wav

    mesh = None
    if args.dp > 1:
        from ..parallel.mesh import make_mesh, named_devices

        mesh = make_mesh(args.dp, devices=named_devices(args.device, args.dp))
    model = codec_tpu_torch.load_model(
        args.model, compute_dtype=args.dtype,
        device=None if mesh is not None else args.device, mesh=mesh)
    seqs = [np.load(p) for p in args.codes]
    if any(s.ndim != 2 or s.shape[0] == 0 for s in seqs):
        raise CodecError(f"want [T, C] inputs, got "
                         f"{[s.shape for s in seqs]}")
    lens = [s.shape[0] for s in seqs]
    if (args.pipeline or len(set(lens)) > 1) and not args.latent \
            and mesh is None:
        outs = model.decode_many(seqs, n_q=args.nq, pcm_format="i16")
    else:
        cols = seqs[0].shape[1] if args.latent else min(
            s.shape[1] for s in seqs)
        batch = np.zeros((len(seqs), max(lens), cols),
                         np.float32 if args.latent else np.int32)
        for i, s in enumerate(seqs):
            batch[i, : s.shape[0]] = s[:, :cols]
        pcm = (model.decode_latent(batch, pcm_format="i16") if args.latent
               else model.decode(batch, n_q=args.nq, pcm_format="i16"))
        outs = [pcm[i, : t * model.hop_size] for i, t in enumerate(lens)]
        if mesh is not None:
            print(f"dp={args.dp}: device output sharding "
                  f"{[str(d) for d in model.last_out_devices]}")
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for path, y in zip(args.codes, outs):
        out = out_dir / (Path(path).stem + ".wav")
        write_wav(out, y, model.sample_rate)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
