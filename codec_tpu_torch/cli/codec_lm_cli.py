"""codec-lm-cli-torch: drive a codec_lm adaptor's step machine from the
shell with the port (counterpart of codec_tpu/cli/codec_lm_cli.py;
reference: examples/codec-lm-cli.cpp).

  codec-lm-cli-torch step --model m.gguf --hidden h.npy \
      --logits-prefix pfx [--codes-out c.npy] [--device cuda|cpu]
  codec-lm-cli-torch compose --model m.gguf --codes c.npy \
      --embd-out e.npy [--device cuda|cpu]
  codec-lm-cli-torch info --model m.gguf

`step` runs one full frame (begin → logits / greedy / push × n_cb →
finish), writing each codebook's logits to `<pfx>_<cb>.npy` and the
finished codes. `compose` turns a code frame into the next backbone input
embedding (the compose table's rows where the file has one).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="codec-lm-cli-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("step")
    p.add_argument("--model", required=True)
    p.add_argument("--hidden", required=True, help="backbone hidden .npy f32 [H]")
    p.add_argument("--logits-prefix", required=True)
    p.add_argument("--codes-out", default=None)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("compose")
    p.add_argument("--model", required=True)
    p.add_argument("--codes", required=True, help="codes .npy i32 [n_cb]")
    p.add_argument("--embd-out", required=True)
    p.add_argument("--device", default="cuda")

    p = sub.add_parser("info")
    p.add_argument("--model", required=True)
    p.add_argument("--device", default="cpu",
                   help="where the adaptor's weights load (info reads none)")
    return ap


def _load_lm(model_path, device):
    from ..io.gguf import GGUFReader
    from ..lm import create_lm

    lm = create_lm(GGUFReader(model_path), device=device)
    if lm is None:
        raise ValueError("GGUF has no codec.lm.* metadata")
    return lm


def _run(args) -> int:
    lm = _load_lm(args.model, args.device)
    if args.cmd == "info":
        i = lm.info
        print(f"kind:           {i.kind}")
        print(f"hidden_dim:     {i.hidden_dim}")
        print(f"n_codebook:     {i.n_codebook}")
        print(f"codebook_sizes: {list(i.codebook_sizes)}")
        if i.delay_pattern:
            print(f"delay_pattern:  {list(i.delay_pattern)}")
        print(f"eos_code_c0:    {i.eos_code_c0}")
        return 0

    if args.cmd == "step":
        h = np.load(args.hidden)
        if h.dtype != np.float32:
            raise ValueError(f"hidden must be float32, got {h.dtype}")
        if h.size != lm.info.hidden_dim:
            raise ValueError(
                f"hidden length {h.size} != hidden_dim {lm.info.hidden_dim}")
        st = lm.new_state()
        st.step_begin(h.reshape(-1))
        while st.step_pending:
            logits, cb_idx = st.step_logits()
            np.save(f"{args.logits_prefix}_{cb_idx}.npy",
                    np.asarray(logits, np.float32))
            st.step_push_code(int(np.argmax(logits)))
        codes = st.step_finish()
        print(f"frame codes: {list(codes)}")
        if args.codes_out:
            np.save(args.codes_out, np.asarray(codes, np.int32))
            print(f"wrote {args.codes_out}")
        return 0

    codes = np.load(args.codes).reshape(-1).astype(np.int32)
    if codes.size != lm.info.n_codebook:
        raise ValueError(
            f"codes length {codes.size} != n_codebook {lm.info.n_codebook}")
    embd = lm.compose_audio_embd(codes)
    np.save(args.embd_out, np.asarray(embd, np.float32))
    print(f"wrote {args.embd_out}: {embd.shape}")
    return 0


def main(argv=None) -> int:
    try:
        return _run(build_parser().parse_args(argv))
    except BrokenPipeError:
        return 0                      # e.g. `... | head` closed stdout
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
