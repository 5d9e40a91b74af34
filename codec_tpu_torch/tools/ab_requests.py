"""Requests of two trees in one process, in alternating pairs.

    python -m codec_tpu_torch.tools.ab_requests --parent DIR [--pairs 10]
        [--runs 5] [--what f32,bf16,tts,tts_decode] [--json out.json]

DIR is the root of another tree (a `git archive` of an older commit,
unpacked under build/ with its pyproject.toml). Its package is imported as
`codec_tpu_torch_parent` beside this tree's `codec_tpu_torch`, each with
its own kernel library, built under its own tree's build/. Random weights
are written once with this tree's writers (seed 0): a full-width Mimi
(with its encoder), DAC and SNAC, a CSM codec (that Mimi and CSM-1B's
depth decoder) and a Llama-3.2-1B-shaped Q4_K backbone; both trees load
the same files.

Requests (--what): `f32` and `bf16`, the Mimi decode of 20 s b1 (host
codes to host PCM; a sample is the median of --runs CUDA-event runs after
two warm-ups); `encode`, the Mimi encode of 20 s b1 f32 (host PCM to host
codes, timed as `f32`); `push` and `push_bf16`, one push of 1 frame on a
warm b1 Mimi streaming decoder (timed as `f32`); `first_audio`, a fresh
session's first push of 1 frame, opening included (a sample is one
host-timed call); `dac` and `snac`, the DAC and SNAC decodes of 20 s b1
f32 (timed as `f32`); `tts`, one CSM TTS request as chip_smoke.py's
q4_k_bucket16 runs it (16 prompt tokens in one 16-row prefill bucket, 25
greedy frames, the Mimi decode; a sample is one host-timed request);
`tts_decode`, the CSM codec's decode of 25 frames b1, the part of a TTS
request the Mimi kernels run (timed as `f32`). Only the files the chosen
requests read are written. Pair i times every request in
both trees, the parent first when i is even and this tree first when it is
odd, so neither tree always runs on a warmer card. Prints, per request, the
median and quartiles of each tree's samples and the median of the pairs'
ratios (this tree over the parent), each beside the card's name and power
limit; --json writes the samples. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from codec_tpu_torch.tools.mimi_times import card, cuda_ms

PROMPT, FRAMES, BUCKET = 16, 25, 16


def import_tree(root: Path, name: str):
    """The codec_tpu_torch package of the tree at root, as module `name`
    (its imports are relative, so it loads its own modules)."""
    init = root / "codec_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


NAMES = {"f32": "mimi decode 20s_b1_f32", "bf16": "mimi decode 20s_b1_bf16",
         "encode": "mimi encode 20s_b1_f32",
         "push": "mimi stream push 1 frame b1 f32",
         "push_bf16": "mimi stream push 1 frame b1 bf16",
         "first_audio": "mimi stream first push b1 f32",
         "dac": "dac decode 20s_b1_f32", "snac": "snac decode 20s_b1_f32",
         "tts": "tts q4_k_bucket16", "tts_decode": "csm decode 25 frames b1 f32"}
HOST_TIMED = ("tts", "first_audio")
MIMI = ("f32", "bf16", "encode", "push", "push_bf16", "first_audio")


def _codes(model, secs: int, rng_seed: int, multiple: int = 1) -> np.ndarray:
    frames = secs * model.sample_rate // model.hop_size
    frames -= frames % multiple
    return np.random.default_rng(rng_seed).integers(
        0, model.codebook_size, (1, frames, model.n_q)).astype(np.int32)


def requests(pkg: str, paths: dict, what, rng_seed: int = 2) -> dict:
    """name → a function that runs the request once, for package pkg (the
    requests in `what`)."""
    top = importlib.import_module(pkg)
    sub = lambda m: importlib.import_module(f"{pkg}.{m}")   # noqa: E731
    out = {}
    if any(w in MIMI for w in what):
        mimi = {dt: top.load_model(paths["mimi"], compute_dtype=dt,
                                   device="cuda")
                for dt in ("float32", "bfloat16")}
        m = mimi["float32"]
        codes = _codes(m, 20, rng_seed)
        pcm = (np.random.default_rng(rng_seed + 1).standard_normal(
            (1, 20 * m.sample_rate)) * 0.3).astype(np.float32)
        sessions = {dt: mimi[dt].streaming_decoder(batch=1) for dt in mimi}
        pushed = {dt: [0] for dt in mimi}

        def push(dt):
            # one frame; the session starts again every 200 frames
            if pushed[dt][0] == 200:
                sessions[dt].reset()
                pushed[dt][0] = 0
            i = pushed[dt][0]
            sessions[dt].push(codes[:, i:i + 1])
            pushed[dt][0] += 1

        def first_audio():
            m.streaming_decoder(batch=1).push(codes[:, :1])

        out.update({"f32": lambda: m.decode(codes),
                    "bf16": lambda: mimi["bfloat16"].decode(codes),
                    "encode": lambda: m.encode(pcm),
                    "push": lambda: push("float32"),
                    "push_bf16": lambda: push("bfloat16"),
                    "first_audio": first_audio})
    if "dac" in what:
        dac = top.load_model(paths["dac"], device="cuda")
        dcodes = _codes(dac, 20, rng_seed)
        out["dac"] = lambda: dac.decode(dcodes)
    if "snac" in what:
        snac = top.load_model(paths["snac"], device="cuda")
        scodes = _codes(snac, 20, rng_seed, multiple=snac.cfg.vq_strides[0])
        out["snac"] = lambda: snac.decode(scodes)
    if "tts" in what or "tts_decode" in what:
        gguf, lm_mod = sub("io.gguf"), sub("lm")
        audio_lm, backbone = sub("lm.audio_lm"), sub("lm.backbone")
        runner = sub("lm.tts_runner")
        csm = top.load_model(paths["csm"], device="cuda")
        reader = gguf.GGUFReader(paths["csm"])
        lm = lm_mod.create_lm(reader, device="cuda")
        bb = backbone.create_backbone(paths["q4_k"], quantized=True,
                                      device="cuda")
        prompt = list(bb.embed_tokens(np.random.default_rng(130).integers(
            0, bb.cfg.vocab_size, PROMPT)))

        def tts():
            bb.reset()
            alm = audio_lm.AudioLM(reader, codec=csm, lm=lm)
            res = runner.run_codebook_ar(alm, bb, prompt, max_steps=FRAMES,
                                         decode=False, prefill_bucket=BUCKET)
            pcm = runner._decode_transformed(alm, res.codes)
            if res.codes.shape[0] != FRAMES or not np.isfinite(pcm).all():
                raise RuntimeError(f"{pkg}: TTS gave codes {res.codes.shape}")

        codes25 = _codes(csm, 2, rng_seed)[:, :FRAMES]
        out.update({"tts": tts, "tts_decode": lambda: csm.decode(codes25)})
    return {w: out[w] for w in what}


def sample_ms(name: str, fn, runs: int) -> float:
    if name in HOST_TIMED:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    return cuda_ms(fn, runs)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ab_requests")
    ap.add_argument("--parent", required=True, help="root of the other tree")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--what", default=",".join(NAMES),
                    help=f"comma-separated of {', '.join(NAMES)}")
    ap.add_argument("--json", help="write the samples to this file")
    args = ap.parse_args(argv)
    what = args.what.split(",")
    for w in what:
        if w not in NAMES:
            raise SystemExit(f"ab_requests: unknown --what {w!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    import_tree(Path(args.parent).resolve(), "codec_tpu_torch_parent")
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf
    from codec_tpu_torch.models.lm_init import (write_random_backbone_gguf,
                                                write_random_csm_gguf)
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf

    with tempfile.TemporaryDirectory(prefix="ab_requests_") as tmp:
        t0 = time.monotonic()
        paths = {}
        if any(w in MIMI for w in what):
            paths["mimi"] = Path(tmp) / "mimi.gguf"
            write_random_mimi_gguf(paths["mimi"], seed=0, encoder=True)
        if "dac" in what:
            paths["dac"] = Path(tmp) / "dac.gguf"
            write_random_dac_gguf(paths["dac"], seed=0)
        if "snac" in what:
            paths["snac"] = Path(tmp) / "snac.gguf"
            write_random_snac_gguf(paths["snac"], seed=0)
        if "tts" in what or "tts_decode" in what:
            paths["csm"] = write_random_csm_gguf(Path(tmp) / "csm.gguf", seed=0)
            paths["q4_k"] = write_random_backbone_gguf(
                Path(tmp) / "q4_k.gguf", seed=0, qtype="Q4_K")
        print(f"wrote the GGUFs in {time.monotonic() - t0:.1f} s", flush=True)
        trees = {"parent": requests("codec_tpu_torch_parent", paths, what),
                 "change": requests("codec_tpu_torch", paths, what)}
    for reqs in trees.values():           # warm-up: build, autotune, caches
        for req in what:
            reqs[req]()
            reqs[req]()
    samples = {req: {tree: [] for tree in trees} for req in what}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for req in samples:
            for tree in order:
                samples[req][tree].append(
                    sample_ms(req, trees[tree][req], args.runs))
    for req, by_tree in samples.items():
        ratios = [c / p for c, p in zip(by_tree["change"], by_tree["parent"])]
        p25, p50, p75 = quartiles(by_tree["parent"])
        c25, c50, c75 = quartiles(by_tree["change"])
        print(f"[ab] {NAMES[req]}: parent median {p50:.3f} ms (quartiles {p25:.3f}-"
              f"{p75:.3f}), change median {c50:.3f} ms (quartiles {c25:.3f}-"
              f"{c75:.3f}), change / parent per pair: median "
              f"{statistics.median(ratios):.4f}, change faster in "
              f"{sum(r < 1 for r in ratios)} of {len(ratios)} pairs "
              f"[{name}]", flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(
            {"card": name, "samples": {NAMES[r]: v for r, v in samples.items()}},
            indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
