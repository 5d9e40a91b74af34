"""The packed products' device time under other launch plans, warm and cold.

For each backbone shape (Llama-3.2-1B's q/o, k/v, gate/up and down) and
both kernels, launches q8_0_matmul / q4_k_matmul at m = 1 under
ops/qmat_cuda.py::plan's choice and under other K splits (chunks of up to
512 columns, up to 4 ring stages), and prints each plan's device time per
launch from torch.profiler: warm (one matrix 50 times) and cold (16 copies
of it in turn, a 64 MB buffer written between launches where the 16 fit
in L2). Each plan is checked against the plain product (max abs err <=
1e-4·max|plain|) and against a second launch (bit-identical).

    python -m codec_tpu_torch.tools.qmat_plans [--m 1]

Weights are Q8_0 / Q4_K quantizations of N(0, 0.02) from seed 0. Needs
the card and the CUDA toolkit's nvcc.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..io.gguf import quantize_q4_k, quantize_q8_0
from ..ops import qmat
from ..ops import qmat_cuda as qc

SHAPES = {(2048, 2048): "q/o", (512, 2048): "k/v", (8192, 2048): "gate/up",
          (2048, 8192): "down"}
SPLITS = (1, 2, 4, 8)
COPIES = 16
L2_BYTES = 50 * 2 ** 20
FLUSH_BYTES = 64 * 2 ** 20


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def _device_ms(fn, calls: int) -> float:
    """fn once to warm up, then once under torch.profiler: the packed
    kernels' device time / calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "matmul_kernel" in e.key) / 1e3 / calls


def candidate_plans(kind: str, m: int, in_d: int, out_d: int) -> list:
    """plan()'s choice first, then the other K splits that divide K into
    slices of whole chunks."""
    chosen = qc.plan(kind, m, in_d, out_d)
    return [chosen] + [qc.plan(kind, m, in_d, out_d, split=s) for s in SPLITS
                       if s != chosen.split and (in_d // qc.granule(kind, in_d)) % s == 0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1)
    args = ap.parse_args(argv)
    card = _card()
    q8, q4k, err_str = qc._kernel_fns()
    rng = np.random.default_rng(0)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for (out_d, in_d), label in SHAPES.items():
        w = rng.standard_normal((out_d, in_d), dtype=np.float32) * 0.02
        for kind, quantize, pack in (("q8_0", quantize_q8_0, qmat.pack_q8_0),
                                     ("q4_k", quantize_q4_k, qmat.pack_q4_k)):
            qt = qmat.to_device(pack(np.frombuffer(quantize(w), np.uint8), w.shape),
                                "cuda")
            copies = [{k: v.clone() for k, v in qt.items()} for _ in range(COPIES)]
            nbytes = sum(v.numel() * v.element_size() for v in qt.values()) * COPIES
            x = torch.randn((args.m, in_d), device="cuda")
            want = x @ qmat.dequant_ref(qt).T
            fn = q8 if kind == "q8_0" else q4k
            cols = []
            for p in candidate_plans(kind, args.m, in_d, out_d):
                def launch(t, p=p):
                    ptrs = [t["qs"].data_ptr(), t["scale"].data_ptr()]
                    ptrs += [t["minv"].data_ptr()] if kind == "q4_k" else []
                    return qc._launch(f"{kind}_matmul", fn, err_str, x, ptrs,
                                      args.m, in_d, out_d, p)

                def cycle():
                    for t in copies:
                        if nbytes < 2 * L2_BYTES:
                            flush.fill_(1.0)
                        launch(t)
                y = launch(qt)
                ok = bool((y - want).abs().max() <= 1e-4 * want.abs().max()) \
                    and torch.equal(y, launch(qt))
                warm = _device_ms(lambda: [launch(qt) for _ in range(50)], 50)
                cold = _device_ms(cycle, COPIES)
                cols.append(f"split {p.split} kc {p.kc} stages {p.stages} "
                            f"({p.blocks} blocks): warm {warm:.4f} ms, cold "
                            f"{cold:.4f} ms{'' if ok else ', WRONG'}")
            print(f"{kind} {label} {out_d}x{in_d} m{args.m}: plan() "
                  + "; ".join(cols) + f" [{card}]", flush=True)
            del copies
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
