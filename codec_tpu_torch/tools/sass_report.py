"""What nvcc made of the port's kernels: per kernel, ptxas's registers,
stack frame and spills, and how many int→float conversions (I2F),
warpgroup tensor-core products (HGMMA: wgmma), warp-level ones (HMMA:
mma.sync) and instructions its SASS holds.

    python -m codec_tpu_torch.tools.sass_report [--match matmul]

Builds the library of the package it is run from (kernels/build.py; a
library already built is rebuilt into a scratch directory for its ptxas
report) and reads `cuobjdump -sass` of it. Needs nvcc and cuobjdump, so it
runs on the card's machine. Kernels are named by their mangled names with
the per-file anonymous-namespace hash taken out (compare_sass.py).
"""

from __future__ import annotations

import argparse
import re
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from .compare_sass import _ANON, _dump, sass_by_kernel


@dataclass(frozen=True)
class KernelReport:
    name: str           # mangled, the anonymous-namespace hash as ANON
    registers: int
    stack: int          # bytes of stack frame
    spill_stores: int   # bytes
    spill_loads: int    # bytes
    i2f: int = -1       # I2F instructions in its SASS (-1: not read)
    instructions: int = -1
    hgmma: int = -1     # HGMMA instructions (wgmma)
    hmma: int = -1      # HMMA instructions (mma.sync)


def parse_ptxas(log: str) -> List[KernelReport]:
    """nvcc's -Xptxas -v report → one entry per compiled kernel."""
    out, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = _ANON.sub("ANON", m.group(1)), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(KernelReport(name, int(m.group(1)), *frame))
            name = None
    return out


def sass_counts(dump: str) -> Dict[str, dict]:
    """cuobjdump -sass output → {kernel: {"i2f", "instructions", "hgmma",
    "hmma": counts}}."""
    counts = {}
    for name, sass in sass_by_kernel(dump).items():
        ops = [op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass)]
        counts[name] = {"i2f": ops.count("I2F"), "instructions": len(ops),
                        "hgmma": ops.count("HGMMA"), "hmma": ops.count("HMMA")}
    return counts


def combine(log: str, lib, match: str = "") -> List[KernelReport]:
    """A build's ptxas report (its nvcc log) with the SASS counts of its
    library, for the kernels whose name holds `match`."""
    counts = sass_counts(_dump(str(lib)))
    return [KernelReport(**{**r.__dict__, **counts.get(r.name, {})})
            for r in parse_ptxas(log) if match in r.name]


def report(match: str = "") -> List[KernelReport]:
    """Build into a scratch directory (so that ptxas reports every kernel,
    whatever is cached) and combine."""
    from ..kernels import build

    with tempfile.TemporaryDirectory(prefix="sass_report_") as tmp:
        old = build.BUILD_DIR
        build.BUILD_DIR = Path(tmp)
        try:
            res = build.build()
            return combine(res.log, res.path, match)
        finally:
            build.BUILD_DIR = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sass_report")
    ap.add_argument("--match", default="", help="kernel name substring")
    args = ap.parse_args(argv)
    for r in report(args.match):
        print(f"{r.name}: {r.registers} registers, {r.stack} bytes stack "
              f"frame, spills {r.spill_stores}/{r.spill_loads} bytes, "
              f"{r.i2f} I2F, {r.hgmma} HGMMA, {r.hmma} HMMA of "
              f"{r.instructions} SASS instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
