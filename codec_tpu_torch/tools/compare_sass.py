"""Which kernels two builds of the port's library compiled to the same
machine code: `cuobjdump -sass` of each library, split into one section
per kernel, with the per-file hash that names an anonymous namespace taken
out of the kernel names.

    python -m codec_tpu_torch.tools.compare_sass LIB_A LIB_B [--match seanet_res]

A library is what `codec_tpu_torch.kernels.build.build().path` names after
a build in a tree (for example a `git archive` of the parent commit beside
the working tree). Prints how many kernels whose name contains `--match`
each library holds, how many of them have identical SASS, and each one that
differs. Needs the CUDA toolkit's cuobjdump.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import Dict

# nvcc names a file's anonymous namespace _GLOBAL__N__<8 hex>_<n>_<file>_cu_<8 hex>
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_by_kernel(dump: str) -> Dict[str, str]:
    """cuobjdump -sass output → {kernel name: its SASS}, anonymous-namespace
    hashes replaced by ANON in names and code alike, and the blank lines
    that end the dump (after the last kernel) left out."""
    dump = _ANON.sub("ANON", dump)
    parts = re.split(r"\n\s*Function : ", dump)
    return {p.split("\n", 1)[0].strip(): p.split("\n", 1)[1].rstrip()
            if "\n" in p else "" for p in parts[1:]}


def _dump(lib: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return subprocess.run([os.path.join(cuda_home, "bin", "cuobjdump"),
                           "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compare_sass")
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--match", default="", help="kernel name substring")
    args = ap.parse_args(argv)
    a, b = (sass_by_kernel(_dump(lib)) for lib in (args.lib_a, args.lib_b))
    names_a = sorted(n for n in a if args.match in n)
    names_b = sorted(n for n in b if args.match in n)
    same = [n for n in names_a if a[n] == b.get(n)]
    print(f"kernels matching {args.match!r}: {len(names_a)} in "
          f"{args.lib_a}, {len(names_b)} in {args.lib_b}; identical SASS: "
          f"{len(same)}")
    for n in sorted(set(names_a) ^ set(names_b)):
        print(f"  only in one library: {n}")
    for n in names_a:
        if n in b and a[n] != b[n]:
            print(f"  differs: {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
