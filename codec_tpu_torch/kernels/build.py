"""Build the port's CUDA sources (`codec_tpu_torch/csrc/*.cu`) at first use.

nvcc compiles every source into one shared library with a plain C
interface, which the op wrappers load with ctypes. The library lands in
`build/codec_tpu_torch/` beside the package and is named by a hash of the
sources and flags, so an unchanged tree loads the library it built before
and an edited one builds anew. Nothing here runs when the package is
imported: the CPU-only hosts that run the tests have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "codec_tpu_torch"

# sm_90a (not sm_90) keeps wgmma and setmaxnreg available to the kernels;
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildResult:
    path: Path          # the shared library
    seconds: float      # time spent in nvcc (0.0 when the library existed)
    log: str            # nvcc's stderr (ptxas report); empty when cached


def sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels of codec_tpu_torch are built with "
                       "the CUDA toolkit's nvcc")


def build() -> BuildResult:
    """Compile csrc/ into the hashed library unless it already exists."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libcodec_tpu_torch-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process sees
    # either no library or a whole one
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in srcs if p.suffix == ".cu")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, proc.stderr)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build().path))
