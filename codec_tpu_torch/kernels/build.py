"""Build the port's CUDA sources (`codec_tpu_torch/csrc/*.cu`) at first use.

nvcc compiles every source to an object, one process per source, all
started together, then links the objects into one shared library with a
plain C interface, which the op wrappers load with ctypes. The library lands in
`build/codec_tpu_torch/` beside the package when the package lies in a
source tree (a checkout with its `pyproject.toml`), else (an installed
package, under `site-packages`) in `~/.cache/codec_tpu_torch/`. It is
named by a hash of the sources and flags, so an unchanged tree loads the library it built before
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


def build_dir(package_dir: Path) -> Path:
    """Where the library of the package at package_dir is built: beside it
    in a source tree, else in the user's cache (site-packages may not be
    writable, and is no place for build outputs)."""
    root = package_dir.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "codec_tpu_torch"
    return Path.home() / ".cache" / "codec_tpu_torch"


BUILD_DIR = build_dir(PACKAGE_DIR)

# sm_90a (not sm_90) keeps wgmma and setmaxnreg available to the kernels;
# -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    # build under private names, then rename: a concurrent process sees
    # either no library or a whole one
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.monotonic()
    objs = [work / f"{p.stem}.o" for p in srcs if p.suffix == ".cu"]
    jobs = []
    try:
        for obj in objs:
            jobs.append(_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                str(CSRC_DIR / f"{obj.stem}.cu")]))
        logs = [_finish(*job) for job in jobs]
        tmp = work / lib.name
        logs.append(_finish(*_start([nvcc, "-shared", "-o", str(tmp),
                                     *map(str, objs)])))
        os.replace(tmp, lib)
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return BuildResult(lib, time.monotonic() - t0, "".join(logs))


def _start(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(cmd: list, proc: subprocess.Popen) -> str:
    """Wait for one nvcc process; its stderr, or raise with it."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{err}")
    return err


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build().path))


def launch_on(device: int, launch):
    """launch(stream) with `device` current, stream the raw cudaStream_t
    (an int) of its current PyTorch stream. The device is switched only
    when it is not the current one, and the stream read without making a
    torch.cuda.Stream: the host cost of a small kernel's launch is most of
    its wrapper's time."""
    import torch

    if device == torch.cuda.current_device():
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        return launch(raw(device) if raw else
                      torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream(device).cuda_stream)
