"""Per-call op profiler, the port's counterpart of
codec_tpu/runtime/op_profile.py (env ``CODEC_OP_PROFILE=<path>``).

codec_tpu dumps a compile-time table per jitted graph: its optimized HLO's
instructions by opcode and by (opcode, result shape), and XLA's cost
estimates. The port runs eagerly, so its table is measured: with
``CODEC_OP_PROFILE`` set, each `decode`, `encode`, `decode_latent` and
`encode_latent` of a CodecModel runs under `torch.profiler` (CPU activity,
and CUDA activity for a model on the card, with shapes and FLOP counts)
and appends one JSONL line in codec_tpu's schema:

    {"event": "graph_profile", "key": "(arch, entry, input shape, dtype)",
     "by_op": {op: count}, "top_by_op_shape": {"op dtype[shape]": count}
     (the 40 most frequent), "n_instructions": sum of by_op,
     "cost": {"self_device_us": ..., "self_cpu_us": ..., "flops": ...}}

The ops counted are the calls the model makes, the profiler's top-level
aten ops (not the ops they call in turn), as codec_tpu counts the
instructions of the graph XLA runs; the shape and dtype are the op's first
input's. `cost` holds measured totals where codec_tpu holds XLA's
estimates: the device time of the call's kernels (0 on the CPU), the host
time of its ops, and the FLOPs the profiler counts (matmuls and convs).

``CODEC_OP_PROFILE_TRACE=<dir>`` writes each call's Chrome trace into
<dir> (with or without the table). With neither set, an entry runs as it
would without this module: no profiler object is made.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

_TOP_N = 40
# the entries a CodecModel profiles
ENTRIES = ("decode", "encode", "decode_latent", "encode_latent")
_state = threading.local()
_seq = itertools.count()


def profile_path() -> Optional[str]:
    return os.environ.get("CODEC_OP_PROFILE") or None


def trace_dir() -> Optional[str]:
    return os.environ.get("CODEC_OP_PROFILE_TRACE") or None


def enabled() -> bool:
    return profile_path() is not None or trace_dir() is not None


def _input_key(x) -> tuple:
    a = x if torch.is_tensor(x) else np.asarray(x)
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


def profile_events(events, averages) -> Dict[str, Any]:
    """The table of one profiled call: `events` its FunctionEvents
    (prof.events()), `averages` prof.key_averages()."""
    by_op: Counter = Counter()
    by_op_shape: Counter = Counter()
    for e in events:
        if (e.cpu_parent is not None or e.device_type.name != "CPU"
                or not e.name.startswith("aten::")):
            continue
        by_op[e.name] += 1
        shapes = e.input_shapes or [[]]
        dtypes = getattr(e, "input_dtypes", None) or [""]
        shape = ",".join(str(s) for s in (shapes[0] or []))
        by_op_shape[f"{e.name} {dtypes[0] or ''}[{shape}]"] += 1
    kernels = [a for a in averages if a.self_device_time_total > 0
               and not a.key.startswith("aten::")]
    return {
        "by_op": dict(by_op.most_common()),
        "top_by_op_shape": dict(by_op_shape.most_common(_TOP_N)),
        "n_instructions": sum(by_op.values()),
        "cost": {
            "self_device_us": float(sum(a.self_device_time_total
                                        for a in kernels)),
            "self_cpu_us": float(sum(a.self_cpu_time_total
                                     for a in averages)),
            "flops": float(sum(a.flops or 0 for a in averages)),
        },
    }


def _run_profiled(model, entry: str, fn: Callable, args, kwargs):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if model.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    shape, dtype = _input_key(args[0]) if args else ((), "")
    key = str((model.arch, entry, shape, dtype))
    _state.active = True
    try:
        with profile(activities=activities, record_shapes=True,
                     with_flops=True) as prof:
            out = fn(model, *args, **kwargs)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
    finally:
        _state.active = False
    path, tdir = profile_path(), trace_dir()
    if tdir:
        Path(tdir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(tdir) / (
            f"{model.arch}.{entry}.{os.getpid()}.{next(_seq)}.json")))
    if path:
        rec: Dict[str, Any] = {"event": "graph_profile", "key": key}
        rec.update(profile_events(prof.events(), prof.key_averages()))
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return out


def profiled(entry: str, fn: Callable) -> Callable:
    """fn, a CodecModel entry, run under the profiler while
    CODEC_OP_PROFILE or CODEC_OP_PROFILE_TRACE is set. A call made inside
    a profiled one (an arch's entry calling the base class's) is part of
    the outer call's record."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not enabled() or getattr(_state, "active", False):
            return fn(self, *args, **kwargs)
        return _run_profiled(self, entry, fn, args, kwargs)

    return wrapper
