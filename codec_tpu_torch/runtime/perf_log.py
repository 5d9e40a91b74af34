"""JSONL phase timers, the port's copy of codec_tpu/runtime/perf_log.py.

RAII-style scopes append {"phase": ..., "wall_us": ..., "detail": ...}
lines to $CODEC_PERF_LOG. The phase names are the JAX package's
(decode_total, encode_total, graph_compute) and the lines are the same
JSONL, so one tool diffs the two engines. Nothing is written, and nothing
is timed, when the variable is unset.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Iterator, Optional


def _log_path() -> Optional[str]:
    return os.environ.get("CODEC_PERF_LOG") or None


def perf_event(phase: str, wall_us: float, detail: str = "") -> None:
    path = _log_path()
    if path is None:
        return
    rec = {"phase": phase, "wall_us": round(float(wall_us), 3)}
    if detail:
        rec["detail"] = detail
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextmanager
def perf_scope(phase: str, detail: str = "") -> Iterator[None]:
    if _log_path() is None:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        perf_event(phase, (time.monotonic() - t0) * 1e6, detail)
