"""The pipeline-parallel backbone forward: a GPipe schedule over a `pp`
mesh axis (counterpart of codec_tpu/parallel/pipeline.py:45-140).

Stage s holds n_layers / S whole layers and their KV caches on the mesh's
device s (LlamaBackbone.set_mesh_pp places them). The T input rows are
split into microbatches; at schedule step t stage s runs microbatch t - s,
so the forward takes n_mb + S - 1 steps, and each stage hands its
[mb, hidden] activation to the next stage's device. Microbatching over
time is sound for causal attention with a cache: microbatch m reaches
stage s after microbatch m - 1 did, so the earlier rows' keys are in the
stage's cache when the later rows attend.

codec_tpu runs the schedule as one SPMD program: every stage computes at
every step, a bubble step on junk rows whose cache writes are gated off,
the last microbatch padded, and a cache given scratch slots for the pad.
Here one process issues each stage's work to its device, so a bubble is
work not issued, the last microbatch is simply shorter, and nothing is
written past the rows given. CUDA launches return before the work ends, so
on several cards the stages overlap; on a mesh that names one card twice
they run there in turn.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..lm.backbone import BackboneConfig, run_layers
from ..ops import norms, qmat


def build_pp_forward(cfg: BackboneConfig, mesh, axis: str = "pp",
                     microbatches: int = 4) -> Callable:
    """fwd(stages, kvs, out_norm, pos0, x, qmm) with backbone_forward's
    semantics (x [T, hidden] at positions pos0.. → hiddens [T, hidden]
    after the output norm, on x's device), run pipeline-parallel over
    mesh[axis]. stages[s]: {"layers": its layer dicts, "freq_factors"} on
    device s; kvs[s]: its caches [n_layers / S, 2, n_kv, max_ctx, D],
    updated in place; out_norm on x's device. `microbatches` caps the split
    of T: a one-token step is one microbatch walking the stages."""
    devs = mesh.axis_devices(axis)
    n_stages = len(devs)

    def fwd(stages: List[Dict[str, Any]], kvs: List[torch.Tensor],
            out_norm: torch.Tensor, pos0: int, x: torch.Tensor,
            qmm: Callable = qmat.qmatmul) -> torch.Tensor:
        t = x.shape[0]
        n_mb = max(1, min(int(microbatches), t))
        mb = -(-t // n_mb)
        n_mb = -(-t // mb)                  # the count after rounding
        rows = [(m * mb, min(t, (m + 1) * mb)) for m in range(n_mb)]
        x0 = x.to(devs[0])
        hand: Dict[int, torch.Tensor] = {}  # microbatch → next stage's input
        out: List[torch.Tensor] = [None] * n_mb
        for step in range(n_mb + n_stages - 1):
            for s in range(n_stages):
                m = step - s
                if not 0 <= m < n_mb:       # a bubble: nothing to issue
                    continue
                a, b = rows[m]
                xin = x0[a:b] if s == 0 else hand.pop(m)
                y = run_layers(stages[s]["layers"], kvs[s], pos0 + a, xin,
                               cfg, stages[s]["freq_factors"], qmm)
                if s == n_stages - 1:
                    out[m] = y.to(x.device, non_blocking=True)
                else:
                    hand[m] = y.to(devs[s + 1], non_blocking=True)
        return norms.rms_norm(torch.cat(out), out_norm, cfg.rms_eps)

    return fwd
