"""Random full-architecture Mimi parameters and GGUF files from a seed.

Shapes mirror kyutai/mimi (num_filters=64 doubling per stride). The NumPy
draws follow codec_tpu/models/mimi_init.py::random_mimi_params in order
and scale, so one seed gives the same weights in both packages.
`write_random_mimi_gguf` writes them under the Mimi wire names and layouts
(those of codec_tpu/convert/mimi.py), so `load_model(path)` runs its real
path with no download.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from ..io.gguf import GGUFWriter
from .mimi import _LAYER_KEYS, MimiConfig, params_from_jax

ENC_STRIDES = (4, 5, 6, 8)


def _random_tree(cfg: MimiConfig, num_filters: int = 64,
                 seed: int = 0) -> Dict[str, Any]:
    """The whole codec_tpu-layout parameter tree (encoder included, WIO
    conv weights, stacked transformer layers) as float32 NumPy arrays."""
    rng = np.random.default_rng(seed)
    nf, h = num_filters, cfg.hidden
    d, v = cfg.codebook_dim, cfg.codebook_size

    def w(*shape, scale=0.05):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def conv_wb(cin, cout, k, bias=True):
        return {"w": w(k, cin, cout), "b": w(cout) if bias else None}

    def tr_stack():
        n, i, hd = cfg.n_layers, cfg.intermediate, cfg.n_heads * cfg.head_dim
        ones = np.ones((n, h), np.float32)
        return {
            "inln_w": ones, "inln_b": 0 * ones, "paln_w": ones, "paln_b": 0 * ones,
            "q_w": w(n, hd, h), "k_w": w(n, hd, h), "v_w": w(n, hd, h),
            "o_w": w(n, h, hd), "fc1_w": w(n, i, h), "fc2_w": w(n, h, i),
            "sa_scale": 0.01 * ones, "mlp_scale": 0.01 * ones,
        }

    p: Dict[str, Any] = {
        "cb_sem": w(cfg.n_sem, v, d, scale=1.0),
        "sem_op": w(h, d),
        "cb_acu": w(cfg.n_q - cfg.n_sem, v, d, scale=1.0),
        "acu_op": w(h, d),
        "up": conv_wb(h, h, 4, bias=False),
        "dtr": tr_stack(),
        "etr": tr_stack(),
    }
    p["enc_l0"] = conv_wb(1, nf, 7)
    c = nf
    p["enc_stages"] = []
    for s in ENC_STRIDES:
        p["enc_stages"].append({"r1": conv_wb(c, c // 2, 3),
                                "r2": conv_wb(c // 2, c, 1),
                                "dn": conv_wb(c, c * 2, 2 * s)})
        c *= 2
    p["enc_l14"] = conv_wb(c, h, 3)
    p["dn"] = {"w": w(4, h, h), "b": None}
    p["sem_ip"] = w(d, h)
    p["acu_ip"] = w(d, h)
    p["dec_l0"] = conv_wb(h, c, 7)
    p["dec_stages"] = []
    for s in reversed(ENC_STRIDES):
        p["dec_stages"].append({"tr": conv_wb(c, c // 2, 2 * s),
                                "r1": conv_wb(c // 2, c // 4, 3),
                                "r2": conv_wb(c // 4, c // 2, 1)})
        c //= 2
    p["dec_l14"] = conv_wb(c, 1, 3)
    return p


def random_mimi_params(cfg: MimiConfig, num_filters: int = 64, seed: int = 0,
                       dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Random decoder-half parameters in this package's layout."""
    return params_from_jax(_random_tree(cfg, num_filters, seed),
                           dtype=dtype, device=device)


def write_random_mimi_gguf(path: Union[str, Path], seed: int = 0,
                           cfg: MimiConfig = MimiConfig(),
                           num_filters: int = 64) -> None:
    """A decode-only Mimi GGUF (F32) with random weights from `seed`,
    kyutai/mimi widths by default."""
    params = random_mimi_params(cfg, num_filters, seed)
    wr = GGUFWriter(path, "mimi")
    wr.add_name("Mimi")
    for key, val in (("codec.sample_rate", cfg.sample_rate),
                     ("codec.hop_size", cfg.hop_size),
                     ("codec.n_q", cfg.n_q),
                     ("codec.num_semantic_quantizers", cfg.n_sem),
                     ("codec.codebook_size", cfg.codebook_size),
                     ("codec.codebook_dim", cfg.codebook_dim),
                     ("codec.latent_dim", cfg.hidden),
                     ("codec.num_hidden_layers", cfg.n_layers),
                     ("codec.num_attention_heads", cfg.n_heads),
                     ("codec.head_dim", cfg.head_dim),
                     ("codec.intermediate_size", cfg.intermediate),
                     ("codec.attn_window", cfg.window or 0)):
        wr.add_uint32(key, val)
    wr.add_float32("codec.rope_theta", cfg.rope_theta)
    wr.add_bool("codec.has_encoder", False)
    wr.add_bool("codec.has_decoder", True)

    def add(name, x):
        wr.add_tensor(name, x.detach().float().cpu().numpy(), "F32")

    def add_wb(name, layer):
        add(f"{name}.w", layer["w"])
        if layer["b"] is not None:
            add(f"{name}.b", layer["b"])

    for i, cb in enumerate(params["cb_sem"]):
        add(f"q.s.layers.{i}.codebook.embed", cb)
    add("q.s.op.w", params["sem_op"])
    for i, cb in enumerate(params.get("cb_acu", ())):
        add(f"q.a.layers.{i}.codebook.embed", cb)
    if "acu_op" in params:
        add("q.a.op.w", params["acu_op"])
    add_wb("up.cv", params["up"])
    for li, lw in enumerate(params["dtr"]):
        for key, suffix in _LAYER_KEYS.items():
            add(f"dtr.l{li}.{suffix}", lw[key])
    add_wb("dec.l0.conv", params["dec_l0"])
    for li, stage in zip((2, 5, 8, 11), params["dec_stages"]):
        add_wb(f"dec.l{li}.conv", stage["tr"])
        add_wb(f"dec.l{li + 1}.block.1.conv", stage["r1"])
        add_wb(f"dec.l{li + 1}.block.3.conv", stage["r2"])
    add_wb("dec.l14.conv", params["dec_l14"])
    wr.write()
