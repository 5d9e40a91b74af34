"""The port's llama backbone (codec_tpu_torch/lm/backbone.py) against
codec_tpu's on the CPU: one GGUF per case, written by the port's
`write_random_backbone_gguf`, loaded by both packages.

Each case runs a 5-token prefill, a bucketed prefill (bucket 8) and 3
steps on both and compares the hiddens at rtol = atol = 1e-5 (the bound
of tests/test_qmat_pallas.py's packed-against-dense backbone test; the
two run the same f32 math with sums in another order). Q4_K needs every
input width to be a multiple of 256, so its cases use hidden 256.
"""

import dataclasses

import numpy as np
import pytest
import torch

from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu.lm.backbone import load_backbone_params as jax_load_params
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.lm.backbone import (BackboneConfig, LlamaBackbone,
                                         load_backbone_params,
                                         params_from_reference)
from codec_tpu_torch.models.lm_init import LLAMA_3_2_1B, write_random_backbone_gguf

SMALL = dataclasses.replace(LLAMA_3_2_1B, hidden=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, head_dim=16, ffn_dim=128,
                            vocab_size=300, max_ctx=32)
WIDE = dataclasses.replace(SMALL, hidden=256, head_dim=64, ffn_dim=512)
QWEN3 = dataclasses.replace(SMALL, rope_theta=1e6, has_qk_norm=True,
                            has_attn_bias=True, tied_lm_head=False)

# (id, qtype, quantized, llama3 freq factors, config)
CASES = [
    ("f32", "F32", False, True, SMALL),
    ("f32-noff", "F32", False, False, SMALL),
    ("q8_0-packed", "Q8_0", True, True, SMALL),
    ("q8_0-packed-noff", "Q8_0", True, False, SMALL),
    ("q8_0-dense", "Q8_0", False, True, SMALL),
    ("q4_k-packed", "Q4_K", True, True, WIDE),
    ("q4_k-packed-noff", "Q4_K", True, False, WIDE),
    ("q4_k-dense", "Q4_K", False, False, WIDE),
    ("qwen3-q8_0-packed", "Q8_0", True, False, QWEN3),
    ("qwen3-f32", "F32", False, False, QWEN3),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _write(tmp_path, qtype, ff, cfg, seed=0):
    path = tmp_path / f"bb_{qtype}.gguf"
    write_random_backbone_gguf(path, seed=seed, qtype=qtype, cfg=cfg,
                               rope_scaling=None if not ff else
                               {"factor": 32.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 16})
    return path


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backbone_matches_reference(tmp_path, case):
    _, qtype, quantized, ff, cfg = case
    path = _write(tmp_path, qtype, ff, cfg)
    port = LlamaBackbone(path, quantized=quantized, device="cpu")
    ref = JaxBackbone(str(path), quantized=quantized)
    packed = quantized and qtype != "F32"
    assert all(isinstance(lw[k], dict) == packed
               for lw in port.params["layers"] for k in ("q", "down"))
    assert (port.params["freq_factors"] is None) == (not ff)

    rng = np.random.default_rng(1)
    h = cfg.hidden
    prompt = (rng.standard_normal((5, h)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(port.prefill(prompt), ref.prefill(prompt), **TOL)
    port.reset()
    ref.reset()
    np.testing.assert_allclose(port.prefill(prompt, bucket=8),
                               ref.prefill(prompt, bucket=8), **TOL)
    assert port.pos == ref.pos == 5
    for _ in range(3):
        x = (rng.standard_normal(h) * 0.3).astype(np.float32)
        got, want = port.step(x), ref.step(x)
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(port.text_logits(got), ref.text_logits(want),
                               rtol=1e-4, atol=1e-4)
    ids = [0, 7, 299]
    np.testing.assert_array_equal(port.embed_tokens(ids), ref.embed_tokens(ids))


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_K"])
def test_params_from_reference_bit_exact(tmp_path, qtype):
    """codec_tpu's stacked, group-minor packed tree → the port's layout,
    equal to what the port loads from the same file."""
    import jax

    cfg = WIDE if qtype == "Q4_K" else QWEN3
    path = _write(tmp_path, qtype, True, cfg)
    jcfg = JaxBackbone(str(path)).cfg
    tree = jax.tree_util.tree_map(
        np.asarray, jax_load_params(JaxReader(str(path)), jcfg, quantized=True))
    got = params_from_reference(cfg, tree)
    want = load_backbone_params(GGUFReader(path), cfg, quantized=True,
                                device="cpu")
    assert sorted(got) == sorted(want)
    assert len(got["layers"]) == cfg.n_layers
    for key in ("tok_embd", "out_norm", "freq_factors"):
        assert torch.equal(got[key], want[key])
    if not cfg.tied_lm_head:
        assert torch.equal(got["lm_head"], want["lm_head"])
    for lg, lw in zip(got["layers"], want["layers"]):
        assert sorted(lg) == sorted(lw)
        for k, v in lw.items():
            if isinstance(v, dict):
                assert sorted(lg[k]) == sorted(v)
                for n in v:
                    assert lg[k][n].dtype == v[n].dtype
                    assert torch.equal(lg[k][n], v[n]), (k, n)
            else:
                assert torch.equal(lg[k], v), k


def test_from_params_shares_weights(tmp_path):
    path = _write(tmp_path, "Q8_0", True, SMALL)
    a = LlamaBackbone(path, quantized=True, device="cpu")
    b = LlamaBackbone.from_params(a.cfg, a.params)
    x = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_array_equal(a.prefill(x), b.prefill(x))
    assert a.kv is not b.kv


MOE = dataclasses.replace(QWEN3, has_attn_bias=False, n_experts=8,
                          n_experts_used=2, moe_ffn_dim=32)
# (id, qtype, quantized, config): the attention packed or dense; codec_tpu
# loads the experts dense either way
MOE_CASES = [
    ("f32-norm", "F32", False, MOE),
    ("f32-raw", "F32", False, dataclasses.replace(MOE, norm_topk_prob=False)),
    ("q4_k-packed", "Q4_K", True,
     dataclasses.replace(MOE, hidden=256, head_dim=64, n_experts=16,
                         n_experts_used=4)),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_backbone_matches_reference(tmp_path, case):
    """A Qwen3-MoE backbone: a 6-token prefill (T·k >= E: codec_tpu's dense
    form), 4 steps (the gathered form) and a bucketed prefill against
    codec_tpu at rtol = atol = 1e-5."""
    _, qtype, quantized, cfg = case
    path = _write(tmp_path, qtype, False, cfg)
    port = LlamaBackbone(path, quantized=quantized, device="cpu")
    ref = JaxBackbone(str(path), quantized=quantized)
    lw = port.params["layers"][0]
    assert isinstance(lw["q"], dict) == quantized and "gate" not in lw
    assert tuple(lw["gate_exps"].shape) == (cfg.n_experts, cfg.moe_ffn_dim,
                                           cfg.hidden)
    rng = np.random.default_rng(3)
    prompt = (rng.standard_normal((6, cfg.hidden)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(port.prefill(prompt), ref.prefill(prompt), **TOL)
    for _ in range(4):
        x = (rng.standard_normal(cfg.hidden) * 0.3).astype(np.float32)
        np.testing.assert_allclose(port.step(x), ref.step(x), **TOL)
    port.reset()
    ref.reset()
    np.testing.assert_allclose(port.prefill(prompt[:3], bucket=8),
                               ref.prefill(prompt[:3], bucket=8), **TOL)


@pytest.mark.parametrize("t", [1, 2, 8], ids=["gather", "gather-t2", "dense"])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "raw"])
def test_moe_ffn_matches_reference(t, norm):
    """_moe_ffn on T tokens (T·k < E gathers the chosen experts; else the
    dense form), the top-k weights renormalized or not, against codec_tpu's
    _moe_ffn at rtol = atol = 1e-5; both forms against each other."""
    import jax.numpy as jnp

    from codec_tpu.lm.backbone import _moe_ffn as jax_moe_ffn
    from codec_tpu_torch.lm.backbone import _moe_ffn

    cfg = dataclasses.replace(MOE, n_experts=8, n_experts_used=3,
                              norm_topk_prob=norm)
    rng = np.random.default_rng(4)
    lw = {"router": rng.standard_normal((8, 64)) * 0.5,
          "gate_exps": rng.standard_normal((8, 32, 64)) * 0.2,
          "up_exps": rng.standard_normal((8, 32, 64)) * 0.2,
          "down_exps": rng.standard_normal((8, 64, 32)) * 0.2}
    lw = {k: v.astype(np.float32) for k, v in lw.items()}
    h = (rng.standard_normal((t, 64))).astype(np.float32)
    tw = {k: torch.from_numpy(v) for k, v in lw.items()}
    got = _moe_ffn(torch.from_numpy(h), tw, cfg).numpy()
    want = np.asarray(jax_moe_ffn(jnp.asarray(h), {k: jnp.asarray(v)
                                                   for k, v in lw.items()}, cfg))
    np.testing.assert_allclose(got, want, **TOL)
    # the other form on the same tokens: one token at a time gathers, all
    # eight at once run dense
    one = np.concatenate([_moe_ffn(torch.from_numpy(h[i:i + 1]), tw,
                                   cfg).numpy() for i in range(t)])
    np.testing.assert_allclose(one, got, **TOL)


def test_moe_tie_rule_matches_reference():
    """Equal router probabilities at the k-th place: the lower expert index
    is taken, as lax.top_k takes it (a stable descending sort)."""
    import jax.numpy as jnp

    from codec_tpu.lm.backbone import _moe_ffn as jax_moe_ffn
    from codec_tpu_torch.lm.backbone import _moe_ffn

    cfg = dataclasses.replace(MOE, n_experts=6, n_experts_used=2)
    rng = np.random.default_rng(5)
    # experts 1, 3 and 4 tie for the top: 1 and 3 are taken
    router = np.zeros((6, 64), np.float32)
    router[[1, 3, 4], 0] = 1.0
    lw = {"router": router,
          "gate_exps": rng.standard_normal((6, 32, 64)).astype(np.float32),
          "up_exps": rng.standard_normal((6, 32, 64)).astype(np.float32),
          "down_exps": rng.standard_normal((6, 64, 32)).astype(np.float32)}
    h = np.zeros((1, 64), np.float32)
    h[0, 0], h[0, 1:] = 2.0, rng.standard_normal(63)
    got = _moe_ffn(torch.from_numpy(h), {k: torch.from_numpy(v)
                                         for k, v in lw.items()}, cfg).numpy()
    want = np.asarray(jax_moe_ffn(jnp.asarray(h), {k: jnp.asarray(v)
                                                   for k, v in lw.items()}, cfg))
    np.testing.assert_allclose(got, want, **TOL)
    taken = dict(lw, gate_exps=lw["gate_exps"].copy())
    taken["gate_exps"][4] = 0.0            # expert 4 is not taken: no change
    np.testing.assert_array_equal(_moe_ffn(
        torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in
                              taken.items()}, cfg).numpy(), got)


def test_moe_writer_and_carry_over(tmp_path):
    """The MoE writer's KVs and tensors (F32 router, F16 stacked experts, no
    dense FFN) as codec_tpu reads them, and codec_tpu's stacked [L, E, ...]
    tree carried across equal to the port's load."""
    import jax

    cfg = MOE_CASES[2][3]
    path = _write(tmp_path, "Q4_K", False, cfg)
    r = GGUFReader(path)
    assert r.tensors["backbone.l0.router.w"].type_name == "F32"
    assert r.tensors["backbone.l1.down_exps.w"].type_name == "F16"
    assert "backbone.l0.gate.w" not in r.tensors
    got = dataclasses.asdict(BackboneConfig.from_gguf(r))
    jbb = JaxBackbone(str(path))
    assert got == dataclasses.asdict(jbb.cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_load_params(JaxReader(str(path)), jbb.cfg,
                                    quantized=True))
    assert tree["layers"]["gate_exps"].shape == (cfg.n_layers, cfg.n_experts,
                                                 cfg.moe_ffn_dim, cfg.hidden)
    mine = params_from_reference(cfg, tree)
    want = load_backbone_params(r, cfg, quantized=True, device="cpu")
    for lg, lw in zip(mine["layers"], want["layers"]):
        assert sorted(lg) == sorted(lw)
        for k, v in lw.items():
            if isinstance(v, dict):
                assert all(torch.equal(lg[k][n], v[n]) for n in v), k
            else:
                assert torch.equal(lg[k], v), k


def test_not_a_backbone_and_context_full(tmp_path):
    path = tmp_path / "codec.gguf"
    w = GGUFWriter(path, "mimi")
    w.add_tensor("x", np.zeros(4, np.float32))
    w.write()
    with pytest.raises(ValueError, match="not a backbone GGUF"):
        LlamaBackbone(path, device="cpu")
    bb = LlamaBackbone(_write(tmp_path, "F32", False, SMALL), device="cpu",
                       max_ctx=4)
    bb.prefill(np.zeros((3, 64), np.float32))
    with pytest.raises(ValueError, match="context full"):
        bb.prefill(np.zeros((2, 64), np.float32))
    # a bucket's pad is clamped to the context instead
    bb.reset()
    bb.prefill(np.zeros((3, 64), np.float32), bucket=8)
    assert bb.pos == 3


def test_config_from_gguf_matches_reference(tmp_path):
    path = _write(tmp_path, "F32", True, QWEN3)
    got = dataclasses.asdict(BackboneConfig.from_gguf(GGUFReader(path)))
    want = dataclasses.asdict(JaxBackbone(str(path)).cfg)
    assert got == want
