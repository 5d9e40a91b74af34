"""The port's RVQ search and the encode path's small ops (codec_tpu_torch)
against codec_tpu's on the CPU.

On a CPU tensor `rvq_encode_fused` runs its plain version (ops/rvq.py), so
these tests hold the plain version, which the card holds the CUDA kernel
against, to codec_tpu's lax.scan search and to its Pallas kernel in
interpret mode. Codes must be equal: the seeded shapes have no near-ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.ops import conv as jconv
from codec_tpu.ops import norms as jnorms
from codec_tpu.ops import rvq as jrvq
from codec_tpu.ops.rvq_pallas import rvq_encode_fused as jrvq_fused
from codec_tpu_torch.ops import conv, norms, rvq, rvq_cuda
from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
from encode_ties import assert_codes, euclid_margin
from tf32_split import rvq_encode_split, split, tf32_rna


def _inputs(b, t, d, q, v, seed=0, x_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, d)) * x_scale).astype(np.float32)
    cb = (rng.standard_normal((q, v, d)) * 0.5).astype(np.float32)
    return x, cb


def _port(x, cb, fn=rvq.rvq_encode):
    return fn(torch.from_numpy(x), torch.from_numpy(cb)).numpy()


# the shapes of tests/test_rvq_pallas.py: unaligned everything, Mimi-like,
# V and D no multiple of 128
@pytest.mark.parametrize("b,t,d,q,v", [
    (1, 7, 32, 4, 64),
    (2, 200, 256, 8, 1024),
    (1, 130, 96, 3, 100),
])
def test_plain_matches_jax_scan_and_pallas_kernel(b, t, d, q, v):
    x, cb = _inputs(b, t, d, q, v)
    want = np.asarray(jrvq.rvq_encode(jnp.asarray(x), jnp.asarray(cb)))
    kernel = np.asarray(jrvq_fused(jnp.asarray(x), jnp.asarray(cb),
                                   interpret=True))
    got = _port(x, cb)
    assert got.dtype == np.int32 and got.shape == (b, t, q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernel)


# the kernel's split-f32 scores (tests/tf32_split.py) on the shapes above:
# codes equal to codec_tpu's scan and to its Pallas kernel, or differing
# only at f64 near-ties (tests/encode_ties.py)
@pytest.mark.parametrize("b,t,d,q,v", [
    (1, 7, 32, 4, 64),
    (2, 200, 256, 8, 1024),
    (1, 130, 96, 3, 100),
])
def test_split_scores_match_jax_scan_and_pallas_kernel(b, t, d, q, v):
    x, cb = _inputs(b, t, d, q, v)
    want = np.asarray(jrvq.rvq_encode(jnp.asarray(x), jnp.asarray(cb)))
    kernel = np.asarray(jrvq_fused(jnp.asarray(x), jnp.asarray(cb),
                                   interpret=True))
    got = rvq_encode_split(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    assert got.dtype == np.int32 and got.shape == (b, t, q)
    x64, cb64 = x.astype(np.float64).reshape(b * t, d), cb.astype(np.float64)
    g = got.reshape(b * t, q)
    for ref in (want, kernel):
        w = ref.reshape(b * t, q)
        assert_codes(g, w, lambda fr, lvl: euclid_margin(
            x64[fr], cb64, w[fr, :lvl], g[fr, lvl], w[fr, lvl]))


@pytest.mark.parametrize("dup", [False, True])
def test_split_scores_are_exact_on_integer_inputs(dup):
    """Small integers split with lo = 0: every product and sum is exact, so
    the split search gives the plain version's codes bit for bit (and the
    lower copy of a duplicated row)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-3, 4, (2, 60, 48)).astype(np.float32)
    cb = rng.integers(-3, 4, (5, 40, 48)).astype(np.float32)
    if dup:
        cb[:, 20:] = cb[:, :20]
    hi, lo = split(torch.from_numpy(cb))
    assert torch.equal(hi, torch.from_numpy(cb)) and not lo.any()
    got = rvq_encode_split(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, _port(x, cb))
    assert got.max() < (20 if dup else 40)


def test_tf32_split_rounds_to_nearest_and_keeps_21_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                      3.0e-5, -123.456], dtype=torch.float32)
    hi = tf32_rna(x)
    # ties go away from zero, as cvt.rna
    assert hi.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                               -(1.0 + 2 ** -10)]
    h, lo = split(x)
    rel = ((h.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert rel.max() < 2 ** -20


def test_norms_argument_gives_the_same_codes():
    x, cb = _inputs(2, 30, 32, 3, 50, seed=10)
    tx, tcb = torch.from_numpy(x), torch.from_numpy(cb)
    nrm = rvq.codebook_norms(tcb)
    assert torch.equal(rvq_encode_fused(tx, tcb, norms=nrm),
                       rvq_encode_fused(tx, tcb))
    assert torch.equal(rvq.rvq_encode(tx, tcb, nrm), rvq.rvq_encode(tx, tcb))


# the launch plan on an H100 (227 KB of shared memory a block, 15 clusters
# of 8 held at once: tools/rvq_phases.py), and the frame count the sweep
# measured fastest at each N (PERF.md §6: 16 at N 16 and 128, 32 at 250
# and 1000)
H100_SMEM = 232448


@pytest.mark.parametrize("n,d,want", [
    (250, 256, 32),
    (1000, 256, 32),
    (16, 256, 16),
    (1, 256, 16),
    (240, 256, 16),
    (241, 256, 32),
])
def test_plan_per_shape(n, d, want):
    assert rvq_cuda.plan(n, d, H100_SMEM) == want


def test_plan_leaves_out_partitions_that_do_not_fit():
    # D 352: 32 frames' residual no longer fits beside the stages
    assert rvq_cuda.smem_bytes(32, 352) > H100_SMEM >= rvq_cuda.smem_bytes(16, 352)
    assert rvq_cuda.plan(250, 352, H100_SMEM) == 16
    # D 512 (and up to 2560): 8 frames, the winners' rows read from L2
    assert rvq_cuda.smem_bytes(16, 512) > H100_SMEM >= rvq_cuda.smem_bytes(8, 512)
    assert rvq_cuda.plan(250, 512, H100_SMEM) == 8
    assert rvq_cuda.plan(1, 2560, H100_SMEM) == 8
    with pytest.raises(ValueError, match="shared memory"):
        rvq_cuda.plan(250, 2592, H100_SMEM)


@pytest.mark.parametrize("frames,d,want", [
    (32, 256, 203848), (16, 256, 184408), (32, 32, 117832), (16, 96, 153688),
    (8, 512, 100952), (8, 2560, 232024)])
def test_smem_bytes_per_shape(frames, d, want):
    """csrc/rvq_encode.cu::layout: stages of 256 x 32 f32, hi and lo [F][dp]
    f32, the rows [F][dp] f32 (8 frames: [F] int), candidates, barriers,
    1024 to align."""
    assert rvq_cuda.smem_bytes(frames, d) == want


def test_rows_past_v_are_never_chosen():
    """V = 5 with inputs near 0 (the Pallas kernel pads V with +inf norms;
    the port's kernel never reads past V)."""
    x, cb = _inputs(1, 9, 16, 2, 5, seed=1, x_scale=1e-6)
    got = _port(x, cb)
    assert got.min() >= 0 and got.max() < 5
    np.testing.assert_array_equal(
        got, np.asarray(jrvq_fused(jnp.asarray(x), jnp.asarray(cb),
                                   interpret=True)))


def test_duplicated_rows_go_to_the_lowest_index():
    """Every row appears twice (v and v + V/2): the first maximum wins."""
    x, cb = _inputs(2, 40, 32, 4, 32, seed=2)
    cb[:, 16:] = cb[:, :16]
    got = _port(x, cb)
    assert got.max() < 16
    np.testing.assert_array_equal(
        got, np.asarray(jrvq.rvq_encode(jnp.asarray(x), jnp.asarray(cb))))


def test_layer_encode_matches_jax():
    x, cb = _inputs(2, 30, 24, 1, 50, seed=3)
    idx, res = rvq.rvq_layer_encode(torch.from_numpy(x),
                                    torch.from_numpy(cb[0]))
    jidx, jres = jrvq.rvq_layer_encode(jnp.asarray(x), jnp.asarray(cb[0]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


def test_wrapper_on_cpu_runs_the_plain_version():
    x, cb = _inputs(1, 20, 32, 3, 40, seed=4)
    before = rvq_encode_fused.launches
    got = _port(x, cb, rvq_encode_fused)
    assert rvq_encode_fused.launches == before
    np.testing.assert_array_equal(got, _port(x, cb))


def test_wrapper_has_no_kernel_for_other_devices():
    x = torch.zeros((1, 4, 8), device="meta")
    cb = torch.zeros((2, 5, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        rvq_encode_fused(x, cb)


def test_import_builds_nothing():
    from codec_tpu_torch.ops import rvq_cuda

    x, cb = _inputs(1, 3, 8, 1, 4, seed=5)
    _port(x, cb, rvq_encode_fused)
    assert rvq_cuda._lib.cache_info().currsize == 0


def test_phases_tool_instruments_the_kernel_source():
    """tools/rvq_phases.py finds every phase boundary in csrc/rvq_encode.cu
    (it raises when the kernel's text moved) and passes the timers out."""
    from codec_tpu_torch.tools import rvq_phases

    src = rvq_phases.instrumented_source()
    for i in range(len(rvq_phases.PHASES)):
        assert src.count(f"PHASE({i});") == 1
    assert "unsigned long long* prof" in src
    assert "rvq_phases_max_clusters" in src


def test_phases_tool_builds_the_presplit_variant():
    """--variant presplit loads A's hi and lo by ldmatrix and splits
    nothing in the scoring loop; the rest of the copy is the same."""
    from codec_tpu_torch.tools import rvq_phases

    split = rvq_phases.instrumented_source()
    pre = rvq_phases.instrumented_source("presplit")
    assert split.count("split(__uint_as_float(raw[u])") == 1
    assert "split(__uint_as_float(raw[u])" not in pre
    assert pre.count("ldsm_x4(l[t], a_at);") == 1
    assert pre.replace(rvq_phases._PRESPLIT_A, rvq_phases._SPLIT_A) == split


def test_ab_tool_imports_a_second_tree_beside_this_one():
    """tools/ab_requests.py loads another tree's package under its own name:
    its modules are that tree's, not this one's."""
    from pathlib import Path

    import codec_tpu_torch
    from codec_tpu_torch.tools.ab_requests import import_tree

    root = Path(codec_tpu_torch.__file__).resolve().parent.parent
    other = import_tree(root, "codec_tpu_torch_second_tree")
    import importlib

    mod = importlib.import_module("codec_tpu_torch_second_tree.ops.rvq_cuda")
    assert other.__name__ == "codec_tpu_torch_second_tree"
    assert mod is not rvq_cuda and mod.plan(250, 256, H100_SMEM) == 32
    assert mod.rvq_encode_fused.launches == 0


def test_decode_sum_matches_jax():
    rng = np.random.default_rng(6)
    cb = rng.standard_normal((3, 20, 8)).astype(np.float32)
    codes = rng.integers(0, 20, (2, 11, 3)).astype(np.int32)
    want = np.asarray(jrvq.rvq_decode_sum(jnp.asarray(codes), jnp.asarray(cb)))
    got = rvq.rvq_decode_sum(torch.from_numpy(codes), torch.from_numpy(cb))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# Mimi's final downsample: k4 stride 2 with replicate padding (and stride 1
# for the padding alone); odd T puts a replicated frame on the right too
@pytest.mark.parametrize("stride,k,t", [(1, 4, 9), (2, 4, 9), (2, 4, 1),
                                        (2, 3, 7)])
def test_conv1d_causal_replicate_matches_jax(stride, k, t):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = (rng.standard_normal((k, 6, 5)) / np.sqrt(k * 6)).astype(np.float32)
    want = np.asarray(jconv.conv1d_causal(jnp.asarray(x), jnp.asarray(w), None,
                                          stride=stride, pad_mode="replicate"))
    got = conv.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w), None,
                             stride=stride, pad_mode="replicate").numpy()
    assert got.shape == want.shape == (2, -(-t // stride), 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    zeros = conv.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w), None,
                               stride=stride).numpy()
    assert not np.allclose(zeros, got)


def test_conv1d_causal_rejects_an_unknown_pad_mode():
    with pytest.raises(ValueError, match="pad_mode"):
        conv.conv1d_causal(torch.zeros(1, 4, 2), torch.zeros(3, 2, 2),
                           pad_mode="reflect")


@pytest.mark.parametrize("scale", [1.0, 1e-20])
def test_l2_normalize_matches_jax(scale):
    """Unit rows, and rows below eps (divided by eps, not their norm)."""
    x = (np.random.default_rng(8).standard_normal((3, 7, 8)) * scale).astype(
        np.float32)
    want = np.asarray(jnorms.l2_normalize(jnp.asarray(x)))
    got = norms.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * scale)
