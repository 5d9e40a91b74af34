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
from codec_tpu_torch.ops import conv, norms, rvq
from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused


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
