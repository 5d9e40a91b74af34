"""Each op of codec_tpu_torch.ops against its codec_tpu.ops counterpart on
the CPU, on the same NumPy inputs. f32 bound: atol 1e-5 (rtol 1e-5 where
values grow past 1) — both compute in f32, in different summation orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.ops import act as jact
from codec_tpu.ops import attn as jattn
from codec_tpu.ops import conv as jconv
from codec_tpu.ops import norms as jnorms
from codec_tpu.ops import rope as jrope
from codec_tpu.ops import rvq as jrvq
from codec_tpu_torch.ops import act, attn, conv, norms, rope, rvq

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


T = torch.from_numpy


@pytest.mark.parametrize("name", ["elu", "gelu_erf"])
def test_activations(name):
    x = _rand(np.random.default_rng(0), 2, 50, 16, scale=3.0)
    _close(getattr(act, name)(T(x)), getattr(jact, name)(jnp.asarray(x)))


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, g, b = _rand(rng, 2, 30, 64, scale=2.0), _rand(rng, 64), _rand(rng, 64)
    _close(norms.layer_norm(T(x), T(g), T(b), 1e-5),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             1e-5))


@pytest.mark.parametrize("batched_pos", [False, True])
def test_apply_rope_neox(batched_pos):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 3, 64, 32)
    pos = None
    if batched_pos:
        pos = np.stack([np.arange(64), np.arange(64) + 7]).astype(np.int32)
    kw = dict(theta=10000.0, freq_scale=0.5)
    got = rope.apply_rope(T(x), None if pos is None else T(pos), **kw)
    want = jrope.apply_rope(jnp.asarray(x),
                            None if pos is None else jnp.asarray(pos),
                            neox=True, **kw)
    _close(got, want)


def test_apply_rope_keeps_bf16():
    x = torch.randn(1, 2, 8, 16).to(torch.bfloat16)
    assert rope.apply_rope(x).dtype == torch.bfloat16


def test_rvq_decode_sum_partial_levels():
    rng = np.random.default_rng(3)
    cbs = _rand(rng, 6, 64, 32)
    codes = rng.integers(0, 64, (2, 11, 6)).astype(np.int32)
    got = rvq.rvq_decode_sum(T(codes), T(cbs), n_q=4)
    want = jrvq.rvq_decode_sum(jnp.asarray(codes), jnp.asarray(cbs), n_q=4)
    _close(got, want)


@pytest.mark.parametrize("k,stride,dilation", [
    (7, 1, 1), (3, 1, 1), (1, 1, 1), (3, 1, 3), (8, 4, 1), (4, 2, 1),
])
def test_conv1d_causal(k, stride, dilation):
    rng = np.random.default_rng(4)
    x, w, b = _rand(rng, 2, 37, 12), _rand(rng, k, 12, 10, scale=0.3), _rand(rng, 10)
    got = conv.conv1d_causal(T(x), T(w), T(b), stride=stride,
                             dilation=dilation)
    want = jconv.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, dilation=dilation)
    assert got.shape == want.shape
    _close(got, want)


def test_conv1d_padded():
    rng = np.random.default_rng(5)
    x, w = _rand(rng, 1, 20, 6), _rand(rng, 5, 6, 4, scale=0.3)
    _close(conv.conv1d(T(x), T(w), padding=2),
           jconv.conv1d(jnp.asarray(x), jnp.asarray(w), padding=2))


@pytest.mark.parametrize("stride", [2, 4, 5, 6, 8])
def test_convtr1d_causal(stride):
    rng = np.random.default_rng(6)
    k = 2 * stride
    x, b = _rand(rng, 2, 13, 12), _rand(rng, 10)
    w_iok = _rand(rng, 12, 10, k, scale=0.3)          # ConvTranspose1d layout
    w = jconv.prepare_convtr_weight(w_iok)            # pre-flipped WIO
    np.testing.assert_array_equal(
        conv.prepare_convtr_weight(T(w_iok)).numpy(), np.asarray(w))
    got = conv.convtr1d_causal(T(x), T(np.array(w)), T(b), stride=stride)
    want = jconv.convtr1d_causal(jnp.asarray(x), w, jnp.asarray(b),
                                 stride=stride)
    assert got.shape == want.shape == (2, 13 * stride, 10)
    _close(got, want)
    # the channels-first form on PyTorch's own layout is the same function
    cf = conv.convtr1d_causal_cf(T(x).transpose(1, 2), T(w_iok), T(b),
                                 stride=stride)
    _close(cf.transpose(1, 2), want)


def test_convtr1d_padding():
    rng = np.random.default_rng(7)
    x, w = _rand(rng, 1, 9, 4), _rand(rng, 6, 4, 3, scale=0.3)
    _close(conv.convtr1d(T(x), T(w), stride=3, padding=1),
           jconv.convtr1d(jnp.asarray(x), jnp.asarray(w), stride=3, padding=1))


def test_prepare_conv_weight():
    w = _rand(np.random.default_rng(8), 10, 12, 7)
    np.testing.assert_array_equal(conv.prepare_conv_weight(T(w)).numpy(),
                                  np.asarray(jconv.prepare_conv_weight(w)))


@pytest.mark.parametrize("causal,window,with_n_valid", [
    (True, None, False), (True, 5, False), (False, None, True), (True, 4, True),
])
def test_attn_mask(causal, window, with_n_valid):
    nv = np.array([6, 9], np.int32) if with_n_valid else None
    got = attn.attn_mask(9, 12, causal=causal, window=window,
                         n_valid=None if nv is None else T(nv))
    want = jattn.attn_mask(9, 12, causal=causal, window=window,
                           n_valid=None if nv is None else jnp.asarray(nv))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sdpa_masked():
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, 2, 3, 40, 16) for _ in range(3))
    m = jattn.attn_mask(40, 40, causal=True, window=7)
    got = attn.sdpa(T(q), T(k), T(v), mask=T(np.array(m)))
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=m)
    _close(got, want)


@pytest.mark.parametrize("window,causal,n_valid", [
    (6, True, None),             # window < T → flash wrapper (plain on CPU)
    (None, True, None),          # pure causal
    (None, False, [20, 13]),     # non-causal with n_valid → masked sdpa
    (6, True, [20, 13]),         # causal with n_valid → masked sdpa
])
def test_mha(window, causal, n_valid):
    rng = np.random.default_rng(10)
    b, t, c, h, d = 2, 20, 32, 4, 8
    x = _rand(rng, b, t, c)
    wq, wk, wv = (_rand(rng, h * d, c, scale=0.2) for _ in range(3))
    wo = _rand(rng, c, h * d, scale=0.2)
    nv = None if n_valid is None else np.array(n_valid, np.int32)
    kw = dict(n_heads=h, causal=causal, window=window)
    got = attn.mha(T(x), T(wq), T(wk), T(wv), T(wo),
                   rope_fn=rope.apply_rope,
                   n_valid=None if nv is None else T(nv), **kw)
    want = jattn.mha(*(jnp.asarray(a) for a in (x, wq, wk, wv, wo)),
                     rope_fn=jrope.apply_rope,
                     n_valid=None if nv is None else jnp.asarray(nv), **kw)
    _close(got, want)
