"""The port's Mimi streaming sessions (codec_tpu_torch) against codec_tpu's
on the CPU, and against the port's own full decode and encode.

Inputs come from NumPy seeds; both packages load one GGUF. Bounds:
- the stream helpers of ops/conv.py against codec_tpu/ops/conv.py's: 1e-6
  absolute (the same f32 sums in other orders);
- the carried-key attention against codec_tpu/models/mimi.py::
  _transformer_stream's masked einsum: atol 2e-5, rtol 1e-5 (the bound of
  tests/test_attn_pallas.py);
- chunked decode against the port's full decode: 2e-5 absolute (the bound
  of tests/test_mimi_parity.py's streaming test); against codec_tpu's
  streaming decode: the f32 bound of tests/test_torch_mimi.py;
- chunked encode codes: equal to codec_tpu's streaming codes and to the
  full encode's, or differing only at f64 near-ties (tests/encode_ties.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.ops import conv as jconv
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import mimi, mimi_init
from codec_tpu_torch.ops import attn_cuda, conv
from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                           flash_sdpa_window_ref)
from encode_ties import assert_codes, mimi_margin
from test_torch_encode import tiny_mimi  # noqa: F401  (a fixture)
from test_torch_mimi import SMALL, _assert_close_pcm, _codes, tiny  # noqa: F401

HOP = 1920


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny shapes: they gain nothing
    from more, and with several test workers sharing the cores their
    threads' spin-waits slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _chunks(n, size):
    return [(i, min(i + size, n)) for i in range(0, n, size)]


# -- the stream helpers of ops/conv.py ----------------------------------------

# (K, stride, dilation) as Mimi's convs use them: the k7 stems, the
# residual blocks' k3 and k1, the strided encoder convs (K = 2·stride) and
# the k4 stride-2 downsample
CONVS = [(7, 1, 1), (3, 1, 1), (1, 1, 1), (8, 4, 1), (10, 5, 1), (12, 6, 1),
         (16, 8, 1), (4, 2, 1)]
# the decoder's transposed convs (K = 2·stride): the x2 upsample, then 8/6/5/4
CONVTRS = [2, 8, 6, 5, 4]
STEPS = 12                # a stream of 12 strides
CHUNKS = [1, 3, STEPS]    # chunks of one stride, three strides, the whole


def _conv_case(k, stride, seed, c_in=3, c_out=4):
    x = _rand((2, c_in, STEPS * stride), seed)
    w = _rand((c_out, c_in, k), seed + 1, 0.5)
    b = _rand((c_out,), seed + 2, 0.1)
    return x, w, b


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("k,stride,dil", CONVS)
def test_conv_stream_matches_jax_and_full(k, stride, dil, chunk):
    x, w, b = _conv_case(k, stride, 0)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    carry = conv.conv1d_causal_stream_init_cf(2, 3, k, stride, dil)
    jcarry = jconv.conv1d_causal_stream_init(2, 3, k, stride, dil)
    got, want = [], []
    for lo, hi in _chunks(STEPS, chunk):
        y, carry = conv.conv1d_causal_stream_cf(
            tx[..., lo * stride:hi * stride], tw, tb, carry, stride, dil)
        jy, jcarry = jconv.conv1d_causal_stream(
            jnp.asarray(x[..., lo * stride:hi * stride].transpose(0, 2, 1)),
            jnp.asarray(w.transpose(2, 1, 0)), jnp.asarray(b), jcarry,
            stride, dil)
        got.append(y.numpy())
        want.append(np.asarray(jy).transpose(0, 2, 1))
        np.testing.assert_allclose(carry.numpy(),
                                   np.asarray(jcarry).transpose(0, 2, 1),
                                   atol=1e-6, rtol=0)
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    full = conv.conv1d_causal_cf(tx, tw, tb, stride=stride, dilation=dil)
    np.testing.assert_allclose(got, full.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("stride", CONVTRS)
@pytest.mark.parametrize("bias", [True, False])
def test_convtr_stream_matches_jax_and_full(stride, chunk, bias):
    """The overlap tail is carried bias-free; the bias lands once per
    emitted sample (the x2 upsample has none)."""
    k = 2 * stride
    x = _rand((2, 3, STEPS), 3)
    w = _rand((3, 4, k), 4, 0.5)                  # [C_in, C_out, K]
    b = _rand((4,), 5, 0.1) if bias else None
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tb = torch.from_numpy(b) if bias else None
    jw = jconv.prepare_convtr_weight(w)
    carry = conv.convtr1d_causal_stream_init_cf(2, 4, k, stride)
    jcarry = jconv.convtr1d_causal_stream_init(2, 4, k, stride)
    got, want = [], []
    for lo, hi in _chunks(STEPS, chunk):
        y, carry = conv.convtr1d_causal_stream_cf(tx[..., lo:hi], tw, tb,
                                                  carry, stride)
        jy, jcarry = jconv.convtr1d_causal_stream(
            jnp.asarray(x[..., lo:hi].transpose(0, 2, 1)), jw,
            None if b is None else jnp.asarray(b), jcarry, stride)
        got.append(y.numpy())
        want.append(np.asarray(jy).transpose(0, 2, 1))
        np.testing.assert_allclose(carry.numpy(),
                                   np.asarray(jcarry).transpose(0, 2, 1),
                                   atol=1e-6, rtol=0)
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert got.shape == (2, 4, STEPS * stride)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    full = conv.convtr1d_causal_cf(tx, tw, tb, stride=stride)
    np.testing.assert_allclose(got, full.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_replicate_stream_matches_jax_and_full(chunk):
    """Mimi's k4 stride-2 downsample: the first chunk's left pad copies
    its first sample, later chunks carry history."""
    k, stride = 4, 2
    x, w, _ = _conv_case(k, stride, 6)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    carry = conv.conv1d_causal_stream_init_cf(2, 3, k, stride)
    jcarry = jconv.conv1d_causal_stream_init(2, 3, k, stride)
    got, want = [], []
    for lo, hi in _chunks(STEPS, chunk):
        y, carry = conv.conv1d_causal_stream_replicate_cf(
            tx[..., lo * stride:hi * stride], tw, None, carry, lo == 0, stride)
        jy, jcarry = jconv.conv1d_causal_stream_replicate(
            jnp.asarray(x[..., lo * stride:hi * stride].transpose(0, 2, 1)),
            jnp.asarray(w.transpose(2, 1, 0)), None, jcarry, lo == 0, stride)
        got.append(y.numpy())
        want.append(np.asarray(jy).transpose(0, 2, 1))
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    full = conv.conv1d_causal_cf(tx, tw, None, stride=stride,
                                 pad_mode="replicate")
    np.testing.assert_allclose(got, full.numpy(), atol=1e-6, rtol=0)


# -- the carried-key attention -------------------------------------------------

def _jax_stream_attention(q, k_ctx, v_ctx, pos0, window):
    """The masked attention of codec_tpu/models/mimi.py::_transformer_stream
    (its qpos, kpos, mask, einsums and softmax), on numpy inputs."""
    import jax

    tc, w1 = q.shape[2], k_ctx.shape[2] - q.shape[2]
    d = q.shape[-1]
    qpos = pos0 + jnp.arange(tc)
    kpos = pos0 - w1 + jnp.arange(w1 + tc)
    ok = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] >= 0)
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    mask = jnp.where(ok, 0.0, -1e30)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k_ctx,
                        preferred_element_type=jnp.float32)
    logits = logits * (d ** -0.5) + mask[None, None]
    wts = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", wts, v_ctx))


# (Tq, carried W-1, window, stream position of the chunk's first query):
# the 2-query step of a 1-frame chunk at the start (every carried slot
# masked), in the middle of the first window and past it; a 10-query
# step; SMALL's window 20
ATTN_STEPS = [(2, 249, 250, 0), (2, 249, 250, 100), (2, 249, 250, 600),
              (10, 249, 250, 240), (6, 19, 20, 4), (6, 19, 20, 50),
              (1, 19, 20, 19)]


@pytest.mark.parametrize("tq,w1,window,pos0", ATTN_STEPS)
def test_carried_key_attention_matches_jax_stream(tq, w1, window, pos0):
    rng = np.random.default_rng(pos0 + tq)
    q = rng.standard_normal((1, 2, tq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, w1 + tq, 64)).astype(np.float32)
            for _ in range(2))
    k_start = max(0, w1 - pos0)
    want = _jax_stream_attention(q, k, v, pos0, window)
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = flash_sdpa_window_ref(tq_, tk, tv, window=window, k_start=k_start)
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5, rtol=1e-5)
    launches = flash_sdpa_window.launches
    got = flash_sdpa_window(tq_, tk, tv, window=window, k_start=k_start)
    assert torch.equal(got, ref)                   # the CPU runs the plain
    assert flash_sdpa_window.launches == launches  # version, launches none


def test_equal_lengths_keep_the_self_attention_mask():
    """Tk == Tq with k_start 0 is the causal (+ window) mask of the decode
    and encode paths, unchanged."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 64)).astype(
        np.float32)) for _ in range(3))
    i = torch.arange(40)
    band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - 7)
    want = torch.softmax((q @ k.transpose(-1, -2)) / 8.0
                         + torch.where(band, 0.0, -1e30), -1) @ v
    got = flash_sdpa_window_ref(q, k, v, window=7)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("q_shape,k_shape,k_start,dtype,match", [
    ((1, 2, 4, 64), (1, 2, 3, 64), 0, None, "Tk >= Tq"),     # Tk < Tq
    ((1, 2, 4, 64), (1, 3, 9, 64), 0, None, "does not fit"),  # H differs
    ((1, 2, 4, 64), (2, 2, 9, 64), 0, None, "does not fit"),  # B differs
    ((1, 2, 4, 64), (1, 2, 9, 128), 0, None, "does not fit"),  # D differs
    ((1, 2, 4, 64), (1, 2, 9, 64), 6, None, "k_start"),      # past Tk - Tq
    ((1, 2, 4, 64), (1, 2, 9, 64), -1, None, "k_start"),
    ((1, 2, 4, 64), (1, 2, 9, 64), 0, torch.bfloat16, "does not fit"),
])
def test_kernel_arguments_are_checked(q_shape, k_shape, k_start, dtype, match):
    """The checks a CUDA launch makes first (they read only shapes and
    types, so they run on CPU tensors here)."""
    q = torch.zeros(q_shape)
    k = torch.zeros(k_shape, dtype=dtype or torch.float32)
    v = torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        attn_cuda._check(q, k, v, 250, k_start)


def test_kernel_arguments_pass_at_the_stream_shapes():
    q, k = torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 251, 64))
    for k_start in (0, 100, 249):
        attn_cuda._check(q, k, k, 250, k_start)


# -- decode sessions -----------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A random Mimi at SMALL's widths (window 20) with its encoder."""
    path = tmp_path_factory.mktemp("mimi_stream") / "small.gguf"
    mimi_init.write_random_mimi_gguf(path, seed=1, cfg=SMALL, num_filters=8,
                                     encoder=True)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _stream(session, x, chunk, axis=0):
    n = x.shape[axis]
    return np.concatenate(
        [session.push(np.take(x, range(lo, hi), axis=axis))
         for lo, hi in _chunks(n, chunk)], axis=axis)


@pytest.mark.parametrize("which,t", [("tiny", 24), ("small", 30)])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_streaming_decode_matches_jax_and_full(request, which, t, chunk):
    """SMALL's 30 frames are 60 transformer frames, past its window of 20:
    the carry rolls; the tiny HF Mimi's window is 250."""
    fx = request.getfixturevalue(which)
    codes = _codes((t, 4), 64, 11)
    got = _stream(fx["port"].streaming_decoder(), codes, chunk)
    assert got.shape == (t * HOP,) and got.dtype == np.float32
    full = fx["port"].decode(codes)
    assert np.abs(got - full).max() < 2e-5
    _assert_close_pcm(got, _stream(fx["jax"].streaming_decoder(), codes,
                                   chunk))


@pytest.mark.parametrize("which", ["tiny", "small"])
def test_streaming_decode_partial_nq_matches_jax(request, which):
    fx = request.getfixturevalue(which)
    codes = _codes((12, 4), 64, 12)
    for n_q in (1, 2):
        got = _stream(fx["port"].streaming_decoder(n_q=n_q), codes, 4)
        assert np.abs(got - fx["port"].decode(codes, n_q=n_q)).max() < 2e-5
        _assert_close_pcm(got, _stream(fx["jax"].streaming_decoder(n_q=n_q),
                                       codes, 4))


def test_streaming_decode_batch_and_reset(small):
    p = small["port"]
    codes = _codes((2, 26, 4), 64, 13)
    dec = p.streaming_decoder(batch=2)
    got = _stream(dec, codes, 5, axis=1)
    assert got.shape == (2, 26 * HOP)
    assert np.abs(got - p.decode(codes)).max() < 2e-5
    _assert_close_pcm(got, _stream(small["jax"].streaming_decoder(batch=2),
                                   codes, 5, axis=1))
    dec.reset()
    assert dec.state["pos"] == 0
    np.testing.assert_array_equal(dec.push(codes[:, :5]), got[:, :5 * HOP])


def test_streaming_decoder_rejects_bad_pushes(small):
    dec = small["port"].streaming_decoder(n_q=3)
    for bad in (np.zeros((0, 4), np.int32), np.zeros((2, 2), np.int32),
                np.zeros((2, 3, 4), np.int32), np.zeros(4, np.int32)):
        with pytest.raises(CodecError):
            dec.push(bad)
    for kw in ({"n_q": 5}, {"n_q": -1}, {"batch": 0}):
        with pytest.raises(CodecError):
            small["port"].streaming_decoder(**kw)


# -- encode sessions -----------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_streaming_encode_matches_jax_and_full(tiny_mimi, chunk):  # noqa: F811
    """12 frames in chunks of 1, 3 and 5 hops (the last chunk shorter);
    codes against codec_tpu's streaming codes and the full encode."""
    j, p = tiny_mimi["jax"], tiny_mimi["port"]
    pcm = _rand(12 * HOP, 20, 0.1)
    got = _stream(p.streaming_encoder(), pcm, chunk * HOP)
    assert got.shape == (12, 4) and got.dtype == np.int32
    full = p.encode(pcm)
    margin = mimi_margin(p.params, p.cfg, pcm, full, got)
    assert_codes(got, full, margin)
    want = _stream(j.streaming_encoder(), pcm, chunk * HOP)
    assert_codes(got, np.asarray(want, np.int32),
                 mimi_margin(p.params, p.cfg, pcm, want, got))


def test_streaming_encode_int16_and_window(small):
    """int16 chunks past SMALL's window of 20 (36 frames = 72 transformer
    frames), batch 2, against the full encode of the same int16 PCM and
    codec_tpu's stream."""
    p, j = small["port"], small["jax"]
    pcm = (_rand((2, 36 * HOP), 21, 0.1) * 32767).astype(np.int16)
    got = _stream(p.streaming_encoder(batch=2), pcm, 3 * HOP, axis=1)
    want = _stream(j.streaming_encoder(batch=2), pcm, 3 * HOP, axis=1)
    full = p.encode(pcm)
    for b in range(2):
        x = pcm[b].astype(np.float32) / 32768.0
        assert_codes(got[b], full[b], mimi_margin(p.params, p.cfg, x, full[b],
                                                  got[b]))
        assert_codes(got[b], np.asarray(want[b], np.int32),
                     mimi_margin(p.params, p.cfg, x, want[b], got[b]))


def test_streaming_encode_partial_nq_and_reset(small):
    p = small["port"]
    pcm = _rand(8 * HOP, 22, 0.1)
    enc = p.streaming_encoder(n_q=2)
    a = _stream(enc, pcm, 2 * HOP)
    assert a.shape == (8, 2)
    full = p.encode(pcm, n_q=2)
    assert_codes(a, full, mimi_margin(p.params, p.cfg, pcm, full, a))
    enc.reset()
    np.testing.assert_array_equal(enc.push(pcm[:2 * HOP]), a[:2])


def test_streaming_encoder_rejects_bad_chunks(small):
    enc = small["port"].streaming_encoder()
    for bad in (np.zeros(HOP + 7, np.float32), np.zeros(0, np.float32),
                np.zeros((2, HOP), np.float32)):
        with pytest.raises(CodecError):
            enc.push(bad)
    with pytest.raises(ValueError):              # CodecError is a ValueError
        enc.push(np.zeros(HOP // 2, np.int16))
