"""The iSTFT-head codecs' shared ops (codec_tpu_torch.ops.istft, .blocks,
norms.group_norm, act.silu) against codec_tpu's on the CPU, on the same
NumPy inputs, and the port's host DSP copy (codec_tpu_torch.dsp.audio)
against codec_tpu's bit for bit.

f32 bound: max abs err <= 1e-4 x peak (and correlation > 0.99999 for the
iSTFT): the same f32 math with sums in other orders; the FFTs are
pocketfft's in both packages here, cuFFT's on the card.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.dsp import audio as jaudio
from codec_tpu.ops import act as jact
from codec_tpu.ops import blocks as jblocks
from codec_tpu.ops import istft as jistft
from codec_tpu.ops import norms as jnorms
from codec_tpu_torch.dsp import audio
from codec_tpu_torch.ops import act, blocks, istft, norms


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, bound=1e-4):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound * peak, f"max abs err {err} vs peak {peak}"


T = torch.from_numpy


# -- the iSTFT ---------------------------------------------------------------

# (n_fft, hop, T, window, skip_dc_nyquist): WavTokenizer's head (n_fft 1280
# = 4 hops), XY-Tokenizer's (960 = 4 x 240), hop not dividing n_fft (480 /
# 320, codec_tpu's scatter form), Soprano's form (the file's window, DC and
# Nyquist zeroed, trim n_fft/2) at its n_fft 2048 / 512 and a small one,
# one frame, and an odd trim ((n_fft - hop) / 2 rounded down)
ISTFT_CASES = [(1280, 320, 40, None, False), (960, 240, 17, None, False),
               (480, 320, 9, None, False), (2048, 512, 13, "sym", True),
               (256, 64, 25, "sym", True), (256, 64, 9, None, True),
               (96, 24, 1, None, False), (100, 30, 12, None, False)]


@pytest.mark.parametrize("n_fft,hop,t,window,skip", ISTFT_CASES)
def test_istft_matches_jax(n_fft, hop, t, window, skip):
    rng = np.random.default_rng(n_fft + t)
    head = _rand(rng, 2, t, n_fft + 2)
    win = jaudio.hann_symmetric(n_fft) if window == "sym" else None
    want = np.asarray(jistft.istft_from_head(
        jnp.asarray(head), hop, window=None if win is None else jnp.asarray(win),
        skip_dc_nyquist=skip))
    got = istft.istft_from_head(T(head), hop,
                                window=None if win is None else T(win),
                                skip_dc_nyquist=skip)
    assert got.dtype == torch.float32
    n_samples = (t - 1) * hop if skip else (t - 1) * hop + n_fft - 2 * (
        (n_fft - hop) // 2)
    assert got.shape == want.shape == (2, n_samples)
    _close(got, want)
    if want.size > 1:
        assert np.corrcoef(got.numpy().ravel(), want.ravel())[0, 1] > 0.99999


def test_istft_explicit_pad_and_hann():
    rng = np.random.default_rng(3)
    head = _rand(rng, 1, 11, 258)
    for pad in (0, 50):
        want = jistft.istft_from_head(jnp.asarray(head), 64, pad=pad)
        _close(istft.istft_from_head(T(head), 64, pad=pad), want)
    np.testing.assert_array_equal(istft.hann_periodic(1280),
                                  jistft.hann_periodic(1280))
    np.testing.assert_allclose(istft.hann_periodic(960),
                               torch.hann_window(960).numpy(), atol=1e-6)


@pytest.mark.parametrize("n,hop,t", [(12, 4, 5), (10, 4, 6), (7, 7, 3),
                                     (5, 8, 4), (6, 2, 1)])
def test_overlap_add_is_the_frame_sum(n, hop, t):
    """F.fold's overlap-add equals the sum of each frame at t*hop, also
    where hop does not divide n, or exceeds it (gaps stay 0)."""
    frames = torch.from_numpy(_rand(np.random.default_rng(n), 2, t, n))
    want = torch.zeros(2, (t - 1) * hop + n)
    for i in range(t):
        want[:, i * hop: i * hop + n] += frames[:, i]
    torch.testing.assert_close(istft.overlap_add(frames, hop), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_istft_16_bit_head_computes_in_f32(dtype):
    """A 16-bit head: the complex math, the overlap-add and the output stay
    f32, close to the f32 head's output (the head rounded to 16 bits)."""
    head = _rand(np.random.default_rng(4), 1, 20, 962, scale=0.5)
    want = istft.istft_from_head(T(head), 240)
    got = istft.istft_from_head(T(head).to(dtype), 240)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert np.corrcoef(got.numpy().ravel(), want.numpy().ravel())[0, 1] > 0.99


# -- the blocks ----------------------------------------------------------------

def _conv_pt(w_wio):
    """codec_tpu's WIO conv weight [K, C_in, C_out] → PyTorch's [C_out,
    C_in, K]."""
    return T(np.ascontiguousarray(np.asarray(w_wio).transpose(2, 1, 0)))


@pytest.mark.parametrize("c,inter,k,gamma", [(32, 48, 7, True),
                                             (64, 96, 3, True),
                                             (16, 40, 7, False)])
def test_convnext_block_matches_jax(c, inter, k, gamma):
    rng = np.random.default_rng(c + k)
    x = _rand(rng, 2, 37, c)
    jp = {"dw_w": _rand(rng, k, 1, c, scale=k ** -0.5), "dw_b": _rand(rng, c),
          "ln_w": 1 + _rand(rng, c, scale=0.1), "ln_b": _rand(rng, c),
          "pw1_w": _rand(rng, inter, c, scale=c ** -0.5),
          "pw1_b": _rand(rng, inter),
          "pw2_w": _rand(rng, c, inter, scale=inter ** -0.5),
          "pw2_b": _rand(rng, c),
          "gamma": _rand(rng, c) if gamma else None}
    want = jblocks.convnext_block(jnp.asarray(x), {
        key: None if v is None else jnp.asarray(v) for key, v in jp.items()})
    pp = {key: None if v is None else T(v) for key, v in jp.items()}
    pp["dw_w"] = _conv_pt(jp["dw_w"])
    _close(blocks.convnext_block(T(x), pp), want)


def _diffusion_params(rng, c):
    return {"n1_w": 1 + _rand(rng, c, scale=0.1), "n1_b": _rand(rng, c),
            "c1_w": _rand(rng, 3, c, c, scale=(3 * c) ** -0.5),
            "c1_b": _rand(rng, c),
            "n2_w": 1 + _rand(rng, c, scale=0.1), "n2_b": _rand(rng, c),
            "c2_w": _rand(rng, 3, c, c, scale=(3 * c) ** -0.5),
            "c2_b": _rand(rng, c)}


@pytest.mark.parametrize("b,t,c", [(2, 25, 64), (1, 1, 32), (1, 40, 96)])
def test_diffusion_resblock_matches_jax(b, t, c):
    rng = np.random.default_rng(t)
    x = _rand(rng, b, t, c, scale=2.0)
    jp = _diffusion_params(rng, c)
    want = jblocks.diffusion_resblock(jnp.asarray(x), {
        key: jnp.asarray(v) for key, v in jp.items()})
    pp = {key: T(v) for key, v in jp.items()}
    pp["c1_w"], pp["c2_w"] = _conv_pt(jp["c1_w"]), _conv_pt(jp["c2_w"])
    _close(blocks.diffusion_resblock(T(x), pp), want)


@pytest.mark.parametrize("b,t,c", [(2, 30, 64), (1, 1, 32), (1, 57, 96)])
def test_diffusion_attn_block_matches_jax(b, t, c):
    rng = np.random.default_rng(t + 1)
    x = _rand(rng, b, t, c)
    jp = {"n_w": 1 + _rand(rng, c, scale=0.1), "n_b": _rand(rng, c)}
    for n in "qkvo":
        jp[f"{n}_w"] = _rand(rng, c, c, 1, scale=c ** -0.5)
        jp[f"{n}_b"] = _rand(rng, c)
    want = jblocks.diffusion_attn_block(jnp.asarray(x), {
        key: jnp.asarray(v) for key, v in jp.items()})
    pp = {key: T(v[:, :, 0].copy() if v.ndim == 3 else v)
          for key, v in jp.items()}
    _close(blocks.diffusion_attn_block(T(x), pp), want)


@pytest.mark.parametrize("skip,dims", [(True, (16, 16, 16)),
                                       (False, (12, 20, 8)),
                                       (True, (64, 64, 64))])
def test_lstm_stack_matches_jax_scan(skip, dims):
    """torch's LSTM op (gate order i, f, g, o) against codec_tpu's lax.scan,
    over 2 layers and 45 steps."""
    rng = np.random.default_rng(sum(dims))
    c_in = dims[0]
    x = _rand(rng, 2, 45, c_in)
    layers = []
    for h in dims[1:]:
        s = h ** -0.5
        layers.append({"w_ih": _rand(rng, 4 * h, c_in, scale=s),
                       "w_hh": _rand(rng, 4 * h, h, scale=s),
                       "b_ih": _rand(rng, 4 * h, scale=0.1),
                       "b_hh": _rand(rng, 4 * h, scale=0.1)})
        c_in = h
    want = jblocks.lstm_stack(jnp.asarray(x), [
        {k: jnp.asarray(v) for k, v in lw.items()} for lw in layers],
        skip=skip)
    got = blocks.lstm_stack(T(x), [{k: T(v) for k, v in lw.items()}
                                   for lw in layers], skip=skip)
    _close(got, want)
    got16 = blocks.lstm_stack(T(x).bfloat16(), [
        {k: T(v).bfloat16() for k, v in lw.items()} for lw in layers],
        skip=skip)
    assert got16.dtype == torch.bfloat16 and torch.isfinite(got16).all()


def test_lstm_layer_lays_weights_out_in_one_buffer():
    """lstm_layer's four tensors are float32 views, in torch's order, of one
    contiguous buffer (what cuDNN takes without a copy), equal to the
    weights given; the stack computes the same through them."""
    rng = np.random.default_rng(12)
    h = 8
    raw = {"w_ih": _rand(rng, 4 * h, h), "w_hh": _rand(rng, 4 * h, h),
           "b_ih": _rand(rng, 4 * h), "b_hh": _rand(rng, 4 * h)}
    lw = blocks.lstm_layer(*(T(raw[k]).bfloat16().float() for k in
                             blocks.LSTM_KEYS))
    ptr = lw["w_ih"].data_ptr()
    for k in blocks.LSTM_KEYS:
        assert lw[k].dtype == torch.float32 and lw[k].is_contiguous()
        assert lw[k].data_ptr() == ptr
        assert lw[k].untyped_storage().data_ptr() == \
            lw["w_ih"].untyped_storage().data_ptr()
        ptr += 4 * lw[k].numel()
        torch.testing.assert_close(lw[k], T(raw[k]).bfloat16().float())
    x = T(_rand(rng, 2, 9, h))
    plain = {k: T(raw[k]).bfloat16().float() for k in raw}
    torch.testing.assert_close(blocks.lstm_stack(x, [lw]),
                               blocks.lstm_stack(x, [plain]))


@pytest.mark.parametrize("groups,c,t", [(32, 64, 20), (32, 768, 3),
                                        (4, 12, 1), (1, 8, 9)])
def test_group_norm_matches_jax(groups, c, t):
    rng = np.random.default_rng(c)
    x = _rand(rng, 2, t, c, scale=3.0) + 1.5
    g, b = _rand(rng, c), _rand(rng, c)
    for eps in (1e-5, 1e-6):
        want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b), groups, eps)
        _close(norms.group_norm(T(x), T(g), T(b), groups, eps), want)


def test_silu_matches_jax():
    x = _rand(np.random.default_rng(9), 3, 40, 8, scale=4.0)
    _close(act.silu(T(x)), jact.silu(jnp.asarray(x)), bound=1e-6)


def test_depthwise_conv_takes_f16_without_cudnn_only_on_the_card():
    """The f16 guard leaves cuDNN's setting as it found it."""
    rng = np.random.default_rng(10)
    x, w, b = _rand(rng, 1, 20, 8), _rand(rng, 8, 1, 3), _rand(rng, 8)
    before = torch.backends.cudnn.enabled
    y = blocks.depthwise_conv(T(x).half(), T(w).half(), T(b).half())
    assert torch.backends.cudnn.enabled == before
    want = blocks.depthwise_conv(T(x), T(w), T(b))
    assert y.dtype == torch.float16
    np.testing.assert_allclose(y.float().numpy(), want.numpy(), atol=2e-2)


# -- the host DSP copy -----------------------------------------------------------

def test_dsp_copy_has_every_function_of_codec_tpu():
    def public(mod):
        return {n for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__}
    assert public(audio) == public(jaudio)
    for name in public(audio):
        assert inspect.getsource(getattr(audio, name)) == \
            inspect.getsource(getattr(jaudio, name)), name


@pytest.mark.parametrize("n", [400, 960, 2048])
def test_dsp_windows_equal(n):
    for name in ("hann_periodic", "hann_symmetric", "povey_window"):
        np.testing.assert_array_equal(getattr(audio, name)(n),
                                      getattr(jaudio, name)(n))


def test_dsp_mel_banks_equal():
    for args in ((201, 80, 0.0, 8000.0, 16000), (257, 64, 20.0, 7600.0, 16000)):
        for kw in ({}, {"norm": "slaney", "mel_scale": "slaney"},
                   {"mel_scale": "kaldi", "triangularize_in_mel_space": True}):
            np.testing.assert_array_equal(audio.mel_filter_bank(*args, **kw),
                                          jaudio.mel_filter_bank(*args, **kw))
    np.testing.assert_array_equal(audio.slaney_mel_filterbank(16000, 400, 80),
                                  jaudio.slaney_mel_filterbank(16000, 400, 80))


@pytest.mark.parametrize("n", [16000, 12345, 500])
def test_dsp_features_equal(n):
    pcm = _rand(np.random.default_rng(n), n, scale=0.2)
    for a, b in ((audio.whisper_log_mel(pcm), jaudio.whisper_log_mel(pcm)),
                 (audio.w2v_bert_features(pcm), jaudio.w2v_bert_features(pcm))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mel_a, n_a = audio.whisper_mel_padded(pcm, 16000, 400, 160, 80, 1280)
    mel_b, n_b = jaudio.whisper_mel_padded(pcm, 16000, 400, 160, 80, 1280)
    assert n_a == n_b
    np.testing.assert_array_equal(mel_a, mel_b)
