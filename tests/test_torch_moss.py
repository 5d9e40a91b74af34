"""The port's MOSS-Audio-Tokenizer (codec_tpu_torch.models.moss_audio)
against codec_tpu's on the CPU: small random GGUFs from the port's writer
(models/moss_init.py) at the widths of tests/test_moss_audio_parity.py's
small mirror (d_model 16, 2 heads, windows of 8 and 6 tokens, 2 levels of
32 × 8), mono and stereo, loaded by both packages, the same codes and PCM
from a NumPy seed.

f32 bound: correlation > 0.99999, max abs err <= 1e-4 x peak. Codes
equal, or each differing frame's first differing level an f64 near-tie
of the cosine search (relative margin < 1e-4) in at most max(2, T/100)
frames. bf16 and f16: corr > 0.99 against codec_tpu's same dtype.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.models import moss_audio as jmoss
from codec_tpu.ops import attn as jattn
from codec_tpu.ops import rope as jrope
from codec_tpu_torch import CodecError
from codec_tpu_torch.models import moss_audio as moss
from codec_tpu_torch.models.moss_init import MOSS_FULL, write_random_moss_gguf
from codec_tpu_torch.ops import act, attn, rope
from codec_tpu_torch.ops.attn_cuda import flash_sdpa_window_ref

SR = 24000
M = moss.MossModuleCfg


def _stage(in_dim, out_dim, dur):
    return M(1, 1, in_dim, out_dim, 16, 2, 1, dur, 10000.0)


# tests/test_moss_audio_parity.py's mirror: patch 2 → d16 (window 8) →
# patch 2 → d16 (window 6), 2 levels of 32 x 8, rvq 16, latent 16
MONO = moss.MossConfig(
    sample_rate=SR, hop_size=4, n_q=2, codebook_size=32, codebook_dim=8,
    latent_dim=16, rvq_dim=16, number_channels=1,
    enc_modules=(M(0, 2), _stage(2, 16, 8 * 2 / SR), M(0, 2),
                 _stage(32, 16, 6 * 4 / SR)),
    dec_modules=(_stage(16, 32, 6 * 4 / SR), M(0, 2),
                 _stage(16, 2, 8 * 2 / SR), M(0, 2)))
# the same modules over a stereo stream: 2 samples a channel a code, the
# windows 4 and 3 codes' worth of the interleaved stream
STEREO = dataclasses.replace(MONO, hop_size=2, number_channels=2)
V, N_Q = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, cfg, encoder=True):
    write_random_moss_gguf(path, seed=0, cfg=cfg, encoder=encoder)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("moss")
    return {"mono": _write(d / "mono.gguf", MONO),
            "stereo": _write(d / "stereo.gguf", STEREO)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _held(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _pcm(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(
        np.float32)


def _cfg_from_jax(c):
    d = dict(vars(c))
    for side in ("enc_modules", "dec_modules"):
        d[side] = tuple(M(**vars(m)) for m in d[side])
    return moss.MossConfig(**d)


def assert_lfq_codes(got, want, params, latent):
    """Codes [T, n_q] equal, or each differing frame's first differing
    level an f64 near-tie of the cosine search (relative distance margin
    < 1e-4) on the residual the reference's own earlier codes leave, in at
    most max(2, T/100) frames. latent: the quantizer's input [T, rvq] (f64).
    → the differing frames."""
    assert got.shape == want.shape and got.dtype == np.int32
    frames = np.where((got != want).any(axis=1))[0]
    assert len(frames) <= max(2, want.shape[0] // 100), frames
    f = {k: [np.asarray(q[k], np.float64) for q in params["q"]]
         for k in moss._LEVEL}
    for fr in frames:
        lvl = int((got[fr] != want[fr]).argmax())
        r = latent[fr].copy()
        for q in range(lvl):
            r -= f["cb"][q][want[fr, q]] @ f["out_w"][q].T + f["out_b"][q]
        z = r @ f["in_w"][lvl].T + f["in_b"][lvl]
        z /= max(np.linalg.norm(z), 1e-12)
        cb = f["cb_norm"][lvl]
        d = ((z[None] - cb) ** 2).sum(-1)
        margin = (d[got[fr, lvl]] - d[want[fr, lvl]]) / max(d[want[fr, lvl]],
                                                            1e-12)
        assert abs(margin) < 1e-4, (fr, lvl, margin)
    return frames


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_config_and_attrs_match(files, kind):
    j, p = files[kind]["jax"], files[kind]["port"]
    assert p.arch == j.arch == "moss_audio_tokenizer"
    want = {"mono": MONO, "stereo": STEREO}[kind]
    # the windows as the file's f32 array holds them
    want = dataclasses.replace(want, **{side: tuple(dataclasses.replace(
        m, context_duration=float(np.float32(m.context_duration)))
        for m in getattr(want, side)) for side in ("enc_modules",
                                                   "dec_modules")})
    assert p.cfg == _cfg_from_jax(j.cfg) == want
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time",
              "expected_channels"):
        assert getattr(p, a) == getattr(j, a), a
    assert p.expected_channels == (2 if kind == "stereo" else 1)
    assert p.encode_sample_rate == getattr(j, "encode_sample_rate", 0) == 0


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_load_matches_params_from_jax(files, kind):
    j, p = files[kind]["jax"], files[kind]["port"]
    got = _leaves(p.params)
    want = _leaves(moss.params_from_jax(
        {k: v for k, v in j.params.items()}))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if g is None or w is None:
            assert g is None and w is None
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_decoder_only_file_has_no_encoder(tmp_path):
    f = _write(tmp_path / "dec.gguf", MONO, encoder=False)
    assert not f["port"].has_encoder and not f["jax"].has_encoder
    # the decoder and quantizer are drawn first: the same decode
    full = _write(tmp_path / "full.gguf", MONO)
    codes = _codes((6, N_Q), 3)
    np.testing.assert_array_equal(f["port"].decode(codes),
                                  full["port"].decode(codes))
    with pytest.raises(CodecError, match="has no encoder"):
        f["port"].encode(_pcm(16, 1))


@pytest.mark.parametrize("kind,t,batch", [("mono", 1, None), ("mono", 20, 2),
                                          ("mono", 33, None),
                                          ("stereo", 1, None),
                                          ("stereo", 20, 2),
                                          ("stereo", 33, None)])
def test_decode_matches_jax(files, kind, t, batch):
    j, p = files[kind]["jax"], files[kind]["port"]
    shape = (t, N_Q) if batch is None else (batch, t, N_Q)
    codes = _codes(shape, 10 + t)
    got, want = p.decode(codes), j.decode(codes)
    nch = p.expected_channels
    lead = () if batch is None else (batch,)
    assert got.shape == want.shape == lead + ((t * p.hop_size, nch) if nch > 1
                                              else (t * p.hop_size,))
    _held(got, want)


def test_decode_clips_codes_and_reads_every_level(files):
    """Codes out of range clip into the codebook; a decode reads every
    level whatever n_q asks, as codec_tpu's (and raises when the codes
    carry fewer)."""
    j, p = files["stereo"]["jax"], files["stereo"]["port"]
    codes = _codes((9, N_Q), 4)
    wild = codes.copy()
    wild[0, 0], wild[3, 1] = -5, V + 7
    clipped = np.clip(wild, 0, V - 1)
    np.testing.assert_array_equal(p.decode(wild), p.decode(clipped))
    one = p.decode(codes, n_q=1)
    np.testing.assert_array_equal(one, p.decode(codes))
    _held(one, j.decode(codes, n_q=1))
    with pytest.raises(CodecError, match="reads all 2 levels"):
        p.decode(codes[:, :1])


def test_async_and_many_decodes(files):
    p = files["stereo"]["port"]
    a, b = _codes((7, N_Q), 5), _codes((11, N_Q), 6)
    outs = p.decode_many([a, b, a])
    for o, s in zip(outs, (a, b, a)):
        np.testing.assert_allclose(o, p.decode(s), rtol=1e-6, atol=1e-7)
    pend = p.decode_async(b, pcm_format="i16")
    assert pend.result().shape == (11 * p.hop_size, 2)
    assert pend.result().dtype == np.int16


# per-channel lengths: hop multiples and not (the tail rows' split), 1
@pytest.mark.parametrize("kind,n", [("mono", 64), ("mono", 67), ("mono", 1),
                                    ("stereo", 40), ("stereo", 41),
                                    ("stereo", 43), ("stereo", 1)])
def test_encode_matches_jax(files, kind, n):
    j, p = files[kind]["jax"], files[kind]["port"]
    pcm = _pcm((n, 2) if kind == "stereo" else (n,), 20 + n)
    got, want = p.encode(pcm), j.encode(pcm)
    assert got.shape == want.shape == (-(-n // p.hop_size), N_Q)
    flat = np.pad(pcm.reshape(n, -1), ((0, (-n) % p.hop_size), (0, 0)))
    with torch.inference_mode():
        lat = moss.moss_encode_latent_fn(
            p.params, torch.from_numpy(flat.reshape(1, -1)), p.cfg,
            n * p.expected_channels)[0].double().numpy()
    assert_lfq_codes(got, want, p.params, lat)


def test_encode_int16_mono_on_stereo_and_n_q(files):
    """int16 PCM scales by 1/32768 as float does; a mono stream on the
    stereo model encodes as one channel (codec_tpu's rule); n_q picks the
    first levels."""
    j, p = files["stereo"]["jax"], files["stereo"]["port"]
    pcm = _pcm((30, 2), 7)
    i16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(p.encode(i16), p.encode(i16 / 32768.0))
    mono = _pcm(32, 8)
    np.testing.assert_array_equal(p.encode(mono), j.encode(mono))
    assert p.encode(mono).shape == (8, N_Q)      # 4 samples of it a code
    with pytest.raises(CodecError, match="no multiple"):
        p.encode(mono[:30])
    # every level whatever n_q asks, as codec_tpu's
    np.testing.assert_array_equal(p.encode(pcm, n_q=1), p.encode(pcm))
    np.testing.assert_array_equal(p.encode(pcm, n_q=1), j.encode(pcm, n_q=1))
    with pytest.raises(CodecError):
        p.encode(pcm, n_q=N_Q + 1)


def test_encode_decode_round_trip(files):
    p = files["stereo"]["port"]
    pcm = _pcm((48, 2), 9)
    back = p.decode(p.encode(pcm))
    assert back.shape == (48, 2) and np.isfinite(back).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_matches_jax(files, dtype):
    f = files["stereo"]
    j16 = codec_tpu.load_model(f["path"], compute_dtype=dtype)
    p16 = codec_tpu_torch.load_model(f["path"], compute_dtype=dtype,
                                     device="cpu")
    assert p16.params["dec"][0]["layers"][0]["qkv"].dtype == getattr(torch,
                                                                     dtype)
    codes = _codes((2, 16, N_Q), 30)
    got, want = p16.decode(codes), j16.decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99
    assert np.corrcoef(got.ravel(), f["port"].decode(codes).ravel())[0, 1] \
        > 0.99
    pcm = _pcm((44, 2), 31)
    c = p16.encode(pcm)
    assert c.shape == (22, N_Q) and c.min() >= 0 and c.max() < V


def test_gelu_tanh_and_the_layer_match_jax(files):
    x = np.random.default_rng(2).standard_normal((3, 50)).astype(np.float32) * 3
    np.testing.assert_allclose(act.gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jmoss.act.gelu_tanh(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    p, j = files["mono"]["port"], files["mono"]["jax"]
    x = np.random.default_rng(3).standard_normal((2, 23, 16)).astype(
        np.float32)
    lw_j = j.params["dec"][0]["layers"][0]
    cos, sin = rope.rope_cos_sin(torch.arange(23), 8, 10000.0)
    layer = jax.jit(jmoss._moss_layer, static_argnums=(2, 3, 4, 5))
    for win, nv in ((6, None), (None, None), (3, 17)):
        want = layer(jnp.asarray(x), lw_j, 2, 10000.0, win, nv)
        got = moss._moss_layer(torch.from_numpy(x),
                               p.params["dec"][0]["layers"][0], 2, cos, sin,
                               win, nv, None)
        _held(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("duration,cum,want", [
    (0.1, 768, 12), (0.1, 256, 38), (0.1, 1280, 8), (0.1, 3840, 2),
    (0.1, 16, 600), (0.1, 128, 75), (10.0, 7680, 125),
    (0.0, 16, 0)])
def test_win_tokens_rounds_half_to_even(duration, cum, want):
    """Python's round, half to even: MOSS's d768 stage (0.1 s of the 96 kHz
    stereo stream over 768 samples a token) is 12.5 → 12 tokens."""
    cfg = MOSS_FULL
    jcfg = jmoss.MossConfig(sample_rate=cfg.sample_rate, number_channels=2)
    assert moss._win_tokens(cfg, duration, cum) == want
    assert jmoss._win_tokens(jcfg, duration, cum) == want


def test_full_config_windows_and_limits():
    """MOSS's full-width decoder windows: 125 / 12 / 75 / 600 tokens at its
    four transformer stages (T 250 / 2500 / 15 000 / 120 000 at 20 s of
    stereo). A request has no length cap: the attention kernel takes any
    Tq that memory allows."""
    cfg = MOSS_FULL
    assert moss._dec_window_tokens(cfg) == [125, 0, 12, 0, 75, 0, 600, 0]


@pytest.mark.parametrize("t,n_valid,window", [
    (24, 20, 6), (40, 33, 10), (24, 17, 3), (24, 23, None), (9, 1, 2),
    (9, 0, 4), (30, 12, 1)])
def test_tail_split_matches_the_masked_form(t, n_valid, window):
    """window_attention (the kernel's rows before n_valid, the masked sdpa
    after, over the rows' key band where each window holds a valid key:
    20 of 24 at window 6, 33 of 40 at window 10) against codec_tpu's whole
    masked form, attn_mask + the n_valid term, including rows whose window
    holds no valid key (window 3 at 17 of 24, window 1 at 12 of 30:
    codec_tpu's uniform weights over the masked keys)."""
    rng = np.random.default_rng(t * 100 + n_valid)
    q, k, v = (rng.standard_normal((2, 3, t, 8)).astype(np.float32)
               for _ in range(3))
    got = moss.window_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                window, n_valid)
    def masked(q, k, v):
        m = jattn.attn_mask(t, t, causal=True, window=window)
        m = m + jnp.where(jnp.arange(t)[None, :] < n_valid, 0.0,
                          jattn.NEG_INF)
        return jattn.sdpa(q, k, v, mask=m)

    want = np.asarray(jax.jit(masked)(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    torch_full = attn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                           mask=attn.attn_mask(t, t, window=window)
                           + torch.where(torch.arange(t)[None] < n_valid,
                                         0.0, attn.NEG_INF))
    np.testing.assert_allclose(got.numpy(), torch_full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_rope_normal_at_120000_positions():
    """RoPE NORMAL at MOSS's longest stage (T 120 000, D 64, θ 10 000): two
    of the 32 inverse frequencies differ by one ulp between the packages,
    which the rotation at the last positions carries to about 1e-4 of the
    peak; bound 1e-4 x peak."""
    x = np.random.default_rng(4).standard_normal((1, 1, 120000, 64)).astype(
        np.float32)
    got = rope.apply_rope(torch.from_numpy(x), theta=10000.0,
                          neox=False).numpy()
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), theta=10000.0,
                                       neox=False))
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-4 * peak, (err, peak)
    short = np.abs(got[:, :, :250] - want[:, :, :250]).max()
    assert short <= 1e-6 * peak, short


@pytest.mark.parametrize("window", [1, 12, None])
@pytest.mark.parametrize("t", [1, 15, 40])
def test_banded_plain_attention_matches_unbanded(t, window):
    """flash_sdpa_window_ref in blocks of 4 queries against only their key
    band, against the masked sdpa over all keys (self-attention, and q
    shorter than k with keys before k_start masked)."""
    rng = np.random.default_rng(t + (window or 0))
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, t, 16)).astype(
        np.float32)) for _ in range(3))
    want = attn.sdpa(q, k, v, mask=attn.attn_mask(t, t, window=window))
    for block in (4, 512):
        got = flash_sdpa_window_ref(q, k, v, window=window, block=block)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    kk, vv = (torch.from_numpy(rng.standard_normal((2, 3, t + 9, 16)).astype(
        np.float32)) for _ in range(2))
    want = attn.sdpa(q, kk, vv, mask=attn.attn_mask(
        t, t + 9, window=window, q_off=9, k_start=5))
    got = flash_sdpa_window_ref(q, kk, vv, window=window, k_start=5, block=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_errors_and_aliases_match_jax(files, tmp_path):
    from codec_tpu.models.registry import get_model_class as jget
    from codec_tpu_torch.models.registry import get_model_class

    for alias in ("moss_audio_tokenizer", "moss-audio-tokenizer",
                  "moss_audio"):
        assert get_model_class(alias) is moss.MossAudioCodec
        assert jget(alias).__name__ == "MossAudioCodec"
    p = files["mono"]["port"]
    with pytest.raises(CodecError):
        p.decode(np.zeros((0, N_Q), np.int32))
    with pytest.raises(CodecError):
        p.decode(np.zeros((4, N_Q), np.int32), n_q=N_Q + 1)
    with pytest.raises(CodecError):
        p.encode(np.zeros(0, np.float32))
    with pytest.raises(CodecError):
        p.decode_latent(np.zeros((4, 16), np.float32))


def test_cli_matches_codec_cli(files, tmp_path):
    """codec-cli-torch as codec-cli on the stereo file: a stereo WAV is
    downmixed on encode (both CLIs), the codes equal codec_tpu's, and
    decode writes a stereo WAV within one LSB of codec_tpu's."""
    from codec_tpu.cli.codec_cli import main as jmain
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    path = str(files["stereo"]["path"])
    write_wav(tmp_path / "in.wav", _pcm((40, 2), 40), SR)
    for tag, fn, extra in (("p", main, ["--device", "cpu"]), ("j", jmain, [])):
        assert fn(["encode", "--model", path, "--in",
                   str(tmp_path / "in.wav"), "--codes",
                   str(tmp_path / f"{tag}.npy"), *extra]) == 0
        assert fn(["decode", "--model", path, "--codes",
                   str(tmp_path / f"{tag}.npy"), "--out",
                   str(tmp_path / f"{tag}.wav"), *extra]) == 0
    codes = np.load(tmp_path / "p.npy")
    assert codes.shape == (10, N_Q)       # a mono stream: 4 samples a code
    np.testing.assert_array_equal(codes, np.load(tmp_path / "j.npy"))
    (x, sr), (y, _) = (read_wav(tmp_path / f"{t}.wav", keep_i16=True)
                       for t in "pj")
    assert sr == SR and x.shape == y.shape == (20, 2)
    assert np.abs(x.astype(np.int32) - y.astype(np.int32)).max() <= 1
