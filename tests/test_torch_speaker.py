"""The port's two speaker encoders (codec_tpu_torch/lm/speaker_chatterbox.py,
speaker_qwen3_tts.py) and `create_speaker_encoder` against codec_tpu on
the CPU.

Fixtures from the port's writers (models/chatterbox_init.py): a small
Chatterbox T3 + VoiceEncoder section (on a small S3Gen file) and a small
Qwen3-TTS ECAPA-TDNN section; both packages read the same files, and the
port's loads equal codec_tpu's weights carried across
(`*_params_from_jax`). The same NumPy PCM goes to both.

Bounds: the host mel front-ends (float64 NumPy copies) bit for bit; the
VoiceEncoder embedding, the conditioning rows and the ECAPA embedding
within 1e-5 of their peak (f32 on both sides: torch's LSTM and convs
against codec_tpu's lax.scan and conv_general_dilated).
"""

import dataclasses

import numpy as np
import pytest
import torch

from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm import create_speaker_encoder as jax_create
from codec_tpu.lm import speaker_chatterbox as jsc
from codec_tpu.lm import speaker_qwen3_tts as jsq
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.lm import create_speaker_encoder
from codec_tpu_torch.lm import speaker_chatterbox as sc
from codec_tpu_torch.lm import speaker_qwen3_tts as sq
from codec_tpu_torch.models import chatterbox_init as cbi

from test_torch_chatterbox import T3, VE
from test_torch_s3g import SMALL, WIDTHS

ECAPA = sq.EcapaConfig(mel_dim=16, enc_dim=24, attn_ch=8, res2net_scale=4,
                       se_ch=8, n_fft=64, hop=16, win=64,
                       enc_channels=(32, 32, 32, 32, 48),
                       enc_kernels=(5, 3, 3, 3, 1),
                       enc_dilations=(1, 2, 3, 4, 1), hidden_dim=24)
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spk")
    cbx = cbi.write_chatterbox_tts_gguf(
        tmp / "cbx.gguf", seed=5, t3=T3, ve=VE,
        cfg=dataclasses.replace(SMALL, codebook_size=T3.start_speech),
        **WIDTHS)
    ecapa = cbi.write_qwen3_speaker_gguf(tmp / "ecapa.gguf", seed=6,
                                         cfg=ECAPA)
    return cbx, ecapa


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * peak, f"max abs err {err} vs peak {peak}"


def _equal_trees(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal_trees(a, b)
    elif torch.is_tensor(want):
        assert torch.equal(got, want)
    else:
        assert got == want


def test_dispatch(files):
    cbx, ecapa = files
    for path, cls, jcls in ((cbx, sc.ChatterboxSpeakerEncoder,
                             jsc.ChatterboxSpeakerEncoder),
                            (ecapa, sq.Qwen3TTSSpeakerEncoder,
                             jsq.Qwen3TTSSpeakerEncoder)):
        enc = create_speaker_encoder(GGUFReader(path), device="cpu")
        assert type(enc) is cls and enc.device == torch.device("cpu")
        assert type(jax_create(JaxReader(str(path)))) is jcls
        assert dataclasses.asdict(enc.cfg) == dataclasses.asdict(
            jax_create(JaxReader(str(path))).cfg)


def test_dispatch_none_and_unknown(tmp_path):
    path = tmp_path / "none.gguf"
    w = GGUFWriter(path, "mimi")
    w.add_uint32("codec.sample_rate", 24000)
    w.write()
    assert create_speaker_encoder(GGUFReader(path), device="cpu") is None
    assert jax_create(JaxReader(str(path))) is None
    path = tmp_path / "other.gguf"
    w = GGUFWriter(path, "mimi")
    w.add_bool("codec.speaker.has_encoder", True)
    w.add_string("codec.speaker.encoder_arch", "wavlm")
    w.write()
    with pytest.raises(ValueError, match="unknown speaker encoder arch"):
        create_speaker_encoder(GGUFReader(path), device="cpu")


def test_weights_match_codec_tpu(files):
    """The port's loads equal codec_tpu's weight trees carried across."""
    cbx, ecapa = files
    enc = sc.ChatterboxSpeakerEncoder(GGUFReader(cbx), T3.hidden, "cpu")
    ref = jsc.ChatterboxSpeakerEncoder(JaxReader(str(cbx)), T3.hidden)
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} \
        if isinstance(t, dict) else [to_np(v) for v in t] \
        if isinstance(t, list) else np.asarray(t)
    _equal_trees(enc.ve_params, sc.ve_params_from_jax(to_np(ref.ve_params)))
    _equal_trees(enc.cond_params,
                 sc.cond_params_from_jax(to_np(ref.cond_params)))
    np.testing.assert_array_equal(enc.mel_basis, ref.mel_basis)
    e = sq.Qwen3TTSSpeakerEncoder(GGUFReader(ecapa), ECAPA.hidden_dim, "cpu")
    je = jsq.Qwen3TTSSpeakerEncoder(JaxReader(str(ecapa)), ECAPA.hidden_dim)
    _equal_trees(e.params, sq.ecapa_params_from_jax(je.params))


@pytest.mark.parametrize("n", [700, 1600, 4000])
def test_voice_encoder_matches(files, n):
    """Mel partials bit for bit; the embedding (1, 2 and 5 partials)
    within 1e-5 of peak and unit norm."""
    cbx, _ = files
    enc = sc.ChatterboxSpeakerEncoder(GGUFReader(cbx), T3.hidden, "cpu")
    ref = jsc.ChatterboxSpeakerEncoder(JaxReader(str(cbx)), T3.hidden)
    pcm = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        sc.ve_mel_partials(pcm, enc.mel_basis, enc.window, enc.cfg),
        jsc.ve_mel_partials(pcm, ref.mel_basis, ref.window, ref.cfg))
    got = enc.embed_ref(pcm)
    _close(got, ref.embed_ref(pcm))
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


@pytest.mark.parametrize("n_tok", [1, 7, 30])
def test_cond_emb_and_encode_match(files, n_tok):
    cbx, _ = files
    enc = sc.ChatterboxSpeakerEncoder(GGUFReader(cbx), T3.hidden, "cpu")
    ref = jsc.ChatterboxSpeakerEncoder(JaxReader(str(cbx)), T3.hidden)
    rng = np.random.default_rng(n_tok)
    spk = rng.standard_normal(T3.speaker_embed).astype(np.float32)
    toks = rng.integers(0, T3.start_speech, n_tok).astype(np.int32)
    got = enc.cond_emb(spk, toks, 0.3)
    assert got.shape == (34, T3.hidden)
    _close(got, ref.cond_emb(spk, toks, 0.3))
    pcm = (rng.standard_normal(1200) * 0.2).astype(np.float32)
    _close(enc.encode(pcm, toks, 0.7), ref.encode(pcm, toks, 0.7))


@pytest.mark.parametrize("n", [48, 333, 2400])
def test_ecapa_matches(files, n):
    """The log-mel bit for bit; the speaker row (3, 20 and 150 frames:
    reflect padding past the input's length at 3) within 1e-5 of peak."""
    _, ecapa = files
    enc = create_speaker_encoder(GGUFReader(ecapa), device="cpu")
    ref = jax_create(JaxReader(str(ecapa)))
    pcm = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        sq.qwen3_speaker_mel(pcm, enc.mel_basis, enc.window, ECAPA.n_fft,
                             ECAPA.hop),
        jsq.qwen3_speaker_mel(pcm, ref.mel_basis, ref.window, ECAPA.n_fft,
                              ECAPA.hop))
    got = enc.encode(pcm)
    assert got.shape == (1, ECAPA.hidden_dim)
    _close(got, ref.encode(pcm))


def test_errors(files):
    cbx, ecapa = files
    with pytest.raises(ValueError, match="too few mel frames"):
        create_speaker_encoder(GGUFReader(ecapa), device="cpu").encode(
            np.zeros(30, np.float32))
    with pytest.raises(ValueError, match="too short"):
        sc.ChatterboxSpeakerEncoder(GGUFReader(cbx), T3.hidden,
                                    "cpu").embed_ref(np.zeros(16, np.float32))
