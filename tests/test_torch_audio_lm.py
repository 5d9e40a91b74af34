"""The port's AudioLM host hooks (codec_tpu_torch/lm/audio_lm.py) against
codec_tpu's on the CPU: the counterparts of tests/test_audio_lm.py's
test_type_a_token_range and test_observe_codes_accumulation_and_eos and of
tests/test_decode_transform.py's test_decode_audio_applies_transform and
test_nq_subset_decode, on those tests' own GGUF fixtures (which the port's
reader reads), and the modality bits, the audio-token keys, the embed
override and push_codes against codec_tpu's AudioLM on one file.

Bounds: actions, frames, codes and decoded stub PCM equal; the Type B
embedding equal to codec_tpu's bit for bit (one table row), the Type C/D
feedback within 1e-6 (rows summed in another order).
"""

import numpy as np
import pytest
import torch

from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.lm.audio_lm import (MODALITY_AUDIO_IN, MODALITY_AUDIO_OUT,
                                         MODALITY_TEXT_IN, MODALITY_TEXT_OUT,
                                         AudioLM, AudioTokenRange,
                                         ObserveAction)
from codec_tpu_torch.lm.base import LmError
from test_decode_transform import (StubCodec, shifting_outputs_oracle,
                                   ttsd_like_gguf)  # noqa: F401
from test_lm_adaptors import H, N_CB, SIZES, phd_gguf, rda_gguf  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(path, **kw):
    return (AudioLM(GGUFReader(path), device="cpu", **kw),
            JaxAudioLM(JaxReader(str(path)), **kw))


def test_type_a_token_range(rda_gguf):  # noqa: F811
    path, _ = rda_gguf
    alm, ref = _pair(path)
    assert alm.token_range == AudioTokenRange()
    for a in (alm, ref):
        a.set_audio_token_range(offset=100, count=50, eos_id=99)
    for tok, want in ((5, ObserveAction.PASSTHROUGH),
                      (120, ObserveAction.CONSUMED),
                      (149, ObserveAction.CONSUMED),
                      (150, ObserveAction.PASSTHROUGH),
                      (99, ObserveAction.STOP)):
        assert alm.observe_token(tok) is want
        assert ref.observe_token(tok).name == want.name
    assert alm.codes_matrix().tolist() == [[20], [49]]
    np.testing.assert_array_equal(alm.codes_matrix(), ref.codes_matrix())


def test_type_b_embed_override_and_reset(rda_gguf):  # noqa: F811
    """With the embed override an in-range token composes the next input
    at the step counter, which starts at start_step and returns there on
    reset()."""
    path, _ = rda_gguf
    alm, ref = _pair(path)
    for a in (alm, ref):
        a.set_audio_token_range(offset=100, count=SIZES[0], eos_id=-1)
        a.set_uses_embed_override(True, start_step=2)
    for _ in range(2):
        for tok in (103, 111):
            assert alm.observe_token(tok) is ObserveAction.CONSUMED_EMBED
            assert ref.observe_token(tok).name == "CONSUMED_EMBED"
            np.testing.assert_array_equal(alm.next_embed, ref.next_embed)
        assert alm._embed_step == ref._embed_step == 4
        alm.reset()
        ref.reset()
        assert alm._embed_step == 2 and alm.frames == []


def test_observe_codes_accumulation_and_eos(phd_gguf):  # noqa: F811
    path, _, _ = phd_gguf
    alm, ref = _pair(path)
    assert alm.n_codebook == N_CB and alm.hidden_dim == ref.hidden_dim == H
    assert alm.lm_eos() == ref.lm_eos() == (7, 2)
    for frame, expect_stop in ((3, False), (7, False), (7, True)):
        codes = []
        for a in (alm, ref):
            st = a.state
            st.step_begin(np.zeros(H, np.float32))
            for k in range(N_CB):
                st.step_logits()
                st.step_push_code(frame if k == 0 else 1)
            codes.append(st.step_finish())
        assert list(codes[0]) == list(codes[1])
        action = alm.observe_codes(codes[0])
        assert (action is ObserveAction.STOP) is expect_stop
        assert ref.observe_codes(codes[1]).name == action.name
    assert alm.codes_matrix().shape == (3, N_CB)
    np.testing.assert_array_equal(alm.codes_matrix(), ref.codes_matrix())
    assert alm.next_embed is not None and alm.next_embed.shape == (H,)
    np.testing.assert_allclose(alm.next_embed, ref.next_embed, rtol=0,
                               atol=1e-6)


def test_decode_audio_applies_transform(ttsd_like_gguf):  # noqa: F811
    """push_codes + decode_audio: the delay unshift and merged-cb0 remap,
    T_out = T - max_delay, the codes codec_tpu's AudioLM hands its codec."""
    path, _ = ttsd_like_gguf
    codec, jcodec = StubCodec(n_q=N_CB, codebook_size=20), \
        StubCodec(n_q=N_CB, codebook_size=20)
    alm = AudioLM(GGUFReader(path), codec=codec, device="cpu")
    ref = JaxAudioLM(JaxReader(str(path)), codec=jcodec)
    rng = np.random.default_rng(5)
    grid = np.stack([rng.integers(10, 30, 12),
                     rng.integers(0, 20, 12),
                     rng.integers(0, 20, 12),
                     rng.integers(0, 20, 12)], axis=1).astype(np.int32)
    alm.push_codes(grid)
    ref.push_codes(grid)
    pcm = alm.decode_audio()
    want = shifting_outputs_oracle(grid, (0, 1, 2, 3), 0, 10, 20, 12 - 3)
    np.testing.assert_array_equal(codec.last_codes, want)
    np.testing.assert_array_equal(pcm, codec.decode(want))
    np.testing.assert_array_equal(pcm, ref.decode_audio())
    # an explicit speech length and decode depth pass through
    alm.decode_audio(n_q=2, n_speech_frames=5)
    assert codec.last_codes.shape == (5, N_CB) and codec.last_n_q == 2


def test_nq_subset_decode(ttsd_like_gguf):  # noqa: F811
    """The LM predicts fewer codebooks than the codec has levels: decode
    runs at the LM's width (the 16-of-32 pattern)."""
    path, _ = ttsd_like_gguf
    codec = StubCodec(n_q=32, codebook_size=20)
    alm = AudioLM(GGUFReader(path), codec=codec, device="cpu")
    rng = np.random.default_rng(6)
    alm.push_codes(rng.integers(10, 30, size=(8, N_CB)).astype(np.int32))
    alm.decode_audio()
    assert codec.last_codes.shape[1] == N_CB


def test_push_codes_modality_and_token_keys(tmp_path):
    """The modality bits and codec.audio_token.* keys read as codec_tpu
    reads them; push_codes widths and the decode_audio errors."""
    g = torch.Generator().manual_seed(1)
    path = tmp_path / "keys.gguf"
    w = GGUFWriter(path, "mimi")
    w.add_uint32("codec.sample_rate", 24000)
    w.add_bool("codec.has_decoder", True)
    w.add_bool("codec.lm.has_adaptor", True)
    w.add_string("codec.lm.kind", "parallel_heads_delay")
    w.add_string("codec.lm.host_arch", "qwen3")
    w.add_uint32("codec.lm.hidden_dim", H)
    w.add_uint32("codec.lm.audio_embed_dim", H)
    w.add_uint32("codec.lm.n_codebook", N_CB)
    w.add_array("codec.lm.codebook_sizes", SIZES)
    w.add_array("codec.lm.delay_pattern", [0] * N_CB)
    w.add_bool("codec.lm.modality.text_in", True)
    w.add_bool("codec.lm.modality.audio_out", True)
    w.add_bool("codec.lm.modality.text_out", True)
    w.add_int32("codec.audio_token.offset", 1000)
    w.add_int32("codec.audio_token.count", 20)
    w.add_int32("codec.audio_token.eos_id", 999)
    for i, v in enumerate(SIZES):
        w.add_tensor(f"lm.heads_{i}.weight",
                     (torch.randn(v, H, generator=g) * 0.3).numpy())
        w.add_tensor(f"lm.audio_embd_{i}.weight",
                     (torch.randn(v, H, generator=g) * 0.5).numpy())
    w.write()

    alm, ref = _pair(path)
    assert alm.modality == ref.modality == (
        MODALITY_TEXT_IN | MODALITY_AUDIO_OUT | MODALITY_TEXT_OUT)
    assert not alm.modality & MODALITY_AUDIO_IN
    assert alm.token_range == AudioTokenRange(1000, 20, 999)
    assert (ref.token_range.offset, ref.token_range.count,
            ref.token_range.eos_id) == (1000, 20, 999)
    for tok, want in ((1005, ObserveAction.CONSUMED),
                      (1020, ObserveAction.PASSTHROUGH),
                      (999, ObserveAction.STOP)):
        assert alm.observe_token(tok) is want
        assert ref.observe_token(tok).name == want.name
    alm.reset()
    alm.push_codes(np.arange(8))                # [T] → [T, 1] frames
    assert alm.codes_matrix().shape == (8, 1)
    with pytest.raises(LmError, match="mismatches"):
        alm.push_codes(np.zeros((2, N_CB), np.int32))
    with pytest.raises(ValueError, match="no codec"):
        alm.decode_audio()
    empty = AudioLM(GGUFReader(path), codec=StubCodec(N_CB, 20),
                    device="cpu")
    with pytest.raises(LmError, match="no codes"):
        empty.decode_audio()
