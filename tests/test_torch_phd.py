"""The port's parallel_heads_delay kind (codec_tpu_torch/lm/
parallel_heads_delay.py) and the MOSS-TTSD flow through run_codebook_ar and
tts-cli-torch against codec_tpu on the CPU.

Fixtures: tests/test_lm_adaptors.py's phd_gguf recipe (untied heads,
delays 0..3, EOS 7 from step 2), written with the port's GGUFWriter; and a
small MOSS-TTSD file from the port's writer (models/lm_tts_init.py: a
small XY-Tokenizer with 4 codebooks of 32 and a tied-head adaptor whose
cb0 is a 300-id merged vocabulary, speech ids [100, 132), pad 32) over
Qwen3-style backbones (qk-norm, hidden 256) in Q8_0 and Q4_K with the
byte-fallback SPM vocabulary. Both packages run with packed backbone
weights.

Bounds: head logits within 1e-5 x peak (f32 on both sides, sums in another
order); composed embeddings equal; greedy codes equal; PCM corr > 0.9999
(the delay-transformed XY decode).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.cli.tts_cli import main as jax_main
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu.lm.prompt_info import build_prompt_info as jax_prompt_info
from codec_tpu_torch.cli.tts_cli import main
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import create_lm, tts_runner
from codec_tpu_torch.lm import parallel_heads_delay as phd
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.lm.base import LmError, LmStateError
from codec_tpu_torch.lm.prompt_info import build_prompt_info
from codec_tpu_torch.models import xy_tokenizer as xy
from codec_tpu_torch.models.lm_init import (byte_fallback_vocab, spm_model_b64,
                                            write_random_backbone_gguf)
from codec_tpu_torch.models.lm_tts_init import (QWEN3_1_7B, PhdConfig,
                                                write_moss_ttsd_gguf)
from codec_tpu_torch.ops.sample import OnDeviceSampling

H, N_CB, SIZES = 32, 4, [50, 20, 20, 20]
# tests/test_torch_xy.py's small XY-Tokenizer with 4 codebooks
XY = xy.XyConfig(encoder_downsample_rate=256, decoder_upsample_rate=192,
                 latent_dim=128, codebook_dim=16, codebook_size=32, n_q=4,
                 mel_n_mels=16, mel_n_fft=64, mel_hop=32, n_layers=1,
                 adapter_layers=1, d_model=32, n_heads=2, vocos_blocks=1,
                 vocos_n_fft=96, vocos_hop=24)
XY_WIDTHS = dict(ffn_dim=64, vocos_dim=32, vocos_intermediate=64,
                 post_pos=64, dec_pos=64)
PHD = PhdConfig(hidden=256, n_codebook=4, text_vocab=300, audio_vocab=33,
                speech_start=100, speech_end=132, speech_pad=32,
                eos_code_c0=-1)
BB = dataclasses.replace(QWEN3_1_7B, hidden=256, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=64, ffn_dim=512,
                         vocab_size=300, max_ctx=320)
QTYPES = ("Q8_0", "Q4_K")
HOP = 192                     # XY samples a code


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_lm_adaptors.py's phd_gguf (untied heads), both packages."""
    g = torch.Generator().manual_seed(0)
    heads = [torch.randn(v, H, generator=g) * 0.3 for v in SIZES]
    embds = [torch.randn(v, H, generator=g) * 0.5 for v in SIZES]
    path = tmp_path_factory.mktemp("phd") / "phd.gguf"
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
    w.add_array("codec.lm.delay_pattern", [0, 1, 2, 3])
    w.add_int32("codec.lm.eos_code_c0", 7)
    w.add_int32("codec.lm.eos_min_step", 2)
    for i in range(N_CB):
        w.add_tensor(f"lm.heads_{i}.weight", heads[i].numpy())
        w.add_tensor(f"lm.audio_embd_{i}.weight", embds[i].numpy())
    w.write()
    return (create_lm(GGUFReader(path), device="cpu"),
            jax_create_lm(JaxReader(str(path))))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ttsd")
    spm = spm_model_b64(byte_fallback_vocab())
    model = write_moss_ttsd_gguf(tmp / "ttsd.gguf", seed=5, phd=PHD,
                                 xy_cfg=XY, **XY_WIDTHS)
    bbs = {q: write_random_backbone_gguf(tmp / f"bb_{q}.gguf", seed=6,
                                         qtype=q, cfg=BB, rope_scaling=None,
                                         spm_b64=spm)
           for q in QTYPES}
    return tmp, model, bbs


def _engine(model_path, bbs, port: bool):
    if port:
        reader = GGUFReader(model_path)
        lm = create_lm(reader, device="cpu")
        return dict(port=True, reader=reader, lm=lm,
                    pi=build_prompt_info(reader, lm.info),
                    codec=codec_tpu_torch.load_model(model_path, device="cpu"),
                    bb={q: LlamaBackbone(p, quantized=True, device="cpu")
                        for q, p in bbs.items()})
    reader = JaxReader(str(model_path))
    lm = jax_create_lm(reader)
    return dict(port=False, reader=reader, lm=lm,
                pi=jax_prompt_info(reader, lm.info),
                codec=codec_tpu.load_model(str(model_path)),
                bb={q: JaxBackbone(str(p), quantized=True)
                    for q, p in bbs.items()})


@pytest.fixture(scope="module")
def engines(files):
    _, model, bbs = files
    return _engine(model, bbs, True), _engine(model, bbs, False)


PROMPT = [3, 17, 42, 99, 150, 7, 260]


def _synth(eng, qtype, max_steps=6, on_device=None, bucket=0):
    alm_cls, run = ((AudioLM, tts_runner.run_codebook_ar) if eng["port"]
                    else (JaxAudioLM, jax_runner.run_codebook_ar))
    bb = eng["bb"][qtype]
    bb.reset()
    alm = alm_cls(eng["reader"], codec=eng["codec"], lm=eng["lm"])
    rows = [alm.compose_prompt_embd(t) for t in PROMPT]
    kw = {} if on_device is None else {"on_device": on_device}
    return run(alm, bb, rows, max_steps=max_steps, pi=eng["pi"],
               prefill_bucket=bucket, **kw)


def _pcm_len(eng, frames):
    """The XY decode's length for `frames` codes (each decode window adds
    the iSTFT's tail)."""
    return eng["codec"].decode(np.zeros((frames, N_CB), np.int32)).shape[0]


def _corr(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.corrcoef(a, b)[0, 1]


def test_info_logits_compose_match(tiny):
    lm, ref = tiny
    assert dataclasses.asdict(lm.info) == dataclasses.asdict(ref.info)
    assert lm.info.delay_pattern == (0, 1, 2, 3) and lm.pos_emb is None
    h = np.random.default_rng(0).standard_normal(H).astype(np.float32)
    st, rst = lm.new_state(), ref.new_state()
    st.step_begin(h)
    rst.step_begin(h)
    for k in range(N_CB):
        got, cb = st.step_logits()
        want, _ = rst.step_logits()
        assert cb == k and got.shape == (SIZES[k],) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        st.step_push_code(int(np.argmax(want)))
        rst.step_push_code(int(np.argmax(want)))
    assert st.step_finish() == rst.step_finish()
    for codes in ([3, 5, -1, 2], [-1, -1, -1, -1], [49, 19, 19, 19]):
        np.testing.assert_array_equal(lm.compose_audio_embd(codes),
                                      ref.compose_audio_embd(codes))
        np.testing.assert_array_equal(lm.compose_next_embd(codes, 3),
                                      ref.compose_next_embd(codes, 3))
    np.testing.assert_array_equal(lm.audio_embd(2, 5), ref.audio_embd(2, 5))


def test_load_matches_params_from_jax(tiny, engines):
    for lm, ref in (tiny, (engines[0]["lm"], engines[1]["lm"])):
        want = phd.params_from_jax(ref.heads, ref.audio_embds, ref.pos_emb)
        for name in ("heads", "audio_embds"):
            got = getattr(lm, name)
            assert len(got) == len(want[name]) == lm.info.n_codebook
            for a, b in zip(got, want[name]):
                assert torch.equal(a, b)
        assert want["pos_emb"] is None and lm.pos_emb is None
    moss = engines[0]["lm"]                      # tied: the same tensors
    assert all(h is e for h, e in zip(moss.heads, moss.audio_embds))
    assert moss.info.codebook_sizes == (300, 33, 33, 33)


def test_eos_min_step_and_state_machine(tiny):
    lm, ref = tiny
    for m in (lm, ref):
        st = m.new_state()
        for frame, (c0, expect) in enumerate([(7, False), (3, False), (7, True)]):
            st.step_begin(np.zeros(H, np.float32))
            for k in range(N_CB):
                st.step_logits()
                st.step_push_code(c0 if k == 0 else 0)
            assert st.step_is_eos(st.step_finish()) is expect, frame
    st = lm.new_state()
    with pytest.raises(LmStateError):
        st.step_logits()
    with pytest.raises(LmError, match="hidden size"):
        st.step_begin(np.zeros(H + 1, np.float32))
    st.step_begin(np.zeros(H, np.float32))
    with pytest.raises(LmStateError):
        st.step_begin(np.zeros(H, np.float32))
    st.step_logits()
    with pytest.raises(LmStateError):
        st.step_logits()
    with pytest.raises(LmError, match="out of range"):
        st.step_push_code(SIZES[0])
    st.step_push_code(0)
    with pytest.raises(LmStateError):
        st.step_finish()
    with pytest.raises(LmError, match="out of range"):
        lm.audio_embd(0, SIZES[0])
    with pytest.raises(LmError, match="n_codebook"):
        lm.compose_audio_embd([1, 2])


@pytest.mark.parametrize("chain", [None, (0.0, 0, 1.0, 0.0)],
                         ids=["traced_chain", "greedy"])
def test_frame_matches_reference_fused_frame(engines, chain):
    """The on-device frame, greedy, head 0 masked to the speech range and
    EOS: codec_tpu's fused_frame on the same hiddens."""
    port, ref = engines
    lm, rlm = port["lm"], ref["lm"]
    rng = np.random.default_rng(3)
    h = rng.standard_normal((3, PHD.hidden)).astype(np.float32) * 4
    cb0 = (PHD.speech_start, PHD.speech_end, 5)
    frame = lm._build_frame(chain, cb0_range=cb0)
    noise = torch.zeros((3, N_CB, lm.noise_width()))
    assert lm.noise_width() == PHD.text_vocab
    chains = None if chain else torch.zeros((3, 4))
    got = frame(torch.from_numpy(h), noise, torch.zeros(3, dtype=torch.long),
                chains).numpy()
    import jax

    fused = rlm.fused_frame(cb0_range=cb0)
    for b in range(3):
        want = np.asarray(fused(h[b], jax.random.PRNGKey(0), 0))
        np.testing.assert_array_equal(got[b], want)
    assert ((got[:, 0] >= PHD.speech_start) & (got[:, 0] < PHD.speech_end)
            | (got[:, 0] == 5)).all()


@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_codes_and_pcm_match(engines, qtype):
    port, ref = engines
    got, want = _synth(port, qtype), _synth(ref, qtype)
    assert got.codes.shape == (6, N_CB) and got.codes.dtype == np.int32
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps, want.stopped_by_eos)
    assert ((got.codes[:, 0] >= PHD.speech_start)
            & (got.codes[:, 0] < PHD.speech_end)).all()
    # the delay unshift leaves 6 - 3 frames
    assert got.pcm.shape == want.pcm.shape == (_pcm_len(port, 3),)
    assert _corr(got.pcm, want.pcm) > 0.9999


@pytest.mark.parametrize("chunk", [1, 4])
def test_on_device_chunk_equals_host(engines, chunk):
    """The chunk on the device path (K frames of frame + EOS gate +
    compose + backbone step a call), greedy, head 0 masked in-graph: the
    host path's codes."""
    port, _ = engines
    host = _synth(port, "Q8_0", max_steps=7)
    dev = _synth(port, "Q8_0", max_steps=7,
                 on_device=OnDeviceSampling(chunk_frames=chunk))
    np.testing.assert_array_equal(dev.codes, host.codes)
    assert dev.n_steps == host.n_steps == 7
    assert _corr(dev.pcm, host.pcm) > 0.99999


def test_eos_and_delay_flush_match(files, engines):
    """EOS = the cb0 id greedy decoding emits at frame 2, honoured from
    step 2 (eos_min_step): the stop, the delay-tail flush of 3 frames with
    cb0 forced to EOS, and the unshifted decode of the 2 speech frames."""
    tmp, _, bbs = files
    frame = 2
    code = int(_synth(engines[0], "Q8_0").codes[frame, 0])
    path = write_moss_ttsd_gguf(
        tmp / "ttsd_eos.gguf", seed=5, xy_cfg=XY, **XY_WIDTHS,
        phd=dataclasses.replace(PHD, eos_code_c0=code, eos_min_step=frame))
    bb = {"Q8_0": bbs["Q8_0"]}
    port = _engine(path, bb, True)
    got = _synth(port, "Q8_0", max_steps=12)
    want = _synth(_engine(path, bb, False), "Q8_0", max_steps=12)
    assert got.stopped_by_eos and want.stopped_by_eos
    assert got.n_steps == want.n_steps == frame + 1 + (N_CB - 1)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.codes[frame:, 0] == code).all()
    assert got.pcm.shape == want.pcm.shape == (_pcm_len(port, frame),)
    assert _corr(got.pcm, want.pcm) > 0.9999


@pytest.mark.parametrize("qtype", QTYPES)
def test_cli_synthesize_matches_reference(files, tmp_path, monkeypatch,
                                          qtype, capsys):
    """tts-cli-torch synthesize on the MOSS-TTSD file (the composed
    prompt, the cb0 range, the delay transform) with --quant-exec, against
    codec_tpu's CLI; --stream is ignored on a backbone flow, as there."""
    _, model, bbs = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bbs[qtype]),
            "--text", "hello there", "--max-frames", "6", "--quant-exec",
            "--temp", "0", "--prefill-bucket", "64"]
    assert main(args + ["--out", str(tmp_path / "port.wav"), "--device",
                        "cpu", "--stream"]) == 0
    assert "backbone AR done: 6 steps" in capsys.readouterr().out
    monkeypatch.delenv("CODEC_QUANT_EXEC", raising=False)
    try:
        assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    finally:
        os.environ.pop("CODEC_QUANT_EXEC", None)       # its main() sets it
    got, sr = read_wav(tmp_path / "port.wav")
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    assert sr == jsr == 24000 and got.shape == want.shape
    assert got.shape[0] > 3 * HOP
    assert _corr(got, want) > 0.9999
