"""The port's LFM2-Audio flow (codec_tpu_torch/lm/residual_depth_ar.py's
per-position in_proj, pre-head norms, c0 modality "none" and compose table;
lm/tts_runner.run_lfm2_sequential; the tts-cli branch) against codec_tpu
on the CPU.

Fixtures are the port's writers at small widths, read by both packages:
models/lm_tts_init.py::write_lfm2_audio_gguf (a tiny Mimi with an LFM2
adaptor of 4 codebooks of 64 + 1 codes over a backbone hidden of 256; its
EOS counts from frame 20, so greedy requests run their length) and a Q8_0
llama backbone at LFM2_1_2B's flags (qk-norm, RoPE theta 1e6) with the
byte-fallback SPM vocab.

Bounds: depth logits within 1e-5 of their peak (f32 on both sides, sums in
another order); the compose table's host rows equal codec_tpu's bit for bit
(the same F16 rows, NumPy's sum on both), its device form within 1e-6 of
the peak (torch's sum in another order); greedy text tokens and codes
equal; sampled frames equal with codec_tpu's key-split Gumbel noise fed
in; PCM corr > 0.99999 and max abs err <= 1e-4 x peak.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.cli.tts_cli import main as jax_main
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu.lm.prompt_info import build_prompt_info as jax_prompt_info
from codec_tpu.ops.sample import OnDeviceSampling as JaxOnDevice
from codec_tpu_torch.cli.tts_cli import main
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.lm.prompt_info import build_prompt_info
from codec_tpu_torch.models import lm_tts_init as lti
from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                            spm_model_b64,
                                            write_random_backbone_gguf)
from codec_tpu_torch.ops.sample import OnDeviceSampling
from test_torch_tts import MIMI, _assert_close_pcm

LFM2 = lti.Lfm2Config(hidden=256, depth_hidden=32, layers=2, heads=4,
                      kv_heads=2, ffn=48, n_codebook=4, audio_vocab=65,
                      audio_start_id=5, text_end_id=6, max_text_tokens=3,
                      eos_min_step=20)
BB = dataclasses.replace(lti.LFM2_1_2B, hidden=256, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=64, ffn_dim=512,
                         vocab_size=300, max_ctx=192)
PROMPT = [3, 17, 42, 99]
SAMPLED = dict(temperature=0.8, top_k=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- helpers shared with tests/test_torch_realtime.py ---------------------------

def codebook_noise(key, lm):
    """The Gumbel noise [n_cb, W] codec_tpu's frame draws from `key` for a
    depth-emits-c0 frame: per codebook `split(key, n_cb)`, each draw over
    the padded head width."""
    w = lm.noise_width()
    return np.stack([np.asarray(jax.random.gumbel(k, (w,), jnp.float32))
                     for k in jax.random.split(key, lm.info.n_codebook)])


def frame_noise(key, lm, n_frames):
    """The noise [K, n_cb, W] of codec_tpu's chunk for K frames (per frame
    `key, sub = split(key)`, then codebook_noise(sub)), and the key after
    them."""
    out = []
    for _ in range(n_frames):
        key, sub = jax.random.split(key)
        out.append(codebook_noise(sub, lm))
    return np.stack(out), key


def chain_of(temperature=0.0, top_k=0, top_p=1.0, min_p=0.0):
    return (float(temperature), int(top_k), float(top_p), float(min_p))


def host_logits(lm, h, codes):
    """Each codebook's logits of the host step machine for hidden h, the
    codes pushed in turn."""
    st = lm.new_state()
    st.step_begin(h)
    out = []
    for c in codes:
        lg, _ = st.step_logits()
        out.append(np.asarray(lg, np.float64))
        st.step_push_code(int(c))
    st.step_finish()
    return out


def make_engines(model, bb_path):
    """Both packages on the same files: reader, codec, AudioLM and packed
    backbone each, and the PromptInfo each builds with its LM's info."""
    reader = GGUFReader(model)
    port = dict(reader=reader, codec=codec_tpu_torch.load_model(model,
                                                                device="cpu"),
                bb=LlamaBackbone(bb_path, quantized=True, device="cpu"))
    port["alm"] = AudioLM(reader, codec=port["codec"], device="cpu")
    port["lm"] = port["alm"].lm
    port["pi"] = build_prompt_info(reader, port["lm"].info)
    jreader = JaxReader(str(model))
    ref = dict(reader=jreader, codec=codec_tpu.load_model(str(model)),
               bb=JaxBackbone(str(bb_path), quantized=True))
    ref["alm"] = JaxAudioLM(jreader, codec=ref["codec"])
    ref["lm"] = ref["alm"].lm
    ref["pi"] = jax_prompt_info(jreader, ref["lm"].info)
    return port, ref


def cli_pair(args, tmp_path, monkeypatch):
    """The port's tts-cli (on the CPU) and codec_tpu's on the same
    arguments → (port PCM, codec_tpu PCM, rate)."""
    assert main(args + ["--out", str(tmp_path / "port.wav"), "--device",
                        "cpu"]) == 0
    monkeypatch.delenv("CODEC_QUANT_EXEC", raising=False)
    try:
        assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    finally:
        os.environ.pop("CODEC_QUANT_EXEC", None)       # its main() sets it
    got, sr = read_wav(tmp_path / "port.wav")
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    assert sr == jsr
    return got, want, sr


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lfm2")
    model = lti.write_lfm2_audio_gguf(tmp / "lfm2.gguf", seed=3, lfm2=LFM2,
                                      mimi_cfg=MIMI, num_filters=8)
    bb = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=4, qtype="Q8_0", cfg=BB, rope_scaling=None,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    return tmp, model, bb


@pytest.fixture(scope="module")
def engines(files):
    _, model, bb = files
    return make_engines(model, bb)


def _lfm2(eng, ods=None, sampler=None, max_frames=6, port=True):
    run = tts_runner.run_lfm2_sequential if port else \
        jax_runner.run_lfm2_sequential
    cls = OnDeviceSampling if port else JaxOnDevice
    bb = eng["bb"]
    bb.reset()
    table = bb.params["tok_embd"] if port else np.asarray(
        bb.params["tok_embd"], np.float32)
    return run(eng["alm"], bb, table, PROMPT, eng["pi"], max_frames=max_frames,
               sampler=sampler, on_device=None if ods is None else cls(**ods))


# -- the adaptor --------------------------------------------------------------

def test_load_matches_reference(engines):
    """The LFM2 flags, the per-position in_proj with its bias, the pre-head
    norms and the compose table load as codec_tpu loads them."""
    port, ref = engines
    lm, jlm = port["lm"], ref["lm"]
    for flag in ("in_proj_per_pos", "has_pre_head_norm", "c0_is_none",
                 "depth_emits_c0", "rope_interleaved", "has_output_norm",
                 "has_qk_norm", "compose_stride", "rope_theta"):
        assert getattr(lm, flag) == getattr(jlm, flag), flag
    assert lm.in_proj_per_pos and lm.c0_is_none and not lm.has_output_norm
    for name in ("compose_table", "in_proj", "in_proj_bias"):
        np.testing.assert_array_equal(getattr(lm, name).numpy(),
                                      np.asarray(getattr(jlm, name)))
    for got, want in zip(lm.heads_pre_norm, jlm.heads_pre_norm):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lm.info.compose_audio_embed_dim == LFM2.hidden
    # the port builds PromptInfo with the LM's info; codec_tpu's CLI without
    # it (build_prompt_info(reader)): the flow's fields agree either way
    cli_pi = jax_prompt_info(ref["reader"])
    for pi in (ref["pi"], cli_pi):
        assert port["pi"].sequential_text_audio and pi.sequential_text_audio
        assert not port["pi"].streaming_interleave and not pi.streaming_interleave
        for key in ("audio_start_id", "text_end_id", "max_text_tokens",
                    "default_temperature", "default_top_k", "default_top_p",
                    "prompt_prefix", "prompt_suffix", "add_bos"):
            assert getattr(port["pi"], key) == getattr(pi, key), key


def test_host_logits_match_reference(engines):
    """The host step machine's logits of every codebook (row 0 zero, the
    per-position in_proj of h, pre-head norms) within 1e-5 of their peak."""
    port, ref = engines
    h = (np.random.default_rng(5).standard_normal(LFM2.hidden) * 0.5
         ).astype(np.float32)
    codes = [int(np.argmax(lg)) for lg in host_logits(ref["lm"], h, [0] * 4)]
    for got, want in zip(host_logits(port["lm"], h, codes),
                         host_logits(ref["lm"], h, codes)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("chain", [dict(), SAMPLED,
                                   dict(temperature=1.1, top_p=0.8)])
def test_frame_matches_reference(engines, chain):
    """The on-device frame, codec_tpu's key-split noise fed in: the codes
    of codec_tpu's fused_frame over 4 hiddens."""
    port, ref = engines
    frame = port["lm"]._build_frame(chain_of(**chain))
    jframe = ref["lm"].fused_frame(**chain)
    rng = np.random.default_rng(6)
    for s in range(4):
        h = (rng.standard_normal(LFM2.hidden) * 0.5).astype(np.float32)
        key = jax.random.PRNGKey(s)
        noise = codebook_noise(key, port["lm"])
        with torch.inference_mode():
            got = frame(torch.from_numpy(h)[None],
                        torch.from_numpy(noise)[None],
                        torch.tensor([0]))[0].numpy()
        want = np.asarray(jframe(jnp.asarray(h), key, jnp.int32(0)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codes", [[3, 0, 64, 17], [-1, 5, -1, 2],
                                   [-1, -1, -1, -1]],
                         ids=["all", "skips", "none"])
def test_compose_table_host_matches_reference(engines, codes):
    """compose_audio_embd with the table: rows codes[i] + i * stride, the
    -1 guard, a zero row when no code is live; codec_tpu's bit for bit."""
    port, ref = engines
    got = port["lm"].compose_audio_embd(codes)
    want = ref["lm"].compose_audio_embd(codes)
    assert got.shape == want.shape == (LFM2.hidden,)
    np.testing.assert_array_equal(got, want)


def test_compose_table_device_matches_host(engines):
    """The device form (gather table[codes + i * stride], f32 sum) against
    the host form and codec_tpu's compose_embd_fn on 8 random frames."""
    port, ref = engines
    rng = np.random.default_rng(7)
    codes = rng.integers(0, LFM2.audio_vocab, (8, LFM2.n_codebook))
    got = port["lm"].compose_embd_fn()(torch.from_numpy(codes)).numpy()
    jfn = ref["lm"].compose_embd_fn()
    for row, g in zip(codes, got):
        want = port["lm"].compose_audio_embd(row.tolist())
        peak = np.abs(want).max()
        assert np.abs(g - want).max() <= 1e-6 * peak
        j = np.asarray(jfn(jnp.asarray(row, jnp.int32)))
        assert np.abs(g - j).max() <= 1e-6 * peak


# -- the flow ------------------------------------------------------------------

class _Greedy:
    """A greedy host sampler that records what it picks."""

    def __init__(self):
        self.picks = []

    def __call__(self, logits):
        self.picks.append(int(np.argmax(logits)))
        return self.picks[-1]


def test_greedy_flow_matches_reference(engines):
    """run_lfm2_sequential greedy: the text phase's tokens (the tied-
    embedding logits on the port's device), the audio codes and the PCM."""
    port, ref = engines
    gs, js = _Greedy(), _Greedy()
    got = _lfm2(port, sampler=gs)
    want = _lfm2(ref, sampler=js, port=False)
    assert gs.picks[:LFM2.max_text_tokens] == js.picks[:LFM2.max_text_tokens]
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.shape == (6, LFM2.n_codebook)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos)
    _assert_close_pcm(got.pcm, want.pcm)
    # the default sampler is the family's (greedy, temperature 0)
    np.testing.assert_array_equal(_lfm2(port).codes, got.codes)


def test_text_end_returns_no_codes(engines):
    """text_end_id before audio_start_id: no codes, stopped, as codec_tpu."""
    port, ref = engines
    for eng, is_port in ((port, True), (ref, False)):
        script = iter([1, LFM2.text_end_id])
        res = _lfm2(eng, sampler=lambda lg: next(script), port=is_port)
        assert res.stopped_by_eos and res.codes.shape == (0, LFM2.n_codebook)
        assert res.pcm is None and res.n_steps == 0


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunks_match_host(engines, chunk):
    """The audio phase in chunks of 2 and 4 (eager on the CPU): greedy codes
    equal the host path's and codec_tpu's chunked run's."""
    port, ref = engines
    host = _lfm2(port)
    got = _lfm2(port, ods=dict(chunk_frames=chunk))
    want = _lfm2(ref, ods=dict(chunk_frames=chunk), port=False)
    np.testing.assert_array_equal(got.codes, host.codes)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.n_steps == host.n_steps == want.n_steps
    _assert_close_pcm(got.pcm, host.pcm)


def test_sampled_chunks_agree(engines):
    """Sampled audio frames: chunks of 2 and 3 draw the same noise stream
    (one [n_cb, W] draw a frame), so the codes are the same."""
    port, _ = engines
    runs = [_lfm2(port, ods=dict(SAMPLED, chunk_frames=k, seed=5))
            for k in (2, 3)]
    np.testing.assert_array_equal(runs[0].codes, runs[1].codes)
    assert not np.array_equal(runs[0].codes, _lfm2(port).codes)


def test_bucketed_prefill_matches_steps(engines):
    """prefill_bucket > 0 (one padded forward over the prompt, the port's
    option; codec_tpu steps a token at a time): the same greedy text
    tokens and codes."""
    port, _ = engines
    bb = port["bb"]
    runs = []
    for bucket in (0, 8):
        gs = _Greedy()
        bb.reset()
        runs.append((tts_runner.run_lfm2_sequential(
            port["alm"], bb, bb.params["tok_embd"], PROMPT, port["pi"],
            max_frames=6, sampler=gs, decode=False,
            prefill_bucket=bucket), gs.picks))
    np.testing.assert_array_equal(runs[0][0].codes, runs[1][0].codes)
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "chunks"])
def test_cli_matches_reference(files, tmp_path, monkeypatch, capsys,
                               on_device):
    """tts-cli-torch synthesize on the LFM2 file (greedy by the family's
    defaults, --quant-exec, the prompt through the baked SPM vocab) against
    codec_tpu's CLI; with --on-device both run chunks of 4."""
    _, model, bb = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "5", "--quant-exec"]
    if on_device:
        args += ["--on-device", "--chunk-frames", "4"]
    got, want, sr = cli_pair(args, tmp_path, monkeypatch)
    assert "backbone AR done: 5 steps" in capsys.readouterr().out
    assert sr == MIMI.sample_rate and got.shape == want.shape
    assert got.shape[0] == 5 * MIMI.hop_size
    _assert_close_pcm(got, want)
