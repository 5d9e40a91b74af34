"""The port's CSM-style TTS slice (codec_tpu_torch/lm, cli/tts_cli.py)
against codec_tpu on the CPU.

Fixtures come from the port's writers (models/lm_init.py), which codec_tpu
reads too: a tiny Mimi with a residual_depth_ar adaptor over a backbone
hidden of 256, and llama backbones in Q8_0 and Q4_K (Q4_K needs input
widths that are multiples of 256) with a baked SPM vocab. Both packages
run with packed backbone weights (quantized=True), the CPU path of the
dequantizing products.

Bounds: depth logits within 1e-5 of max|logit| (f32 on both sides, sums
in another order); greedy and sampled codes equal; PCM corr > 0.99999
and max abs err <= 1e-4 * peak (the bound of tests/test_torch_mimi.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import create_lm, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.base import LmError, LmStateError
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B, DepthConfig,
                                            byte_fallback_vocab,
                                            spm_model_b64,
                                            write_random_backbone_gguf,
                                            write_random_csm_gguf)
from codec_tpu_torch.models.mimi import MimiConfig

MIMI = MimiConfig(n_q=4, codebook_size=64, codebook_dim=32, hidden=64,
                  n_layers=1, n_heads=2, head_dim=32, intermediate=128,
                  window=40)
DEPTH = DepthConfig(hidden=256, depth_hidden=24, layers=1, heads=2,
                    kv_heads=2, head_dim=12, ffn=48, n_codebook=4, vocab=64)
BB = dataclasses.replace(LLAMA_3_2_1B, hidden=256, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=64, ffn_dim=512,
                         vocab_size=300, max_ctx=96)
QTYPES = ("Q8_0", "Q4_K")
PROMPT = [3, 17, 42, 99, 150, 7]


def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99999, corr
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# residual_depth_ar on tests/test_lm_adaptors.py's rda_gguf recipe
# ---------------------------------------------------------------------------

H, N_CB, SIZES = 32, 4, [50, 20, 20, 20]
DH, DHEADS, DHD, DINTER, DLAYERS = 24, 2, 12, 48, 2


def _rda_gguf(path, variant):
    """CSM flags (shared in_proj, c0 head, NEOX rope), or the same with
    qk-norm, one KV head, llama3-style freq factors and interleaved rope."""
    g = torch.Generator().manual_seed(1)
    dkv = 2 if variant == "csm" else 1

    def W(*shape, s=0.3):
        return (torch.randn(*shape, generator=g) * s).numpy()

    t = {"lm.c0_head.weight": W(SIZES[0], H),
         "lm.depth.in_proj.weight": W(DH, H),
         "lm.depth.output_norm.weight": W(DH, s=0.2) + 1.0}
    for i in range(N_CB):
        t[f"lm.audio_embd_{i}.weight"] = W(SIZES[i], H, s=0.5)
    for i in range(N_CB - 1):
        t[f"lm.depth.heads_{i}.weight"] = W(SIZES[i + 1], DH)
    for li in range(DLAYERS):
        p = f"lm.depth.blk_{li}"
        t[f"{p}.attn_norm.weight"] = W(DH, s=0.2) + 1.0
        t[f"{p}.q.weight"] = W(DHEADS * DHD, DH)
        t[f"{p}.k.weight"] = W(dkv * DHD, DH)
        t[f"{p}.v.weight"] = W(dkv * DHD, DH)
        t[f"{p}.o.weight"] = W(DH, DHEADS * DHD)
        t[f"{p}.ffn_norm.weight"] = W(DH, s=0.2) + 1.0
        t[f"{p}.ffn_gate.weight"] = W(DINTER, DH)
        t[f"{p}.ffn_up.weight"] = W(DINTER, DH)
        t[f"{p}.ffn_down.weight"] = W(DH, DINTER)
        if variant != "csm":
            t[f"{p}.q_norm.weight"] = W(DHD, s=0.2) + 1.0
            t[f"{p}.k_norm.weight"] = W(DHD, s=0.2) + 1.0
    if variant != "csm":
        t["lm.depth.rope_freq_factors"] = (1.0 + np.arange(DHD // 2)).astype(np.float32)
    w = GGUFWriter(path, "mimi")
    w.add_uint32("codec.sample_rate", 24000)
    w.add_bool("codec.has_decoder", True)
    w.add_bool("codec.lm.has_adaptor", True)
    w.add_string("codec.lm.kind", "residual_depth_ar")
    w.add_string("codec.lm.host_arch", "llama")
    w.add_uint32("codec.lm.hidden_dim", H)
    w.add_uint32("codec.lm.audio_embed_dim", H)
    w.add_uint32("codec.lm.n_codebook", N_CB)
    w.add_array("codec.lm.codebook_sizes", SIZES)
    w.add_array("codec.lm.delay_pattern", [0] * N_CB)
    for key, val in (("depth_layers", DLAYERS), ("depth_hidden", DH),
                     ("depth_n_heads", DHEADS), ("depth_n_kv_heads", dkv),
                     ("depth_head_dim", DHD), ("depth_intermediate", DINTER)):
        w.add_uint32(f"codec.lm.residual.{key}", val)
    w.add_float32("codec.lm.residual.depth_rope_theta", 10000.0)
    w.add_float32("codec.lm.residual.depth_rms_norm_eps", 1e-5)
    w.add_bool("codec.lm.residual.depth_has_in_proj", True)
    w.add_bool("codec.lm.residual.depth_has_qk_norm", variant != "csm")
    w.add_bool("codec.lm.residual.depth_rope_interleaved", variant != "csm")
    w.add_bool("codec.lm.residual.depth_has_output_norm", True)
    w.add_bool("codec.lm.residual.depth_use_rope", True)
    w.add_string("codec.lm.residual.c0_input_modality", "audio")
    for name, a in t.items():
        w.add_tensor(name, a)
    w.write()
    return path


@pytest.mark.parametrize("variant", ["csm", "qk_norm-gqa-freq-interleaved"])
def test_rda_logits_match_reference(tmp_path, variant):
    path = _rda_gguf(tmp_path / "rda.gguf", variant)
    lm = create_lm(GGUFReader(path), device="cpu")
    ref = jax_create_lm(JaxReader(path))
    assert dataclasses.asdict(lm.info) == dataclasses.asdict(ref.info)
    h = np.random.default_rng(2).standard_normal(H).astype(np.float32)
    for frame in range(2):
        st, rst = lm.new_state(), ref.new_state()
        st.step_begin(h * (frame + 1))
        rst.step_begin(h * (frame + 1))
        for k in range(N_CB):
            got, cb = st.step_logits()
            want, _ = rst.step_logits()
            assert cb == k and got.shape == (SIZES[k],) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            code = int(np.argmax(want))
            st.step_push_code(code)
            rst.step_push_code(code)
        assert st.step_finish() == rst.step_finish()
    codes = [1, 2, 3, 4]
    np.testing.assert_allclose(lm.compose_audio_embd(codes),
                               ref.compose_audio_embd(codes), rtol=0, atol=0)
    np.testing.assert_array_equal(lm.compose_audio_embd([-1, 2, -1, 4]),
                                  ref.compose_audio_embd([-1, 2, -1, 4]))
    np.testing.assert_array_equal(lm.audio_embd(2, 5), ref.audio_embd(2, 5))


def test_rda_state_machine_errors(tmp_path):
    lm = create_lm(GGUFReader(_rda_gguf(tmp_path / "rda.gguf", "csm")),
                   device="cpu")
    st = lm.new_state()
    with pytest.raises(LmStateError):
        st.step_logits()
    with pytest.raises(LmError, match="hidden size"):
        st.step_begin(np.zeros(H + 1, np.float32))
    st.step_begin(np.zeros(H, np.float32))
    with pytest.raises(LmStateError):
        st.step_begin(np.zeros(H, np.float32))
    st.step_logits()
    with pytest.raises(LmError, match="out of range"):
        st.step_push_code(SIZES[0])
    st.step_push_code(0)
    with pytest.raises(LmStateError):
        st.step_finish()
    with pytest.raises(LmError, match="out of range"):
        lm.audio_embd(0, SIZES[0])


def test_unported_kind_raises(tmp_path):
    """Every kind codec_tpu registers loads in the port (a small file of
    each, the same LmInfo as codec_tpu's); an unknown kind raises."""
    from codec_tpu.lm.base import _KIND_REGISTRY as jax_kinds
    from codec_tpu_torch.models import lm_tts_init as lti

    writers = {
        "residual_depth_ar": None,
        "flow_lm": lambda w: lti.add_flow_lm(w, 0, lti.FlowLmConfig(
            d_model=32, n_layers=1, n_heads=2, head_dim=16, ffn=64, ldim=8,
            flow_dim=16, flow_depth=1, n_bins=20, lsd_steps=1)),
        "parallel_heads_delay": lambda w: lti.add_phd(w, 0, lti.PhdConfig(
            hidden=32, n_codebook=3, text_vocab=40, audio_vocab=9,
            speech_start=10, speech_end=18, speech_pad=8, eos_code_c0=5)),
        "continuous_latent_cfm": lambda w: lti.add_cfm(w, 0, lti.CfmConfig(
            hidden=16, h_vox=16, h_enc=16, h_dit=16, latent_dim=4,
            patch_size=2, n_heads=2, n_kv=1, head_dim=8, n_locenc=1,
            n_locdit=1, n_ralm=1, ffn_mult=2, rope_rows=16))}
    assert sorted(writers) == sorted(jax_kinds)
    for kind, add in writers.items():
        path = tmp_path / f"{kind}.gguf"
        if add is None:
            _rda_gguf(path, "csm")
        else:
            w = GGUFWriter(path, "mimi")
            add(w)
            w.write()
        lm = create_lm(GGUFReader(path), device="cpu")
        ref = jax_create_lm(JaxReader(str(path)))
        assert type(lm).__name__ == type(ref).__name__
        assert lm.info.kind == kind
        assert dataclasses.asdict(lm.info) == dataclasses.asdict(ref.info)
    path = tmp_path / "unknown.gguf"
    w = GGUFWriter(path, "pocket_mimi")
    w.add_bool("codec.lm.has_adaptor", True)
    w.add_string("codec.lm.kind", "sparse_heads")
    w.add_tensor("x", np.zeros(4, np.float32))
    w.write()
    with pytest.raises(LmError, match="unrecognised codec.lm.kind"):
        create_lm(GGUFReader(path), device="cpu")


# ---------------------------------------------------------------------------
# the slice: codec + adaptor + packed backbone → codes → PCM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("csm")
    spm = spm_model_b64(byte_fallback_vocab())
    model = write_random_csm_gguf(tmp / "csm.gguf", seed=2, mimi_cfg=MIMI,
                                  num_filters=8, dcfg=DEPTH)
    bbs = {q: write_random_backbone_gguf(tmp / f"bb_{q}.gguf", seed=1,
                                         qtype=q, cfg=BB, spm_b64=spm)
           for q in QTYPES}
    small = write_random_backbone_gguf(
        tmp / "bb_h64.gguf", seed=1, qtype="Q8_0", spm_b64=spm,
        cfg=dataclasses.replace(BB, hidden=64, head_dim=16, ffn_dim=128))
    return tmp, model, bbs, small


def _engine(model_path, bbs, port: bool):
    """Codec, shared LM and packed backbones of one package."""
    if port:
        reader = GGUFReader(model_path)
        return dict(port=True, reader=reader,
                    codec=codec_tpu_torch.load_model(model_path, device="cpu"),
                    lm=create_lm(reader, device="cpu"),
                    bb={q: LlamaBackbone(p, quantized=True, device="cpu")
                        for q, p in bbs.items()})
    reader = JaxReader(str(model_path))
    return dict(port=False, reader=reader,
                codec=codec_tpu.load_model(str(model_path)),
                lm=jax_create_lm(reader),
                bb={q: JaxBackbone(str(p), quantized=True)
                    for q, p in bbs.items()})


@pytest.fixture(scope="module")
def engines(files):
    _, model, bbs, _ = files
    return _engine(model, bbs, True), _engine(model, bbs, False)


def _synth(eng, qtype, sampler=None, bucket=0, max_steps=6, ids=PROMPT):
    alm_cls, run = ((AudioLM, tts_runner.run_codebook_ar) if eng["port"]
                    else (JaxAudioLM, jax_runner.run_codebook_ar))
    bb = eng["bb"][qtype]
    bb.reset()
    alm = alm_cls(eng["reader"], codec=eng["codec"], lm=eng["lm"])
    kw = {} if sampler is None else {"sampler": sampler}
    return run(alm, bb, list(bb.embed_tokens(ids)), max_steps=max_steps,
               prefill_bucket=bucket, **kw)


@pytest.mark.parametrize("bucket", [0, 8])
@pytest.mark.parametrize("qtype", QTYPES)
def test_greedy_codes_and_pcm_match(engines, qtype, bucket):
    port, ref = engines
    got, want = _synth(port, qtype, bucket=bucket), _synth(ref, qtype, bucket=bucket)
    assert got.codes.dtype == np.int32 and got.codes.shape == (6, DEPTH.n_codebook)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps, want.stopped_by_eos)
    assert got.pcm.shape == (6 * MIMI.hop_size,)
    _assert_close_pcm(got.pcm, want.pcm)


def test_sampler_chain_matches(engines):
    port, ref = engines

    def chain_sampler(cls):
        chain = cls(seed=3, temperature=0.8)
        return lambda cb, logits: chain(logits)

    got = _synth(port, "Q8_0", chain_sampler(tts_runner.SamplerChain))
    want = _synth(ref, "Q8_0", chain_sampler(jax_runner.SamplerChain))
    np.testing.assert_array_equal(got.codes, want.codes)
    greedy = _synth(port, "Q8_0")
    assert not np.array_equal(got.codes, greedy.codes)
    _assert_close_pcm(got.pcm, want.pcm)


@pytest.fixture(scope="module")
def eos_code(engines):
    """A c0 code that greedy decoding emits first at frame >= 2."""
    codes = _synth(engines[0], "Q8_0", max_steps=10).codes[:, 0]
    for k in range(2, len(codes)):
        if codes[k] not in codes[:k]:
            return int(codes[k]), k
    pytest.fail(f"no fresh c0 code in {codes}")


@pytest.mark.parametrize("delays", [[0, 0, 0, 0], [0, 1, 1, 1]],
                         ids=["eos_frame_drop", "delay_tail_flush"])
def test_eos_drop_and_delay_flush_match(files, eos_code, delays):
    tmp, _, bbs, _ = files
    code, frame = eos_code
    path = write_random_csm_gguf(tmp / f"csm_eos_{delays[1]}.gguf", seed=2,
                                 mimi_cfg=MIMI, num_filters=8, dcfg=DEPTH,
                                 eos_code_c0=code, delay_pattern=delays)
    bb = {"Q8_0": bbs["Q8_0"]}
    got = _synth(_engine(path, bb, True), "Q8_0", max_steps=10)
    want = _synth(_engine(path, bb, False), "Q8_0", max_steps=10)
    assert got.stopped_by_eos and want.stopped_by_eos
    flush = max(delays)
    assert got.n_steps == want.n_steps == frame + 1 + flush
    np.testing.assert_array_equal(got.codes, want.codes)
    # without a delay the EOS frame is dropped; with one, the EOS frame and
    # the flushed frames stay in the codes and the unshift leaves them out
    assert len(got.codes) == (frame + 1 + flush if flush else frame)
    assert got.pcm.shape == (frame * MIMI.hop_size,)
    _assert_close_pcm(got.pcm, want.pcm)


def test_run_codebook_ar_rejects_unported_paths(engines):
    """A grammar without its token pieces raises, as codec_tpu's does (the
    grammar flow is tests/test_torch_gbnf.py's); on-device sampling runs
    (its parity with codec_tpu is tests/test_torch_fused.py's)."""
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    port, _ = engines
    alm = AudioLM(port["reader"], codec=port["codec"], lm=port["lm"])
    bb = port["bb"]["Q8_0"]
    bb.reset()
    res = tts_runner.run_codebook_ar(alm, bb, [np.zeros(256, np.float32)],
                                     max_steps=2, decode=False,
                                     on_device=OnDeviceSampling(chunk_frames=2))
    assert res.codes.shape == (2, DEPTH.n_codebook) and res.n_steps == 2
    with pytest.raises(ValueError, match="grammar"):
        tts_runner.run_codebook_ar(alm, bb, [np.zeros(256, np.float32)],
                                   grammar='root ::= "a"')


@pytest.mark.parametrize("qtype", QTYPES)
def test_cli_synthesize_matches_reference(files, tmp_path, monkeypatch,
                                          qtype, capsys):
    from codec_tpu.cli.tts_cli import main as jax_main
    from codec_tpu_torch.cli.tts_cli import main

    _, model, bbs, _ = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bbs[qtype]),
            "--text", "hello there", "--max-frames", "3", "--quant-exec"]
    assert main(args + ["--out", str(tmp_path / "port.wav"),
                        "--device", "cpu"]) == 0
    assert "backbone AR done: 3 steps" in capsys.readouterr().out
    monkeypatch.delenv("CODEC_QUANT_EXEC", raising=False)
    try:
        assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    finally:
        os.environ.pop("CODEC_QUANT_EXEC", None)       # its main() sets it
    got, sr = read_wav(tmp_path / "port.wav")
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    assert sr == jsr == 24000
    assert got.shape == want.shape == (3 * MIMI.hop_size, 1)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


def test_cli_errors(files, tmp_path, capsys):
    from codec_tpu_torch.cli.tts_cli import main

    _, model, bbs, small = files
    base = ["synthesize", "--model", str(model), "--text", "hi", "--out",
            str(tmp_path / "o.wav"), "--device", "cpu", "--max-frames", "2"]
    cases = [(["--backbone", str(small)], "backbone hidden 64 != codec.lm hidden 256"),
             (["--backbone", str(bbs["Q8_0"]), "--grammar", "x"],
              "GBNF parse error at line 1: expected ::= after 'x'"),
             ([], "kind 'residual_depth_ar' needs a backbone")]
    for extra, msg in cases:
        assert main(base + extra) == 1
        assert msg in capsys.readouterr().err
    assert not (tmp_path / "o.wav").exists()
    # --stream streams Pocket-TTS only: a backbone flow ignores it, as
    # codec_tpu's does
    assert main(base + ["--backbone", str(bbs["Q8_0"]), "--stream"]) == 0
    assert "backbone AR done: 2 steps" in capsys.readouterr().out
    assert (tmp_path / "o.wav").exists()


def test_hidden_mismatch_raises_value_error(files):
    from codec_tpu_torch.cli.tts_cli import run_backbone_synthesize

    _, model, _, small = files
    with pytest.raises(ValueError, match="backbone hidden"):
        run_backbone_synthesize(codec_tpu_torch.load_model(model, device="cpu"),
                                GGUFReader(model), small, "hi", device="cpu")


def test_cli_info_and_decode(files, tmp_path, capsys):
    from codec_tpu_torch.cli.tts_cli import main

    _, model, _, _ = files
    assert main(["info", "--model", str(model)]) == 0
    assert "residual_depth_ar" in capsys.readouterr().out
    np.save(tmp_path / "c.npy", np.random.default_rng(0).integers(
        0, 64, (5, 4)).astype(np.int32))
    assert main(["decode", "--model", str(model), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(tmp_path / "d.wav"),
                 "--device", "cpu"]) == 0
    pcm, sr = read_wav(tmp_path / "d.wav")
    assert sr == 24000 and pcm.shape == (5 * MIMI.hop_size, 1)
