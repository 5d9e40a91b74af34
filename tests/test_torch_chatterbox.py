"""The port's Chatterbox TTS flow (codec_tpu_torch/lm/chatterbox_t3.py,
tts_runner.run_chatterbox, fused_gen.build_chatterbox_chunk, tts-cli-torch)
against codec_tpu on the CPU.

Fixtures: a small Chatterbox GGUF from the port's writer
(models/chatterbox_init.py: the small S3Gen of tests/test_torch_s3g.py with
a T3 section of hidden 64, the VoiceEncoder and the made-up baked
tokenizer) and an f32 llama backbone of hidden 64 with llama3 rope
scaling; a second file whose speech head's stop row is raised so that the
stop comes inside a chunk. Both packages read the same files.

Bounds: punc_norm and token ids equal; prompt rows within 1e-6 of their
peak (the conditioning rows go through the perceiver in f32 on both
sides); greedy codes equal, or first differing at a near-tie of the CFG
logits (relative top-2 margin < 1e-4, ROADMAP Queue 3's rule); with
codec_tpu's key-split Gumbel noise fed in, the sampled chunk's packed
codes and counts equal codec_tpu's chunk; PCM corr > 0.9999.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_tpu.cli.tts_cli import main as jax_main
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import chatterbox_t3 as jt3
from codec_tpu.lm import fused_gen as jax_fused
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import create_backbone as jax_backbone
from codec_tpu.ops.sample import OnDeviceSampling as JaxSampling
from codec_tpu_torch.cli.tts_cli import main
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import chatterbox_t3 as t3m
from codec_tpu_torch.lm import create_lm, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone, StepGroup
from codec_tpu_torch.lm.fused_gen import chatterbox_chunk_cached, chunk_ctx
from codec_tpu_torch.lm.speaker_chatterbox import VeConfig
from codec_tpu_torch.models import chatterbox_init as cbi
from codec_tpu_torch.models.lm_init import write_random_backbone_gguf
from codec_tpu_torch.ops.sample import OnDeviceSampling

from test_torch_s3g import SMALL, WIDTHS

H = 64
T3 = cbi.T3Config(hidden=H, text_vocab=200, speech_vocab=300, start_text=150,
                  start_speech=250, stop_speech=251, text_pos=96,
                  speech_pos=40, speaker_embed=16, cond_tokens=5,
                  emotion=0.4)
VE = VeConfig(n_mels=8, hidden_size=12, num_layers=2, embed_size=16,
              n_fft=64, hop=16, win=64, partial_frames=10, rate=0.0,
              hidden_dim=H)
BB = dataclasses.replace(cbi.LLAMA_520M, hidden=H, n_layers=2, n_heads=4,
                         n_kv_heads=4, head_dim=16, ffn_dim=128, max_ctx=256)
TEXT = "hello there"
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"plain": model, "stop": model with the stop inside a chunk}, bb."""
    tmp = tmp_path_factory.mktemp("cbx")
    out = {}
    for name, gain in (("plain", 0.01), ("stop", 2.0)):
        out[name] = cbi.write_chatterbox_tts_gguf(
            tmp / f"{name}.gguf", seed=3,
            t3=dataclasses.replace(T3, stop_gain=gain), ve=VE,
            cfg=dataclasses.replace(SMALL, codebook_size=T3.start_speech),
            **WIDTHS)
    bb = write_random_backbone_gguf(tmp / "bb.gguf", seed=4, qtype="F32",
                                    cfg=BB, rope_scaling=cbi.T3_ROPE_SCALING)
    return out, bb


def _engines(model, bb):
    reader, jreader = GGUFReader(model), JaxReader(str(model))
    port = dict(port=True, reader=reader, t3=t3m.ChatterboxT3(reader, "cpu"),
                lm=create_lm(reader, device="cpu"), bb=bb)
    ref = dict(port=False, reader=jreader, t3=jt3.ChatterboxT3(jreader),
               bb=bb)
    return port, ref


@pytest.fixture(scope="module")
def engines(files):
    return _engines(files[0]["plain"], files[1])


@pytest.fixture(scope="module")
def stop_engines(files):
    return _engines(files[0]["stop"], files[1])


class _Rec:
    """A backbone lane that records the hiddens it returns."""

    def __init__(self, bb):
        self.bb, self.hs = bb, []

    def step(self, e):
        h = self.bb.step(e)
        self.hs.append(np.asarray(h, np.float32))
        return h


def _lanes(eng, n=2, record=False):
    if eng["port"]:
        bb = LlamaBackbone(eng["bb"], device="cpu")
        lanes = [bb] + [LlamaBackbone.from_params(bb.cfg, bb.params)
                        for _ in range(n - 1)]
    else:
        lanes = [jax_backbone(str(eng["bb"])) for _ in range(n)]
    return [_Rec(b) for b in lanes] if record else lanes


def _run(eng, lanes, **kw):
    kw.setdefault("max_frames", 10)
    if eng["port"]:
        if "on_device" in kw:
            kw["on_device"] = OnDeviceSampling(**kw["on_device"])
        alm = AudioLM(eng["reader"], lm=eng["lm"])
        return tts_runner.run_chatterbox(alm, eng["t3"], lanes, TEXT,
                                         decode=False, **kw)
    if "on_device" in kw:
        kw["on_device"] = JaxSampling(**kw["on_device"])
    return jax_runner.run_chatterbox(JaxAudioLM(eng["reader"]), eng["t3"],
                                     lanes, TEXT, decode=False, **kw)


def _greedy(lg):
    return int(np.argmax(lg))


def _same_or_tie(got, want, rec, head, rows, w=0.5):
    """Equal codes, or the first difference a near-tie of the CFG logits
    on the recorded hiddens (lane 0, lane 1) of a host run."""
    n = min(len(got), len(want))
    diff = np.flatnonzero(got[:n, 0] != want[:n, 0])
    if not len(diff) and len(got) == len(want):
        return
    f = int(diff[0]) if len(diff) else n
    hs = [np.asarray(r.hs[rows - 1 + f], np.float64) for r in rec]
    cond = head @ hs[0]
    lg = cond + w * (cond - head @ hs[1]) if len(hs) > 1 else cond
    top = np.sort(lg)[-2:]
    assert (top[1] - top[0]) / abs(top[1]) < NEAR_TIE, f"frame {f}"


def _head(eng):
    return np.asarray(eng["reader"].get("lm.heads_0.weight"), np.float64)


@pytest.mark.parametrize("text", [
    "", "hello   world", "Hi there…", "ok:", "done!", 'She said “yes”',
    "a - b; c — d – e", "lowercase start", "ünïcode first", "trailing ,",
    "  spaces  ", "Already ends?"])
def test_punc_norm_matches(text):
    assert t3m.punc_norm(text) == jt3.punc_norm(text)


def test_tokenizer_and_tables_match(engines):
    port, ref = engines
    assert dataclasses.asdict(port["t3"].info) == dataclasses.asdict(ref["t3"].info)
    assert port["t3"].info.has_builtin_conds and port["t3"].info.has_tokenizer
    for text in ("Hello there, this is a test.", "the quick brown fox!",
                 "Café naïve — 12 345 dogs; \"quoted\" ok?", "[START] [STOP]",
                 "unknown ~^ chars ☃", ""):
        np.testing.assert_array_equal(port["t3"].tokenize(text),
                                      ref["t3"].tokenize(text))
    for name in ("text_emb", "text_pos_emb", "speech_emb", "speech_pos_emb",
                 "builtin_speaker_emb", "builtin_cond_tokens"):
        np.testing.assert_array_equal(getattr(port["t3"], name),
                                      np.asarray(getattr(ref["t3"], name)))
    assert port["t3"].builtin_emotion == pytest.approx(ref["t3"].builtin_emotion)
    ids = port["t3"].tokenize("hello")
    for code, pos in ((0, 1), (7, T3.speech_pos - 1), (9, T3.speech_pos)):
        np.testing.assert_array_equal(port["t3"].compose_speech_embd(code, pos),
                                      ref["t3"].compose_speech_embd(code, pos))
    assert len(ids) > 1


@pytest.mark.parametrize("case", ["builtin", "speaker_emb", "one_lane",
                                  "ref_pcm"])
def test_build_prompt_rows_match(engines, case):
    """The prompt rows of both lanes (the CFG lane zeroes the text
    content and keeps the positions; speech BOS twice) within 1e-6 of
    their peak."""
    port, ref = engines
    ids = port["t3"].tokenize("Hello there, this is it.")
    rng = np.random.default_rng(5)
    kw = dict(cfg_weight=0.5)
    if case == "speaker_emb":
        kw.update(speaker_emb=rng.standard_normal(T3.speaker_embed)
                  .astype(np.float32), emotion=0.8,
                  ref_speech_tokens=np.array([3, 1, 4, 1, 5, 9], np.int32))
    elif case == "one_lane":
        kw["cfg_weight"] = 0.0
    elif case == "ref_pcm":
        kw["ref_pcm"] = (rng.standard_normal(1200) * 0.2).astype(np.float32)
    got = port["t3"].build_prompt(ids, **kw)
    want = np.asarray(ref["t3"].build_prompt(ids, **kw))
    n_seq = 1 if case == "one_lane" else 2
    assert got.shape == want.shape == (n_seq, 34 + len(ids) + 4, H)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if n_seq == 2:
        np.testing.assert_array_equal(got[0, :34], got[1, :34])
        np.testing.assert_array_equal(got[1, 34], port["t3"].text_pos_emb[0])


def test_run_chatterbox_host_matches(engines):
    """The host path, greedy, two lanes: codes, steps and the stop against
    codec_tpu's host path (near-tie rule on the port's hiddens)."""
    port, ref = engines
    rec = _lanes(port, record=True)
    got = _run(port, rec, sampler=_greedy)
    want = _run(ref, _lanes(ref), sampler=_greedy)
    rows = port["t3"].build_prompt(port["t3"].tokenize(TEXT)).shape[1]
    _same_or_tie(got.codes, want.codes, rec, _head(port), rows)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos)
    assert got.codes.shape == (10, 1) and got.codes.max() < T3.start_speech


@pytest.mark.parametrize("eng_name", ["engines", "stop_engines"])
def test_run_chatterbox_chunk_matches(eng_name, request):
    """The device chunk (K = 4, greedy, eagerly on the CPU) against the
    host path and codec_tpu's chunk: codes, steps and the stop (the stop
    file's stop comes at the first frame of the third chunk, the frames
    after it held)."""
    port, ref = request.getfixturevalue(eng_name)
    rec = _lanes(port, record=True)
    host = _run(port, rec, sampler=_greedy)
    got = _run(port, _lanes(port), on_device=dict(chunk_frames=4))
    want = _run(ref, _lanes(ref), on_device=dict(chunk_frames=4))
    rows = port["t3"].build_prompt(port["t3"].tokenize(TEXT)).shape[1]
    _same_or_tie(got.codes, host.codes, rec, _head(port), rows)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos) \
        == (host.n_steps, host.stopped_by_eos)
    if eng_name == "stop_engines":                # inside the 3rd chunk
        assert got.stopped_by_eos and got.n_steps % 4 == 1


def _prefilled(eng):
    """Both lanes prefilled with the prompt → (lanes, hiddens [2, H])."""
    t3 = eng["t3"]
    prompt = np.asarray(t3.build_prompt(t3.tokenize(TEXT), cfg_weight=0.5))
    lanes = _lanes(eng)
    hs = [tts_runner.prefill_prompt(b, list(prompt[s]))
          for s, b in enumerate(lanes)]
    return lanes, np.stack([np.asarray(h, np.float32) for h in hs])


@pytest.mark.parametrize("eng_name,chain,pen", [
    ("engines", (0.8, 0, 1.0, 0.05), 1.2),
    ("engines", (1.0, 5, 0.9, 0.0), 1.0),
    ("stop_engines", (0.8, 0, 1.0, 0.05), 1.2)])
def test_chunk_with_jax_noise_matches(eng_name, chain, pen, request):
    """One sampled chunk of 4 frames from the same prefilled lanes, the
    port fed codec_tpu's key-split Gumbel noise: the packed codes and
    [n_emitted, stopped, pos_after, step_after] equal codec_tpu's, and the
    repetition history (the seen mask) too."""
    port, ref = request.getfixturevalue(eng_name)
    k = 4
    lanes, hs = _prefilled(port)
    jlanes, jhs = _prefilled(ref)
    np.testing.assert_allclose(hs, jhs, rtol=1e-4, atol=1e-5)
    pos = lanes[0].pos
    t3, jt = port["t3"], ref["t3"]
    key = jax.random.PRNGKey(11)
    noise, kk = [], key
    for _ in range(k):
        kk, sub = jax.random.split(kk)
        noise.append(np.asarray(jax.random.gumbel(sub, (T3.speech_vocab,),
                                                  jnp.float32)))
    ctx = chunk_ctx(lanes[0], pos + k + 1)
    runner = chatterbox_chunk_cached(port["lm"], t3, lanes[0], chain=chain,
                                     rep_pen=pen, n_frames=k, n_seq=2,
                                     cfg_weight=0.5, ctx=ctx)
    for s, b in enumerate(lanes):
        runner.kv[s].copy_(b.kv[..., :ctx, :])
    runner.h.copy_(torch.from_numpy(jhs))
    runner.pos.fill_(pos)
    runner.step.fill_(0)
    runner.seen.zero_()
    runner.seen[T3.start_speech] = True
    runner.noise.copy_(torch.from_numpy(np.stack(noise)))
    got = runner.run().numpy()

    fn = jax_fused.build_chatterbox_chunk(
        jlanes[0].cfg, chain, pen, k, n_seq=2, cfg_weight=0.5,
        stop_token=T3.stop_speech, n_pos=T3.speech_pos)
    seen = jnp.zeros((T3.speech_vocab,), bool).at[T3.start_speech].set(True)
    packed, _, _, _, jseen = fn(
        jlanes[0].params, jnp.asarray(np.asarray(ref_head(ref))),
        jnp.asarray(jt.speech_emb), jnp.asarray(jt.speech_pos_emb),
        jnp.stack([b.kv for b in jlanes]), np.int32(pos), np.int32(0),
        jnp.asarray(jhs), key, seen)
    want = np.asarray(packed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(runner.seen.numpy(), np.asarray(jseen))


def ref_head(ref):
    return np.asarray(JaxAudioLM(ref["reader"]).lm.heads[0], np.float32)


def test_cfg_weight_zero_runs_one_lane(engines):
    """cfg_weight 0: one lane, the uncond lane never built or stepped;
    host and chunk against codec_tpu's."""
    port, ref = engines
    for od in (None, dict(chunk_frames=3)):
        kw = dict(cfg_weight=0.0, sampler=_greedy)
        if od:
            kw["on_device"] = od
        got = _run(port, _lanes(port, n=1), **kw)
        want = _run(ref, _lanes(ref, n=1), **kw)
        np.testing.assert_array_equal(got.codes, want.codes)
        assert got.n_steps == want.n_steps == 10
    with pytest.raises(ValueError, match="2 backbone lanes"):
        _run(port, _lanes(port, n=1), cfg_weight=0.5)


def test_cli_synthesize_matches_reference(files, tmp_path, capsys):
    """tts-cli-torch synthesize on the Chatterbox file (greedy, on the host
    path and with --on-device, --cfg-weight 0 too) against codec_tpu's
    CLI: the S3Gen PCM."""
    model, bb = files[0]["plain"], files[1]
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "5", "--temp", "0"]
    assert jax_main(args + ["--out", str(tmp_path / "ref.wav")]) == 0
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    for extra in ([], ["--on-device", "--chunk-frames", "2"]):
        out = tmp_path / f"port{len(extra)}.wav"
        assert main(args + extra + ["--out", str(out), "--device", "cpu"]) == 0
        assert "chatterbox AR done: 5 steps" in capsys.readouterr().out
        got, sr = read_wav(out)
        assert sr == jsr == 24000 and got.shape == want.shape == (5 * 960, 1)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    assert main(args + ["--cfg-weight", "0", "--out", str(tmp_path / "o.wav"),
                        "--device", "cpu"]) == 0
    assert jax_main(args + ["--cfg-weight", "0", "--out",
                            str(tmp_path / "r.wav")]) == 0
    got, _ = read_wav(tmp_path / "o.wav")
    want, _ = jax_read_wav(tmp_path / "r.wav")
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def test_chip_smoke_chatterbox_on_cpu(monkeypatch):
    """chip_smoke.py's phase 9d end to end at small widths on the CPU (its
    card-only measurements left out): the writers, loads, the CLI's
    requests, the code comparisons, the eager chunk's launch count, the
    voice prompt and the ECAPA embedding."""
    from codec_tpu_torch.lm.speaker_qwen3_tts import EcapaConfig

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    h = 256                                  # Q4_K wants widths of 256
    sizes = dict(
        chatterbox=dict(t3=dataclasses.replace(T3, hidden=h),
                        ve=dataclasses.replace(VE, hidden_dim=h),
                        cfg=dataclasses.replace(
                            SMALL, codebook_size=T3.start_speech), **WIDTHS),
        backbone=dataclasses.replace(BB, hidden=h, n_layers=1, head_dim=64,
                                     ffn_dim=512),
        ecapa=dict(cfg=EcapaConfig(
            mel_dim=8, enc_dim=20, attn_ch=8, res2net_scale=4, se_ch=8,
            n_fft=64, hop=16, win=64, enc_channels=(16, 16, 16, 24),
            enc_kernels=(5, 3, 3, 1), enc_dilations=(1, 2, 3, 1),
            hidden_dim=20)),
        frames=6, voice_seconds=0.1, ecapa_seconds=0.05)
    none = {"q4_k_matmul": 0, "q8_0_matmul": 0}
    got, times = cs.chatterbox_flow("CPU", lambda: None, lambda: dict(none),
                                    none, dev="cpu", sizes=sizes)
    # the card is held to: the Q4_K request's per-token prefill (2 lanes x
    # 71 rows x 7 products x 1 layer), its new graph's warm-up and capture
    # (2 x 7 x 8 frames) and one eager chunk (7 x 8)
    assert got == {"q4_k_matmul": 2 * 71 * 7 + 3 * 7 * 8, "q8_0_matmul": 0}
    assert times["host_ms"] > 0 and "host_profile" not in times


# ---------------------------------------------------------------------------
# batched Chatterbox: B streams x CFG lanes in one chunk
# ---------------------------------------------------------------------------

BATCH_TEXTS = ["hello there", "ok", "hello hello"]
SAMPLED_T3 = dict(temperature=0.8, min_p=0.05, repetition_penalty=1.2,
                  repetition_window=-1, seed=11, chunk_frames=3)


def _batch(eng, on_device, sampling=None, max_frames=10):
    if eng["port"]:
        bb = LlamaBackbone(eng["bb"], device="cpu")
        alms = [AudioLM(eng["reader"], lm=eng["lm"]) for _ in BATCH_TEXTS]
        return tts_runner.run_chatterbox_batch(
            alms, eng["t3"], bb, BATCH_TEXTS, OnDeviceSampling(**on_device),
            max_frames=max_frames, decode=False,
            sampling=None if sampling is None
            else [OnDeviceSampling(**s) for s in sampling])
    from codec_tpu.lm import create_lm as jax_create_lm

    shared = jax_create_lm(eng["reader"])
    alms = [JaxAudioLM(eng["reader"], lm=shared) for _ in BATCH_TEXTS]
    return jax_runner.run_chatterbox_batch(
        alms, eng["t3"], jax_backbone(str(eng["bb"])), BATCH_TEXTS,
        JaxSampling(**on_device), max_frames=max_frames, decode=False)


@pytest.mark.parametrize("eng_name", ["engines", "stop_engines"])
def test_run_chatterbox_batch_greedy_matches_jax(eng_name, request):
    """Greedy with CFG, K = 4: every stream's codes, steps and stop equal
    codec_tpu's run_chatterbox_batch and the port's own single-stream
    chunk (the stop file's streams stop inside a chunk)."""
    port, ref = request.getfixturevalue(eng_name)
    od = dict(chunk_frames=4)
    got = _batch(port, od)
    want = _batch(ref, od)
    for i, text in enumerate(BATCH_TEXTS):
        np.testing.assert_array_equal(got[i].codes, want[i].codes)
        assert (got[i].n_steps, got[i].stopped_by_eos) == \
            (want[i].n_steps, want[i].stopped_by_eos)
        alm = AudioLM(port["reader"], lm=port["lm"])
        one = tts_runner.run_chatterbox(
            alm, port["t3"], _lanes(port), text, max_frames=10, decode=False,
            on_device=OnDeviceSampling(**od))
        np.testing.assert_array_equal(got[i].codes, one.codes)
        assert got[i].n_steps == one.n_steps
    if eng_name == "stop_engines":
        assert any(r.stopped_by_eos for r in got)


def test_run_chatterbox_batch_sampled_matches_single(engines):
    """Stream i of a sampled batch equals the port's single-stream chunk
    with seed + i, with per-stream chains (the T3 preset, greedy, a hot
    top-k) as data in one chunk."""
    port, _ = engines
    chains = [SAMPLED_T3, dict(SAMPLED_T3, temperature=0.0),
              dict(SAMPLED_T3, temperature=1.4, top_k=5)]
    got = _batch(port, SAMPLED_T3, sampling=chains)
    for i, text in enumerate(BATCH_TEXTS):
        alm = AudioLM(port["reader"], lm=port["lm"])
        one = tts_runner.run_chatterbox(
            alm, port["t3"], _lanes(port), text, max_frames=10, decode=False,
            on_device=OnDeviceSampling(**dict(chains[i], seed=11 + i)))
        np.testing.assert_array_equal(got[i].codes, one.codes)
        assert (got[i].n_steps, got[i].stopped_by_eos) == \
            (one.n_steps, one.stopped_by_eos)
    assert not np.array_equal(got[0].codes, got[1].codes)


def test_batched_chunk_meta_matches_jax(stop_engines):
    """One greedy batched chunk of 10 frames over two streams from the same
    prefilled lanes (the second three frames on): [n_iter] ++ done ++ pos
    ++ step equal codec_tpu's, and the codes of every frame a stream was
    live; the first stream stops at its ninth frame."""
    from codec_tpu_torch.lm.fused_gen import build_chatterbox_chunk_batched

    port, ref = stop_engines
    k, b = 10, 2
    lanes, hs = _prefilled(port)
    jlanes, _ = _prefilled(ref)
    pos = lanes[0].pos
    ctx = chunk_ctx(lanes[0], pos + k + 1)
    kv = torch.stack([torch.stack([x.kv[..., :ctx, :] for x in lanes])] * b)
    t3, jt = port["t3"], ref["t3"]
    semb, pemb = t3.speech_tables("cpu")
    chunk = build_chatterbox_chunk_batched(
        lanes[0].cfg, k, n_seq=2, cfg_weight=0.5,
        stop_token=T3.stop_speech, n_pos=T3.speech_pos, rep_pen=1.2)
    seen = torch.zeros((b, T3.speech_vocab), dtype=torch.bool)
    seen[:, T3.start_speech] = True
    step0 = torch.tensor([0, 3])                 # stream 1 three frames on
    with torch.inference_mode():
        got, *_ = chunk(StepGroup(lanes[0]), port["lm"].heads[0], semb, pemb,
                        [kv],
                        torch.tensor([pos] * b), step0,
                        torch.from_numpy(np.stack([hs] * b)),
                        torch.zeros((k, b, T3.speech_vocab)), seen,
                        torch.zeros(b, dtype=torch.bool),
                        torch.zeros((b, 4)), ctx)
    fn = jax_fused.build_chatterbox_chunk_batched(
        jlanes[0].cfg, k, n_seq=2, cfg_weight=0.5, stop_token=T3.stop_speech,
        n_pos=T3.speech_pos, rep_pen=1.2)
    jkv = jnp.stack([jnp.stack([x.kv for x in jlanes])] * b)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(b, dtype=jnp.uint32))
    want, *_ = fn(jlanes[0].params, jnp.asarray(ref_head(ref)),
                  jnp.asarray(jt.speech_emb), jnp.asarray(jt.speech_pos_emb),
                  jkv, jnp.asarray([pos] * b, jnp.int32),
                  jnp.asarray(step0.numpy(), jnp.int32),
                  jnp.asarray(np.stack([hs] * b)), keys,
                  jnp.asarray(seen.numpy()), jnp.zeros(b, bool),
                  jnp.zeros((b, 4), jnp.float32))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[k * b:], want[k * b:])
    done = got[k * b + 1: k * b + 1 + b]
    assert done[0]                               # a stop inside the chunk
    rows, wrows = got[: k * b].reshape(k, b), want[: k * b].reshape(k, b)
    for s in range(b):
        live = k if not done[s] else int(np.argmax(rows[:, s] == T3.stop_speech)) + 1
        np.testing.assert_array_equal(rows[:live, s], wrows[:live, s])


def test_backbone_synthesize_batch_routes_chatterbox(files, monkeypatch):
    """run_backbone_synthesize_batch sends a Chatterbox file to
    run_chatterbox_synthesize_batch (its T3 preset, per-text sampling, the
    reused T3, the mesh); run_chatterbox_batch's streams must divide over
    its mesh."""
    from codec_tpu_torch.cli import tts_cli
    from codec_tpu_torch.parallel.mesh import make_mesh

    calls = []

    def fake(*args, **kw):
        calls.append((args, kw))
        return [(None, 0, "eos")] * len(args[3])
    monkeypatch.setattr(tts_cli, "run_chatterbox_synthesize_batch", fake)
    reader = GGUFReader(files[0]["plain"])
    out = tts_cli.run_backbone_synthesize_batch(
        None, reader, str(files[1]), ["a", "b"], seed=3, max_frames=5,
        sampling=[{}, {"temperature": 0.0}], t3="T3", device="cpu")
    assert out == [(None, 0, "eos")] * 2
    (args, kw), = calls
    assert args[3] == ["a", "b"] and kw["seed"] == 3 and kw["t3"] == "T3"
    assert kw["sampling"] == [{}, {"temperature": 0.0}]
    assert kw["mesh"] is None
    mesh = make_mesh(2, devices=["cpu"] * 2)
    tts_cli.run_backbone_synthesize_batch(
        None, reader, str(files[1]), ["a", "b"], mesh=mesh, device="cpu")
    assert calls[-1][1]["mesh"] is mesh
    alm = AudioLM(reader, lm=create_lm(reader, device="cpu"))
    with pytest.raises(ValueError, match="1 streams not divisible"):
        tts_runner.run_chatterbox_batch(
            [alm], t3m.ChatterboxT3(reader, "cpu"),
            LlamaBackbone(files[1], device="cpu"), ["a"],
            OnDeviceSampling(chunk_frames=2), mesh=mesh)
