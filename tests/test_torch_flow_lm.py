"""The port's flow_lm (Pocket-TTS) kind and its self-contained synthesize
flow (codec_tpu_torch/lm/flow_lm.py, cli/tts_cli.py::run_flow_synthesize)
against codec_tpu on the CPU.

Fixtures: tests/test_flow_lm.py's tiny flow_lm (its TorchFlow tensors,
written with the port's GGUFWriter), and a small Pocket-TTS file from the
port's writer (models/lm_tts_init.py: a small Pocket-Mimi with its encoder,
a flow_lm adaptor and the byte-fallback SPM vocabulary), loaded by both
packages. Noise comes from NumPy on the host in both.

Bounds: latents and EOS logits within 1e-5 x peak frame by frame (f32 on
both sides, sums in another order); flow_run equal to repeated flow_step
bit for bit; synthesized PCM corr > 0.9999 against codec_tpu's with equal
frame counts and stop reasons; streamed PCM corr > 0.99999 against the
batch decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import codec_tpu
import codec_tpu_torch
from codec_tpu.cli import tts_cli as jax_cli
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu_torch.cli import tts_cli
from codec_tpu_torch.io.gguf import GGUFReader, GGUFWriter
from codec_tpu_torch.io.wav import read_wav, write_wav
from codec_tpu_torch.lm import create_lm
from codec_tpu_torch.lm import flow_lm
from codec_tpu_torch.lm.base import LmError
from codec_tpu_torch.models.lm_tts_init import FlowLmConfig, write_pocket_tts_gguf
from codec_tpu_torch.models.pocket_init import POCKET_TTS

from test_flow_lm import DM, FDEPTH, FDIM, HD, LDIM, LSD, NBINS, H, L, TorchFlow

# the Pocket-Mimi of tests/test_torch_pocket.py (latent 8, hop 32)
SMALL = dataclasses.replace(POCKET_TTS, latent_dim=8, outer_dim=32,
                            tf_heads=2, tf_head_dim=16, tf_context=12,
                            decoder_ratios=(2, 2, 2),
                            encoder_ratios=(2, 2, 2), resample_stride=4,
                            hop_size=32)
FLOW = FlowLmConfig(d_model=32, n_layers=2, n_heads=2, head_dim=16, ffn=64,
                    ldim=8, flow_dim=24, flow_depth=2, n_bins=300, lsd_steps=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_flow_lm.py's tiny_flow, both packages."""
    path = tmp_path_factory.mktemp("flow") / "flow.gguf"
    w = GGUFWriter(path, "pocket_mimi")
    w.add_uint32("codec.sample_rate", 24000)
    w.add_bool("codec.has_decoder", True)
    w.add_bool("codec.lm.has_adaptor", True)
    w.add_string("codec.lm.kind", "flow_lm")
    for key, val in (("d_model", DM), ("n_layers", L), ("n_heads", H),
                     ("head_dim", HD), ("ldim", LDIM), ("flow_dim", FDIM),
                     ("flow_depth", FDEPTH), ("lut_n_bins", NBINS),
                     ("lsd_decode_steps", LSD)):
        w.add_uint32(f"codec.lm.{key}", val)
    w.add_bool("codec.lm.insert_bos_before_voice", True)
    w.add_float32("codec.lm.eos_threshold", -4.0)
    for name, tensor in TorchFlow().t.items():
        w.add_tensor(name, tensor.numpy())
    w.write()
    return (create_lm(GGUFReader(path), device="cpu"),
            jax_create_lm(JaxReader(str(path))))


@pytest.fixture(scope="module")
def pocket(tmp_path_factory):
    """A small Pocket-TTS file: codec + flow_lm + SPM vocabulary."""
    path = write_pocket_tts_gguf(
        tmp_path_factory.mktemp("ptts") / "pocket_tts.gguf", seed=3,
        flow=FLOW, codec_cfg=SMALL, channels=(32, 16, 8, 8), ffn=64)
    return {"path": path,
            "port": (codec_tpu_torch.load_model(path, device="cpu"),
                     create_lm(GGUFReader(path), device="cpu")),
            "jax": (codec_tpu.load_model(str(path)),
                    jax_create_lm(JaxReader(str(path))))}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def _corr(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.corrcoef(a, b)[0, 1]


def test_info_matches(tiny):
    lm, ref = tiny
    assert dataclasses.asdict(lm.info) == dataclasses.asdict(ref.info)
    assert lm.info.kind == "flow_lm" and lm.info.is_continuous
    for a in ("d_model", "n_layers", "n_heads", "head_dim", "ldim", "flow_dim",
              "flow_depth", "lsd_steps", "insert_bos_before_voice",
              "frames_after_eos", "temperature", "eos_threshold", "max_T"):
        assert getattr(lm, a) == getattr(ref, a), a


def test_load_matches_params_from_jax(tiny):
    lm, ref = tiny
    want = flow_lm.params_from_jax({k: v for k, v in ref.w.items()})
    assert sorted(want) == sorted(lm.w)
    got_l, want_l = _leaves(lm.w), _leaves(want)
    assert len(got_l) == len(want_l) > 60
    for a, b in zip(got_l, want_l):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("voice", [False, True], ids=["text", "voice"])
def test_prefill_and_steps_match(tiny, voice):
    """Prefill and 6 AR frames with the same noise, each frame's latent
    fed back: latents and EOS logits frame by frame."""
    lm, ref = tiny
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, NBINS, 5).tolist()
    rows = lm.speaker_rows(rng.standard_normal((3, LDIM)).astype(np.float32)) \
        if voice else None
    noises = (rng.standard_normal((6, LDIM)) * 0.7).astype(np.float32)
    st, rst = lm.new_state(), ref.new_state()
    lm.flow_prefill(st, tokens, voice_rows=rows)
    ref.flow_prefill(rst, tokens, voice_rows=rows)
    assert st.kind_state["kv_pos"] == rst.kind_state["kv_pos"] == 5 + 4 * voice
    prev = rprev = None
    for noise in noises:
        lat, eos, is_eos = lm.flow_step(st, prev_latent=prev, noise=noise)
        rlat, reos, ris_eos = ref.flow_step(rst, prev_latent=rprev, noise=noise)
        assert lat.dtype == np.float32 and lat.shape == (LDIM,)
        _close(lat, rlat)
        assert abs(eos - reos) <= 1e-5 * max(abs(reos), 1.0)
        assert is_eos == ris_eos
        prev, rprev = lat, rlat


def test_flow_run_equals_steps_and_reference(tiny):
    lm, ref = tiny
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, NBINS, 4).tolist()
    noises = (rng.standard_normal((7, LDIM)) * 0.5).astype(np.float32)
    st1, st2, rst = lm.new_state(), lm.new_state(), ref.new_state()
    for s, m in ((st1, lm), (st2, lm), (rst, ref)):
        m.flow_prefill(s, tokens)
    lats, eos = [], []
    prev = None
    for noise in noises:
        lat, e, _ = lm.flow_step(st1, prev_latent=prev, noise=noise)
        lats.append(lat)
        eos.append(e)
        prev = lat
    # two calls: 4 frames, then 3 more from the 4th frame's latent
    a_lat, a_eos = lm.flow_run(st2, noises[:4])
    b_lat, b_eos = lm.flow_run(st2, noises[4:], prev_latent=a_lat[-1])
    run_lat, run_eos = np.concatenate([a_lat, b_lat]), np.concatenate([a_eos, b_eos])
    np.testing.assert_array_equal(run_lat, np.stack(lats))
    np.testing.assert_array_equal(run_eos, np.asarray(eos, np.float32))
    assert st2.kind_state["kv_pos"] == st1.kind_state["kv_pos"] == 11
    assert torch.equal(st1.kind_state["kv"], st2.kind_state["kv"])
    r_lat, r_eos = ref.flow_run(rst, noises[:4])
    r2_lat, r2_eos = ref.flow_run(rst, noises[4:], prev_latent=r_lat[-1])
    _close(run_lat, np.concatenate([r_lat, r2_lat]))
    _close(run_eos, np.concatenate([r_eos, r2_eos]))


def test_host_noise_speaker_rows_denorm_tokenize(pocket):
    (_, lm), (_, ref) = pocket["port"], pocket["jax"]
    mu = np.random.default_rng(2).standard_normal((3, lm.ldim)).astype(np.float32)
    np.testing.assert_array_equal(lm.speaker_rows(mu), ref.speaker_rows(mu))
    np.testing.assert_array_equal(lm.denorm_latent(mu), ref.denorm_latent(mu))
    for text in ("Hello there.", "hello world, 123!", "é ü"):
        assert lm.tokenize(text) == ref.tokenize(text)
    # the state's own generator draws the noise codec_tpu's does
    st, rst = lm.new_state(), ref.new_state()
    ids = lm.tokenize("Hello.")
    lm.flow_prefill(st, ids)
    ref.flow_prefill(rst, ids)
    lat, eos, _ = lm.flow_step(st)
    rlat, reos, _ = ref.flow_step(rst)
    _close(lat, rlat)
    assert abs(eos - reos) <= 1e-5 * max(abs(reos), 1.0)
    lm.flow_reset(st)
    assert st.kind_state["kv_pos"] == 0 and not st.kind_state["kv"].any()


def test_errors(tiny, pocket):
    lm, _ = tiny
    with pytest.raises(LmError, match="SentencePiece"):
        lm.tokenize("hi")
    st = lm.new_state()
    with pytest.raises(LmError, match="exceeds KV capacity"):
        lm.flow_prefill(st, np.zeros(lm.max_T + 1, np.int32))
    lm.flow_prefill(st, [1, 2])
    st.kind_state["kv_pos"] = lm.max_T - 1
    with pytest.raises(LmError, match="KV cache full"):
        lm.flow_run(st, np.zeros((2, LDIM), np.float32))


def _synth(eng, **kw):
    model, lm = eng
    run = tts_cli.run_flow_synthesize if isinstance(
        lm, flow_lm.FlowLM) else jax_cli.run_flow_synthesize
    return run(model, lm, "hello there", seed=4, **kw)


@pytest.mark.parametrize("case", ["batch", "ref_audio", "temp0_min_len"])
def test_run_flow_synthesize_matches_reference(pocket, case):
    kw = {"max_frames": 20}
    if case == "ref_audio":
        kw["ref_pcm"] = (np.random.default_rng(6).standard_normal(5 * 32 + 7)
                         * 0.1).astype(np.float32)
    if case == "temp0_min_len":
        kw.update(temperature=0.0, min_len=20)
    pcm, n, stop = _synth(pocket["port"], **kw)
    rpcm, rn, rstop = _synth(pocket["jax"], **kw)
    assert (n, stop) == (rn, rstop) and pcm.shape == rpcm.shape == (n * 32,)
    assert np.isfinite(pcm).all() and _corr(pcm, rpcm) > 0.9999


def test_stream_equals_batch(pocket, capsys):
    pcm, n, stop = _synth(pocket["port"], max_frames=11)
    spcm, sn, sstop = _synth(pocket["port"], max_frames=11, stream=True)
    assert (n, stop) == (sn, sstop) and spcm.shape == pcm.shape
    assert _corr(spcm, pcm) > 0.99999
    assert "time-to-first-audio" in capsys.readouterr().out


def test_cli_synthesize_end_to_end(pocket, tmp_path, capsys):
    path = str(pocket["path"])
    ref_wav = tmp_path / "prompt.wav"
    write_wav(ref_wav, (np.random.default_rng(7).standard_normal(200) * 0.1)
              .astype(np.float32), 24000)
    # --min-len 9: the random EOS head fires at once; the gate holds it off
    base = ["synthesize", "--model", path, "--text", "hello there",
            "--max-frames", "9", "--min-len", "9", "--seed", "2"]
    outs = {}
    for name, extra in (("batch", []), ("stream", ["--stream"]),
                        ("voice", ["--ref-audio", str(ref_wav)])):
        outs[name] = tmp_path / f"{name}.wav"
        assert tts_cli.main(base + ["--out", str(outs[name]), "--device",
                                    "cpu"] + extra) == 0
    log = capsys.readouterr().out
    assert "voice conditioning" in log and "time-to-first-audio" in log
    assert jax_cli.main(base + ["--out", str(tmp_path / "ref.wav"),
                                "--ref-audio", str(ref_wav)]) == 0
    pcm = {k: read_wav(v)[0] for k, v in outs.items()}
    want, sr = read_wav(tmp_path / "ref.wav")
    assert sr == 24000 and pcm["batch"].shape == (9 * 32, 1)
    assert _corr(pcm["stream"], pcm["batch"]) > 0.999
    assert _corr(pcm["voice"], want) > 0.999
    # a voice prompt at another rate is refused, as codec_tpu refuses it
    write_wav(ref_wav, np.zeros(64, np.float32), 16000)
    assert tts_cli.main(base + ["--out", str(tmp_path / "x.wav"), "--device",
                                "cpu", "--ref-audio", str(ref_wav)]) == 1
    assert "ref audio rate 16000" in capsys.readouterr().err


def test_chip_smoke_lm_flows_on_cpu(monkeypatch):
    """chip_smoke.py's phase 9c end to end at small widths on the CPU (its
    card-only measurements left out): the three flows' writers, loads,
    requests and card-vs-CPU holds run, and the phase reports the
    requests' frame and patch counts."""
    from pathlib import Path

    from codec_tpu_torch.models import lm_tts_init as lti
    from codec_tpu_torch.models import xy_tokenizer as xy
    from codec_tpu_torch.models.bluemagpie_init import BLUEMAGPIE

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    xy_cfg = xy.XyConfig(encoder_downsample_rate=256, decoder_upsample_rate=192,
                         latent_dim=128, codebook_dim=16, codebook_size=32,
                         n_q=4, mel_n_mels=16, mel_n_fft=64, mel_hop=32,
                         n_layers=1, adapter_layers=1, d_model=32, n_heads=2,
                         vocos_blocks=1, vocos_n_fft=96, vocos_hop=24)
    sizes = dict(
        pocket=dict(flow=FLOW, codec_cfg=SMALL, channels=(32, 16, 8, 8),
                    ffn=64),
        moss=dict(phd=lti.PhdConfig(hidden=256, n_codebook=4, text_vocab=300,
                                    audio_vocab=33, speech_start=100,
                                    speech_end=132, speech_pad=32,
                                    eos_code_c0=5, eos_min_step=6),
                  xy_cfg=xy_cfg, ffn_dim=64, vocos_dim=32,
                  vocos_intermediate=64, post_pos=64, dec_pos=64),
        qwen3=dataclasses.replace(lti.QWEN3_1_7B, hidden=256, n_layers=1,
                                  n_heads=4, n_kv_heads=2, head_dim=64,
                                  ffn_dim=512, vocab_size=300, max_ctx=320),
        bluemagpie=dict(cfm=lti.CfmConfig(
            hidden=64, h_vox=32, h_enc=16, h_dit=16, latent_dim=8,
            patch_size=2, n_heads=2, n_kv=1, head_dim=8, n_locenc=1,
            n_locdit=1, n_ralm=1, ffn_mult=2, rope_rows=64),
            codec_cfg=dataclasses.replace(
                BLUEMAGPIE, latent_dim=8, decoder_rates=(2, 3),
                encoder_rates=(2, 2), decode_hop=6, encode_hop=4),
            decoder_dim=32),
        minicpm=dataclasses.replace(lti.MINICPM4_0_5B, hidden=64, n_layers=1,
                                    n_heads=4, n_kv_heads=2, head_dim=16,
                                    ffn_dim=128, vocab_size=300, max_ctx=256),
        pocket_frames=5, moss_frames=5, bm_patches=2, ref_seconds=0.01)
    none = {"flash_sdpa_window": 0, "q4_k_matmul": 0}
    got, times = cs.lm_flows("CPU", lambda: None, lambda: dict(none), none,
                             dev="cpu", sizes=sizes)
    # what the card is held to: Pocket 2 a decode_latent (3 requests) and
    # an encode_latent, 2 a push with carried keys (5); MOSS 7 products x 1
    # layer x 5 steps
    assert got == {"flash_sdpa_window": 2 * 3 + 2, "q4_k_matmul": 35,
                   "flash_sdpa_window (carried keys)": 2 * 5}
    assert sorted(times) == ["bluemagpie", "moss", "pocket"]
    assert times["pocket"]["profile"] is None     # no card: not measured
    assert times["bluemagpie"]["patch_ms"] > 0
