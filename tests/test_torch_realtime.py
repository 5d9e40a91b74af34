"""The port's MOSS-TTS-Realtime flow (the repetition-penalized frame
`_build_frame(rep=)`, the stream chunk and StreamRunner of lm/fused_gen.py,
lm/tts_runner.run_realtime_streaming, the tts-cli branch) against
codec_tpu on the CPU.

Fixtures are the port's writers at small widths, read by both packages:
models/lm_tts_init.py::write_moss_realtime_gguf (a tiny stereo
MOSS-Audio-Tokenizer of 4 levels x 16 with a realtime adaptor of 4
codebooks of 16 codes + pad 16, BOS 17 and EOS 18, c0 modality "none",
over a backbone hidden of 256) and a Q8_0 backbone at Qwen3-1.7B's flags
with the byte-fallback SPM vocab.

Randomness is data in the port (Gumbel noise where codec_tpu takes keys),
so sampled comparisons feed the port the noise of codec_tpu's key splits
and ask for equal codes and equal histories; greedy codes are equal
outright; host SamplerChains draw from NumPy on both sides. PCM corr >
0.99999 and max abs err <= 1e-4 x peak; hiddens within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_tpu.lm import fused_gen as jax_fused_gen
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.ops.sample import OnDeviceSampling as JaxOnDevice
from codec_tpu_torch.lm import fused_gen, tts_runner
from codec_tpu_torch.lm.backbone import StepGroup
from codec_tpu_torch.lm.tts_runner import SamplerChain
from codec_tpu_torch.models import lm_tts_init as lti
from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                            spm_model_b64,
                                            write_random_backbone_gguf)
from codec_tpu_torch.ops import sample
from codec_tpu_torch.ops.sample import OnDeviceSampling
from test_torch_lfm2 import (chain_of, cli_pair, codebook_noise, frame_noise,
                             host_logits, make_engines)
from test_torch_moss import STEREO
from test_torch_tts import _assert_close_pcm

MOSS = dataclasses.replace(STEREO, n_q=4, codebook_size=16)
RT = lti.RealtimeConfig(hidden=256, layers=1, heads=2, kv_heads=1,
                        head_dim=16, ffn=48, n_codebook=4, audio_vocab=19,
                        prefill_text_len=2, text_pad=0)
BB = dataclasses.replace(lti.QWEN3_1_7B, hidden=256, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=64, ffn_dim=512,
                         vocab_size=300, max_ctx=448)
CTX, TEXT = [1, 2, 3], [4, 5, 6, 7]
SAMPLED = dict(temperature=0.8, top_k=5)
REP = (1.3, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp, name, **rt):
    return lti.write_moss_realtime_gguf(tmp / name, seed=5,
                                        rt=dataclasses.replace(RT, **rt),
                                        moss_cfg=MOSS)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("realtime")
    bb = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=6, qtype="Q8_0", cfg=BB, rope_scaling=None,
        spm_b64=spm_model_b64(byte_fallback_vocab()))
    return tmp, _write(tmp, "rt.gguf"), bb


@pytest.fixture(scope="module")
def engines(files):
    _, model, bb = files
    return make_engines(model, bb)


def _stream(eng, ods=None, samplers=None, max_frames=6, port=True):
    run = tts_runner.run_realtime_streaming if port else \
        jax_runner.run_realtime_streaming
    cls = OnDeviceSampling if port else JaxOnDevice
    bb = eng["bb"]
    bb.reset()
    return run(eng["alm"], bb, lambda t: bb.embed_tokens([t])[0], CTX, TEXT,
               eng["pi"], max_frames=max_frames, samplers=samplers,
               on_device=None if ods is None else cls(**ods))


GREEDY = [lambda lg: int(np.argmax(lg))] * RT.n_codebook


def _h(seed):
    return (np.random.default_rng(seed).standard_normal(RT.hidden) * 0.5
            ).astype(np.float32)


def _port_rp(lm, chain, rep, h, noise, hist):
    """The port's penalized frame on one hidden → (codes [n_cb], hist')."""
    frame = lm._build_frame(chain, rep=rep)
    with torch.inference_mode():
        codes, hist = frame(torch.from_numpy(h)[None],
                            torch.from_numpy(noise)[None], torch.tensor([0]),
                            hist)
    return codes[0].numpy(), hist


def _jax_hist(hist):
    if isinstance(hist, tuple):
        return (jnp.asarray(hist[0].numpy()), jnp.int32(int(hist[1][0])))
    return jnp.asarray(hist.numpy())


def _assert_hist_equal(got, want):
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1][0]) == int(want[1])
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _some_hist(lm, window, frames=2, seed=8):
    """A history after `frames` frames of random codes (a ring with
    window - frames empty slots, or a seen mask)."""
    rng = np.random.default_rng(seed)
    hist = fused_gen.init_rep_hist(lm, window, "cpu")
    for _ in range(frames):
        codes = rng.integers(0, RT.audio_vocab, RT.n_codebook)
        if window > 0:
            ring, ptr = hist
            ring[:, int(ptr[0]) % window] = torch.from_numpy(codes)
            hist = (ring, ptr + 1)
        else:
            hist[np.arange(RT.n_codebook), codes] = True
    return hist


# -- the penalized frame -------------------------------------------------------

@pytest.mark.parametrize("window", [3, -1], ids=["ring", "mask"])
def test_frame_rp_greedy_matches_plain_and_reference(engines, window):
    """At temperature 0 the penalty is inert: the plain frame's codes; the
    history still advances, as codec_tpu's does."""
    port, ref = engines
    lm, chain, h = port["lm"], chain_of(), _h(1)
    plain = lm._build_frame(chain)
    with torch.inference_mode():
        want = plain(torch.from_numpy(h)[None], torch.zeros(
            (1, RT.n_codebook, lm.noise_width())), torch.tensor([0]))[0].numpy()
    hist = fused_gen.init_rep_hist(lm, window, "cpu")
    jhist = _jax_hist(hist)
    codes, hist = _port_rp(lm, chain, (1.3, window), h,
                           np.zeros((RT.n_codebook, lm.noise_width()),
                                    np.float32), hist)
    np.testing.assert_array_equal(codes, want)
    jcodes, jhist = jax.jit(ref["lm"]._build_frame(chain, rep=(1.3, window)))(
        jnp.asarray(h), jax.random.PRNGKey(0), jnp.int32(0), jhist)
    np.testing.assert_array_equal(codes, np.asarray(jcodes))
    _assert_hist_equal(hist, jhist)
    if window > 0:
        np.testing.assert_array_equal(hist[0][:, 0].numpy(), codes)
        assert (hist[0][:, 1:] == -1).all() and int(hist[1][0]) == 1


@pytest.mark.parametrize("window", [3, -1], ids=["ring", "mask"])
def test_frame_rp_sampled_matches_reference(engines, window):
    """Sampled with the penalty on a history of 2 frames (the ring with one
    empty slot), codec_tpu's key-split noise fed in: its codes and its
    history, over 4 keys."""
    port, ref = engines
    lm, chain = port["lm"], chain_of(**SAMPLED)
    jframe = jax.jit(ref["lm"]._build_frame(chain, rep=(REP[0], window)))
    for s in range(4):
        hist = _some_hist(lm, window, seed=s)
        jhist = _jax_hist(hist)
        key = jax.random.PRNGKey(s)
        codes, hist = _port_rp(lm, chain, (REP[0], window), _h(s),
                               codebook_noise(key, lm), hist)
        jcodes, jhist = jframe(jnp.asarray(_h(s)), key, jnp.int32(0), jhist)
        np.testing.assert_array_equal(codes, np.asarray(jcodes))
        _assert_hist_equal(hist, jhist)


def test_frame_rp_penalty_suppresses_repeats(engines):
    """A huge penalty at a near-greedy temperature: a code already in the
    ring cannot win again where its logit is positive (codec_tpu's test)."""
    port, _ = engines
    lm, h = port["lm"], _h(2)
    greedy, _ = _port_rp(lm, chain_of(), (1.0, 4), h,
                         np.zeros((RT.n_codebook, lm.noise_width()),
                                  np.float32),
                         fused_gen.init_rep_hist(lm, 4, "cpu"))
    rings = torch.from_numpy(np.tile(greedy[:, None], (1, 4))).int()
    codes, _ = _port_rp(lm, chain_of(temperature=1e-4), (1e6, 4), h,
                        codebook_noise(jax.random.PRNGKey(1), lm),
                        (rings, torch.tensor([4])))
    for cb, lg in enumerate(host_logits(lm, h, greedy)):
        if lg[greedy[cb]] > 0:
            assert codes[cb] != greedy[cb], f"cb {cb} repeated"


def test_empty_ring_marks_the_last_id(engines):
    """codec_tpu's quirk, kept: an empty ring slot (-1) marks id
    max_vocab - 1 as seen, so a fresh ring penalizes that id (here the EOS
    code) and only it: the frame on an empty ring equals the frame on a
    seen mask holding that id alone, and codec_tpu's frame."""
    port, ref = engines
    lm, chain = port["lm"], chain_of(**SAMPLED)
    ring = fused_gen.init_rep_hist(lm, 3, "cpu")
    seen = sample.seen_mask_from_ring(ring[0], RT.audio_vocab)
    assert seen[:, -1].all() and seen.sum() == RT.n_codebook
    only_last = fused_gen.init_rep_hist(lm, -1, "cpu")
    only_last[:, -1] = True
    jframe = jax.jit(ref["lm"]._build_frame(chain, rep=(50.0, 3)))
    for s in range(4):
        noise = codebook_noise(jax.random.PRNGKey(10 + s), lm)
        got, _ = _port_rp(lm, chain, (50.0, 3), _h(s), noise,
                          fused_gen.init_rep_hist(lm, 3, "cpu"))
        want, _ = _port_rp(lm, chain, (50.0, -1), _h(s), noise,
                           only_last.clone())
        np.testing.assert_array_equal(got, want)
        jcodes, _ = jframe(jnp.asarray(_h(s)), jax.random.PRNGKey(10 + s),
                           jnp.int32(0), _jax_hist(fused_gen.init_rep_hist(
                               lm, 3, "cpu")))
        np.testing.assert_array_equal(got, np.asarray(jcodes))


# -- the flow -------------------------------------------------------------------

def test_host_greedy_matches_reference(engines):
    """run_realtime_streaming on the host path, greedy samplers: the codes
    and PCM of codec_tpu's; the prompt's pad codes (16, not -1) composed."""
    port, ref = engines
    from codec_tpu.lm.prompt_info import build_prompt_info as jax_prompt_info

    # the port builds PromptInfo with the LM's info; codec_tpu's CLI without
    # it (build_prompt_info(reader)): the flow's fields agree either way
    for pi in (ref["pi"], jax_prompt_info(ref["reader"])):
        assert port["pi"].streaming_interleave and pi.streaming_interleave
        assert not pi.sequential_text_audio
        for key in ("audio_pad_code", "bos_code_c0", "text_pad_id",
                    "prefill_text_len", "repetition_window",
                    "default_temperature", "default_top_k", "default_top_p",
                    "default_repetition_penalty", "prompt_prefix",
                    "prompt_suffix"):
            assert getattr(port["pi"], key) == getattr(pi, key), key
    got = _stream(port, samplers=GREEDY)
    want = _stream(ref, samplers=GREEDY, port=False)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.shape == (6, RT.n_codebook)
    assert (got.n_steps, got.stopped_by_eos) == (want.n_steps,
                                                 want.stopped_by_eos)
    _assert_close_pcm(got.pcm, want.pcm)


def test_host_default_samplers_match_reference(engines):
    """The family's samplers (a SamplerChain a codebook: temperature 0.8,
    top_k 30, top_p 0.6, repetition penalty 1.1 over 50 codes; NumPy draws
    on both sides): codec_tpu's codes."""
    port, ref = engines
    got = _stream(port, max_frames=8)
    want = _stream(ref, max_frames=8, port=False)
    np.testing.assert_array_equal(got.codes, want.codes)


@pytest.mark.parametrize("chunk", [2, 4])
def test_chunks_greedy_match_host(engines, chunk):
    """Greedy stream chunks of 2 and 4 (eager on the CPU; the penalty is
    inert at temperature 0): the host path's codes and codec_tpu's chunked
    run's."""
    port, ref = engines
    ods = dict(chunk_frames=chunk, repetition_penalty=REP[0],
               repetition_window=REP[1])
    got = _stream(port, ods=ods)
    np.testing.assert_array_equal(got.codes, _stream(port, samplers=GREEDY).codes)
    np.testing.assert_array_equal(got.codes, _stream(ref, ods=ods,
                                                     port=False).codes)
    assert got.n_steps == 6 and not got.stopped_by_eos


def test_sampled_chunk_sizes_agree(engines):
    """Sampled with the penalty: chunks of 2 and 4 draw the same noise
    stream and carry the same history across chunks, so the same codes."""
    port, _ = engines
    runs = [_stream(port, ods=dict(SAMPLED, chunk_frames=k, seed=11,
                                   repetition_penalty=REP[0],
                                   repetition_window=REP[1]))
            for k in (2, 4)]
    np.testing.assert_array_equal(runs[0].codes, runs[1].codes)
    assert runs[0].codes.shape == (6, RT.n_codebook)


def _prefilled(eng, port=True):
    """The flow's prefill on the engine's backbone → the last hidden."""
    bb, pi, lm = eng["bb"], eng["pi"], eng["lm"]
    bb.reset()
    pad = [pi.audio_pad_code] * RT.n_codebook
    rows = [(t, pad) for t in CTX] + [(TEXT[0], pad),
                                      (TEXT[1], [pi.bos_code_c0] + pad[1:])]
    h = None
    for t, codes in rows:
        h = bb.step(bb.embed_tokens([t])[0] + lm.compose_audio_embd(codes))
    return np.asarray(h, np.float32)


@pytest.mark.parametrize("chain", [chain_of(), chain_of(**SAMPLED)],
                         ids=["greedy", "sampled"])
def test_stream_chunk_packed_matches_reference(engines, chain):
    """One 4-frame stream chunk from the same state, codec_tpu's noise fed
    in and a history of 2 frames: packed codes and meta, the history and
    the position equal codec_tpu's, the hidden within 1e-4."""
    port, ref = engines
    h = _prefilled(port)
    _prefilled(ref, port=False)
    bb, jbb, lm = port["bb"], ref["bb"], port["lm"]
    key = jax.random.PRNGKey(3)
    noise, _ = frame_noise(key, lm, 4)
    hist = _some_hist(lm, REP[1])
    jhist = _jax_hist(hist)
    sched = [TEXT[2], TEXT[3], 0, 0]
    chunk = fused_gen.build_stream_chunk(lm, bb.cfg, chain, REP, 4)
    with torch.inference_mode():
        packed, h2, pos, hist = chunk(
            StepGroup(bb), [bb.kv[None]], torch.tensor([bb.pos]),
            torch.tensor([0]), torch.from_numpy(h)[None], torch.from_numpy(noise)[:, None], hist,
            torch.tensor(sched), 64)
    fn = jax_fused_gen.gen_chunk_cached(
        ref["lm"], jbb, n_frames=4, stream=True, rep=REP, temperature=chain[0],
        top_k=chain[1], top_p=chain[2], min_p=chain[3])
    jpacked, jh2, _, _, jhist = fn(jbb.params, jbb.kv, np.int32(jbb.pos),
                                   np.int32(0), jnp.asarray(h), key, jhist,
                                   jnp.asarray(sched, jnp.int32))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    _assert_hist_equal(hist, jhist)
    assert int(pos[0]) == len(CTX) + 2 + 4
    np.testing.assert_allclose(h2[0].numpy(), np.asarray(jh2), rtol=1e-4,
                               atol=1e-4)


def test_history_after_a_chunk_is_the_host_chains(engines):
    """Greedy, window 3: the ring after one chunk of 4 frames holds, slot
    by slot, each codebook's last 3 codes of the host SamplerChain's
    history over the same frames."""
    port, _ = engines
    chains = [SamplerChain(temperature=0.0, repetition_penalty=REP[0],
                           repetition_window=REP[1])
              for _ in range(RT.n_codebook)]
    host = _stream(port, samplers=chains, max_frames=4)
    _stream(port, ods=dict(chunk_frames=4, repetition_penalty=REP[0],
                           repetition_window=REP[1]), max_frames=4)
    runner = next(reversed(port["bb"]._gen_chunks.values()))[1]
    assert isinstance(runner, fused_gen.StreamRunner)
    ring, ptr = runner.hist
    assert int(ptr[0]) == 4
    order = [(int(ptr[0]) + j) % REP[1] for j in range(REP[1])]
    for cb, chain in enumerate(chains):
        assert ring[cb, order].tolist() == chain.history[-REP[1]:]
        assert chain.history == host.codes[:, cb].tolist()


def test_eos_mid_chunk_matches_reference(files, engines):
    """EOS inside a chunk of 8: the frames stop at the gate, the EOS frame
    is dropped from the codes and counts no step; host path, chunk and
    codec_tpu's chunk agree."""
    tmp, _, bb = files
    c0 = _stream(engines[0], samplers=GREEDY, max_frames=10).codes[:, 0]
    k = next(k for k in range(2, len(c0)) if c0[k] not in c0[:k])
    port, ref = make_engines(_write(tmp, "rt_eos.gguf",
                                    audio_eos_token=int(c0[k])), bb)
    ods = dict(chunk_frames=8)
    runs = [_stream(port, samplers=GREEDY, max_frames=16),
            _stream(port, ods=ods, max_frames=16),
            _stream(ref, ods=ods, max_frames=16, port=False)]
    for res in runs:
        assert res.stopped_by_eos and res.n_steps == k
        assert res.codes.shape == (k, RT.n_codebook)
        np.testing.assert_array_equal(res.codes, runs[0].codes)


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "chunks"])
def test_cli_matches_reference(files, tmp_path, monkeypatch, capsys,
                               on_device):
    """tts-cli-torch synthesize on the realtime file (the prompt split into
    context and the last prefill_text_len tokens of spoken text; host: the
    family's samplers; --on-device --temp 0: greedy chunks of 4 with the
    penalty of the family's window) against codec_tpu's CLI."""
    _, model, bb = files
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "5", "--quant-exec"]
    if on_device:
        args += ["--on-device", "--chunk-frames", "4", "--temp", "0"]
    got, want, sr = cli_pair(args, tmp_path, monkeypatch)
    assert "backbone AR done: 5 steps" in capsys.readouterr().out
    assert sr == MOSS.sample_rate and got.shape == want.shape
    _assert_close_pcm(got, want)


def test_bucketed_prefill_matches_steps(engines):
    """prefill_bucket > 0 (one padded forward over the prompt's rows, the
    port's option; codec_tpu steps a row at a time): the hidden before the
    first frame within 1e-5 and the same greedy codes."""
    port, _ = engines
    bb = port["bb"]
    got = []
    for bucket in (0, 8):
        bb.reset()
        got.append(tts_runner.run_realtime_streaming(
            port["alm"], bb, lambda t: bb.embed_tokens([t])[0], CTX, TEXT,
            port["pi"], max_frames=6, samplers=GREEDY, decode=False,
            prefill_bucket=bucket))
    np.testing.assert_array_equal(got[0].codes, got[1].codes)
    assert got[0].n_steps == got[1].n_steps == 6


def test_chip_smoke_rest_flows_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 9e end to end at small widths on the CPU (its
    card-only measurements left out): the writers, loads, requests and
    holds of LFM2-Audio, MOSS-TTS-Realtime (greedy and sampled) and the
    Qwen3-MoE backbone under a small MOSS-TTSD file, and the launch counts
    the card is held to."""
    from pathlib import Path

    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.backbone import create_backbone
    from codec_tpu_torch.lm.prompt_info import build_prompt_info
    from codec_tpu_torch.lm.spm import SpmUnigram
    from codec_tpu_torch.models import xy_tokenizer as xy
    from codec_tpu_torch.models.lm_init import write_random_backbone_ggufs
    from test_torch_lfm2 import LFM2
    from test_torch_tts import MIMI

    import codec_tpu_torch

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    xy_cfg = xy.XyConfig(encoder_downsample_rate=256, decoder_upsample_rate=192,
                         latent_dim=128, codebook_dim=16, codebook_size=32,
                         n_q=4, mel_n_mels=16, mel_n_fft=64, mel_hop=32,
                         n_layers=1, adapter_layers=1, d_model=32, n_heads=2,
                         vocos_blocks=1, vocos_n_fft=96, vocos_hop=24)
    ttsd = lti.write_moss_ttsd_gguf(
        tmp_path / "ttsd.gguf", seed=0, phd=lti.PhdConfig(
            hidden=256, n_codebook=4, text_vocab=300, audio_vocab=33,
            speech_start=100, speech_end=132, speech_pad=32, eos_code_c0=5,
            eos_min_step=30), xy_cfg=xy_cfg, ffn_dim=64, vocos_dim=32,
        vocos_intermediate=64, post_pos=64, dec_pos=64)
    spm = spm_model_b64(byte_fallback_vocab())
    small = dict(hidden=256, n_layers=1, n_heads=4, n_kv_heads=2, head_dim=64,
                 vocab_size=300)
    q_path = write_random_backbone_ggufs(
        {"Q4_K": tmp_path / "q.gguf"}, seed=1, rope_scaling=None, spm_b64=spm,
        cfg=dataclasses.replace(lti.QWEN3_1_7B, ffn_dim=512, max_ctx=640,
                                **small))["Q4_K"]
    reader = GGUFReader(ttsd)
    plm = create_lm(reader, device="cpu")
    pi = build_prompt_info(reader, plm.info)
    reuse = {"ttsd": (reader, plm, create_lm(reader, device="cpu"),
                      codec_tpu_torch.load_model(ttsd, device="cpu"),
                      SpmUnigram.from_b64(spm).encode(
                          pi.prompt_prefix + cs.LM_TEXT + pi.prompt_suffix), pi),
             "qwen3": tuple(create_backbone(q_path, quantized=True,
                                            device="cpu") for _ in range(2))}
    sizes = dict(
        lfm2=dataclasses.replace(LFM2, layers=1, eos_min_step=30,
                                 max_text_tokens=2),
        mimi=dict(mimi_cfg=MIMI, num_filters=8),
        lfm2_bb=dataclasses.replace(lti.LFM2_1_2B, ffn_dim=512, max_ctx=512,
                                    **small),
        rt=dataclasses.replace(RT, eos_min_step=30),
        moss=dict(moss_cfg=MOSS),
        moe=dataclasses.replace(lti.QWEN3_30B_A3B, max_ctx=512, n_experts=8,
                                n_experts_used=2, moe_ffn_dim=32, **small),
        frames=5, cpu_frames=3, chunk=2, moe_prompt=4, moe_steps=2)
    none = {"flash_sdpa_window": 0, "q4_k_matmul": 0, "q8_0_matmul": 0}
    got, times = cs.rest_lm_flows("CPU", lambda: None, lambda: dict(none),
                                  none, reuse, dev="cpu", sizes=sizes)
    # what the card is held to: LFM2 7 products a layer a step (5 frames,
    # 2 text tokens and audio_start) on the host path and the text phase's
    # 3 steps on the device path, the same on Q8_0; realtime 7 x 5 steps;
    # the MoE's 4 a layer a call (a prefill and 2 steps, then 5 steps);
    # Mimi's 8 and MOSS's 15 attention launches a decode (LFM2 x 3, MOSS x
    # 3 with the sampled request)
    assert got == {"flash_sdpa_window": 3 * 8 + 3 * 15,
                   "q4_k_matmul": 7 * 8 + 7 * 3 + 7 * 5 + 4 * 3 + 4 * 5,
                   "q8_0_matmul": 7 * 8}
    assert sorted(times) == ["lfm2", "moe", "rt"]
    assert "replay_frame_ms" not in times["rt"]     # no card: not measured
