"""The port's GBNF grammars (codec_tpu_torch/lm/gbnf.py) and the
grammar-constrained codebook-AR flow (tts_runner.run_codebook_ar(grammar=,
token_pieces=), tts-cli-torch --grammar) against codec_tpu on the CPU.

Fixtures: the small MOSS-TTSD file of tests/test_torch_phd.py (cb0 is the
backbone's 300-id merged text vocabulary, where a grammar on the backbone
sampler applies) over an f32 Qwen3-style backbone with tests/test_bpe.py's
Llama-3-style BPE tokenizer baked in, so that the token pieces come from
the BPE branch. Bounds: parse trees, auto grammars, sampled tokens, codes
equal; PCM corr > 0.9999.
"""

import dataclasses

import numpy as np
import pytest

from codec_tpu.cli.tts_cli import main as jax_main
from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.wav import read_wav as jax_read_wav
from codec_tpu.lm import create_lm as jax_create_lm
from codec_tpu.lm import gbnf as jgbnf
from codec_tpu.lm import tts_runner as jax_runner
from codec_tpu.lm.audio_lm import AudioLM as JaxAudioLM
from codec_tpu.lm.backbone import LlamaBackbone as JaxBackbone
from codec_tpu.lm.prompt_info import build_prompt_info as jax_prompt_info
from codec_tpu_torch.cli.tts_cli import load_backbone_tokenizer, main
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.io.wav import read_wav
from codec_tpu_torch.lm import create_lm, gbnf, tts_runner
from codec_tpu_torch.lm.audio_lm import AudioLM
from codec_tpu_torch.lm.backbone import LlamaBackbone
from codec_tpu_torch.lm.bpe import BpeByteLevel
from codec_tpu_torch.lm.prompt_info import build_prompt_info
from codec_tpu_torch.models.lm_init import write_random_backbone_gguf
from codec_tpu_torch.models.lm_tts_init import write_moss_ttsd_gguf

from test_bpe import llama3_pair  # noqa: F401
from test_torch_phd import BB, PHD, XY, XY_WIDTHS

# (codec_tpu's parser reads the end of the text as a dangling quantifier,
# and loops forever on a rule name at the end: its grammars here end in a
# newline; the port's copy parses both, test_end_of_text_fixed)
GRAMMARS = [
    'root ::= "a"\n',
    'root ::= [a-z]+ ("," [ \\t]* [a-z]+)*  # words\nws ::= [ \\n]?\n',
    'root ::= item*\nitem ::= "<" num ">" | "\\x41"\nnum ::= [1-9] [0-9]?\n',
    'root ::= ( "yes" | "no" )? [^"\\\\]+\n',
    'root ::= "\\[" [\\]\\[a]* "\\]"\n',
]
BAD = ['root ::= "a\n', 'x ::= "a"\n', 'root ::= ref\n', 'root ::= [a-\n',
       'root = "a"\n', 'root ::= *\n', 'root ::= "\\q"\n']


def _rules(g):
    return {k: [tuple(a) for a in v] for k, v in g.rules.items()}


@pytest.mark.parametrize("text", GRAMMARS)
def test_parse_matches(text):
    assert _rules(gbnf.parse_gbnf(text)) == _rules(jgbnf.parse_gbnf(text))


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_match(text):
    with pytest.raises(jgbnf.GbnfError) as want:
        jgbnf.parse_gbnf(text)
    with pytest.raises(gbnf.GbnfError) as got:
        gbnf.parse_gbnf(text)
    assert str(got.value) == str(want.value)
    assert issubclass(gbnf.GbnfError, ValueError)


@pytest.mark.parametrize("text", GRAMMARS)
def test_end_of_text_fixed(text):
    """Without the trailing newline the port parses what codec_tpu parses
    with it (codec_tpu raises "dangling" there); a rule name that ends
    the text is an error, not a hang."""
    with pytest.raises(jgbnf.GbnfError, match="dangling"):
        jgbnf.parse_gbnf(text.rstrip("\n"))
    assert _rules(gbnf.parse_gbnf(text.rstrip("\n"))) == \
        _rules(jgbnf.parse_gbnf(text))
    with pytest.raises(gbnf.GbnfError, match="expected ::= after 'x'"):
        gbnf.parse_gbnf("x")
    with pytest.raises(gbnf.GbnfError, match="undefined rule 'ref'"):
        gbnf.parse_gbnf("root ::= ref")


@pytest.mark.parametrize("n", [0, 5, 9, 10, 42, 99, 100, 123, 999, 1000,
                               1234, 9999, 10000])
def test_uint_range_rule_matches(n):
    assert gbnf.gbnf_uint_range_rule(n) == jgbnf.gbnf_uint_range_rule(n)
    g = gbnf.parse_gbnf(f"root ::= {gbnf.gbnf_uint_range_rule(n)}\n")
    for v in (0, n // 2, n, n + 1):
        st = gbnf.GrammarState(g).accepts_text(str(v))
        ok = st is not None and st.can_stop
        assert ok == (v <= n or n > 9999), v


def test_auto_grammar_matches(tmp_path):
    model = write_moss_ttsd_gguf(tmp_path / "m.gguf", seed=1, phd=PHD,
                                 xy_cfg=XY, **XY_WIDTHS)
    reader = GGUFReader(model)
    pi = build_prompt_info(reader, create_lm(reader, device="cpu").info)
    jr = JaxReader(str(model))
    jpi = jax_prompt_info(jr, jax_create_lm(jr).info)
    assert gbnf.tts_auto_grammar(pi) == jgbnf.tts_auto_grammar(jpi) != ""


@pytest.mark.parametrize("text", GRAMMARS[1:])
def test_sampler_matches(text):
    """A grammar over 200 random pieces with an argmax base sampler: the
    picks (the fast path and the masked resample), the stop flags and the
    dead-end error equal codec_tpu's."""
    rng = np.random.default_rng(len(text))
    alphabet = list("abcxyz<>19, \t[]A\"") + ["yes", "no", "ab", "<1", "0>"]
    pieces = [""] + ["".join(rng.choice(alphabet, rng.integers(1, 3)))
                     for _ in range(199)]
    base = lambda lg: int(np.argmax(lg))
    ours = gbnf.GrammarSampler(text, pieces, base, eog_tokens=(0,))
    ref = jgbnf.GrammarSampler(text, pieces, base, eog_tokens=(0,))
    for _ in range(12):
        lg = rng.standard_normal(200).astype(np.float32)
        try:
            want = ref(lg)
        except jgbnf.GbnfError:
            with pytest.raises(gbnf.GbnfError):
                ours(lg)
            break
        assert ours(lg) == want
        assert ours.state.can_stop == ref.state.can_stop
        ours.accept(want)
        ref.accept(want)
    np.testing.assert_array_equal(ours.mask(lg), ref.mask(lg))


@pytest.fixture(scope="module")
def files(tmp_path_factory, llama3_pair):
    oracle, _ = llama3_pair
    tmp = tmp_path_factory.mktemp("gbnf")
    model = write_moss_ttsd_gguf(tmp / "ttsd.gguf", seed=5, phd=PHD,
                                 xy_cfg=XY, **XY_WIDTHS)
    blob = BpeByteLevel.json_to_zb64(oracle.to_str().encode())
    bb = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=6, qtype="F32",
        cfg=dataclasses.replace(BB, vocab_size=oracle.get_vocab_size()),
        rope_scaling=None, bpe_zb64=blob)
    tok = load_backbone_tokenizer(GGUFReader(bb))
    # a grammar whose pieces are the speech range's (MOSS-TTSD's cb0 range)
    pieces = sorted({tok.decode_piece(i) for i in
                     range(PHD.speech_start, PHD.speech_end)} - {""})
    esc = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\r": "\\r", "\t": "\\t"}
    lits = " | ".join('"' + "".join(esc.get(c, c) for c in p) + '"'
                      for p in pieces)
    grammar = f"root ::= piece+\npiece ::= {lits}\n"
    return tmp, model, bb, grammar


def _engine(model, bb, port):
    if port:
        reader = GGUFReader(model)
        lm = create_lm(reader, device="cpu")
        return dict(port=True, reader=reader, lm=lm,
                    pi=build_prompt_info(reader, lm.info),
                    bb=LlamaBackbone(bb, device="cpu"),
                    tok=load_backbone_tokenizer(GGUFReader(bb)))
    reader = JaxReader(str(model))
    lm = jax_create_lm(reader)
    from codec_tpu.cli.tts_cli import load_backbone_tokenizer as jload

    return dict(port=False, reader=reader, lm=lm,
                pi=jax_prompt_info(reader, lm.info), bb=JaxBackbone(str(bb)),
                tok=jload(JaxReader(str(bb))))


@pytest.mark.parametrize("which", ["speech", "words"])
def test_run_codebook_ar_with_grammar_matches(files, which):
    """run_codebook_ar with a grammar (the host path, also when on_device
    is asked for) against codec_tpu's: the codes, and every cb0 pick's
    piece admitted by the grammar."""
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    _, model, bb, grammar = files
    if which == "words":
        grammar = 'root ::= [a-zA-Z ]+\n'
    out = []
    for port in (True, False):
        eng = _engine(model, bb, port)
        alm_cls, run = ((AudioLM, tts_runner.run_codebook_ar) if port
                        else (JaxAudioLM, jax_runner.run_codebook_ar))
        alm = alm_cls(eng["reader"], lm=eng["lm"])
        ids = eng["tok"].encode("hello there")
        rows = [alm.compose_prompt_embd(t) for t in ids]
        pieces = [eng["tok"].decode_piece(i)
                  for i in range(eng["tok"].vocab_size)]
        kw = dict(on_device=OnDeviceSampling(chunk_frames=2)) if port else {}
        out.append(run(alm, eng["bb"], rows, max_steps=6, pi=eng["pi"],
                       decode=False, grammar=grammar, token_pieces=pieces,
                       sampler=lambda cb, lg: int(np.argmax(lg)), **kw))
        text = "".join(pieces[c] for c in out[-1].codes[:, 0])
        assert gbnf.GrammarState(gbnf.parse_gbnf(grammar)).accepts_text(text)
    np.testing.assert_array_equal(out[0].codes, out[1].codes)
    assert out[0].n_steps == out[1].n_steps == 6


def test_cli_grammar_matches_reference(files, tmp_path, capsys):
    """tts-cli-torch synthesize --grammar (a file, then the same grammar
    as a literal string) on the BPE backbone against codec_tpu's CLI."""
    _, model, bb, grammar = files
    gfile = tmp_path / "speech.gbnf"
    gfile.write_text(grammar)
    args = ["synthesize", "--model", str(model), "--backbone", str(bb),
            "--text", "hello there", "--max-frames", "6", "--temp", "0"]
    assert jax_main(args + ["--grammar", str(gfile), "--out",
                            str(tmp_path / "ref.wav")]) == 0
    want, jsr = jax_read_wav(tmp_path / "ref.wav")
    for g in (str(gfile), grammar):
        out = tmp_path / "port.wav"
        assert main(args + ["--grammar", g, "--out", str(out), "--device",
                            "cpu", "--on-device"]) == 0
        assert "backbone AR done: 6 steps" in capsys.readouterr().out
        got, sr = read_wav(out)
        assert sr == jsr and got.shape == want.shape
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    assert main(args + ["--grammar", "root ::= [a\n", "--out",
                        str(tmp_path / "x.wav"), "--device", "cpu"]) == 1
    assert "GBNF parse error" in capsys.readouterr().err
