"""codec-lm-cli-torch (codec_tpu_torch/cli/codec_lm_cli.py) against
codec_tpu's codec-lm-cli on the CPU: `info`'s lines, `step`'s per-codebook
logits (within 1e-5 of their peak: f32 on both sides, sums in another
order) and greedy codes, `compose`'s embedding (bit for bit: the same F16
rows, summed by NumPy on both sides with a compose table, in codebook
order without), on an LFM2-Audio file (per-position in_proj, compose
table) and a CSM-style file (shared in_proj, c0 head, depth tables).
"""

import numpy as np
import pytest

from codec_tpu.cli.codec_lm_cli import main as jax_main
from codec_tpu_torch.cli.codec_lm_cli import main
from codec_tpu_torch.models import lm_tts_init as lti
from codec_tpu_torch.models.lm_init import write_random_csm_gguf
from test_torch_lfm2 import LFM2
from test_torch_tts import DEPTH, MIMI


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lmcli")
    return {"lfm2": lti.write_lfm2_audio_gguf(tmp / "lfm2.gguf", seed=3,
                                              lfm2=LFM2, mimi_cfg=MIMI,
                                              num_filters=8),
            "csm": write_random_csm_gguf(tmp / "csm.gguf", seed=2,
                                         mimi_cfg=MIMI, num_filters=8,
                                         dcfg=DEPTH)}


def _both(args, capsys):
    """Run the port's CLI (on the CPU) and codec_tpu's → their stdouts."""
    assert main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_main(args) == 0
    return got, capsys.readouterr().out


@pytest.mark.parametrize("name", ["lfm2", "csm"])
def test_info_matches_reference(models, name, capsys):
    got, want = _both(["info", "--model", str(models[name])], capsys)
    assert got == want and "kind:           residual_depth_ar" in got


@pytest.mark.parametrize("name", ["lfm2", "csm"])
def test_step_matches_reference(models, name, tmp_path, capsys):
    hidden = {"lfm2": LFM2.hidden, "csm": DEPTH.hidden}[name]
    h = (np.random.default_rng(4).standard_normal(hidden) * 0.5
         ).astype(np.float32)
    np.save(tmp_path / "h.npy", h)
    args = ["step", "--model", str(models[name]), "--hidden",
            str(tmp_path / "h.npy")]
    assert main(args + ["--logits-prefix", str(tmp_path / "q"), "--codes-out",
                        str(tmp_path / "q.npy"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_main(args + ["--logits-prefix", str(tmp_path / "j"),
                            "--codes-out", str(tmp_path / "j.npy")]) == 0
    want = capsys.readouterr().out
    assert got.replace("q.npy", "j.npy") == want
    np.testing.assert_array_equal(np.load(tmp_path / "q.npy"),
                                  np.load(tmp_path / "j.npy"))
    n_cb = {"lfm2": LFM2.n_codebook, "csm": DEPTH.n_codebook}[name]
    for k in range(n_cb):
        a, b = np.load(tmp_path / f"q_{k}.npy"), np.load(tmp_path / f"j_{k}.npy")
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("name", ["lfm2", "csm"])
def test_compose_matches_reference(models, name, tmp_path, capsys):
    n_cb = {"lfm2": LFM2.n_codebook, "csm": DEPTH.n_codebook}[name]
    codes = np.random.default_rng(5).integers(0, 60, n_cb).astype(np.int32)
    codes[1] = -1                                   # a skipped codebook
    np.save(tmp_path / "c.npy", codes)
    args = ["compose", "--model", str(models[name]), "--codes",
            str(tmp_path / "c.npy")]
    assert main(args + ["--embd-out", str(tmp_path / "q.npy"), "--device",
                        "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert jax_main(args + ["--embd-out", str(tmp_path / "j.npy")]) == 0
    want_out = capsys.readouterr().out
    assert got_out.split(":")[-1] == want_out.split(":")[-1]
    got, want = np.load(tmp_path / "q.npy"), np.load(tmp_path / "j.npy")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_errors_match_reference(models, tmp_path, capsys):
    """A hidden of the wrong length or dtype and a code frame of the wrong
    length: exit 1 with codec_tpu's message."""
    bad = [("h.npy", np.zeros(7, np.float32), "step", "--hidden",
            ["--logits-prefix", str(tmp_path / "p")]),
           ("h64.npy", np.zeros(LFM2.hidden, np.float64), "step", "--hidden",
            ["--logits-prefix", str(tmp_path / "p")]),
           ("c.npy", np.zeros(3, np.int32), "compose", "--codes",
            ["--embd-out", str(tmp_path / "e.npy")])]
    for fname, arr, cmd, flag, rest in bad:
        np.save(tmp_path / fname, arr)
        args = [cmd, "--model", str(models["lfm2"]), flag,
                str(tmp_path / fname)] + rest
        assert main(args + ["--device", "cpu"]) == 1
        got = capsys.readouterr().err
        assert jax_main(args) == 1
        assert got == capsys.readouterr().err and got.startswith("error: ")
