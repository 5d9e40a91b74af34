"""The port's WAV module against codec_tpu.io.wav: identical bytes out,
identical samples in."""

import numpy as np
import pytest

from codec_tpu.io import wav as jw
from codec_tpu_torch.io import wav as pw


@pytest.mark.parametrize("kind", ["f32_mono", "f32_stereo", "i16"])
def test_write_wav_bytes_match(tmp_path, kind):
    rng = np.random.default_rng(0)
    if kind == "i16":
        x = rng.integers(-32768, 32767, 1000).astype(np.int16)
    elif kind == "f32_stereo":
        x = (rng.standard_normal((500, 2)) * 0.7).astype(np.float32)
    else:
        x = (rng.standard_normal(1000) * 1.5).astype(np.float32)  # clips
    pw.write_wav(tmp_path / "p.wav", x, 24000)
    jw.write_wav(tmp_path / "j.wav", x, 24000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for keep in (False, True):
        got, sr = pw.read_wav(tmp_path / "p.wav", keep_i16=keep)
        want, jsr = jw.read_wav(tmp_path / "j.wav", keep_i16=keep)
        assert sr == jsr == 24000 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
