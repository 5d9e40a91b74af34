"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                           flash_sdpa_window_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, dtype) for _ in range(3)]


# the Mimi decoder shapes, the reference kernel's test shapes, and D=128;
# f32 bound as in tests/test_attn_pallas.py (atol 2e-5, rtol 1e-5)
@pytest.mark.parametrize("b,h,t,d,w", [
    (1, 8, 500, 64, 250),
    (1, 8, 1500, 64, 250),
    (4, 8, 500, 64, 250),
    (1, 2, 300, 64, None),
    (1, 2, 256, 128, 16),
    (2, 4, 300, 64, 50),
    (1, 8, 130, 64, 250),
    (1, 1, 1, 64, 1),
])
def test_kernel_matches_plain_f32(dev, b, h, t, d, w):
    q, k, v = _qkv((b, h, t, d), torch.float32, dev)
    got = flash_sdpa_window(q, k, v, window=w)
    want = flash_sdpa_window_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_matches_plain_bf16(dev, d):
    q, k, v = _qkv((1, 8, 500, d), torch.bfloat16, dev, seed=1)
    got = flash_sdpa_window(q, k, v, window=250)
    want = flash_sdpa_window_ref(q, k, v, window=250)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # bound as in tests/test_attn_pallas.py::test_flash_bf16
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def test_launch_counter_counts_kernel_launches_only(dev):
    q, k, v = _qkv((1, 2, 100, 64), torch.float32, dev)
    before = flash_sdpa_window.launches
    flash_sdpa_window(q, k, v, window=10)
    flash_sdpa_window(q.cpu(), k.cpu(), v.cpu(), window=10)
    assert flash_sdpa_window.launches == before + 1


SMALL = dict(n_q=4, codebook_size=64, codebook_dim=32, hidden=128, n_layers=2,
             n_heads=2, head_dim=64, intermediate=256, window=40)


@pytest.fixture(scope="module")
def small_gguf(tmp_path_factory):
    from codec_tpu_torch.models.mimi import MimiConfig
    from codec_tpu_torch.models.mimi_init import write_random_mimi_gguf

    path = tmp_path_factory.mktemp("mimi") / "small.gguf"
    write_random_mimi_gguf(path, seed=2, cfg=MimiConfig(**SMALL), num_filters=8)
    return path


def test_decode_on_card_uses_kernel_and_matches_cpu(dev, small_gguf):
    """One launch per layer; the card's decode agrees with the port on the
    CPU (which the CPU tests hold against codec_tpu) at the f32 bound of
    tests/test_torch_mimi.py."""
    import codec_tpu_torch

    gpu = codec_tpu_torch.load_model(small_gguf, device="cuda")
    cpu = codec_tpu_torch.load_model(small_gguf, device="cpu")
    codes = np.random.default_rng(3).integers(0, 64, (2, 60, 4)).astype(np.int32)
    before = flash_sdpa_window.launches
    got = gpu.decode(codes)
    assert flash_sdpa_window.launches == before + SMALL["n_layers"]
    want = cpu.decode(codes)
    assert got.shape == want.shape == (2, 60 * 1920)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99999, corr
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_cli_decode_on_card(dev, small_gguf, tmp_path):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav

    np.save(tmp_path / "c.npy",
            np.random.default_rng(4).integers(0, 64, (25, 4)).astype(np.int32))
    assert main(["decode", "--model", str(small_gguf), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(tmp_path / "o.wav")]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 24000 and x.shape == (25 * 1920, 1)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "layout", "window"])
def test_kernel_rejects_what_it_does_not_take(dev, case):
    q, k, v = _qkv((1, 2, 64, 64), torch.float32, dev)
    kw = {"window": 16}
    if case == "head_dim":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "layout":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)   # T == D here
    else:
        kw = {"window": 0}
    with pytest.raises(ValueError):
        flash_sdpa_window(q, k, v, **kw)
