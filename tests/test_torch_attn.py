"""The flash attention wrapper of the port on the CPU: its plain version and
its CPU dispatch against codec_tpu's Pallas kernel in interpret mode, at
the shapes and bounds of tests/test_attn_pallas.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.ops.attn_pallas import flash_sdpa_window as jflash
from codec_tpu_torch.ops import attn_cuda
from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                           flash_sdpa_window_ref)
from tf32_split import flash_split


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,t,d,w", [
    (1, 2, 64, 32, None),     # pure causal, unaligned T
    (2, 4, 300, 64, 50),      # window < T, unaligned
    (1, 8, 130, 64, 250),     # window > T (degenerates to causal)
    (1, 2, 256, 128, 16),     # tiny window, aligned
])
def test_plain_and_cpu_dispatch_match_pallas(b, h, t, d, w):
    q, k, v = _qkv(np.random.default_rng(0), (b, h, t, d))
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), window=w,
                             interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = flash_sdpa_window_ref(tq, tk, tv, window=w)
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5, rtol=1e-5)
    launches = flash_sdpa_window.launches
    got = flash_sdpa_window(tq, tk, tv, window=w)
    assert torch.equal(got, ref)                # CPU runs the plain version
    assert flash_sdpa_window.launches == launches   # and launches nothing


# the kernel's products (tests/tf32_split.py: split f32 for QK^T and PV)
# on the shapes above, and T 1, T below one 16-query tile, window 1
@pytest.mark.parametrize("b,h,t,d,w", [
    (1, 2, 64, 32, None),
    (2, 4, 300, 64, 50),
    (1, 8, 130, 64, 250),
    (1, 2, 256, 128, 16),
    (1, 1, 1, 64, 1),
    (1, 2, 9, 64, None),
    (1, 2, 40, 64, 1),
])
def test_split_products_match_pallas(b, h, t, d, w):
    q, k, v = _qkv(np.random.default_rng(0), (b, h, t, d))
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), window=w,
                             interpret=True))
    got = flash_split(*(torch.from_numpy(a) for a in (q, k, v)), window=w)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_bf16_split_products_match_pallas():
    """bf16: exact QK^T products, P = P_hi + P_lo in bf16 against exact V."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, (1, 2, 200, 64))
    want = np.asarray(jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                             window=40, interpret=True), dtype=np.float32)
    got = flash_split(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in (q, k, v)), window=40)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    b, h, t, d, w = 1, 2, 200, 64, 40
    q, k, v = _qkv(rng, (b, h, t, d))
    want = np.asarray(jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                             window=w, interpret=True), dtype=np.float32)
    got = flash_sdpa_window(*(torch.from_numpy(a).to(torch.bfloat16)
                              for a in (q, k, v)), window=w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_explicit_scale_matches_pallas():
    q, k, v = _qkv(np.random.default_rng(2), (1, 2, 70, 64))
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3,
                             window=9, interpret=True))
    got = flash_sdpa_window(*(torch.from_numpy(a) for a in (q, k, v)),
                            scale=0.3, window=9)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_import_builds_nothing_and_needs_no_nvcc():
    """The module imports where there is no nvcc and no GPU; the kernel is
    built only by its first CUDA launch."""
    from codec_tpu_torch.kernels import build
    from codec_tpu_torch.ops import qmat_cuda, rvq_cuda

    assert build.load_library.cache_info().currsize == 0
    assert attn_cuda._kernel_fn.cache_info().currsize == 0
    assert qmat_cuda._kernel_fns.cache_info().currsize == 0
    assert rvq_cuda._lib.cache_info().currsize == 0
    assert build.sources() == [build.CSRC_DIR / name for name in (
        "flash_sdpa_window.cu", "qmat.cu", "rvq_encode.cu", "seanet_gemm.cuh",
        "seanet_res.cu", "seanet_tiles.cuh", "snac_res.cu", "tf32x3.cuh")]


def test_tile_sweep_finds_the_kernel_cfg():
    """tools/mimi_times.py --what attn_tiles rewrites the two lines of
    csrc/flash_sdpa_window.cu's Cfg that hold the block's query m-tiles and
    warps (it raises when they moved), and the kernel's pick is the sweep's
    first pair."""
    from codec_tpu_torch.kernels.build import CSRC_DIR
    from codec_tpu_torch.tools import mimi_times

    src = (CSRC_DIR / "flash_sdpa_window.cu").read_text()
    for line, patched in mimi_times._CFG_LINES:
        assert src.count(line) == 1
        assert patched.format(mt=1, warps=8) not in src
    assert mimi_times.ATTN_TILES[0] == (2, 4)
    assert "ATTN_" not in src


def test_no_device_falls_back_to_the_plain_version():
    q = torch.zeros((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_sdpa_window(q, q, q, window=2)


def test_build_dir_is_beside_a_source_tree_else_in_the_user_cache(tmp_path):
    """A checkout (a pyproject.toml beside the package) builds into its own
    build/; an installed package (site-packages) into ~/.cache."""
    from pathlib import Path

    from codec_tpu_torch.kernels import build

    assert build.BUILD_DIR == build.PACKAGE_DIR.parent / "build" / "codec_tpu_torch"
    tree = tmp_path / "checkout"
    (tree / "codec_tpu_torch").mkdir(parents=True)
    (tree / "pyproject.toml").write_text("[project]\n")
    assert build.build_dir(tree / "codec_tpu_torch") == tree / "build" / "codec_tpu_torch"
    site = tmp_path / "lib" / "python3.12" / "site-packages"
    (site / "codec_tpu_torch").mkdir(parents=True)
    assert build.build_dir(site / "codec_tpu_torch") == \
        Path.home() / ".cache" / "codec_tpu_torch"
