"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from codec_tpu_torch.ops import seanet_cuda
from codec_tpu_torch.ops.attn_cuda import (flash_sdpa_window,
                                           flash_sdpa_window_ref)

pytestmark = pytest.mark.cuda
# the kernels' dtypes: f16 takes bf16's bounds (both 16-bit operands; f16
# rounds finer)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


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
# T 1, T below one 16-query tile, ragged T, window 1, window >= T, pure
# causal, B·H 64; f32 bound as in tests/test_attn_pallas.py (atol 2e-5,
# rtol 1e-5)
ATTN_SHAPES = [
    (1, 8, 500, 64, 250),
    (1, 8, 1500, 64, 250),
    (4, 8, 500, 64, 250),
    (1, 2, 300, 64, None),
    (1, 2, 256, 128, 16),
    (2, 4, 300, 64, 50),
    (1, 8, 130, 64, 250),
    (1, 1, 1, 64, 1),
    (1, 2, 9, 64, None),
    (1, 2, 37, 64, 5),
    (1, 4, 200, 64, 1),
    (1, 2, 100, 64, 300),
    (8, 8, 100, 64, 50),
    (2, 2, 150, 128, 40),
    (1, 1, 1, 128, None),
    # Qwen3-TTS-Tokenizer's decoder at 20 s (16 heads, full causal and its
    # 72-frame window) and Pocket-Mimi's 200 Hz transformer at 20 s
    (1, 16, 250, 64, None),
    (1, 16, 250, 64, 72),
    (1, 8, 4000, 64, 250),
]


@pytest.mark.parametrize("b,h,t,d,w", ATTN_SHAPES)
def test_kernel_matches_plain_f32(dev, b, h, t, d, w):
    q, k, v = _qkv((b, h, t, d), torch.float32, dev)
    got = flash_sdpa_window(q, k, v, window=w)
    want = flash_sdpa_window_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,d,w", [(1, 8, 500, 128, 250)] + ATTN_SHAPES)
def test_kernel_matches_plain_bf16(dev, b, h, t, d, w):
    q, k, v = _qkv((b, h, t, d), torch.bfloat16, dev, seed=1)
    got = flash_sdpa_window(q, k, v, window=w)
    want = flash_sdpa_window_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # bound as in tests/test_attn_pallas.py::test_flash_bf16
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("b,h,t,d,w", [(1, 8, 500, 128, 250)] + ATTN_SHAPES)
def test_kernel_matches_plain_f16(dev, b, h, t, d, w):
    q, k, v = _qkv((b, h, t, d), torch.float16, dev, seed=1)
    got = flash_sdpa_window(q, k, v, window=w)
    want = flash_sdpa_window_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and got.shape == want.shape
    # bf16's bound
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_two_launches_are_bit_identical(dev, dtype, d):
    """No atomics and a fixed merge order: the same inputs give the same
    bits."""
    q, k, v = _qkv((2, 4, 333, d), dtype, dev, seed=2)
    a = flash_sdpa_window(q, k, v, window=100)
    b = flash_sdpa_window(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_takes_views_off_16_byte_words(dev):
    """A view that starts off a 16-byte word is copied, not refused."""
    q, k, v = _qkv((1, 2, 65, 64), torch.float32, dev, seed=3)
    flat = torch.empty(q.numel() + 1, device=dev)
    flat[1:] = q.reshape(-1)
    qv = flat[1:].view(q.shape)
    assert qv.data_ptr() % 16 and qv.is_contiguous()
    got = flash_sdpa_window(qv, k, v, window=20)
    torch.testing.assert_close(got, flash_sdpa_window(q, k, v, window=20),
                               atol=0, rtol=0)


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


@pytest.mark.parametrize("case", ["head_dim", "dtype", "layout", "window",
                                  "rows"])
def test_kernel_rejects_what_it_does_not_take(dev, case):
    q, k, v = _qkv((1, 2, 64, 64), torch.float32, dev)
    kw = {"window": 16}
    if case == "rows":           # B*H past the grid's y dimension (65 535)
        q = k = v = torch.zeros((2, 32768, 1, 64), device=dev)
    elif case == "head_dim":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif case == "dtype":
        q, k, v = (x.double() for x in (q, k, v))
    elif case == "layout":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)   # T == D here
    else:
        kw = {"window": 0}
    with pytest.raises(ValueError):
        flash_sdpa_window(q, k, v, **kw)


# -- the fused SEANet res-unit kernels (DAC) ---------------------------------

DILS = (1, 3, 9)


def _res_params(n, c, dtype, dev, seed=0, k=7):
    """n units' weights as chip_smoke.py draws them: convs at fan-in
    scale, biases N(0, 0.1), alphas |N(0, 1)| + 1."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    return dict(w1s=t(rng.standard_normal((n, k, c, c)) / np.sqrt(k * c)),
                b1s=t(rng.standard_normal((n, c)) * 0.1),
                a1s=t(np.abs(rng.standard_normal((n, c))) + 1.0),
                a2s=t(np.abs(rng.standard_normal((n, c))) + 1.0),
                w2s=t(rng.standard_normal((n, c, c)) / np.sqrt(c)),
                b2s=t(rng.standard_normal((n, c)) * 0.1))


def _x(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, dtype)


def _unit_args(p):
    return (p["a1s"][0], p["w1s"][0], p["b1s"][0], p["a2s"][0], p["w2s"][0],
            p["b2s"][0])


def _check_against_plain(got, x, p, dtype, fn_ref):
    """f32: max abs err <= 1e-4 * peak and corr > 0.99999; bf16 (against
    the plain version in f32 on the same bf16 inputs): the bounds of
    tests/test_seanet_pallas.py (unit rtol 2e-2 / atol 5e-2 / corr 0.9999,
    chain rtol 3e-2 / atol 8e-2 / corr 0.9995)."""
    from codec_tpu_torch.runtime.model import f32_precision

    with f32_precision(True):
        want = fn_ref(x.float(), {k: v.float() for k, v in p.items()})
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    g, w = got.float().cpu().numpy(), want.cpu().numpy()
    corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
    if dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert corr > 0.99999, corr
    elif fn_ref is _unit_ref:
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=5e-2)
        assert corr > 0.9999, corr
    else:
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=8e-2)
        assert corr > 0.9995, corr


def _unit_ref(x, p, d=1):
    return seanet_cuda.seanet_res_unit_ref(x, *_unit_args(p), dilation=d)


def _chain_ref(x, p):
    return seanet_cuda.seanet_res_chain_ref(x, **p, dilations=DILS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,c,d", [
    (1, 20, 96, 9),        # T below the halo
    (2, 100, 16, 3),       # B = 2, a ragged last tile
    (1, 200, 8, 1),
    (1, 333, 384, 9),      # two column passes
    (1, 64, 768, 1),       # three column passes
    (1, 37, 40, 3),        # C no multiple of 32
    (1, 45, 20, 9),        # C no multiple of 8: bf16 weights padded to 24
    (2, 50, 6, 3),         # C no multiple of 4: so are f32 weights
    (1, 300, 192, 1),      # T no multiple of the row tile (128 / 256 rows)
    (2, 1000, 64, 9),      # B = 2: every block and TMA box in one batch row
    (1, 500, 96, 3),       # C96 and C64: no multiple of a 64-wide chunk
    (1, 700, 64, 1),
    # T long enough for the larger tiles (unit_tile), T no multiple of them:
    (1, 30001, 96, 9),     # f32 128 x 128, bf16 256 x 128 (a ragged pass)
    (1, 40001, 192, 3),    # f32 256 x 64, bf16 128 x 192
    (1, 9001, 384, 1),     # f32 128 x 128, bf16 256 x 128: three passes
])
def test_res_unit_kernel_matches_plain(dev, dtype, b, t, c, d):
    """Also: a second launch on the same inputs gives the same bits."""
    p = _res_params(1, c, dtype, dev, seed=b * t + c)
    x = _x((b, t, c), dtype, dev, seed=2)
    got = seanet_cuda.seanet_res_unit(x, *_unit_args(p), dilation=d)
    _check_against_plain(got, x, p, dtype, lambda x, p: _unit_ref(x, p, d))
    again = seanet_cuda.seanet_res_unit(x, *_unit_args(p), dilation=d)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,c", [
    (1, 20, 192),          # T far below the chain's halo of 39
    (2, 100, 96),
    (1, 700, 192),         # several tiles of 128 rows
    (1, 1000, 8),
    (1, 77, 40),
    (1, 90, 6),
    (2, 1500, 64),         # C64, B = 2, a ragged last tile
    (1, 20, 96),           # T below the halo at C96
])
def test_res_chain_kernel_matches_plain(dev, dtype, b, t, c):
    """Also: a second launch on the same inputs gives the same bits."""
    p = _res_params(3, c, dtype, dev, seed=t + c)
    x = _x((b, t, c), dtype, dev, seed=3)
    got = seanet_cuda.seanet_res_chain(x, **p, dilations=DILS)
    _check_against_plain(got, x, p, dtype, _chain_ref)
    assert torch.equal(got, seanet_cuda.seanet_res_chain(x, **p, dilations=DILS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res_geometry_matches_the_kernels(dev, dtype):
    """The wrappers' shared-memory sums (ops/seanet_cuda.py: the gate, the
    tile and the chain plan read them) equal the kernels' own layouts
    (codec_seanet_smem_bytes) for every tile at the DAC widths."""
    lib = seanet_cuda._lib()
    code = seanet_cuda._DTYPE_CODES[dtype]
    for c in (768, 384, 192, 96, 64, 40):
        for tile in seanet_cuda._UNIT_TILES[dtype]:
            for d in (1, 9):
                assert seanet_cuda.unit_smem_bytes(c, 7, d, dtype, tile) == \
                    lib.codec_seanet_smem_bytes(0, c, 3 * d, 0, 0, *tile, code)
            assert seanet_cuda.unit_smem_bytes(c, 7, 1, dtype, tile, True) == \
                lib.codec_seanet_smem_bytes(1, c, 0, 0, 0, *tile, code)
        rows = seanet_cuda.chain_tile(c, 7, DILS, dtype,
                                      seanet_cuda.smem_per_block(0))
        block = seanet_cuda.chain_block(c, dtype)
        if rows:
            assert seanet_cuda.chain_smem_bytes(c, 7, DILS, rows, dtype, block) \
                == lib.codec_seanet_smem_bytes(2, c, 27, 39, rows, *block, code)


def test_res_counters_count_kernel_launches_only(dev):
    p = _res_params(3, 96, torch.float32, dev)
    x = torch.randn(1, 50, 96, device=dev)
    cpu = {k: v.cpu() for k, v in p.items()}
    unit0, chain0 = (seanet_cuda.seanet_res_unit.launches,
                     seanet_cuda.seanet_res_chain.launches)
    seanet_cuda.seanet_res_unit(x, *_unit_args(p))
    seanet_cuda.seanet_res_unit(x.cpu(), *_unit_args(cpu))
    seanet_cuda.seanet_res_chain(x, **p)
    seanet_cuda.seanet_res_chain(x.cpu(), **cpu)
    seanet_cuda.seanet_res_units(x.cpu(), **cpu)
    assert seanet_cuda.seanet_res_unit.launches == unit0 + 1
    assert seanet_cuda.seanet_res_chain.launches == chain0 + 1


@pytest.mark.parametrize("case", ["even_k", "no_bias", "dtype", "layout",
                                  "conv2_k3"])
def test_res_kernels_reject_what_they_do_not_take(dev, case):
    p = _res_params(3, 32, torch.float32, dev)
    x = torch.randn(1, 64, 32, device=dev)
    if case == "even_k":
        p["w1s"] = p["w1s"][:, :6].contiguous()
    elif case == "no_bias":
        p["b1s"] = None
    elif case == "dtype":
        x = x.double()
        p = {k: v.double() for k, v in p.items()}
    elif case == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        p["w2s"] = torch.randn(3, 3, 32, 32, device=dev)
    with pytest.raises(ValueError):
        seanet_cuda.seanet_res_chain(x, **p)
    unit = [None if p[k] is None else p[k][0]
            for k in ("a1s", "w1s", "b1s", "a2s", "w2s", "b2s")]
    with pytest.raises(ValueError):
        seanet_cuda.seanet_res_unit(x, *unit)


@pytest.fixture(scope="module")
def small_dac_gguf(tmp_path_factory):
    from codec_tpu_torch.models.dac import DacConfig
    from codec_tpu_torch.models.dac_init import write_random_dac_gguf

    path = tmp_path_factory.mktemp("dac") / "small.gguf"
    write_random_dac_gguf(path, seed=3, decoder_dim=768, cfg=DacConfig(
        n_q=4, codebook_size=64, codebook_dim=8, latent_dim=128))
    return path


def test_dac_decode_on_card_uses_kernels_and_matches_cpu(dev, small_dac_gguf):
    """Decoder widths 384/192/96/48: the launches follow the gate at an
    H100's shared memory (f32: three unit launches per block; bf16: the
    chain at C48, where 512 rows of its state fit), so the decodes run both
    kernels; the card's f32 decode agrees with the port on the CPU at the
    f32 bound of tests/test_torch_dac.py."""
    import codec_tpu_torch

    cpu = codec_tpu_torch.load_model(small_dac_gguf, device="cpu")
    limit = seanet_cuda.smem_per_block(0)
    codes = np.random.default_rng(5).integers(0, 64, (2, 30, 4)).astype(np.int32)
    ran = 0
    for dtype in (torch.bfloat16, torch.float32):
        gpu = codec_tpu_torch.load_model(small_dac_gguf, device="cuda",
                                         compute_dtype=str(dtype)[6:])
        chains = sum(seanet_cuda.use_chain(c, 7, DILS, dtype, limit)
                     for c in (384, 192, 96, 48))
        ran += chains
        unit0, chain0 = (seanet_cuda.seanet_res_unit.launches,
                         seanet_cuda.seanet_res_chain.launches)
        got = gpu.decode(codes)
        assert seanet_cuda.seanet_res_chain.launches == chain0 + chains
        assert seanet_cuda.seanet_res_unit.launches == unit0 + 3 * (4 - chains)
    assert ran > 0
    want = cpu.decode(codes)
    assert got.shape == want.shape == (2, 320 * 30 - 8)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99999, corr
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the fused depthwise res-unit kernel (SNAC) ---------------------------------

def _dw_params(n, c, dtype, dev, seed=0, k=7):
    """n depthwise units' weights as chip_smoke.py draws them (the scales
    of tests/test_seanet_pallas.py's depthwise test, the 1x1 at that
    test's gain for any C), alphas N(1, 0.5) with every fourth channel's
    sign flipped, so some are negative at any C."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def alpha():
        a = 1.0 + 0.5 * rng.standard_normal((n, c))
        a[:, ::4] *= -1
        return t(a)

    return dict(w1s=t(rng.standard_normal((n, k, c)) * 0.2),
                b1s=t(rng.standard_normal((n, c)) * 0.1),
                a1s=alpha(), a2s=alpha(),
                w2s=t(rng.standard_normal((n, c, c)) * 0.1 * np.sqrt(128 / c)),
                b2s=t(rng.standard_normal((n, c)) * 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,dils", [
    (1, 20, 64, DILS),       # T below the chain's halo of 39
    (1, 1, 64, DILS),
    (2, 1000, 128, DILS),    # B = 2, a ragged last tile
    (1, 700, 64, DILS),      # two tiles of 512 rows
    (1, 77, 40, DILS),       # C no multiple of 32
    (2, 50, 6, DILS),        # C no multiple of 8 or 4: weights load unvectorized
    (1, 333, 512, (9,)),     # the unit kernel (N = 1) at SNAC's widest block
    (1, 4100, 256, (1,)),
    (2, 45, 20, (3,)),
])
def test_dw_chain_kernel_matches_plain(dev, dtype, b, t, c, dils):
    """f32: max abs err <= 1e-4 * peak and corr > 0.99999; bf16 (against
    the plain version in f32 on the same bf16 inputs): rtol 3e-2 / atol
    8e-2 / corr 0.9995, the bounds of tests/test_seanet_pallas.py."""
    from codec_tpu_torch.runtime.model import f32_precision

    p = _dw_params(len(dils), c, dtype, dev, seed=b * t + c)
    x = _x((b, t, c), dtype, dev, seed=4) * 0.3
    got = seanet_cuda.snac_res_chain(x, **p, dilations=dils)
    with f32_precision(True):
        want = seanet_cuda.snac_res_chain_ref(
            x.float(), **{k: v.float() for k, v in p.items()}, dilations=dils)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    g, w = got.float().cpu().numpy(), want.cpu().numpy()
    corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
    if dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert corr > 0.99999, corr
    else:
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=8e-2)
        assert corr > 0.9995, corr


def _hold_dw(got, want, dtype, rtol, atol, corr_min):
    torch.cuda.synchronize()
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all()
    corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
    if dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert corr > 0.99999, corr
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        assert corr > corr_min, corr


# every SNAC block width (decoder C512-C64, encoder C48-C384) at a short T,
# T no multiple of the pass's rows, B = 2, T below the halo and T = 1, C no
# multiple of 8 or of 4; every fourth alpha negative (_dw_params)
SNAC_UNIT_SHAPES = [
    (1, 1000, 48, 1), (1, 777, 96, 3), (2, 300, 192, 9), (1, 500, 384, 9),
    (1, 2000, 512, 1), (1, 333, 256, 3), (2, 1001, 128, 9), (1, 700, 64, 3),
    (1, 20, 64, 9),        # T below the halo of 27
    (1, 1, 48, 3),         # T = 1
    (2, 45, 20, 3),        # C no multiple of 8: bf16 weights padded to 24
    (2, 50, 6, 9),         # C no multiple of 4: x loaded element by element
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,c,d", SNAC_UNIT_SHAPES)
def test_dw_pass_matches_plain(dev, dtype, b, t, c, d):
    """The depthwise pass alone (x → the snaked hidden S) against
    snac_dw_ref in f32 on the same inputs: f32 at the units' bound; bf16 S
    is rounded to nearest even once, so within 2^-8 relative (twice the
    rounding) and 1e-4 absolute (the kernel's sin^2 series). Pad channels
    of S are zero. Two launches give the same bits."""
    from codec_tpu_torch.runtime.model import f32_precision

    p = _dw_params(1, c, dtype, dev, seed=b * t + c)
    x = _x((b, t, c), dtype, dev, seed=7) * 0.3
    vec = seanet_cuda.unit_vec(p["a1s"], p["b1s"], p["a2s"], p["b2s"])
    got = seanet_cuda._launch_snac_dw(x, p["w1s"][0], vec, d)
    cw = got.shape[-1]
    assert got.dtype == dtype and got.shape == (b, t, cw) and cw >= c
    assert not got[..., c:].any()
    with f32_precision(True):
        want = seanet_cuda.snac_dw_ref(
            x.float(), p["w1s"][0].float(), p["b1s"][0].float(),
            p["a1s"][0].float(), p["a2s"][0].float(), d)
    _hold_dw(got[..., :c], want, dtype, 2 ** -8, 1e-4, 0.99999)
    assert torch.equal(got, seanet_cuda._launch_snac_dw(x, p["w1s"][0], vec, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_dw_pass_at_other_tap_counts(dev, dtype, k):
    """The depthwise pass compiled for K = 1, 3 and 5 taps (SNAC's is 7),
    held as in test_dw_pass_matches_plain."""
    from codec_tpu_torch.runtime.model import f32_precision

    c, d = 64, 3
    p = _dw_params(1, c, dtype, dev, seed=k, k=k)
    x = _x((2, 300, c), dtype, dev, seed=9) * 0.3
    vec = seanet_cuda.unit_vec(p["a1s"], p["b1s"], p["a2s"], p["b2s"])
    got = seanet_cuda._launch_snac_dw(x, p["w1s"][0], vec, d)
    with f32_precision(True):
        want = seanet_cuda.snac_dw_ref(
            x.float(), p["w1s"][0].float(), p["b1s"][0].float(),
            p["a1s"][0].float(), p["a2s"][0].float(), d)
    _hold_dw(got, want, dtype, 2 ** -8, 1e-4, 0.99999)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,c,d", SNAC_UNIT_SHAPES + [
    (1, 30001, 64, 9),     # T long enough for the larger 1x1 tiles
    (1, 20001, 128, 1),
    (4, 2000, 512, 3),     # B = 4 at the widest block
])
def test_snac_unit_kernel_matches_plain(dev, dtype, b, t, c, d):
    """One unit (N = 1: the depthwise pass, then the 1x1 at snac_tile's
    tile) against the plain unit at the bounds of
    test_dw_chain_kernel_matches_plain; two launches give the same bits;
    one launch counted per call."""
    from codec_tpu_torch.runtime.model import f32_precision

    p = _dw_params(1, c, dtype, dev, seed=b * t + c + 1)
    x = _x((b, t, c), dtype, dev, seed=8) * 0.3
    before = seanet_cuda.snac_res_chain.launches
    got = seanet_cuda.snac_res_chain(x, **p, dilations=(d,))
    assert seanet_cuda.snac_res_chain.launches == before + 1
    with f32_precision(True):
        want = seanet_cuda.snac_res_chain_ref(
            x.float(), **{k: v.float() for k, v in p.items()}, dilations=(d,))
    assert got.dtype == dtype and got.shape == x.shape
    _hold_dw(got, want, dtype, 3e-2, 8e-2, 0.9995)
    vec = seanet_cuda.unit_vec(p["a1s"], p["b1s"], p["a2s"], p["b2s"])
    assert torch.equal(got, seanet_cuda.snac_res_chain(x, **p, dilations=(d,),
                                                       vec=vec))


@pytest.mark.parametrize("c,t", [(256, 59904), (128, 239616)])
def test_plain_f16_unit_at_the_decoder_blocks(dev, c, t):
    """The plain f16 unit at SNAC decoder blocks: cuDNN's f16 depthwise
    conv faults at C256 T59904 (tools/f16_probe.py), so snac_dw_ref takes
    PyTorch's own kernel for f16 on the card. It finishes, leaves cuDNN on
    for what follows, and agrees with the plain f32 unit on the same
    inputs at the 16-bit bounds."""
    from codec_tpu_torch.runtime.model import f32_precision

    p = _dw_params(1, c, torch.float16, dev, seed=c)
    x = _x((1, t, c), torch.float16, dev, seed=9) * 0.3
    got = seanet_cuda.snac_res_chain_ref(x, **p, dilations=(1,))
    torch.cuda.synchronize()
    assert torch.backends.cudnn.enabled
    with f32_precision(True):
        want = seanet_cuda.snac_res_chain_ref(
            x.float(), **{k: v.float() for k, v in p.items()}, dilations=(1,))
    assert got.dtype == torch.float16
    _hold_dw(got, want, torch.float16, 3e-2, 8e-2, 0.9995)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snac_geometry_matches_the_kernels(dev, dtype):
    """The wrapper's shared-memory sums for the SNAC unit equal the
    kernels' own (the depthwise pass's and the 1x1's layouts)."""
    lib = seanet_cuda._lib()
    code = seanet_cuda._DTYPE_CODES[dtype]
    for d in (1, 3, 9, 27):
        assert seanet_cuda.dw_smem_bytes(7, d, dtype) == \
            lib.codec_snac_dw_smem_bytes(7, d, seanet_cuda.dw_rows(d), code)
    for tile in seanet_cuda._SNAC_TILES[dtype]:
        assert seanet_cuda.unit_smem_bytes(64, 7, 1, dtype, tile, True, 2) == \
            lib.codec_seanet_smem_bytes(3, 64, 0, 0, 0, *tile, code)


def test_dw_counter_counts_kernel_launches_only(dev):
    p = _dw_params(3, 64, torch.float32, dev)
    x = torch.randn(1, 50, 64, device=dev)
    cpu = {k: v.cpu() for k, v in p.items()}
    before = seanet_cuda.snac_res_chain.launches
    seanet_cuda.snac_res_chain(x, **p)
    seanet_cuda.snac_res_chain(x.cpu(), **cpu)
    seanet_cuda.snac_res_units(x.cpu(), **cpu)
    assert seanet_cuda.snac_res_chain.launches == before + 1
    seanet_cuda.snac_res_units(x, **p)              # three N = 1 launches
    assert seanet_cuda.snac_res_chain.launches == before + 4


@pytest.mark.parametrize("case", ["dense_taps", "no_bias", "dtype", "layout",
                                  "wide_chain"])
def test_dw_kernel_rejects_what_it_does_not_take(dev, case):
    c = 512 if case == "wide_chain" else 32
    p = _dw_params(3, c, torch.float32, dev)
    x = torch.randn(1, 64, c, device=dev)
    if case == "dense_taps":
        p["w1s"] = torch.randn(3, 7, c, c, device=dev)
    elif case == "no_bias":
        p["b2s"] = None
    elif case == "dtype":
        x = x.double()
        p = {k: v.double() for k, v in p.items()}
    elif case == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        seanet_cuda.snac_res_chain(x, **p)


@pytest.fixture(scope="module")
def small_snac_gguf(tmp_path_factory):
    from codec_tpu_torch.models.snac import SnacConfig
    from codec_tpu_torch.models.snac_init import write_random_snac_gguf

    path = tmp_path_factory.mktemp("snac") / "small.gguf"
    write_random_snac_gguf(path, seed=3, decoder_dim=512, cfg=SnacConfig(
        latent_dim=128, codebook_size=64, codebook_dim=8))
    return path


def test_snac_decode_on_card_uses_kernel_and_matches_cpu(dev, small_snac_gguf):
    """Decoder widths 256/128/64/32: every block's three units run
    through snac_res_chain, one N = 1 launch each, in both dtypes; the
    card's f32 decode agrees with the port on the CPU at the f32 bound of
    tests/test_torch_snac.py."""
    import codec_tpu_torch

    cpu = codec_tpu_torch.load_model(small_snac_gguf, device="cpu")
    codes = np.random.default_rng(6).integers(0, 64, (2, 16, 3)).astype(np.int32)
    for dtype in ("bfloat16", "float32"):
        gpu = codec_tpu_torch.load_model(small_snac_gguf, device="cuda",
                                         compute_dtype=dtype)
        before = seanet_cuda.snac_res_chain.launches
        got = gpu.decode(codes)
        assert seanet_cuda.snac_res_chain.launches == before + 4 * 3
    want = cpu.decode(codes)
    assert got.shape == want.shape == (2, 16 * 512)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99999, corr
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the dequantizing products over packed Q8_0 / Q4_K weights ----------------

def _packed(qtype, out_d, in_d, dev, seed=0):
    from codec_tpu_torch.io.gguf import quantize_q4_k, quantize_q8_0
    from codec_tpu_torch.ops import qmat

    w = np.random.default_rng(seed).standard_normal((out_d, in_d)).astype(
        np.float32) * 0.02
    quantize, pack = {"Q8_0": (quantize_q8_0, qmat.pack_q8_0),
                      "Q4_K": (quantize_q4_k, qmat.pack_q4_k)}[qtype]
    return qmat.to_device(pack(np.frombuffer(quantize(w), np.uint8), w.shape), dev)


def _product(qtype, x, qt):
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul

    if qtype == "Q8_0":
        return q8_0_matmul(x, qt["qs"], qt["scale"])
    return q4_k_matmul(x, qt["qs"], qt["scale"], qt["minv"])


# chip_smoke.py's bound: the same dequantized weights in f32, sums in
# another order: max abs err <= 1e-4 * max|plain|. Shapes: small ones, the
# backbone's k/v (512 x 2048, a cluster of 8 K slices) and down (2048 x
# 8192), and a Q8_0 width with in % 128 != 0 (the cp.async form)
QMAT_CASES = [(q, o, i) for q in ("Q8_0", "Q4_K")
              for o, i in [(96, 512), (520, 256), (64, 2048), (512, 2048),
                           (2048, 8192), (96, 160)]
              if q == "Q8_0" or i % 256 == 0]


@pytest.mark.parametrize("qtype,out_d,in_d", QMAT_CASES)
@pytest.mark.parametrize("m", [1, 2, 16, 17, 32])
def test_qmat_kernel_matches_plain(dev, qtype, out_d, in_d, m):
    """Also: two launches give bit-identical outputs (the split-K sums
    meet in a fixed order)."""
    from codec_tpu_torch.ops import qmat

    qt = _packed(qtype, out_d, in_d, dev)
    x = _x((m, in_d), torch.float32, dev, seed=m)
    got = _product(qtype, x, qt)
    want = x @ qmat.dequant_ref(qt).T
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, out_d)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(_product(qtype, x, qt), got)


@pytest.mark.parametrize("qtype,out_d,in_d",
                         [("Q8_0", 128, 512), ("Q4_K", 128, 512)]
                         + [c for c in QMAT_CASES if c[1] in (512, 2048, 96)
                            and c[2] != 512])
def test_qmat_kernel_bf16_x(dev, qtype, out_d, in_d):
    from codec_tpu_torch.ops import qmat

    qt = _packed(qtype, out_d, in_d, dev, seed=1)
    x = _x((1, in_d), torch.bfloat16, dev, seed=2)
    got = _product(qtype, x, qt)
    want = x.float() @ qmat.dequant_ref(qt).T
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype,out_d,in_d",
                         [("Q8_0", 200, 1024), ("Q4_K", 200, 1024)] + QMAT_CASES)
def test_qmat_kernel_one_hot_rows_give_dequantized_weights(dev, qtype, dtype,
                                                          out_d, in_d):
    from codec_tpu_torch.ops import qmat

    qt = _packed(qtype, out_d, in_d, dev, seed=3)
    cols = torch.from_numpy(np.random.default_rng(4).choice(in_d, 32, replace=False)).to(dev)
    x = torch.zeros((32, in_d), dtype=dtype, device=dev)
    x[torch.arange(32, device=dev), cols] = 1
    assert torch.equal(_product(qtype, x, qt), qmat.dequant_ref(qt)[:, cols].T)


def test_qmat_counters_and_dispatch(dev):
    """qmatmul launches a kernel for m <= 32 and goes to dequant + matmul
    above; CPU tensors never count."""
    from codec_tpu_torch.ops import qmat
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul

    qt = _packed("Q4_K", 64, 256, dev)
    before = (q8_0_matmul.launches, q4_k_matmul.launches)
    for m in (1, 32, 33):
        x = _x((m, 256), torch.float32, dev, seed=m)
        got = qmat.qmatmul(x, qt)
        torch.testing.assert_close(got, x @ qmat.dequant_ref(qt).T,
                                   rtol=1e-5, atol=1e-5)
    qmat.qmatmul(torch.zeros((2, 256)), {k: v.cpu() for k, v in qt.items()})
    assert (q8_0_matmul.launches, q4_k_matmul.launches) == (before[0], before[1] + 2)


@pytest.mark.parametrize("case", ["layout", "rows", "width", "qs_dtype", "x_dtype"])
def test_qmat_kernels_reject_what_they_do_not_take(dev, case):
    qtype = "Q4_K"
    qt = _packed(qtype, 64, 512, dev)
    x = _x((4, 512), torch.float32, dev, seed=0)
    if case == "layout":
        x = _x((512, 4), torch.float32, dev, seed=0).T
    elif case == "rows":
        x = _x((33, 512), torch.float32, dev, seed=0)
    elif case == "width":
        qt, qtype = _packed("Q8_0", 64, 288, dev), "Q4_K"
        qt = {"qs": qt["qs"].view(torch.uint8)[:, :144].contiguous(),
              "scale": qt["scale"], "minv": qt["scale"]}
        x = _x((1, 288), torch.float32, dev, seed=0)
    elif case == "qs_dtype":
        qt = dict(qt, qs=qt["qs"].view(torch.int8))
    else:
        x = x.half()
    with pytest.raises(ValueError):
        _product(qtype, x, qt)


def test_backbone_on_card_uses_kernels_and_matches_cpu(dev, tmp_path):
    """A packed Q4_K backbone on the card: 7 launches per layer per step,
    hiddens equal to the port on the CPU within 1e-4 (f32, sums in
    another order)."""
    import dataclasses

    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B,
                                                write_random_backbone_gguf)
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul

    cfg = dataclasses.replace(LLAMA_3_2_1B, hidden=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, head_dim=64, ffn_dim=512,
                              vocab_size=300, max_ctx=64)
    path = write_random_backbone_gguf(tmp_path / "bb.gguf", seed=5, cfg=cfg)
    gpu = LlamaBackbone(path, quantized=True, device="cuda")
    cpu = LlamaBackbone(path, quantized=True, device="cpu")
    x = _x((6, 256), torch.float32, "cpu", seed=6).numpy()
    before = q4_k_matmul.launches
    np.testing.assert_allclose(gpu.prefill(x, bucket=8), cpu.prefill(x, bucket=8),
                               rtol=1e-4, atol=1e-4)
    for i in range(3):
        np.testing.assert_allclose(gpu.step(x[i]), cpu.step(x[i]),
                                   rtol=1e-4, atol=1e-4)
    assert q4_k_matmul.launches == before + 7 * 2 * 4


def test_tts_cli_synthesize_on_card(dev, tmp_path):
    import dataclasses

    from codec_tpu_torch.cli.tts_cli import main
    from codec_tpu_torch.io.wav import read_wav
    from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B, DepthConfig,
                                                byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf,
                                                write_random_csm_gguf)
    from codec_tpu_torch.models.mimi import MimiConfig

    model = write_random_csm_gguf(
        tmp_path / "csm.gguf", seed=1, num_filters=8,
        mimi_cfg=MimiConfig(n_q=4, codebook_size=64, codebook_dim=32,
                            hidden=64, n_layers=1, n_heads=1, head_dim=64,
                            intermediate=128, window=40),
        dcfg=DepthConfig(hidden=256, depth_hidden=64, layers=1, heads=2,
                         kv_heads=1, head_dim=32, ffn=128, n_codebook=4,
                         vocab=64))
    bb = write_random_backbone_gguf(
        tmp_path / "bb.gguf", seed=2, spm_b64=spm_model_b64(byte_fallback_vocab()),
        cfg=dataclasses.replace(LLAMA_3_2_1B, hidden=256, n_layers=2, n_heads=4,
                                n_kv_heads=2, head_dim=64, ffn_dim=512,
                                vocab_size=300, max_ctx=96))
    out = tmp_path / "o.wav"
    assert main(["synthesize", "--model", str(model), "--backbone", str(bb),
                 "--text", "hello there", "--out", str(out), "--max-frames",
                 "3", "--quant-exec"]) == 0
    pcm, sr = read_wav(out)
    assert sr == 24000 and pcm.shape == (3 * 1920, 1)


# -- the fused RVQ search, the encoder widths of the res-unit kernels, and
# -- encode on the card ---------------------------------------------------------

def _rvq_inputs(b, t, d, n_q, v, dev, kind, seed=0):
    """x [b, t, d], codebooks [n_q, v, d] f32. "int": small integers, so
    every product and sum is exact in f32 and ties are many; "dup": the
    same with every row v + v/2 a copy of row v; "normal": N(0, 1) frames
    and N(0, 0.5) codebooks; "tiny": normal frames near 0 (the norms
    decide)."""
    rng = np.random.default_rng(seed)
    if kind in ("int", "dup"):
        x = rng.integers(-3, 4, (b, t, d))
        cb = rng.integers(-3, 4, (n_q, v, d))
        if kind == "dup":
            cb[:, v // 2: 2 * (v // 2)] = cb[:, : v // 2]
    else:
        x = rng.standard_normal((b, t, d)) * (1e-3 if kind == "tiny" else 1.0)
        cb = rng.standard_normal((n_q, v, d)) * 0.5
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(cb.astype(np.float32)).to(dev))


# the Mimi shapes (20 s b1 acoustic and semantic, b4), the unaligned
# shapes of tests/test_rvq_pallas.py, D no multiple of 4 (padded by the
# wrapper), V above 8 x 256 (several row tiles per block); N 1, N no
# multiple of the frame group, V below the cluster size, D 32, D 96, D no
# multiple of 8; D 512 and 2560 (8 frames a cluster, the winners' rows
# read from L2); the iSTFT-head codecs' 20 s b1 searches: WavTokenizer (one
# 4096 x 512 codebook, two 256-row tiles a block) and XY-Tokenizer (8 x 1024
# x 512)
RVQ_SHAPES = [(1, 250, 256, 31, 2048), (1, 250, 256, 1, 2048),
              (4, 250, 256, 31, 2048), (1, 7, 32, 4, 64), (1, 130, 96, 3, 100),
              (2, 33, 30, 3, 70), (1, 40, 64, 2, 5000), (1, 1, 32, 3, 64),
              (1, 1, 256, 31, 2048), (3, 17, 96, 2, 300), (1, 50, 36, 3, 6),
              (1, 70, 20, 2, 2049), (1, 250, 512, 4, 2048),
              (1, 20, 2560, 2, 300), (1, 1500, 512, 1, 4096),
              (1, 250, 512, 8, 1024)]


@pytest.mark.parametrize("kind", ["int", "normal", "dup"])
@pytest.mark.parametrize("b,t,d,n_q,v", RVQ_SHAPES)
def test_rvq_kernel_matches_plain(dev, kind, b, t, d, n_q, v):
    """Integer-valued inputs, also with duplicated rows: bit for bit, and
    the lower copy wins. Normal inputs: equal, or each differing frame's
    first differing level an f64 near-tie."""
    from codec_tpu_torch.ops import rvq
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from encode_ties import assert_codes, euclid_margin, f64

    x, cb = _rvq_inputs(b, t, d, n_q, v, dev, kind, seed=b * t + v)
    got = rvq_encode_fused(x, cb)
    want = rvq.rvq_encode(x, cb)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (b, t, n_q)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if kind in ("int", "dup"):
        np.testing.assert_array_equal(got, want)
        assert got.max() < (v // 2 if kind == "dup" else v)
        return
    x64, cb64 = f64(x).reshape(b * t, d), f64(cb)
    g, w = got.reshape(b * t, n_q), want.reshape(b * t, n_q)
    assert_codes(g, w, lambda fr, q: euclid_margin(x64[fr], cb64, w[fr, :q],
                                                   g[fr, q], w[fr, q]))


@pytest.mark.parametrize("b,t,d,n_q,v", [(1, 250, 256, 31, 2048),
                                         (2, 33, 30, 3, 70)])
def test_rvq_kernel_norms_argument_and_two_launches(dev, b, t, d, n_q, v):
    """Codes with norms= (as a model passes them) equal codes without it,
    and two launches give the same codes."""
    from codec_tpu_torch.ops import rvq
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    x, cb = _rvq_inputs(b, t, d, n_q, v, dev, "normal", seed=5)
    nrm = rvq.codebook_norms(cb)
    a = rvq_encode_fused(x, cb)
    got = rvq_encode_fused(x, cb, norms=nrm)
    again = rvq_encode_fused(x, cb, norms=nrm)
    torch.cuda.synchronize()
    assert torch.equal(a, got) and torch.equal(got, again)


def test_rvq_layout_and_plan_match_the_card(dev):
    """ops/rvq_cuda.py's shared-memory mirror equals the library's, the
    card holds the HELD clusters of 8 the plan assumes, and the plan only
    picks an instantiation the card holds."""
    from codec_tpu_torch.ops import rvq_cuda
    from codec_tpu_torch.ops.seanet_cuda import smem_per_block

    lib = rvq_cuda._lib()
    for frames in rvq_cuda.FRAMES:
        for d in (4, 32, 96, 256, 288, 512, 2560):
            assert lib.codec_rvq_encode_smem_bytes(frames, d) == \
                rvq_cuda.smem_bytes(frames, d)
    for frames in (16, 32):
        assert rvq_cuda.held_clusters(0, frames, 256) >= rvq_cuda.HELD
    for n, d in ((1, 256), (16, 256), (250, 256), (1000, 256), (250, 512)):
        frames = rvq_cuda.plan(n, d, smem_per_block(0))
        assert rvq_cuda.held_clusters(0, frames, d) >= 1
        assert rvq_cuda.smem_bytes(frames, d) <= smem_per_block(0)


@pytest.mark.parametrize("b,t,d,n_q,v", [(1, 1500, 512, 1, 4096),
                                         (1, 300, 64, 3, 4100)])
def test_rvq_kernel_lowest_index_wins_across_the_tile_seam(dev, b, t, d, n_q,
                                                           v):
    """Each block's second 256-row tile a copy of its first (V/8 rows a
    block): every exact tie spans the seam, the running best carries over
    it, and the first tile's row must win, bit for bit as the plain search
    (integer-valued inputs: exact products)."""
    from codec_tpu_torch.ops import rvq
    from codec_tpu_torch.ops.rvq_cuda import CLUSTER, TILE_V, rvq_encode_fused

    x, cb = _rvq_inputs(b, t, d, n_q, v, dev, "int", seed=v)
    copied = torch.zeros(v, dtype=torch.bool, device=dev)
    for lo in range(0, v, -(-v // CLUSTER)):
        n = min(TILE_V, v - lo - TILE_V)
        cb[:, lo + TILE_V: lo + TILE_V + n] = cb[:, lo: lo + n]
        copied[lo + TILE_V: lo + TILE_V + n] = True
    got = rvq_encode_fused(x, cb)
    want = rvq.rvq_encode(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not copied[got.long()].any()         # no copy beat its original


def test_rvq_kernel_never_picks_rows_past_v(dev):
    from codec_tpu_torch.ops import rvq
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    x, cb = _rvq_inputs(1, 300, 64, 3, 5, dev, "tiny", seed=1)
    got = rvq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert int(got.min()) >= 0 and int(got.max()) < 5
    assert torch.equal(got, rvq.rvq_encode(x, cb))


def test_rvq_counter_counts_kernel_launches_only(dev):
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    x, cb = _rvq_inputs(1, 20, 32, 2, 40, dev, "normal")
    before = rvq_encode_fused.launches
    rvq_encode_fused(x, cb)
    rvq_encode_fused(x.cpu(), cb.cpu())
    assert rvq_encode_fused.launches == before + 1


@pytest.mark.parametrize("case", ["bf16", "cpu_codebook", "layout", "dim",
                                  "norms_shape", "norms_dtype"])
def test_rvq_kernel_rejects_what_it_does_not_take(dev, case):
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    x, cb = _rvq_inputs(1, 16, 32, 2, 40, dev, "normal")
    nrm = None
    if case == "bf16":
        x, cb = x.bfloat16(), cb.bfloat16()
    elif case == "cpu_codebook":
        cb = cb.cpu()
    elif case == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "dim":
        cb = cb[..., :16].contiguous()
    elif case == "norms_shape":
        nrm = torch.zeros((2, 39), device=dev)
    else:
        nrm = torch.zeros((2, 40), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        rvq_encode_fused(x, cb, norms=nrm)


# the encoders' widths: DAC's units at C = 64 (T = n) and 512 (T = n/40),
# SNAC's at C = 48 (T = n, no multiple of the 32-channel staging) and 384
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c", [(4000, 64), (300, 512)])
def test_res_units_at_the_dac_encoder_widths(dev, dtype, t, c):
    p = _res_params(3, c, dtype, dev, seed=c)
    x = _x((1, t, c), dtype, dev, seed=5)
    got = seanet_cuda.seanet_res_units(x, **p, dilations=DILS)
    _check_against_plain(got, x, p, dtype, _chain_ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,c", [(4100, 48), (500, 384)])
def test_dw_units_at_the_snac_encoder_widths(dev, dtype, t, c):
    from codec_tpu_torch.runtime.model import f32_precision

    p = _dw_params(3, c, dtype, dev, seed=c)
    x = _x((1, t, c), dtype, dev, seed=6) * 0.3
    before = seanet_cuda.snac_res_chain.launches
    got = seanet_cuda.snac_res_units(x, **p, dilations=DILS)
    assert seanet_cuda.snac_res_chain.launches == before + 3
    with f32_precision(True):
        want = seanet_cuda.snac_res_chain_ref(
            x.float(), **{k: v.float() for k, v in p.items()}, dilations=DILS)
    torch.cuda.synchronize()
    g, w = got.float().cpu().numpy(), want.cpu().numpy()
    corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
    if dtype == torch.float32:
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        assert corr > 0.99999, corr
    else:
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=8e-2)
        assert corr > 0.9995, corr


@pytest.fixture(scope="module")
def encoder_ggufs(tmp_path_factory):
    """Small random files with encoders: Mimi (2 layers), DAC and SNAC at
    their published encoder widths with narrow decoders."""
    from codec_tpu_torch.models import dac, dac_init, mimi_init, snac, snac_init
    from codec_tpu_torch.models.mimi import MimiConfig

    d = tmp_path_factory.mktemp("enc")
    mimi_init.write_random_mimi_gguf(d / "mimi.gguf", seed=4, num_filters=8,
                                     cfg=MimiConfig(**SMALL), encoder=True)
    dac_init.write_random_dac_gguf(d / "dac.gguf", seed=4, decoder_dim=64,
                                   encoder=True, cfg=dac.DacConfig(
                                       n_q=4, codebook_size=64))
    snac_init.write_random_snac_gguf(d / "snac.gguf", seed=4, decoder_dim=64,
                                     encoder=True, cfg=snac.SnacConfig(
                                         codebook_size=64))
    return d


@pytest.mark.parametrize("arch,n", [("mimi", 12 * 1920 + 517),
                                    ("dac", 40 * 320), ("snac", 2 * 2048)])
def test_encode_on_card_uses_kernels_and_matches_cpu(dev, encoder_ggufs, arch,
                                                     n):
    """The card's encode makes its launches and gives the codes of the
    port on the CPU (the plain path, which the CPU tests hold against
    codec_tpu) under the near-tie rule."""
    import codec_tpu_torch
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from encode_ties import assert_codes, model_margin

    path = encoder_ggufs / f"{arch}.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    pcm = np.random.default_rng(7).standard_normal(n).astype(np.float32) * 0.3
    wrappers = (flash_sdpa_window, rvq_encode_fused, seanet_cuda.seanet_res_unit,
                seanet_cuda.seanet_res_chain, seanet_cuda.snac_res_chain)
    before = [w.launches for w in wrappers]
    got = gpu.encode(pcm)
    step = [w.launches - b for w, b in zip(wrappers, before)]
    if arch == "mimi":
        assert step == [SMALL["n_layers"], 2, 0, 0, 0]
    elif arch == "dac":
        limit = seanet_cuda.smem_per_block(0)
        chains = sum(seanet_cuda.use_chain(c, 7, DILS, torch.float32, limit)
                     for c in (64, 128, 256, 512))
        assert step == [0, 0, 3 * (4 - chains), chains, 0]
    else:
        assert step == [0, 0, 0, 0, 12]
    want = cpu.encode(pcm)
    assert got.shape == want.shape
    assert_codes(got, want, model_margin(cpu, pcm, want, got))
    assert np.isfinite(gpu.decode(got)).all()


@pytest.fixture(scope="module")
def istft_ggufs(tmp_path_factory):
    """Small random WavTokenizer and XY-Tokenizer files with encoders and a
    small Soprano (the CPU tests' widths)."""
    import dataclasses

    from codec_tpu_torch.models import soprano_init, wavtokenizer_init, xy_init
    from codec_tpu_torch.models.xy_tokenizer import XyConfig

    d = tmp_path_factory.mktemp("istft")
    wavtokenizer_init.write_random_wt_gguf(
        d / "wavtokenizer.gguf", seed=3, encoder=True, codebook_size=256,
        codebook_dim=64, dim=64, intermediate=96, n_convnext=2, n_fft=480,
        enc_filters=4)
    soprano_init.write_random_soprano_gguf(
        d / "soprano.gguf", seed=3, cfg=dataclasses.replace(
            soprano_init.SOPRANO_1_1, decoder_dim=64, intermediate_dim=96,
            num_layers=2))
    xy_init.write_random_xy_gguf(
        d / "xy_tokenizer.gguf", seed=3, encoder=True, cfg=XyConfig(
            n_layers=2, adapter_layers=1, d_model=64, n_heads=2,
            vocos_blocks=2, latent_dim=256, codebook_dim=64,
            codebook_size=128), ffn_dim=128, vocos_dim=64,
        vocos_intermediate=128, enc_pos=500, post_pos=20, dec_pos=100)
    return d


@pytest.mark.parametrize("arch", ["wavtokenizer", "soprano", "xy_tokenizer"])
def test_istft_codecs_on_card_match_cpu(dev, istft_ggufs, arch):
    """f32 decodes (XY across decode windows) on the card launch none of
    the port's kernels and give the CPU's samples; encodes launch one
    rvq_encode_fused a row and give the CPU's codes under the near-tie
    rule."""
    import codec_tpu_torch
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from encode_ties import assert_codes, euclid_margin, f64

    path = istft_ggufs / f"{arch}.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    rng = np.random.default_rng(11)
    before = rvq_encode_fused.launches
    if arch == "soprano":
        z = rng.standard_normal((2, 40, 512)).astype(np.float32)
        got, want = gpu.decode_latent(z), cpu.decode_latent(z)
    else:
        codes = rng.integers(0, gpu.codebook_size, (2, 45, gpu.n_q))
        got, want = gpu.decode(codes), cpu.decode(codes)
    assert rvq_encode_fused.launches == before
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    if arch == "soprano":
        return
    rate = gpu.encode_sample_rate or gpu.sample_rate
    pcm = (rng.standard_normal((2, rate * 2 + 77)) * 0.3).astype(np.float32)
    got = gpu.encode(pcm)
    assert rvq_encode_fused.launches == before + (1 if arch == "wavtokenizer"
                                                  else 2)
    want = cpu.encode(pcm)
    assert got.shape == want.shape and got.dtype == np.int32
    cb = f64(cpu.params["cb"])
    for i in range(2):
        lat = f64(_istft_latent(cpu, pcm[i]))
        assert_codes(got[i], want[i], lambda fr, q: euclid_margin(
            lat[fr], cb, want[i, fr, :q], got[i, fr, q], want[i, fr, q]))


@pytest.mark.parametrize("b,t,c,k", [(1, 1500, 768, 7), (4, 15000, 768, 7),
                                     (1, 62450, 768, 3), (4, 30000, 512, 7)])
def test_f16_depthwise_conv_on_card(dev, b, t, c, k):
    """ConvNeXt's f16 depthwise conv on the card (PyTorch's own kernel) at
    a 20 s request and at lengths where cuDNN's f16 kernel faults: the f32
    conv's values, cuDNN left on as it was."""
    from codec_tpu_torch.ops import blocks

    g = torch.Generator(device=dev).manual_seed(t + c)
    x = torch.randn((b, t, c), device=dev, generator=g)
    w = torch.randn((c, 1, k), device=dev, generator=g) * k ** -0.5
    bias = torch.randn(c, device=dev, generator=g) * 0.1
    got = blocks.depthwise_conv(x.half(), w.half(), bias.half())
    torch.cuda.synchronize()
    assert torch.backends.cudnn.enabled
    want = blocks.depthwise_conv(x, w, bias)
    assert got.dtype == torch.float16 and got.shape == want.shape
    assert float((got.float() - want).abs().max()) <= 1e-2 * float(
        want.abs().max())


@pytest.mark.parametrize("arch", ["wavtokenizer", "soprano", "xy_tokenizer"])
def test_istft_codecs_f16_on_card(dev, istft_ggufs, arch):
    """f16 decodes on the card against the same decode with cuDNN off
    (phases 4-6's f16 bound, corr > 0.9995) and against the f32 decode on
    the CPU (the bf16 tests' corr > 0.99)."""
    import codec_tpu_torch

    path = istft_ggufs / f"{arch}.gguf"
    gpu = codec_tpu_torch.load_model(path, compute_dtype="f16", device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    rng = np.random.default_rng(12)
    if arch == "soprano":
        x = rng.standard_normal((2, 40, 512)).astype(np.float32)
        run = lambda m: m.decode_latent(x)                # noqa: E731
    else:
        x = rng.integers(0, gpu.codebook_size, (2, 45, gpu.n_q))
        run = lambda m: m.decode(x)                       # noqa: E731
    got = run(gpu)
    cudnn, torch.backends.cudnn.enabled = torch.backends.cudnn.enabled, False
    try:
        plain = run(gpu)
    finally:
        torch.backends.cudnn.enabled = cudnn
    want = run(cpu)
    assert got.shape == plain.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(plain).all()
    assert np.corrcoef(got.ravel(), plain.ravel())[0, 1] > 0.9995
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


def _istft_latent(model, pcm_row):
    """A WavTokenizer or XY-Tokenizer model's latent before its search, for
    one PCM row."""
    from codec_tpu_torch.dsp.audio import whisper_mel_padded
    from codec_tpu_torch.models import wavtokenizer, xy_tokenizer

    with torch.inference_mode():
        if model.arch == "wavtokenizer":
            return wavtokenizer.wt_encode_latent_fn(
                model.params, torch.from_numpy(pcm_row[None]))[0]
        c = model.cfg
        mel, n_frames = whisper_mel_padded(
            pcm_row, c.encode_sample_rate, c.mel_n_fft, c.mel_hop,
            c.mel_n_mels, c.encoder_downsample_rate)
        n_valid = min(n_frames, len(pcm_row) // c.mel_hop)
        return xy_tokenizer.xy_encode_latent_fn(
            model.params, torch.from_numpy(np.ascontiguousarray(mel.T[None])),
            c, n_valid)[0]


def test_cli_encode_and_e2e_on_card(dev, encoder_ggufs, tmp_path):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    pcm = np.random.default_rng(8).standard_normal(5 * 1920).astype(np.float32)
    write_wav(tmp_path / "in.wav", pcm * 0.3, 24000)
    model = str(encoder_ggufs / "mimi.gguf")
    assert main(["encode", "--model", model, "--in", str(tmp_path / "in.wav"),
                 "--codes", str(tmp_path / "c.npy")]) == 0
    assert np.load(tmp_path / "c.npy").shape == (5, 4)
    assert main(["e2e", "--model", model, "--in", str(tmp_path / "in.wav"),
                 "--out", str(tmp_path / "o.wav")]) == 0
    x, sr = read_wav(tmp_path / "o.wav")
    assert sr == 24000 and x.shape == (5 * 1920, 1)


# -- the attention with carried keys (a streaming step: k, v longer than q) --
# query i at key position Tk - Tq + i; Tq 1, 2, 8, 33 against Tk = Tq + 249
# and Tq + 19 (Mimi's window 250 and SMALL-like 20 carried, each under both
# windows); k_start 0, mid and Tk - Tq (every carried slot masked, as at
# stream start); D 64 at B·H 8 and D 128 at B·H 32; bounds as above

STREAM_ATTN = [(tq, extra, w, ks)
               for tq in (1, 2, 8, 33)
               for extra, w in ((249, 250), (19, 20), (249, 20), (19, 250))
               for ks in (0, extra // 2, extra)]
# Pocket-Mimi's pushes of 1 and 5 latent frames: 16 and 80 queries at 200 Hz
STREAM_ATTN += [(tq, 249, 250, ks) for tq in (16, 80) for ks in (0, 124, 249)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,d", [(1, 8, 64), (4, 8, 128)])
@pytest.mark.parametrize("tq,extra,w,k_start", STREAM_ATTN)
def test_carried_key_kernel_matches_plain(dev, b, h, d, dtype, tq, extra, w,
                                          k_start):
    rng = np.random.default_rng(tq * 1000 + extra + k_start)
    q = torch.from_numpy(rng.standard_normal((b, h, tq, d)).astype(
        np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, h, tq + extra, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    before = flash_sdpa_window.launches
    got = flash_sdpa_window(q, k, v, window=w, k_start=k_start)
    assert flash_sdpa_window.launches == before + 1
    want = flash_sdpa_window_ref(q, k, v, window=w, k_start=k_start)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_carried_key_two_launches_are_bit_identical(dev, dtype, d):
    q, k, v = _qkv((2, 4, 251, d), dtype, dev, seed=5)
    q = q[:, :, -2:].contiguous()
    a = flash_sdpa_window(q, k, v, window=250, k_start=100)
    b = flash_sdpa_window(q, k, v, window=250, k_start=100)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_carried_key_shapes_the_kernel_rejects_raise(dev):
    """No fallback: a shape the kernel does not take raises on the card."""
    q, k, _ = _qkv((1, 2, 4, 64), torch.float32, dev)
    long_k = torch.zeros((1, 2, 9, 64), device=dev)
    for args, kw in (((q, long_k[:, :, :3].contiguous(), long_k[:, :, :3]
                       .contiguous()), {}),
                     ((q, long_k, long_k), {"k_start": 6}),
                     ((q, long_k, long_k[:, :1].contiguous()), {})):
        before = flash_sdpa_window.launches
        with pytest.raises(ValueError):
            flash_sdpa_window(*args, window=20, **kw)
        assert flash_sdpa_window.launches == before


@pytest.fixture(scope="module")
def parent_attention():
    """An older commit's kernel entry, called with q, k, v of one length,
    for the bit-for-bit check of Tk == Tq: CODEC_PARENT_TREE names an unpacked
    `git archive` of that commit; its csrc/flash_sdpa_window.cu is built
    with the port's nvcc flags. Skips when the variable is unset."""
    import ctypes
    import os
    import subprocess
    from pathlib import Path

    from codec_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    tree = os.environ.get("CODEC_PARENT_TREE")
    if not tree:
        pytest.skip("CODEC_PARENT_TREE (an unpacked parent tree) is unset")
    csrc = Path(tree) / "codec_tpu_torch" / "csrc"
    out = BUILD_DIR.parent / "attn_parent" / "libattn_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "--shared",
                    "-o", str(out), str(csrc / "flash_sdpa_window.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).codec_flash_sdpa_window
    # an entry with carried keys takes (bh, t_q, t_k, k_start, d, window),
    # an older one (bh, t, d, window)
    carried = "int k_start, int d" in (csrc / "flash_sdpa_window.cu").read_text()
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (
        6 if carried else 4) + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

    def call(q, k, v, o, bh, t, d, w, scale, dtype, stream):
        lengths = (bh, t, t, 0) if carried else (bh, t)
        return fn(q, k, v, o, *lengths, d, w, scale, dtype, stream)

    return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d,w", ATTN_SHAPES)
def test_equal_lengths_are_bit_identical_to_the_parent(dev, parent_attention,
                                                       b, h, t, d, w, dtype):
    q, k, v = _qkv((b, h, t, d), dtype, dev, seed=6)
    got = flash_sdpa_window(q, k, v, window=w)
    o = torch.empty_like(q)
    err = parent_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), b * h, t, d, w or 0, d ** -0.5,
                           0 if dtype == torch.float32 else 1,
                           torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got, o)


def test_streaming_on_card_uses_kernels_and_matches_cpu(dev, encoder_ggufs):
    """A decode session's step launches the attention once per layer, an
    encode session's also the RVQ search twice; their chunks agree with
    the same sessions on the CPU (which the CPU tests hold against
    codec_tpu and the full calls) at the f32 bounds, streamed past SMALL's
    window of 40."""
    import codec_tpu_torch
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from encode_ties import assert_codes, model_margin

    path = encoder_ggufs / "mimi.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    codes = np.random.default_rng(9).integers(0, 64, (2, 36, 4)).astype(
        np.int32)
    sessions = [m.streaming_decoder(batch=2) for m in (gpu, cpu)]
    outs = [[], []]
    for lo in range(0, 36, 3):
        before = flash_sdpa_window.launches
        outs[0].append(sessions[0].push(codes[:, lo:lo + 3]))
        assert flash_sdpa_window.launches == before + SMALL["n_layers"]
        outs[1].append(sessions[1].push(codes[:, lo:lo + 3]))
    got, want = (np.concatenate(o, axis=1) for o in outs)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    pcm = np.random.default_rng(10).standard_normal(30 * 1920).astype(
        np.float32) * 0.3
    enc = gpu.streaming_encoder()
    chunks = []
    for lo in range(0, 30 * 1920, 5 * 1920):
        before = (flash_sdpa_window.launches, rvq_encode_fused.launches)
        chunks.append(enc.push(pcm[lo:lo + 5 * 1920]))
        assert (flash_sdpa_window.launches - before[0],
                rvq_encode_fused.launches - before[1]) == (SMALL["n_layers"], 2)
    got = np.concatenate(chunks)
    want = cpu.encode(pcm)
    assert_codes(got, want, model_margin(cpu, pcm, want, got))


# -- float16 requests, and the on-device TTS loop as CUDA graphs ---------------

@pytest.mark.parametrize("arch", ["mimi", "dac", "snac"])
def test_f16_decode_on_card_uses_kernels(dev, arch, small_gguf, small_dac_gguf,
                                         small_snac_gguf):
    """An f16 decode launches the f16 instances (every launch the f32
    decode makes) and agrees with the f32 decode at the bf16 tests' bound
    (corr > 0.99)."""
    import codec_tpu_torch

    path = {"mimi": small_gguf, "dac": small_dac_gguf,
            "snac": small_snac_gguf}[arch]
    cols = 3 if arch == "snac" else 4
    codes = np.random.default_rng(5).integers(0, 64, (1, 24, cols)).astype(np.int32)
    wrappers = [flash_sdpa_window, seanet_cuda.seanet_res_unit,
                seanet_cuda.seanet_res_chain, seanet_cuda.snac_res_chain]
    out = {}
    for dtype in ("float16", "float32"):
        model = codec_tpu_torch.load_model(path, compute_dtype=dtype,
                                           device="cuda")
        before = [w.launches for w in wrappers]
        out[dtype] = model.decode(codes)
        ran = sum(w.launches - b for w, b in zip(wrappers, before))
        assert ran > 0, dtype
    got, want = out["float16"], out["float32"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99


@pytest.fixture(scope="module")
def tts_files(tmp_path_factory):
    import dataclasses

    from codec_tpu_torch.models.lm_init import (LLAMA_3_2_1B, DepthConfig,
                                                byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf,
                                                write_random_csm_gguf)
    from codec_tpu_torch.models.mimi import MimiConfig

    tmp = tmp_path_factory.mktemp("tts")
    model = write_random_csm_gguf(
        tmp / "csm.gguf", seed=1, num_filters=8,
        mimi_cfg=MimiConfig(n_q=4, codebook_size=64, codebook_dim=32,
                            hidden=64, n_layers=1, n_heads=1, head_dim=64,
                            intermediate=128, window=40),
        dcfg=DepthConfig(hidden=256, depth_hidden=64, layers=1, heads=2,
                         kv_heads=1, head_dim=32, ffn=128, n_codebook=4,
                         vocab=64))
    bb = write_random_backbone_gguf(
        tmp / "bb.gguf", seed=2, spm_b64=spm_model_b64(byte_fallback_vocab()),
        cfg=dataclasses.replace(LLAMA_3_2_1B, hidden=256, n_layers=2, n_heads=4,
                                n_kv_heads=2, head_dim=64, ffn_dim=512,
                                vocab_size=300, max_ctx=96))
    return model, bb


def _tts(tts_files):
    import codec_tpu_torch
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm import create_lm
    from codec_tpu_torch.lm.backbone import LlamaBackbone

    model, bb = tts_files
    reader = GGUFReader(model)
    return (reader, codec_tpu_torch.load_model(model, device="cuda"),
            create_lm(reader, device="cuda"),
            LlamaBackbone(bb, quantized=True, device="cuda"))


@pytest.mark.parametrize("chain", [dict(), dict(temperature=0.8, top_k=5)])
def test_gen_chunk_graph_equals_eager(dev, tts_files, chain):
    """A captured chunk's replay gives the eager chunk's packed result,
    hidden and position bit for bit, from the same state; the graph holds
    7 q4_k_matmul launches a layer a frame (counted as it is captured)."""
    from codec_tpu_torch.lm.fused_gen import gen_chunk_cached
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul

    reader, codec, lm, bb = _tts(tts_files)
    bb.reset()
    h = bb.prefill(bb.embed_tokens([3, 17, 42, 99]))
    runner = gen_chunk_cached(lm, bb, n_frames=4, ctx=64, **chain)
    runner.h.copy_(torch.as_tensor(h).reshape(1, -1))
    runner.pos.fill_(bb.pos)
    runner.draw_noise([torch.Generator(device="cuda").manual_seed(3)
                       if chain else None])
    state = [t.clone() for t in (runner.h, runner.pos, runner.kv)]
    eager = runner.graphed.eager().clone()
    after = [t.clone() for t in (runner.h, runner.pos)]
    for t, s in zip((runner.h, runner.pos, runner.kv), state):
        t.copy_(s)
    before = q4_k_matmul.launches
    graph = runner.run().clone()
    assert q4_k_matmul.launches - before == 7 * 2 * 4 * 2   # warm-up + capture
    torch.cuda.synchronize()
    assert torch.equal(eager, graph)
    assert torch.equal(after[0], runner.h) and torch.equal(after[1], runner.pos)
    before = q4_k_matmul.launches
    runner.run()                                 # a replay: no wrapper calls
    assert q4_k_matmul.launches == before


class _HostOnly:
    """The tts_runner Backbone protocol alone over a LlamaBackbone: the
    chunk cannot run it, so its frames take fused_gen.FrameRunner."""

    def __init__(self, bb):
        self.bb = bb

    def step(self, embed):
        return self.bb.step(embed)


def test_on_device_greedy_equals_host_on_card(dev, tts_files):
    """Greedy codes of the chunked device path (K = 1, 3, 4) and of the
    per-frame path a host-only backbone takes equal the host path's on
    the card."""
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.tts_runner import run_codebook_ar
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    reader, codec, lm, bb = _tts(tts_files)
    prompt = list(bb.embed_tokens([3, 17, 42, 99, 150, 7]))

    def run(ods, backbone=bb):
        bb.reset()
        return run_codebook_ar(AudioLM(reader, codec=codec, lm=lm), backbone,
                               prompt, max_steps=7, on_device=ods)

    host = run(None)
    for k in (1, 3, 4):
        got = run(OnDeviceSampling(chunk_frames=k))
        np.testing.assert_array_equal(got.codes, host.codes)
        assert got.pcm.shape == host.pcm.shape and np.isfinite(got.pcm).all()
    got = run(OnDeviceSampling(), backbone=_HostOnly(bb))
    np.testing.assert_array_equal(got.codes, host.codes)
    assert lm._frame_runners
    a = run(OnDeviceSampling(temperature=0.8, top_k=5, chunk_frames=1, seed=4))
    b = run(OnDeviceSampling(temperature=0.8, top_k=5, chunk_frames=4, seed=4))
    np.testing.assert_array_equal(a.codes, b.codes)


def test_batch_on_card_equals_single_streams(dev, tts_files):
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.tts_runner import (run_codebook_ar,
                                               run_codebook_ar_batch)
    from codec_tpu_torch.ops.sample import OnDeviceSampling

    reader, codec, lm, bb = _tts(tts_files)
    prompts = [[5, 9, 200, 31], [44, 2, 17, 80, 9, 100], [250, 1, 3]]
    embeds = [list(bb.embed_tokens(p)) for p in prompts]
    ods = OnDeviceSampling(temperature=0.8, top_k=5, chunk_frames=3, seed=21)
    got = run_codebook_ar_batch([AudioLM(reader, codec=codec, lm=lm)
                                 for _ in prompts], bb, embeds, ods, max_steps=6)
    for s, e in enumerate(embeds):
        bb.reset()
        one = run_codebook_ar(AudioLM(reader, codec=codec, lm=lm), bb, e,
                              max_steps=6, on_device=OnDeviceSampling(
                                  temperature=0.8, top_k=5, chunk_frames=3,
                                  seed=21 + s))
        np.testing.assert_array_equal(got[s].codes, one.codes)


def test_mesh_chunks_on_card(dev, tts_files):
    """The chunks on a mesh that names the card twice (or four times):
    DP streams (one captured graph a share), a TP chunk and the dp x tp
    batch give the unsharded runs' codes; a TP chunk's replay equals its
    eager run bit for bit."""
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.lm.fused_gen import gen_chunk_cached
    from codec_tpu_torch.lm.tts_runner import (run_codebook_ar,
                                               run_codebook_ar_batch)
    from codec_tpu_torch.ops.sample import OnDeviceSampling
    from codec_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    reader, codec, lm, bb = _tts(tts_files)
    prompts = [[5, 9, 200, 31], [44, 2, 17, 80, 9, 100], [250, 1, 3],
               [7, 7, 8]]
    embeds = [list(bb.embed_tokens(p)) for p in prompts]
    ods = OnDeviceSampling(temperature=0.8, top_k=5, chunk_frames=3, seed=21)

    def batch(backbone, mesh=None, od=ods):
        return run_codebook_ar_batch(
            [AudioLM(reader, codec=codec, lm=lm) for _ in prompts], backbone,
            embeds, od, max_steps=6, decode=False, mesh=mesh)

    def same(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)

    two = make_mesh(2, devices=["cuda:0"] * 2)
    same(batch(bb, two), batch(bb))
    dense = LlamaBackbone(tts_files[1], device="cuda")
    mesh2 = make_mesh_2d(2, 2, devices=["cuda:0"] * 4)
    tp2 = LlamaBackbone.from_params(dense.cfg, dense.params)
    tp2.set_mesh(mesh2, axis="tp")
    greedy = OnDeviceSampling(chunk_frames=3)
    same(batch(tp2, mesh2, greedy), batch(dense, od=greedy))
    tp = LlamaBackbone.from_params(dense.cfg, dense.params)
    tp.set_mesh(make_mesh(2, axis="tp", devices=["cuda:0"] * 2), axis="tp")
    one = []
    for b in (tp, dense):
        b.reset()
        one.append(run_codebook_ar(AudioLM(reader, lm=lm), b, embeds[0],
                                   max_steps=6, decode=False,
                                   on_device=greedy))
    same(one[:1], one[1:])
    tp.reset()
    h = tp.prefill(tp.embed_tokens([3, 17, 42, 99]))
    runner = gen_chunk_cached(lm, tp, n_frames=4, ctx=64)
    runner.h.copy_(torch.as_tensor(h).reshape(1, -1))
    runner.pos.fill_(tp.pos)
    state = [t.clone() for t in runner.graphed.restore]
    eager = runner.graphed.eager().clone()
    for t, s in zip(runner.graphed.restore, state):
        t.copy_(s)
    graph = runner.run().clone()
    torch.cuda.synchronize()
    assert torch.equal(eager, graph)


def test_tts_cli_on_device_on_card(dev, tts_files, tmp_path):
    from codec_tpu_torch.cli.tts_cli import main
    from codec_tpu_torch.io.wav import read_wav

    model, bb = tts_files
    out = tmp_path / "o.wav"
    assert main(["synthesize", "--model", str(model), "--backbone", str(bb),
                 "--text", "hello there", "--out", str(out), "--max-frames",
                 "5", "--quant-exec", "--on-device", "--chunk-frames", "4"]) == 0
    pcm, sr = read_wav(out)
    assert sr == 24000 and pcm.shape == (5 * 1920, 1)


# -- the windowed-transformer codecs: Qwen3-TTS-Tokenizer and Pocket-Mimi ----
# small files at the kernel's head dim (64): Qwen3 with 2 heads over 1 KV
# head, biases and a window of 5 frames, its Mimi encoder as SMALL; Pocket
# with a 12-frame context (pushes and decodes reach past it)

@pytest.fixture(scope="module")
def windowed_ggufs(tmp_path_factory):
    import dataclasses

    from codec_tpu_torch.models.mimi import MimiConfig
    from codec_tpu_torch.models.pocket_init import (POCKET_TTS,
                                                    write_random_pocket_gguf)
    from codec_tpu_torch.models.qwen3_tts_init import (QWEN3_TTS_12HZ,
                                                       write_random_q3t_gguf)

    d = tmp_path_factory.mktemp("windowed")
    write_random_q3t_gguf(
        d / "qwen3.gguf", seed=5, cfg=dataclasses.replace(
            QWEN3_TTS_12HZ, n_q=4, codebook_size=64, codebook_dim=32,
            latent_dim=64, hidden=64, n_layers=2, n_heads=2, n_kv_heads=1,
            head_dim=64, intermediate=128, decoder_dim=64, window=5),
        enc_cfg=MimiConfig(**SMALL), num_filters=8)
    write_random_pocket_gguf(
        d / "pocket.gguf", seed=5, cfg=dataclasses.replace(
            POCKET_TTS, outer_dim=128, tf_heads=2, tf_context=12),
        channels=(128, 64, 32, 16), ffn=256)
    return d


def _held(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


def test_qwen3_on_card_uses_kernels_and_matches_cpu(dev, windowed_ggufs):
    """A decode launches the attention once per pre-transformer layer (also
    with the window taken off), an encode once per Mimi encoder layer and
    the RVQ search twice; samples and codes agree with the port on the CPU
    (which the CPU tests hold against codec_tpu)."""
    import dataclasses

    import codec_tpu_torch
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused
    from encode_ties import assert_codes, mimi_margin

    path = windowed_ggufs / "qwen3.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    codes = np.random.default_rng(12).integers(0, 64, (2, 20, 4)).astype(
        np.int32)
    for window in (5, None):
        for m in (gpu, cpu):
            m.cfg = dataclasses.replace(m.cfg, window=window)
        before = flash_sdpa_window.launches
        got = gpu.decode(codes)
        assert flash_sdpa_window.launches == before + 2
        _held(got, cpu.decode(codes))
    pcm = (np.random.default_rng(13).standard_normal((2, 1920 * 6 + 517))
           * 0.3).astype(np.float32)
    before = (flash_sdpa_window.launches, rvq_encode_fused.launches)
    got = gpu.encode(pcm)
    assert (flash_sdpa_window.launches - before[0],
            rvq_encode_fused.launches - before[1]) == (SMALL["n_layers"], 2)
    want = cpu.encode(pcm)
    for i in range(2):
        assert_codes(got[i], want[i], mimi_margin(
            cpu.enc_params, cpu.enc_cfg, pcm[i], want[i], got[i]))


def test_pocket_on_card_uses_kernels_and_matches_cpu(dev, windowed_ggufs):
    """decode_latent, encode_latent (a ragged length: the valid-length
    path) and each push of a 1-frame stream launch the attention once per
    transformer layer (16 queries against 11 carried keys a push: context
    12; STREAM_ATTN holds the full width's 249) and agree with the port on
    the CPU; the stream also with the full call."""
    import codec_tpu_torch

    path = windowed_ggufs / "pocket.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    z = (np.random.default_rng(14).standard_normal((2, 20, 32)) * 0.5
         ).astype(np.float32)
    before = flash_sdpa_window.launches
    got = gpu.decode_latent(z)
    assert flash_sdpa_window.launches == before + 2
    _held(got, cpu.decode_latent(z))
    pcm = (np.random.default_rng(15).standard_normal(1920 * 5 + 733) * 0.3
           ).astype(np.float32)
    before = flash_sdpa_window.launches
    mu = gpu.encode_latent(pcm)
    assert flash_sdpa_window.launches == before + 2
    want = cpu.encode_latent(pcm)
    assert mu.shape == want.shape == (6, 32)
    assert np.abs(mu - want).max() <= 1e-4 * np.abs(want).max()
    session, outs = gpu.streaming_decoder(batch=2), []
    for t in range(20):
        before = flash_sdpa_window.launches
        outs.append(session.push(z[:, t:t + 1]))
        assert flash_sdpa_window.launches == before + 2
    streamed = np.concatenate(outs, axis=1)
    _held(streamed, got)


@pytest.fixture(scope="module")
def neu_ggufs(tmp_path_factory):
    """Small random DistillNeuCodec and XCodec2 files (the CPU tests'
    widths: tests/test_torch_neucodec.py, tests/test_torch_xcodec2.py)."""
    import dataclasses

    from codec_tpu_torch.models import neucodec_init, xcodec2_init
    from codec_tpu_torch.models.neucodec import NeuEncConfig
    from codec_tpu_torch.models.xcodec2 import X2EncConfig

    d = tmp_path_factory.mktemp("neu")
    neucodec_init.write_random_neu_gguf(
        d / "distill_neucodec.gguf", seed=4, n_fft=128, mlp=64, encoder=True,
        cfg=dataclasses.replace(neucodec_init.NEUCODEC, hop_size=32,
                                vq_dim=24, hidden_dim=32, num_layers=2,
                                num_heads=2, head_dim=16),
        enc_cfg=NeuEncConfig(
            hubert_hidden=8, hubert_heads=2, hubert_intermediate=16,
            hubert_layers=2, hubert_pos_k=4, hubert_pos_groups=2,
            hubert_conv_dim=(8, 8, 8), hubert_conv_kernel=(10, 4, 8),
            hubert_conv_stride=(10, 4, 8), distill_heads=2, down_window=8,
            local_window=4),
        dim=8, branch=2, first=4, dpb=6, fsq_out=12, sem_out=12)
    xcodec2_init.write_random_x2_gguf(
        d / "xcodec2.gguf", seed=4, n_fft=640, mlp=64, encoder=True,
        cfg=dataclasses.replace(xcodec2_init.XCODEC2, vq_dim=24,
                                hidden_dim=32, num_layers=2, num_heads=2,
                                head_dim=16),
        enc_cfg=X2EncConfig(
            w2v_layers=2, w2v_hidden=32, w2v_heads=2, w2v_head_dim=16,
            w2v_left_max=4, w2v_right_max=2, w2v_dw_kernel=7,
            w2v_input_dim=16, mel_n_fft=64, mel_win=64, mel_hop=160,
            mel_n_mels=8, mel_stride=2), ngf=2, w2v_ffn=64)
    return d


def _all_launches():
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    return [f.launches for f in (
        flash_sdpa_window, seanet_cuda.seanet_res_unit,
        seanet_cuda.seanet_res_chain, seanet_cuda.snac_res_chain,
        q4_k_matmul, q8_0_matmul, rvq_encode_fused)]


@pytest.mark.parametrize("arch", ["distill_neucodec", "xcodec2"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_neu_codecs_on_card_match_cpu(dev, neu_ggufs, arch, dtype):
    """Decodes and encodes on the card launch none of the port's kernels.
    f32: decodes give the CPU's samples (corr > 0.99999, max abs err <=
    1e-4 x peak; decode_async and decode_many their own decodes), encodes
    the CPU's codes under the FSQ near-tie rule. f16
    (its depthwise convs without cuDNN): decodes against the f32 decode on
    the CPU at corr > 0.9999, encodes in range."""
    import codec_tpu_torch
    from codec_tpu_torch.models import neucodec as neu
    from codec_tpu_torch.models import xcodec2 as x2
    from fsq_ties import assert_fsq_codes

    path = neu_ggufs / f"{arch}.gguf"
    gpu = codec_tpu_torch.load_model(path, compute_dtype=dtype, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4 ** 8, (2, 37, 1)).astype(np.int32)
    pcm = (rng.standard_normal((2, 16000 + 1234)) * 0.3).astype(np.float32)
    before = _all_launches()
    got, got_codes = gpu.decode(codes), gpu.encode(pcm)
    assert _all_launches() == before
    want, want_codes = cpu.decode(codes), cpu.encode(pcm)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got_codes.shape == want_codes.shape and got_codes.dtype == np.int32
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    if dtype == "float16":
        assert corr > 0.9999
        assert 0 <= got_codes.min() and got_codes.max() < 4 ** 8
        return
    assert corr > 0.99999
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(gpu.decode_async(codes).result(), got)
    for o, g in zip(gpu.decode_many([codes[0], codes[1, :20]]),
                    (got[0], gpu.decode(codes[1, :20]))):
        assert o.shape == g.shape
        assert np.abs(o - g).max() <= 1e-4 * np.abs(g).max()
    for i in range(2):
        with torch.inference_mode():
            if arch == "xcodec2":
                mel = cpu.mel(pcm[i])
                n = min(len(pcm[i]) // 320, mel.shape[0])
                z = x2.x2_encode_latent_fn(
                    cpu.enc_params, torch.from_numpy(pcm[i][None]),
                    torch.from_numpy(mel[None]), n, cpu.enc_cfg)[0]
            else:
                (row, sem), = neu.encode_rows(pcm[i][None])
                z = neu.neu_encode_latent_fn(
                    cpu.enc_params, torch.from_numpy(row[None]),
                    torch.from_numpy(sem[None]), cpu.enc_cfg)[0]
        assert_fsq_codes(got_codes[i], want_codes[i], z.numpy())


@pytest.mark.parametrize("b,c,t", [(1, 48, 160000), (1, 96, 80000),
                                   (4, 192, 20000)])
def test_f16_alias_fir_on_card(dev, b, c, t):
    """The alias-free snake-beta in f16 (up step at t, down step at 2t
    frames, both past cuDNN's faulting f16 lengths) runs clean without
    cuDNN and gives the f32 op's values; cuDNN is left as it was."""
    from codec_tpu_torch.models.xcodec2_init import kaiser_sinc_filter
    from codec_tpu_torch.ops.alias_act import (alias_free_snake_beta_cf,
                                               polyphase_up_taps)

    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((b, c, t), device=dev, generator=g)
    a = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
    ib = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
    k = torch.from_numpy(kaiser_sinc_filter()).to(dev)
    up = polyphase_up_taps(k)
    got = alias_free_snake_beta_cf(x.half(), a.half(), ib.half(), k, up)
    torch.cuda.synchronize()
    assert torch.backends.cudnn.enabled
    want = alias_free_snake_beta_cf(x, a, ib, k, up)
    assert got.dtype == torch.float16 and got.shape == want.shape == x.shape
    assert float((got.float() - want).abs().max()) <= 1e-2 * float(
        want.abs().max())


@pytest.mark.parametrize("b,t", [(1, 320000), (1, 80000)])
def test_f16_distill_unit_on_card(dev, b, t):
    """The distill unit (its depthwise k7 at the PCM rate of a 20 s
    request, and a block later) in f16 on the card: the f32 unit's values
    at the f16 bound, cuDNN left as it was."""
    from codec_tpu_torch.models import neucodec as neu

    g = torch.Generator(device=dev).manual_seed(t)
    c = 512
    u = {"dw_w": torch.randn((c, 1, 7), device=dev, generator=g) * 7 ** -0.5,
         "dw_b": 0.01 * torch.randn(c, device=dev, generator=g),
         "pw1_w": torch.randn((2 * c, c), device=dev, generator=g) * c ** -0.5,
         "pw1_b": 0.01 * torch.randn(2 * c, device=dev, generator=g),
         "alpha": 1 + 0.1 * torch.randn(2 * c, device=dev, generator=g),
         "grn_g": 0.1 * torch.randn(2 * c, device=dev, generator=g),
         "grn_b": 0.01 * torch.randn(2 * c, device=dev, generator=g),
         "pw2_w": torch.randn((c, 2 * c), device=dev, generator=g)
         * 0.3 * (2 * c) ** -0.5,
         "pw2_b": 0.01 * torch.randn(c, device=dev, generator=g)}
    x = torch.randn((b, t, c), device=dev, generator=g)
    with torch.inference_mode():
        got = neu._base_unit_fwd(x.half(), {k: v.half() for k, v in u.items()})
        torch.cuda.synchronize()
        assert torch.backends.cudnn.enabled
        want = neu._base_unit_fwd(x, u)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(
        want.abs().max())


# MOSS-Audio-Tokenizer's four transformer stages at 20 s of 48 kHz stereo
# (heads of 64): T 250 w125, T 2500 w12 (a window below the kernel's
# 16-query block), T 15 000 w75, T 120 000 w600
MOSS_ATTN = [(1, 12, 250, 64, 125), (1, 12, 2500, 64, 12),
             (1, 6, 15000, 64, 75), (1, 3, 120000, 64, 600)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,t,d,w", MOSS_ATTN)
def test_kernel_matches_banded_plain_at_moss_shapes(dev, b, h, t, d, w,
                                                    dtype):
    """The kernel against its banded plain version (the full mask at T
    120 000 would need 173 GB of logits): f32 atol 2e-5 rtol 1e-5, 16-bit
    atol 3e-2."""
    q, k, v = _qkv((b, h, t, d), dtype, dev, seed=t)
    got = flash_sdpa_window(q, k, v, window=w)
    want = flash_sdpa_window_ref(q, k, v, window=w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("t,n_valid,w", [(15000, 14941, 75), (2500, 2491, 12),
                                         (250, 249, 125), (40, 3, 2)])
def test_moss_tail_split_on_card_matches_masked_form(dev, t, n_valid, w):
    """window_attention on the card (the kernel for the rows before
    n_valid, the masked sdpa after) against the whole masked form with
    codec_tpu's mask (attn_mask + the n_valid term), f32."""
    from codec_tpu_torch.models.moss_audio import window_attention
    from codec_tpu_torch.ops.attn import NEG_INF, attn_mask, sdpa

    q, k, v = _qkv((1, 2, t, 64), torch.float32, dev, seed=n_valid)
    before = flash_sdpa_window.launches
    got = window_attention(q, k, v, w, n_valid)
    assert flash_sdpa_window.launches == before + 1
    kj = torch.arange(t, device=dev)[None]
    rows = slice(max(0, n_valid - 300), t)
    m = attn_mask(t, t, window=w, device=dev)[rows] + torch.where(
        kj < n_valid, 0.0, NEG_INF)
    want = sdpa(q[:, :, rows], k, v, mask=m)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, :, rows], want, atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def small_ggufs(tmp_path_factory):
    """Small random MOSS (stereo, heads of 64: the kernel's), NeMo nano,
    BlueMagpie and S3T files."""
    import dataclasses

    from codec_tpu_torch.models import (bluemagpie_init, moss_init,
                                        nemo_init, s3t_init)
    from codec_tpu_torch.models.moss_audio import MossModuleCfg as M

    d = tmp_path_factory.mktemp("small4")
    sr = 24000

    def stage(i, o, dur, layers):
        return M(1, 1, i, o, 128, 2, layers, dur, 10000.0)

    moss_cfg = dataclasses.replace(
        moss_init.MOSS_FULL, sample_rate=sr, hop_size=8, n_q=4,
        codebook_size=64, latent_dim=32, rvq_dim=32,
        enc_modules=(M(0, 4), stage(4, 128, 24 / (2 * sr), 2), M(0, 4),
                     stage(512, 32, 8 * 16 / (2 * sr), 1)),
        dec_modules=(stage(32, 512, 8 * 16 / (2 * sr), 1), M(0, 4),
                     stage(128, 4, 24 / (2 * sr), 2), M(0, 4)))
    moss_init.write_random_moss_gguf(d / "moss.gguf", seed=5, cfg=moss_cfg,
                                     encoder=True)
    nemo_init.write_random_nemo_gguf(
        d / "nemo.gguf", seed=5, encoder=True, levels=(5, 4), enc_base=4,
        dec_base=64, cfg=dataclasses.replace(
            nemo_init.NEMO_NANO, n_q=2, codebook_size=20, codebook_dim=2,
            latent_dim=4))
    bluemagpie_init.write_random_bm_gguf(
        d / "bluemagpie.gguf", seed=5, encoder=True, decoder_dim=32,
        encoder_dim=8, cfg=dataclasses.replace(
            bluemagpie_init.BLUEMAGPIE, latent_dim=8, decoder_rates=(2, 3),
            encoder_rates=(2, 2), decode_hop=6, encode_hop=4))
    s3t_init.write_random_s3t_gguf(
        d / "s3t.gguf", seed=5, cfg=dataclasses.replace(
            s3t_init.S3T, n_mels=8, hidden=128, n_heads=2, n_layers=2,
            fsmn_kernel=5, n_fft=64, win_length=64))
    return d


def test_moss_on_card_uses_kernel_and_matches_cpu(dev, small_ggufs):
    """One flash_sdpa_window a transformer layer (3 a decode, 3 an encode,
    the tail rows on the masked sdpa); f32 decodes as the CPU's (corr >
    0.99999, 1e-4 x peak), encodes the CPU's codes (a non-hop-multiple
    length: the tail split), f16 decodes at corr > 0.999 to f32."""
    import codec_tpu_torch

    path = small_ggufs / "moss.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    f16 = codec_tpu_torch.load_model(path, compute_dtype="f16", device="cuda")
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 64, (2, 40, 4)).astype(np.int32)
    pcm = (rng.standard_normal((8 * 37 + 5, 2)) * 0.3).astype(np.float32)
    before = _all_launches()
    got = gpu.decode(codes)
    assert _all_launches()[0] == before[0] + 3
    got_codes = gpu.encode(pcm)
    assert _all_launches()[0] == before[0] + 6
    assert _all_launches()[1:] == before[1:]
    want = cpu.decode(codes)
    assert got.shape == want.shape == (2, 320, 2)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(got_codes, cpu.encode(pcm))
    half = f16.decode(codes)
    assert np.corrcoef(half.ravel(), got.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_past_65535_query_tiles(dev, dtype):
    """Tq 1 200 000 at D 64 w600 (75 000 query tiles of 16, past what
    gridDim.y would take): the kernel against its banded plain version, f32
    atol 2e-5 rtol 1e-5, bf16 atol 3e-2."""
    q, k, v = _qkv((1, 1, 1200000, 64), dtype, dev, seed=12)
    got = flash_sdpa_window(q, k, v, window=600)
    want = flash_sdpa_window_ref(q, k, v, window=600)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=0)


def test_moss_requests_past_174_s_run_on_the_kernel(dev):
    """At full width (48 kHz stereo, 16 samples a token at the first
    stage) a decode of 2185 codes and an encode of 8 386 561 samples a
    channel (past 174.72 s of stereo, where the first stage has more than
    65 535 query tiles of 16) run on the card: the right shape, finite,
    one flash_sdpa_window launch a transformer layer (15 a request)."""
    import tempfile
    from pathlib import Path

    import codec_tpu_torch
    from codec_tpu_torch.models.moss_init import write_random_moss_gguf

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "moss.gguf"
        write_random_moss_gguf(path, seed=0, encoder=True)
        m = codec_tpu_torch.load_model(path, device="cuda")
    rng = np.random.default_rng(3)
    codes = rng.integers(0, m.codebook_size, (2185, m.n_q)).astype(np.int32)
    before = flash_sdpa_window.launches
    pcm = m.decode(codes)
    assert flash_sdpa_window.launches == before + 15
    assert pcm.shape == (2185 * m.hop_size, 2) and np.isfinite(pcm).all()
    x = (rng.standard_normal((8386561, 2)) * 0.3).astype(np.float32)
    got = m.encode(x)
    assert flash_sdpa_window.launches == before + 30
    assert got.shape == (-(-8386561 // m.hop_size), m.n_q)
    assert got.min() >= 0 and got.max() < m.codebook_size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s3g_on_card_launches_nothing_and_matches_cpu(dev, tmp_path, dtype):
    """Chatterbox S3Gen on a small file (a 10-token prompt): no kernel of
    the port; f32 as the CPU's (corr > 0.99999, max abs err <= 1e-4 x
    peak), bf16 against the f32 card decode (corr > 0.99)."""
    import dataclasses

    import codec_tpu_torch
    from codec_tpu_torch.models.s3g_init import S3G, write_random_s3g_gguf

    cfg = dataclasses.replace(S3G, mel_dim=8, spk_dim=12, enc_hidden=32,
                              attn_heads=2, attn_head_dim=16, enc_layers=2,
                              enc_up_layers=1, cfm_mid_blocks=2,
                              cfm_transformers=1)
    path = tmp_path / "s3g.gguf"
    write_random_s3g_gguf(path, seed=0, cfg=cfg, ff=64, cfm_ch=24, ted=48,
                          cfm_ff=64, hift_ch=(16, 8, 4, 2), prompt_tokens=10)
    gpu = codec_tpu_torch.load_model(path, compute_dtype=dtype, device="cuda")
    codes = np.random.default_rng(11).integers(0, 6561, (40, 1)).astype(
        np.int32)
    before = _all_launches()
    got = gpu.decode(codes)
    assert _all_launches() == before
    if dtype == "float32":
        want = codec_tpu_torch.load_model(path, device="cpu").decode(codes)
        assert np.corrcoef(got, want)[0, 1] > 0.99999
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        want = codec_tpu_torch.load_model(path, device="cuda").decode(codes)
        assert np.corrcoef(got, want)[0, 1] > 0.99
    assert got.shape == want.shape == (2 * 50 * 480 - 20 * 480,)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("arch", ["nemo", "bluemagpie", "s3t"])
def test_small_codecs_on_card_launch_nothing_and_match_cpu(dev, small_ggufs,
                                                           arch):
    """NeMo decode and encode, BlueMagpie decode_latent and encode_latent,
    S3T encode on the card: none of the port's kernels; f32 as the CPU's
    (outputs corr > 0.99999 and 1e-4 x peak, codes equal)."""
    import codec_tpu_torch

    path = small_ggufs / f"{arch}.gguf"
    gpu = codec_tpu_torch.load_model(path, device="cuda")
    cpu = codec_tpu_torch.load_model(path, device="cpu")
    rng = np.random.default_rng(9)
    before = _all_launches()
    if arch == "nemo":
        x = rng.integers(0, 20, (2, 5, 2)).astype(np.int32)
        pcm = (rng.standard_normal((2, 1764 * 3)) * 0.1).astype(np.float32)
        outs = [(gpu.decode(x), cpu.decode(x)),
                (gpu.encode(pcm), cpu.encode(pcm))]
    elif arch == "bluemagpie":
        z = rng.standard_normal((2, 50, 8)).astype(np.float32)
        pcm = (rng.standard_normal((2, 400)) * 0.1).astype(np.float32)
        outs = [(gpu.decode_latent(z), cpu.decode_latent(z)),
                (gpu.encode_latent(pcm), cpu.encode_latent(pcm))]
    else:
        pcm = (rng.standard_normal((2, 16000 + 77)) * 0.3).astype(np.float32)
        outs = [(gpu.encode(pcm), cpu.encode(pcm))]
    assert _all_launches() == before
    for got, want in outs:
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_bluemagpie_f16_decode_past_cudnn_fault_lengths(dev, small_ggufs):
    """BlueMagpie's f16 decode_latent with its last stage at 72 000 frames
    (a causal depthwise conv where cuDNN's f16 kernel faults) runs clean
    without cuDNN and holds to the f32 decode; cuDNN is left as it was."""
    import codec_tpu_torch

    path = small_ggufs / "bluemagpie.gguf"
    f16 = codec_tpu_torch.load_model(path, compute_dtype="f16", device="cuda")
    f32 = codec_tpu_torch.load_model(path, device="cuda")
    z = np.random.default_rng(10).standard_normal((1, 12000, 8)).astype(
        np.float32)
    got = f16.decode_latent(z)
    torch.cuda.synchronize()
    assert torch.backends.cudnn.enabled
    want = f32.decode_latent(z)
    assert got.shape == want.shape == (1, 72000) and np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.fixture(scope="module")
def rest_files(tmp_path_factory):
    """Small LFM2-Audio and MOSS-TTS-Realtime files, their backbones (Q4_K;
    hidden 256) and a small Qwen3-MoE backbone (Q4_K attention)."""
    import dataclasses

    from codec_tpu_torch.models import lm_tts_init as lti
    from codec_tpu_torch.models.lm_init import (byte_fallback_vocab,
                                                spm_model_b64,
                                                write_random_backbone_gguf)
    from codec_tpu_torch.models.mimi import MimiConfig
    from codec_tpu_torch.models.moss_audio import MossConfig, MossModuleCfg

    tmp = tmp_path_factory.mktemp("rest")
    spm = spm_model_b64(byte_fallback_vocab())
    small = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                 ffn_dim=512, vocab_size=300, max_ctx=256)
    lfm2 = lti.write_lfm2_audio_gguf(
        tmp / "lfm2.gguf", seed=1, num_filters=8,
        lfm2=lti.Lfm2Config(hidden=256, depth_hidden=64, layers=1, heads=2,
                            kv_heads=1, ffn=128, n_codebook=4, audio_vocab=65,
                            eos_min_step=30, audio_start_id=298,
                            text_end_id=299, max_text_tokens=2),
        mimi_cfg=MimiConfig(n_q=4, codebook_size=64, codebook_dim=32,
                            hidden=64, n_layers=1, n_heads=1, head_dim=64,
                            intermediate=128, window=40))

    def stage(i, o, dur):
        return MossModuleCfg(1, 1, i, o, 64, 1, 1, dur, 10000.0)
    moss = MossConfig(sample_rate=24000, hop_size=4, n_q=4, codebook_size=16,
                      codebook_dim=8, latent_dim=64, rvq_dim=16,
                      number_channels=1,
                      enc_modules=(MossModuleCfg(0, 2), stage(2, 64, 0.001),
                                   MossModuleCfg(0, 2), stage(128, 64, 0.002)),
                      dec_modules=(stage(64, 128, 0.002), MossModuleCfg(0, 2),
                                   stage(64, 2, 0.001), MossModuleCfg(0, 2)))
    rt = lti.write_moss_realtime_gguf(
        tmp / "rt.gguf", seed=2, moss_cfg=moss,
        rt=lti.RealtimeConfig(hidden=256, layers=1, heads=2, kv_heads=1,
                              head_dim=64, ffn=128, n_codebook=4,
                              audio_vocab=19, eos_min_step=30, text_pad=0))
    bbs = {name: write_random_backbone_gguf(
        tmp / f"{name}.gguf", seed=3, spm_b64=spm, rope_scaling=None,
        cfg=dataclasses.replace(cfg, **small))
        for name, cfg in (("lfm2_bb", lti.LFM2_1_2B),
                          ("qwen3", lti.QWEN3_1_7B),
                          ("moe", dataclasses.replace(
                              lti.QWEN3_30B_A3B, n_experts=16,
                              n_experts_used=4, moe_ffn_dim=64)))}
    return lfm2, rt, bbs


def _rest_request(path, bb_path, dev, on_device, frames=6, **chain):
    import codec_tpu_torch
    from codec_tpu_torch.cli.tts_cli import run_text_audio_flow
    from codec_tpu_torch.io.gguf import GGUFReader
    from codec_tpu_torch.lm.audio_lm import AudioLM
    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.lm.prompt_info import build_prompt_info

    reader = GGUFReader(path)
    alm = AudioLM(reader, codec=codec_tpu_torch.load_model(path, device=dev),
                  device=dev)
    bb = LlamaBackbone(bb_path, quantized=True, device=dev)
    pi = build_prompt_info(reader, alm.lm.info)
    return run_text_audio_flow(alm, bb, pi, [3, 17, 42, 99, 150, 7],
                               max_steps=frames, on_device=on_device,
                               chunk_frames=4, **chain), bb, alm.lm


@pytest.mark.parametrize("flow", ["lfm2", "rt"])
def test_text_audio_flows_on_card(dev, rest_files, flow):
    """LFM2-Audio greedy and MOSS-TTS-Realtime (its host path at the
    family's sampler chain, NumPy's draws; its chunks greedy and sampled
    with the penalty, the noise drawn on the host) through the tts-cli
    branch: the card's codes equal the CPU's on the host path and in chunks
    of 4 (CUDA graphs on the card); LFM2's chunks equal its host path."""
    lfm2, rt, bbs = rest_files
    path, bb = (lfm2, bbs["lfm2_bb"]) if flow == "lfm2" else (rt, bbs["qwen3"])
    chains = [dict(temperature=0.0)]
    if flow == "rt":
        chains.append(dict(temperature=0.8, top_k=5, rep_penalty=1.3))
    host = _rest_request(path, bb, "cuda", False, temperature=0.0)[0]
    assert host.codes.shape == (6, 4) and np.isfinite(host.pcm).all()
    np.testing.assert_array_equal(
        _rest_request(path, bb, "cpu", False, temperature=0.0)[0].codes,
        host.codes)
    for chain in chains:
        got = _rest_request(path, bb, "cuda", True, **chain)[0]
        want = _rest_request(path, bb, "cpu", True, **chain)[0]
        np.testing.assert_array_equal(got.codes, want.codes)
        assert np.isfinite(got.pcm).all()
        if flow == "lfm2":
            np.testing.assert_array_equal(got.codes, host.codes)


def test_stream_chunk_graph_equals_eager(dev, rest_files):
    """The realtime stream chunk's replay gives the eager chunk's packed
    result, hidden, position and repetition ring bit for bit."""
    from codec_tpu_torch.lm.fused_gen import chunk_ctx, gen_chunk_cached

    _, rt, bbs = rest_files
    _, bb, lm = _rest_request(rt, bbs["qwen3"], "cuda", True, frames=4,
                              temperature=0.8, top_k=5, rep_penalty=1.3)
    runner = gen_chunk_cached(lm, bb, n_frames=4,
                              ctx=chunk_ctx(bb, 6 + 4 + 1), stream=True,
                              rep=(1.3, 50), temperature=0.8, top_k=5,
                              top_p=0.6)
    assert runner.graphed.graph is not None
    state = (runner.h, runner.pos, *runner.hist, runner.kv)
    saved = [t.clone() for t in state]
    eager = runner.graphed.eager().clone()
    after = [t.clone() for t in state]
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = runner.run().clone()
    torch.cuda.synchronize()
    assert torch.equal(eager, graph)
    assert all(torch.equal(a, t) for a, t in zip(after, state))


def test_moe_backbone_on_card_equals_cpu(dev, rest_files):
    """The Qwen3-MoE backbone on the card (its attention packed, its experts
    dense): a prefill of 8 rows (the dense form) and 4 steps (the gathered
    experts) within 1e-5 of the CPU's peak, 4 q4_k_matmul a layer a call."""
    from codec_tpu_torch.lm.backbone import LlamaBackbone
    from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul

    _, _, bbs = rest_files
    card = LlamaBackbone(bbs["moe"], quantized=True, device="cuda")
    cpu = LlamaBackbone(bbs["moe"], quantized=True, device="cpu")
    rows = card.embed_tokens(np.arange(12) * 7)
    before = q4_k_matmul.launches
    got = [card.prefill(rows[:8])] + [card.step(r) for r in rows[8:]]
    assert q4_k_matmul.launches - before == 4 * 2 * 5
    want = [cpu.prefill(rows[:8])] + [cpu.step(r) for r in rows[8:]]
    got, want = np.stack(got), np.stack(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
