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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,d", [
    (1, 20, 96, 9),        # T below the halo
    (2, 100, 16, 3),       # B = 2, a ragged last tile
    (1, 200, 8, 1),
    (1, 333, 384, 9),      # two column passes
    (1, 64, 768, 1),       # three column passes
    (1, 37, 40, 3),        # C no multiple of 32
    (1, 45, 20, 9),        # C no multiple of 8: bf16 weights load unvectorized
    (2, 50, 6, 3),         # C no multiple of 4: so do f32 weights
])
def test_res_unit_kernel_matches_plain(dev, dtype, b, t, c, d):
    p = _res_params(1, c, dtype, dev, seed=b * t + c)
    x = _x((b, t, c), dtype, dev, seed=2)
    got = seanet_cuda.seanet_res_unit(x, *_unit_args(p), dilation=d)
    _check_against_plain(got, x, p, dtype, lambda x, p: _unit_ref(x, p, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c", [
    (1, 20, 192),          # T far below the chain's halo of 39
    (2, 100, 96),
    (1, 700, 192),         # several tiles of 128 rows
    (1, 1000, 8),
    (1, 77, 40),
    (1, 90, 6),
])
def test_res_chain_kernel_matches_plain(dev, dtype, b, t, c):
    p = _res_params(3, c, dtype, dev, seed=t + c)
    x = _x((b, t, c), dtype, dev, seed=3)
    got = seanet_cuda.seanet_res_chain(x, **p, dilations=DILS)
    _check_against_plain(got, x, p, dtype, _chain_ref)


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
        x = x.half()
        p = {k: v.half() for k, v in p.items()}
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
    """Decoder widths 384/192/96/48: blocks 1-2 run three unit launches
    each, blocks 3-4 one chain launch each (the gate at an H100's shared
    memory); the card's decode agrees with the port on the CPU at the f32
    bound of tests/test_torch_dac.py."""
    import codec_tpu_torch

    gpu = codec_tpu_torch.load_model(small_dac_gguf, device="cuda")
    cpu = codec_tpu_torch.load_model(small_dac_gguf, device="cpu")
    limit = seanet_cuda.smem_per_block(0)
    chains = sum(seanet_cuda.use_chain(c, 7, DILS, torch.float32, limit)
                 for c in (384, 192, 96, 48))
    assert 0 < chains < 4
    codes = np.random.default_rng(5).integers(0, 64, (2, 30, 4)).astype(np.int32)
    unit0, chain0 = (seanet_cuda.seanet_res_unit.launches,
                     seanet_cuda.seanet_res_chain.launches)
    got = gpu.decode(codes)
    assert seanet_cuda.seanet_res_chain.launches == chain0 + chains
    assert seanet_cuda.seanet_res_unit.launches == unit0 + 3 * (4 - chains)
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
        x = x.half()
        p = {k: v.half() for k, v in p.items()}
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
    through snac_res_chain, one N = 1 launch each; the card's decode
    agrees with the port on the CPU at the f32 bound of
    tests/test_torch_snac.py."""
    import codec_tpu_torch

    gpu = codec_tpu_torch.load_model(small_snac_gguf, device="cuda")
    cpu = codec_tpu_torch.load_model(small_snac_gguf, device="cpu")
    codes = np.random.default_rng(6).integers(0, 64, (2, 16, 3)).astype(np.int32)
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
# shapes of tests/test_rvq_pallas.py, D no multiple of 4 (4-byte staging)
# and V above 8 x 256 (several row tiles per block)
RVQ_SHAPES = [(1, 250, 256, 31, 2048), (1, 250, 256, 1, 2048),
              (4, 250, 256, 31, 2048), (1, 7, 32, 4, 64), (1, 130, 96, 3, 100),
              (2, 33, 30, 3, 70), (1, 40, 64, 2, 5000)]


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


@pytest.mark.parametrize("case", ["bf16", "cpu_codebook", "layout", "dim"])
def test_rvq_kernel_rejects_what_it_does_not_take(dev, case):
    from codec_tpu_torch.ops.rvq_cuda import rvq_encode_fused

    x, cb = _rvq_inputs(1, 16, 32, 2, 40, dev, "normal")
    if case == "bf16":
        x, cb = x.bfloat16(), cb.bfloat16()
    elif case == "cpu_codebook":
        cb = cb.cpu()
    elif case == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        cb = cb[..., :16].contiguous()
    with pytest.raises(ValueError):
        rvq_encode_fused(x, cb)


# the encoders' widths: DAC's units at C = 64 (T = n) and 512 (T = n/40),
# SNAC's at C = 48 (T = n, no multiple of the 32-channel staging) and 384
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,c", [(4000, 64), (300, 512)])
def test_res_units_at_the_dac_encoder_widths(dev, dtype, t, c):
    p = _res_params(3, c, dtype, dev, seed=c)
    x = _x((1, t, c), dtype, dev, seed=5)
    got = seanet_cuda.seanet_res_units(x, **p, dilations=DILS)
    _check_against_plain(got, x, p, dtype, _chain_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
