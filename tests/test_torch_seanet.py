"""The port's fused SEANet res-unit ops (codec_tpu_torch.ops.seanet_cuda)
against codec_tpu's on the CPU.

On a CPU tensor each wrapper runs its plain version, so these tests hold
the plain versions (the card's reference for the CUDA kernels) against
codec_tpu's Pallas kernels in interpret mode and against its plain f32
ops. Inputs come from NumPy seeds and go to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.ops import act as jact
from codec_tpu.ops import conv as jconv
from codec_tpu.ops import seanet_pallas
from codec_tpu_torch.ops import seanet_cuda
from codec_tpu_torch.ops.seanet_cuda import (seanet_res_chain,
                                             seanet_res_unit,
                                             seanet_res_units)

DILS = (1, 3, 9)


def _unit_params(rng, c, k=7, w_scale=0.2):
    """One unit's weights as in tests/test_seanet_pallas.py (w_scale=None:
    fan-in scale, std 1/sqrt(K*C))."""
    s1 = 1 / np.sqrt(k * c) if w_scale is None else w_scale
    s2 = 1 / np.sqrt(c) if w_scale is None else w_scale
    f32 = lambda a: a.astype(np.float32)
    return dict(w1=f32(rng.standard_normal((k, c, c)) * s1),
                b1=f32(rng.standard_normal(c)),
                w2=f32(rng.standard_normal((c, c)) * s2),
                b2=f32(rng.standard_normal(c)),
                a1=f32(np.abs(rng.standard_normal(c)) + 0.2),
                a2=f32(np.abs(rng.standard_normal(c)) + 0.2))


def _stacked(units):
    return {k: np.stack([u[k] for u in units]) for k in units[0]}


def _port_unit(x, u, d):
    t = torch.from_numpy
    return seanet_res_unit(t(x), t(u["a1"]), t(u["w1"]), t(u["b1"]),
                           t(u["a2"]), t(u["w2"]), t(u["b2"]),
                           dilation=d).numpy()


def _port_chain(x, s, fn=seanet_res_chain):
    t = torch.from_numpy
    return fn(t(x), t(s["w1"]), t(s["b1"]), t(s["a1"]), t(s["a2"]),
              t(s["w2"]), t(s["b2"]), dilations=DILS).numpy()


def _jax_unit_f32(x, u, d):
    """codec_tpu's plain f32 ops: snake, conv1d, snake, 1x1, +x."""
    j = {k: jnp.asarray(v) for k, v in u.items()}
    k = u["w1"].shape[0]
    h = jact.snake(jnp.asarray(x), j["a1"])
    h = jconv.conv1d(h, j["w1"], j["b1"], dilation=d,
                     padding=((k - 1) * d) // 2)
    h = jact.snake(h, j["a2"])
    return np.asarray(jnp.asarray(x) + (h @ j["w2"] + j["b2"]))


def _assert_corr(got, want, bound):
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > bound, corr


# the shapes and bounds of tests/test_seanet_pallas.py: the Pallas kernel
# rounds its matmul operands to bf16, which bounds the agreement
@pytest.mark.parametrize("b,t,c,d,tb", [
    (2, 200, 8, 1, 64),
    (1, 200, 8, 3, 64),
    (1, 130, 16, 9, 32),
    (1, 64, 8, 1, 64),
])
def test_unit_matches_pallas_kernel(b, t, c, d, tb):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    u = _unit_params(rng, c)
    want = np.asarray(seanet_pallas.seanet_res_unit(
        jnp.asarray(x), u["a1"], u["w1"], u["b1"], u["a2"], u["w2"], u["b2"],
        dilation=d, t_blk=tb, interpret=True))
    got = _port_unit(x, u, d)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2)
    _assert_corr(got, want, 0.9999)


@pytest.mark.parametrize("b,t,tb", [(1, 200, 64), (2, 130, 64), (1, 64, 64)])
def test_chain_matches_pallas_kernel(b, t, tb):
    rng = np.random.default_rng(1)
    c = 8
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    s = _stacked([_unit_params(rng, c) for _ in DILS])
    want = np.asarray(seanet_pallas.seanet_res_chain(
        jnp.asarray(x), s["w1"], s["b1"], s["a1"], s["a2"], s["w2"], s["b2"],
        dilations=DILS, t_blk=tb, interpret=True))
    for fn in (seanet_res_chain, seanet_res_units):
        got = _port_chain(x, s, fn)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=8e-2)
        _assert_corr(got, want, 0.9995)


# f32 against f32: the same math with sums in another order; weights at
# fan-in scale keep every activation near 1, so atol 1e-5 is ~1e-5
# relative. B=2, a T that is no multiple of 32, and T below the halo.
@pytest.mark.parametrize("b,t,c,d", [
    (2, 45, 16, 1), (1, 77, 24, 3), (1, 20, 16, 9), (2, 5, 8, 9),
    (1, 1, 8, 3),
])
def test_unit_matches_jax_f32_ops(b, t, c, d):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    u = _unit_params(rng, c, w_scale=None)
    np.testing.assert_allclose(_port_unit(x, u, d), _jax_unit_f32(x, u, d),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,t,c", [(2, 45, 16), (1, 20, 16), (1, 130, 8)])
def test_chain_matches_jax_f32_ops(b, t, c):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    units = [_unit_params(rng, c, w_scale=None) for _ in DILS]
    want = x
    for u, d in zip(units, DILS):
        want = _jax_unit_f32(want, u, d)
    np.testing.assert_allclose(_port_chain(x, _stacked(units)), want,
                               rtol=0, atol=1e-5)


def test_sin2_matches_jax_and_sin():
    """The kernels' sin² formula: the port's statement of it against the
    reference's `_sin2` (same f32 formula, 1e-6), and against sin²: the
    series stops at r⁹, whose remainder at |r| = π/2 makes sin² off by
    up to 7.2e-6 (bound 1e-5)."""
    rng = np.random.default_rng(4)
    y = np.concatenate([np.linspace(-40, 40, 4001),
                        rng.standard_normal(4000) * 10]).astype(np.float32)
    got = seanet_cuda.sin2(torch.from_numpy(y)).numpy()
    want = np.asarray(seanet_pallas._sin2(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.sin(y.astype(np.float64)) ** 2,
                               rtol=0, atol=1e-5)


H100_SMEM = 232448      # opt-in shared memory per block of an H100


@pytest.mark.parametrize("dtype,c,tile", [
    (torch.float32, 768, 0), (torch.float32, 384, 0),
    (torch.float32, 192, 32), (torch.float32, 96, 224),
    (torch.float32, 64, 288), (torch.float32, 128, 96),
    (torch.float32, 256, 0), (torch.float32, 512, 0),
    (torch.bfloat16, 768, 0), (torch.bfloat16, 384, 0),
    (torch.bfloat16, 192, 96), (torch.bfloat16, 96, 288),
    (torch.bfloat16, 64, 512), (torch.bfloat16, 128, 192),
    (torch.bfloat16, 256, 32), (torch.bfloat16, 512, 0),
])
def test_gate_at_the_24khz_widths(dtype, c, tile):
    """The chain's rows of state where they fit, at the DAC decoder and
    encoder widths, at its one product tile per width (bf16 128 x 64; f32
    the one pass that covers C); the gate takes it in bf16 where all 512
    rows fit, so only at bf16 C64 (the encoder's first block): every
    decode runs 12 unit launches, the bf16 encode 9 and one chain. The
    unit's tile fits both of its launches."""
    block = seanet_cuda.chain_block(c, dtype)
    assert block == ((128, 64) if dtype == torch.bfloat16 else
                     (256, 64) if c <= 64 else (128, 128) if c <= 128
                     else (64, 256))
    assert seanet_cuda.chain_tile(c, 7, DILS, dtype, H100_SMEM) == tile
    assert seanet_cuda.use_chain(c, 7, DILS, dtype, H100_SMEM) == (
        dtype == torch.bfloat16 and c == 64)
    unit = seanet_cuda.unit_tile(c, dtype)
    for pointwise in (False, True):
        assert seanet_cuda.unit_smem_bytes(c, 7, 9, dtype, unit,
                                           pointwise) <= H100_SMEM
    if tile:
        assert seanet_cuda.chain_smem_bytes(c, 7, DILS, tile, dtype,
                                            block) <= H100_SMEM
        assert tile == 512 or seanet_cuda.chain_smem_bytes(
            c, 7, DILS, tile + 32, dtype, block) > H100_SMEM


@pytest.mark.parametrize("kernel,dtype,c,t,want", [
    # SNAC's kernel: (rows per warp, pass width)
    ("snac", torch.float32, 768, 0, (8, 6)), ("snac", torch.float32, 384, 0, (4, 6)),
    ("snac", torch.float32, 192, 0, (4, 6)), ("snac", torch.float32, 96, 0, (4, 3)),
    ("snac", torch.float32, 8, 0, (4, 1)), ("snac", torch.float32, 300, 0, (4, 6)),
    ("snac", torch.float32, 40, 0, (4, 2)), ("snac", torch.float32, 512, 0, (8, 8)),
    ("snac", torch.float32, 1024, 0, (8, 8)),
    ("snac", torch.bfloat16, 768, 0, (32, 6)), ("snac", torch.bfloat16, 384, 0, (32, 6)),
    ("snac", torch.bfloat16, 192, 0, (32, 3)), ("snac", torch.bfloat16, 96, 0, (32, 2)),
    ("snac", torch.bfloat16, 8, 0, (32, 1)), ("snac", torch.bfloat16, 1000, 0, (32, 6)),
    # the DAC unit's: (rows per block, columns per pass) at 20 s b1, the
    # fastest of its tiles in the sweep in PERF.md (f32 C768 and C96:
    # within 1% of it)
    ("dac", torch.float32, 768, 12000, (64, 256)),
    ("dac", torch.float32, 384, 60000, (128, 128)),
    ("dac", torch.float32, 192, 240000, (256, 64)),
    ("dac", torch.float32, 96, 480000, (128, 128)),
    ("dac", torch.float32, 64, 480000, (256, 64)),
    ("dac", torch.float32, 128, 240000, (128, 128)),
    ("dac", torch.float32, 256, 60000, (64, 256)),
    ("dac", torch.float32, 40, 0, (256, 64)),
    ("dac", torch.bfloat16, 768, 12000, (128, 192)),
    ("dac", torch.bfloat16, 384, 60000, (128, 128)),
    ("dac", torch.bfloat16, 192, 240000, (128, 192)),
    ("dac", torch.bfloat16, 96, 480000, (256, 128)),
    ("dac", torch.bfloat16, 64, 480000, (128, 64)),
    ("dac", torch.bfloat16, 128, 240000, (128, 128)),
    ("dac", torch.bfloat16, 256, 60000, (256, 128)),
    ("dac", torch.bfloat16, 512, 12000, (128, 128)),
    ("dac", torch.bfloat16, 768, 0, (128, 192)),
])
def test_tile_width(kernel, dtype, c, t, want):
    """SNAC: rows per warp and the fewest passes (f32: 32·TN columns, 64·TN
    from C = 512 with 8 rows per warp; bf16: 64·NT), split evenly. The DAC
    unit: the tile whose waves over 132 SMs cost least (outputs, with a
    pass's and a block's fixed cost; t = 0: the fewest columns past C),
    then the widest pass."""
    if kernel == "snac":
        assert seanet_cuda.tile_width(c, dtype) == want[1]
        assert seanet_cuda._tile_args(c, dtype)[:2] == want
    else:
        assert seanet_cuda.unit_tile(c, dtype, t) == want
        assert want in seanet_cuda._UNIT_TILES[dtype]


def test_import_builds_nothing_and_needs_no_nvcc():
    """The wrappers ran their plain versions above; nothing loaded the
    library or asked a device for its shared memory."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 9, 8)).astype(np.float32)
    _port_chain(x, _stacked([_unit_params(rng, 8) for _ in DILS]),
                seanet_res_units)
    assert seanet_cuda._lib.cache_info().currsize == 0
    assert seanet_cuda.smem_per_block.cache_info().currsize == 0


def test_no_device_falls_back_to_the_plain_version():
    x = torch.zeros((1, 4, 8), device="meta")
    w1 = torch.zeros((7, 8, 8), device="meta")
    v = torch.zeros(8, device="meta")
    w2 = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        seanet_res_unit(x, v, w1, v, v, w2, v)
    with pytest.raises(ValueError, match="no kernel for device"):
        seanet_res_chain(x, w1[None].expand(3, -1, -1, -1), v[None], v[None],
                         v[None], w2[None], v[None])


def test_compare_sass_splits_kernels_and_drops_file_hashes():
    """The SASS comparison tool (used to show that moving code into a
    shared header left the compiled kernels alone) keys kernels by name
    with the per-file namespace hash taken out."""
    from codec_tpu_torch.tools.compare_sass import sass_by_kernel

    def dump(file_hash, body):
        ns = f"_GLOBAL__N__{file_hash}_11_seanet_res_cu_47380782"
        return (f"\n\tcode for sm_90a\n\t\tFunction : _ZN44{ns}"
                f"20seanet_res_unit_kernelIfEEvv\n{body}\n"
                f"\t\tFunction : _Z3fooIfEvv\n  MOV R1, c[0x0][0x28] ;\n")

    a = sass_by_kernel(dump("f6ec251a", "  FFMA R0, R1, R2, R0 ;"))
    b = sass_by_kernel(dump("0badcafe", "  FFMA R0, R1, R2, R0 ;"))
    c = sass_by_kernel(dump("0badcafe", "  FFMA R0, R2, R1, R0 ;"))
    name = "_ZN44ANON20seanet_res_unit_kernelIfEEvv"
    assert sorted(a) == sorted(b) == sorted([name, "_Z3fooIfEvv"])
    assert a == b and a[name] != c[name]


def test_compare_sass_ignores_the_blank_lines_that_end_a_dump():
    """The last kernel of a dump carries the dump's ending; two builds may
    end it with more or fewer blank lines, which do not make its SASS
    differ."""
    from codec_tpu_torch.tools.compare_sass import sass_by_kernel

    body = ("\n\tcode for sm_90a\n\t\tFunction : _Z3foov\n  MOV R1, "
            "c[0x0][0x28] ;\n\t\tFunction : _Z3barv\n  FFMA R0, R1, R2, "
            "R0 ;\n  EXIT ;\n\t\t..........")
    a, b = sass_by_kernel(body), sass_by_kernel(body + "\n\n\n")
    assert a == b
    assert a["_Z3foov"] == "  MOV R1, c[0x0][0x28] ;"
    assert a["_Z3barv"].endswith("EXIT ;\n\t\t..........")
    assert sass_by_kernel(body.replace("R2, R0", "R2, R1")) != a
