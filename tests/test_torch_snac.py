"""The port's SNAC decode and its depthwise res-unit op
(codec_tpu_torch) against codec_tpu's on the CPU.

On a CPU tensor `snac_res_chain` runs its plain version, so the op tests
hold the plain version (the card's reference for the CUDA kernel) against
codec_tpu's Pallas kernel in interpret mode and against its plain f32 ops.
The model tests load one GGUF into both packages and decode the same codes
from a NumPy seed. f32 bound: correlation > 0.99999 and max abs error <=
1e-4 * peak, as for Mimi and DAC: the same f32 math with reductions in
other orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codec_tpu
import codec_tpu_torch
from codec_tpu.ops import act as jact
from codec_tpu.ops import conv as jconv
from codec_tpu.ops import seanet_pallas
from codec_tpu_torch import CodecError
from codec_tpu_torch.io.gguf import GGUFReader
from codec_tpu_torch.models import snac, snac_init
from codec_tpu_torch.ops import conv, seanet_cuda
from codec_tpu_torch.ops.seanet_cuda import snac_res_chain, snac_res_units

DILS = (1, 3, 9)
# the small width of tests/test_snac_parity.py: latent 64, decoder 32
# halving to 16/8/4/2, 3 codebooks of 64 x 8
SMALL = snac.SnacConfig(latent_dim=64, codebook_size=64, codebook_dim=8)
V = SMALL.codebook_size


def _units(rng, c, n, k=7, fan_in=False):
    """n depthwise units' weights, stacked: taps [n, K, C], w2 [n, C, C].
    Scales as tests/test_seanet_pallas.py's depthwise test (fan_in: std
    1/sqrt(K) and 1/sqrt(C) instead); alphas N(1, 0.5) with every fourth
    channel's sign flipped, so some are negative, as in trained SNAC."""
    f32 = lambda a: a.astype(np.float32)
    s1, s2, sb = ((1 / np.sqrt(k), 1 / np.sqrt(c), 0.1) if fan_in
                  else (0.2, 0.1, 0.1))

    def alpha():
        a = 1.0 + 0.5 * rng.standard_normal((n, c))
        a[:, ::4] *= -1
        return f32(a)

    return dict(w1=f32(rng.standard_normal((n, k, c)) * s1),
                b1=f32(rng.standard_normal((n, c)) * sb),
                w2=f32(rng.standard_normal((n, c, c)) * s2),
                b2=f32(rng.standard_normal((n, c)) * sb),
                a1=alpha(), a2=alpha())


def _port(x, u, dils, fn=snac_res_chain):
    t = torch.from_numpy
    return fn(t(x), t(u["w1"]), t(u["b1"]), t(u["a1"]), t(u["a2"]),
              t(u["w2"]), t(u["b2"]), dilations=dils).numpy()


def _jax_f32(x, u, dils):
    """codec_tpu's plain f32 ops: snake, depthwise conv1d, snake, 1x1, +x."""
    k, c = u["w1"].shape[1], x.shape[-1]
    y = jnp.asarray(x)
    for i, d in enumerate(dils):
        h = jact.snake(y, jnp.asarray(u["a1"][i]))
        h = jconv.conv1d(h, jnp.asarray(u["w1"][i])[:, None, :],
                         jnp.asarray(u["b1"][i]), dilation=d,
                         padding=((k - 1) * d) // 2, groups=c)
        h = jact.snake(h, jnp.asarray(u["a2"][i]))
        y = y + (h @ jnp.asarray(u["w2"][i]) + jnp.asarray(u["b2"][i]))
    return np.asarray(y)


def _assert_corr(got, want, bound):
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > bound, corr


# the bounds of tests/test_seanet_pallas.py's depthwise test: the Pallas
# kernel rounds its 1x1's operands to bf16; B = 2, a ragged last tile, T
# below the chain's halo of 39, and one unit alone
@pytest.mark.parametrize("b,t,tb,dils", [
    (1, 200, 64, DILS), (2, 130, 64, DILS), (1, 20, 64, DILS),
    (1, 1, 64, DILS), (2, 100, 32, (9,)), (1, 77, 32, (3,)),
])
def test_chain_matches_pallas_kernel(b, t, tb, dils):
    rng = np.random.default_rng(0)
    c = 8
    x = (rng.standard_normal((b, t, c)) * 0.3).astype(np.float32)
    u = _units(rng, c, len(dils))
    assert (u["a1"] < 0).any() and (u["a2"] < 0).any()
    want = np.asarray(seanet_pallas.snac_res_chain(
        jnp.asarray(x), u["w1"], u["b1"], u["a1"], u["a2"], u["w2"], u["b2"],
        dilations=dils, t_blk=tb, interpret=True))
    for fn in (seanet_cuda.snac_res_chain_ref, snac_res_chain,
               snac_res_units):
        got = _port(x, u, dils, fn)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=8e-2)
        _assert_corr(got, want, 0.9995)


# f32 against f32: the same math with sums in another order; weights at
# fan-in scale keep the activations near 1, so atol 1e-5 is ~1e-5 relative
@pytest.mark.parametrize("b,t,c,dils", [
    (2, 45, 16, DILS), (1, 20, 16, DILS), (1, 1, 8, DILS), (1, 130, 8, DILS),
    (2, 33, 24, (3,)),
])
def test_chain_matches_jax_f32_ops(b, t, c, dils):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    u = _units(rng, c, len(dils), fan_in=True)
    np.testing.assert_allclose(_port(x, u, dils), _jax_f32(x, u, dils),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("c,groups,k,d", [(12, 12, 7, 3), (12, 2, 5, 1),
                                          (8, 1, 3, 2)])
def test_conv1d_groups_matches_jax(c, groups, k, d):
    """conv1d with WIO weights [K, C_in/groups, C_out] (depthwise: [K, 1,
    C]) against codec_tpu's, f32 at 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, c)).astype(np.float32)
    w = (rng.standard_normal((k, c // groups, c)) / np.sqrt(k)).astype(
        np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    pad = (k - 1) * d // 2
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), dilation=d, padding=pad,
                                   groups=groups))
    got = conv.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), dilation=d, padding=pad,
                      groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


H100_SMEM = 232448      # opt-in shared memory per block of an H100


@pytest.mark.parametrize("dtype,c,tile", [
    (torch.float32, 512, 0), (torch.float32, 256, 32),
    (torch.float32, 128, 224), (torch.float32, 64, 512),
    (torch.bfloat16, 512, 0), (torch.bfloat16, 256, 64),
    (torch.bfloat16, 128, 288), (torch.bfloat16, 64, 512),
])
def test_gate_at_the_24khz_widths(dtype, c, tile):
    """The depthwise chain's tile where its state (all three halos, K=7)
    fits an H100's shared memory; the unit (N = 1: the depthwise pass and
    the 1x1 at snac_tile's tile), which a decode launches three times per
    block, fits at every width and dilation."""
    assert seanet_cuda.dw_chain_tile(c, 7, DILS, dtype, H100_SMEM) == tile
    for d in DILS:
        assert seanet_cuda.snac_unit_smem_bytes(
            c, 7, d, dtype, seanet_cuda.snac_tile(c, dtype)) <= H100_SMEM
    if tile:
        assert seanet_cuda.dw_chain_smem_bytes(c, 7, DILS, tile,
                                               dtype) <= H100_SMEM
    if 0 < tile < 512:
        assert seanet_cuda.dw_chain_smem_bytes(c, 7, DILS, tile + 32,
                                               dtype) > H100_SMEM
    # the gate bounds the summed halo: a longer kernel shrinks the tile
    assert seanet_cuda.dw_chain_tile(c, 11, DILS, dtype, H100_SMEM) <= tile


# SNAC's block widths: the decoder's (C, T at 20 s b1) and the encoder's
# after its pad to 2048
SNAC_BLOCKS = [(512, 7488), (256, 59904), (128, 239616), (64, 479232),
               (48, 481280), (96, 240640), (192, 60160), (384, 7520)]


@pytest.mark.parametrize("d", DILS)
@pytest.mark.parametrize("c,t", SNAC_BLOCKS)
def test_dw_pass_geometry(c, t, d):
    """The depthwise pass's blocks (csrc/snac_res.cu): rows a multiple of
    4·d (whole items of 4 outputs per residue class) of at most 256, 32
    channels each, staged with their halo as f32 (bf16: also as they
    land); at SNAC's dilations (halo 3d) three blocks fit an SM's 228 KB
    (the kernel's occupancy), and every block's rows are at least 4/5
    outputs (not halo)."""
    rows = seanet_cuda.dw_rows(d)
    assert rows % (4 * d) == 0 and 4 * d <= rows <= 256
    assert rows > 256 - 4 * d
    # f32 rows (snaked in place in f32), bf16 also the rows as they land
    assert seanet_cuda.dw_smem_bytes(7, d, torch.float32) == \
        (rows + 6 * d) * 32 * 4
    assert seanet_cuda.dw_smem_bytes(7, d, torch.bfloat16) == \
        (rows + 6 * d) * 32 * (4 + 2)
    for dtype in (torch.float32, torch.bfloat16):
        assert 3 * seanet_cuda.dw_smem_bytes(7, d, dtype) <= 228 * 1024
    assert rows / (rows + 6 * d) >= 0.8
    grid = (-(-t // rows), -(-c // 32))
    assert grid[0] * rows >= t and grid[1] * 32 >= c
    for dtype in (torch.float32, torch.bfloat16):
        tile = seanet_cuda.snac_tile(c, dtype, t)
        assert seanet_cuda.snac_unit_smem_bytes(c, 7, d, dtype,
                                                tile) <= H100_SMEM


@pytest.mark.parametrize("dtype,c,t,b,want", [
    # the faster of the 1x1's two tiles at each SNAC block in the sweep in
    # PERF.md (20 s b1, b4 at the decoder's widths, 2 s b1), or within
    # 7.3% (f32) and 10.4% (bf16) of it
    (torch.float32, 512, 7488, 1, (128, 128)), (torch.float32, 256, 59904, 1, (128, 128)),
    (torch.float32, 128, 239616, 1, (128, 128)), (torch.float32, 64, 479232, 1, (256, 64)),
    (torch.float32, 48, 481280, 1, (256, 64)), (torch.float32, 96, 240640, 1, (128, 128)),
    (torch.float32, 192, 60160, 1, (256, 64)), (torch.float32, 384, 7520, 1, (128, 128)),
    (torch.float32, 128, 239616, 4, (128, 128)), (torch.float32, 192, 6016, 1, (128, 128)),
    (torch.bfloat16, 512, 7488, 1, (128, 128)), (torch.bfloat16, 256, 59904, 1, (128, 128)),
    (torch.bfloat16, 128, 239616, 1, (128, 128)), (torch.bfloat16, 64, 479232, 1, (128, 64)),
    (torch.bfloat16, 48, 481280, 1, (128, 64)), (torch.bfloat16, 96, 240640, 1, (128, 128)),
    (torch.bfloat16, 192, 60160, 1, (128, 64)), (torch.bfloat16, 384, 7520, 1, (128, 128)),
    (torch.bfloat16, 256, 59904, 4, (128, 128)), (torch.bfloat16, 512, 748, 1, (128, 64)),
])
def test_snac_tile(dtype, c, t, b, want):
    """SNAC's 1x1 tile: of its two tiles per dtype, DAC's rule (the fewest
    outputs in the rounds over 132 SMs) with its own costs (no cost per
    pass, 8192 outputs per tile)."""
    assert seanet_cuda.snac_tile(c, dtype, t, b) == want
    assert want in seanet_cuda._SNAC_TILES[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snac_1x1_fits_two_x_tiles(dtype):
    """SNAC's 1x1 keeps two x tiles at each of its tiles (csrc: a
    static_assert), and DAC's 1x1 at the same tile one."""
    for tile in seanet_cuda._SNAC_TILES[dtype]:
        assert tile in seanet_cuda._UNIT_TILES[dtype]
        two = seanet_cuda.unit_smem_bytes(64, 7, 1, dtype, tile, True, 2)
        assert seanet_cuda.unit_smem_bytes(64, 7, 1, dtype, tile, True) <= \
            two <= H100_SMEM


def test_dw_rows_past_the_cap():
    """A dilation past 64 takes 4·d rows (one item per residue class)."""
    assert seanet_cuda.dw_rows(65) == 260
    assert seanet_cuda.dw_rows(64) == 256
    assert seanet_cuda.dw_rows(27) == 216


@pytest.mark.parametrize("b,t,c,d", [
    (1, 200, 8, 1), (2, 130, 16, 3), (1, 20, 8, 9), (1, 1, 8, 9),
    (2, 57, 12, 3),
])
def test_dw_halves_match_jax_and_compose_to_the_unit(b, t, c, d):
    """snac_dw_ref (x → the snaked hidden S) against codec_tpu's plain f32
    snake / depthwise conv1d / snake at 1e-5 (fan-in scale: values near
    1); the two halves composed equal snac_res_chain_ref at 1e-6 relative
    and codec_tpu's Pallas kernel (interpret mode) under its bf16 bounds
    (it rounds its 1x1's operands to bf16)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    u = _units(rng, c, 1, fan_in=True)
    k = u["w1"].shape[1]
    h = jact.snake(jnp.asarray(x), jnp.asarray(u["a1"][0]))
    h = jconv.conv1d(h, jnp.asarray(u["w1"][0])[:, None, :],
                     jnp.asarray(u["b1"][0]), dilation=d,
                     padding=((k - 1) * d) // 2, groups=c)
    want_s = np.asarray(jact.snake(h, jnp.asarray(u["a2"][0])))
    t_ = {key: torch.from_numpy(v) for key, v in u.items()}
    xt = torch.from_numpy(x)
    s = seanet_cuda.snac_dw_ref(xt, t_["w1"][0], t_["b1"][0], t_["a1"][0],
                                t_["a2"][0], d)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=0, atol=1e-5)
    got = seanet_cuda.snac_pointwise_ref(xt, s, t_["w2"][0], t_["b2"][0])
    chain = seanet_cuda.snac_res_chain_ref(xt, t_["w1"], t_["b1"], t_["a1"],
                                           t_["a2"], t_["w2"], t_["b2"],
                                           dilations=(d,))
    torch.testing.assert_close(got, chain, rtol=1e-6, atol=0)
    want = np.asarray(seanet_pallas.snac_res_chain(
        jnp.asarray(x), u["w1"], u["b1"], u["a1"], u["a2"], u["w2"], u["b2"],
        dilations=(d,), t_blk=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=8e-2)
    _assert_corr(got.numpy(), want, 0.9995)


def test_unit_rows_are_checked_and_cached_at_load(tiny):
    """The model builds each block's f32 rows once at load: they equal
    unit_vec's of its alphas and biases; the wrapper takes rows only of
    unit_vec's shape and type."""
    for blk in tiny["port"].params["dec_blocks"]:
        u = blk["units"]
        want = seanet_cuda.unit_vec(u["a1"], u["b1"], u["a2"], u["b2"])
        assert u["vec"].dtype == torch.float32 and u["vec"].is_contiguous()
        assert torch.equal(u["vec"], want)
        assert torch.equal(u["vec"][:, 1], 1.0 / (u["a1"].float() + 1e-9))
        vectors = (u["a1"], u["b1"], u["a2"], u["b2"])
        assert seanet_cuda._unit_rows("t", u["vec"], vectors, 1e-9) is u["vec"]
        for bad in (u["vec"][:2], u["vec"].double(), u["vec"].transpose(0, 1)):
            with pytest.raises(ValueError, match="vec must be"):
                seanet_cuda._unit_rows("t", bad, vectors, 1e-9)


def test_no_device_falls_back_to_the_plain_version():
    x = torch.zeros((1, 4, 8), device="meta")
    w1 = torch.zeros((3, 7, 8), device="meta")
    v = torch.zeros((3, 8), device="meta")
    w2 = torch.zeros((3, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        snac_res_chain(x, w1, v, v, v, w2, v)


def test_import_builds_nothing_and_needs_no_nvcc():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 9, 8)).astype(np.float32)
    _port(x, _units(rng, 8, 3), DILS, snac_res_units)
    assert seanet_cuda._lib.cache_info().currsize == 0
    assert seanet_cuda.smem_per_block.cache_info().currsize == 0


# -- the model ---------------------------------------------------------------

def _assert_close_pcm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    err = np.abs(got - want).max()
    peak = np.abs(want).max()
    assert corr > 0.99999, f"corr={corr}"
    assert err <= 1e-4 * peak, f"max abs err {err} vs peak {peak}"


def _codes(shape, v, seed):
    return np.random.default_rng(seed).integers(0, v, shape).astype(np.int32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("snac") / "tiny_snac.gguf"
    snac_init.write_random_snac_gguf(path, seed=0, cfg=SMALL, decoder_dim=32)
    return {"path": path, "jax": codec_tpu.load_model(path),
            "port": codec_tpu_torch.load_model(path, device="cpu")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def test_config_and_attrs_match(tiny):
    j, p = tiny["jax"], tiny["port"]
    assert p.arch == "snac" and "snac" in codec_tpu_torch.known_archs()
    assert p.cfg == snac.SnacConfig(**vars(j.cfg)) == SMALL
    for a in ("sample_rate", "hop_size", "n_q", "codebook_size", "latent_dim",
              "has_encoder", "has_decoder", "causal_time"):
        assert getattr(p, a) == getattr(j, a), a
    assert not p.has_encoder and not p.causal_time


def test_load_matches_params_from_jax(tiny):
    """load_snac_params reads the GGUF's PyTorch layouts; it must equal
    codec_tpu's load of the same file (WIO, depthwise [K, 1, C],
    pre-flipped convtrs), converted, bit for bit."""
    want = snac.params_from_jax(tiny["jax"].params)
    got = tiny["port"].params
    flat_w, flat_g = _leaves(want), _leaves(got)
    assert len(flat_w) == len(flat_g) > 0
    for a, b in zip(flat_w, flat_g):
        assert torch.equal(a, b)
        assert a.is_contiguous() and b.is_contiguous()   # the kernel's rule
    units = got["dec_blocks"][3]["units"]
    assert units["w1"].shape == (3, 7, 2) and units["w2"].shape == (3, 2, 2)


@pytest.mark.parametrize("t", [8, 64])
def test_decode_matches_jax(tiny, t):
    codes = _codes((t, 3), V, t)
    got = tiny["port"].decode(codes)
    want = tiny["jax"].decode(codes)
    assert got.shape == want.shape == (512 * t,)
    _assert_close_pcm(got, want)


def test_clipped_codes_match_jax(tiny):
    codes = _codes((12, 3), V, 1)
    codes[0, 0], codes[4, 1], codes[7, 2] = -3, 500, V
    _assert_close_pcm(tiny["port"].decode(codes), tiny["jax"].decode(codes))


def test_batched_decode_matches_single(tiny):
    p = tiny["port"]
    codes = _codes((3, 8, 3), V, 2)
    batched = p.decode(codes)
    assert batched.shape == (3, 512 * 8)
    # batching changes the order of the convs' f32 sums; the decoder's
    # activations reach about 6, so atol 1e-5 is ~2e-6 of their scale
    for i in range(3):
        np.testing.assert_allclose(batched[i], p.decode(codes[i]),
                                   rtol=1e-5, atol=1e-5)


def test_i16_within_one_step_of_jax(tiny):
    codes = _codes((16, 3), V, 3)
    got = tiny["port"].decode(codes, pcm_format="i16")
    want = tiny["jax"].decode(codes, pcm_format="i16")
    assert got.dtype == want.dtype == np.int16 and got.shape == want.shape
    # f32 reduction-order noise may move a sample across a rounding
    # boundary by one step
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("codes_shape,n_q", [
    ((6, 3), 0),            # T not a multiple of the coarsest stride
    ((2, 10, 3), 0),
    ((8, 3), 2),            # SNAC decodes all three levels
    ((8, 2), 0),
    ((8,), 0),
    ((0, 3), 0),
])
def test_bad_decode_arguments_raise(tiny, codes_shape, n_q):
    with pytest.raises(CodecError):
        tiny["port"].decode(np.zeros(codes_shape, np.int32), n_q=n_q)


def test_frames_must_be_a_multiple_of_four_in_both(tiny):
    codes = _codes((6, 3), V, 4)
    for model in (tiny["jax"], tiny["port"]):
        with pytest.raises(ValueError, match="multiple of 4"):
            model.decode(codes)


def test_encode_and_decode_latent_raise(tiny):
    """The fixture is decode-only: encode raises, and SNAC has no
    decode_latent in either package."""
    p = tiny["port"]
    with pytest.raises(CodecError, match="no encoder"):
        p.encode(np.zeros(2048, np.float32))
    with pytest.raises(CodecError, match="decode_latent not supported"):
        p.decode_latent(np.zeros((8, 64), np.float32))
    with pytest.raises(ValueError, match="decode_latent not supported"):
        tiny["jax"].decode_latent(np.zeros((8, 64), np.float32))


def test_bfloat16_compute_decodes(tiny):
    p16 = codec_tpu_torch.load_model(tiny["path"], compute_dtype="bfloat16",
                                     device="cpu")
    assert p16.params["dec_blocks"][0]["units"]["w1"].dtype == torch.bfloat16
    codes = _codes((8, 3), V, 7)
    got, want = p16.decode(codes), tiny["port"].decode(codes)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] > 0.99


def test_cli_info_and_decode(tiny, tmp_path, capsys):
    from codec_tpu_torch.cli.codec_cli import main
    from codec_tpu_torch.io.wav import read_wav, write_wav

    codes = _codes((8, 3), V, 8)
    np.save(tmp_path / "c.npy", codes)
    out = tmp_path / "o.wav"
    assert main(["info", "--model", str(tiny["path"])]) == 0
    info = capsys.readouterr().out
    assert "architecture: snac" in info and "codec.hop_size = 512" in info
    assert main(["decode", "--model", str(tiny["path"]), "--codes",
                 str(tmp_path / "c.npy"), "--out", str(out), "--device", "cpu",
                 "--dtype", "float32"]) == 0
    want = tmp_path / "want.wav"
    write_wav(want, tiny["port"].decode(codes), 24000)
    assert out.read_bytes() == want.read_bytes()
    x, sr = read_wav(out)
    assert sr == 24000 and x.shape == (512 * 8, 1)


def test_decode_fn_takes_a_res_units_hook(tiny):
    """snac_decode_fn runs the units through its hook; on the CPU the
    kernel's wrapper and the plain version are the same math."""
    p = tiny["port"]
    codes = torch.from_numpy(_codes((1, 8, 3), V, 10)).long()
    calls = []

    def hook(x, units):
        calls.append(tuple(x.shape))
        return snac.plain_res_units(x, units)

    with torch.inference_mode():
        got = snac.snac_decode_fn(p.params, codes, p.cfg, res_units=hook)
        want = snac.snac_decode_fn(p.params, codes, p.cfg)
    assert calls == [(1, 64, 16), (1, 512, 8), (1, 2048, 4), (1, 4096, 2)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_random_params_shapes():
    p = snac_init.random_snac_params(SMALL, seed=0, decoder_dim=32)
    assert p["snac.q.2.out_proj.w"].shape == (64, 8, 1)
    assert p["snac.q.0.in_proj.w"].shape == (8, 64, 1)
    assert p["snac.dec.conv_in_dw.w"].shape == (64, 1, 7)
    assert p["snac.dec.conv_in_pw.w"].shape == (32, 64, 1)
    assert p["snac.dec.b0.convtr.w"].shape == (32, 16, 16)
    assert p["snac.dec.b3.r2.conv1.w"].shape == (2, 1, 7)
    assert p["snac.dec.b3.r2.conv2.w"].shape == (2, 2, 1)
    assert p["snac.dec.conv_final.w"].shape == (1, 2, 7)
    alphas = np.concatenate([v for k, v in p.items() if k.endswith(".alpha")])
    assert (alphas < 0).any() and abs(alphas.mean() - 1) < 0.1
    assert np.array_equal(p["snac.q.1.codebook"], snac_init.random_snac_params(
        SMALL, seed=0, decoder_dim=32)["snac.q.1.codebook"])
    with pytest.raises(ValueError, match="rates"):
        snac_init.random_snac_params(snac.SnacConfig(decoder_rates=(8, 8, 4)))


def test_full_width_random_gguf_decodes_alike_in_both(tmp_path):
    """hubertsiuzdak/snac_24khz widths (latent 768, decoder 1024, rates
    8/8/4/2, 3 x 4096 x 8 codebooks) with random weights from a seed,
    T = 8 frames; the output is not saturated."""
    path = tmp_path / "snac_full.gguf"
    snac_init.write_random_snac_gguf(path, seed=0)
    j = codec_tpu.load_model(path)
    p = codec_tpu_torch.load_model(path, device="cpu")
    assert p.cfg == snac.SnacConfig() and GGUFReader(path).architecture == "snac"
    assert [tuple(b["units"]["w1"].shape) for b in p.params["dec_blocks"]] == [
        (3, 7, c) for c in (512, 256, 128, 64)]
    codes = _codes((8, 3), 4096, 9)
    got = p.decode(codes)
    assert got.shape == (512 * 8,)
    _assert_close_pcm(got, j.decode(codes))
    assert (np.abs(got) > 0.99).mean() < 0.01
