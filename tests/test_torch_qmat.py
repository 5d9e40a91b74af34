"""The port's packed Q8_0/Q4_K weights and `qmatmul` (codec_tpu_torch/ops/
qmat.py) against codec_tpu's on the CPU, plus the small ops of the LM
slice (rms_norm, rope with llama3 freq factors).

Packing is checked bit for bit: the port's dequantized weights equal the
GGUF dequantizer's and codec_tpu's `dequant_ref` exactly. Products use
f32 on both sides, so they agree to rtol = atol = 1e-5 (sums taken in
another order), except against codec_tpu's TPU kernels in interpret
mode: those round x and the dequantized weights to bf16 for the MXU, so
they are held at that test's bf16 bounds (tests/test_qmat_pallas.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tpu.io.gguf import GGUFReader as JaxReader
from codec_tpu.io.gguf import GGUFWriter as JaxWriter
from codec_tpu.lm import backbone as jbackbone
from codec_tpu.ops import norms as jnorms
from codec_tpu.ops import qmat_pallas as jq
from codec_tpu.ops import rope as jrope
from codec_tpu_torch.io.gguf import (GGUFReader, dequantize_q4_k,
                                     dequantize_q8_0, quantize_q4_k,
                                     quantize_q8_0)
from codec_tpu_torch.ops import norms, qmat, rope
from codec_tpu_torch.ops.qmat_cuda import q4_k_matmul, q8_0_matmul

SHAPES = [(128, 256), (128, 512), (64, 8192)]
QUANT = {"Q8_0": (quantize_q8_0, dequantize_q8_0, qmat.pack_q8_0, jq.pack_q8_0),
         "Q4_K": (quantize_q4_k, dequantize_q4_k, qmat.pack_q4_k, jq.pack_q4_k)}


def _raw(qtype, shape, seed=0):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    return np.frombuffer(QUANT[qtype][0](w), np.uint8)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("qtype", list(QUANT))
@pytest.mark.parametrize("shape", SHAPES)
def test_dequant_bit_exact(qtype, shape):
    raw = _raw(qtype, shape)
    _, dequant, pack, jpack = QUANT[qtype]
    gguf = dequant(raw.tobytes(), int(np.prod(shape))).reshape(shape)
    got = qmat.dequant_ref(qmat.to_device(pack(raw, shape), "cpu")).numpy()
    ref = np.asarray(jq.dequant_ref(jpack(raw, shape)))
    np.testing.assert_array_equal(_bits(got), _bits(gguf))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("qtype", list(QUANT))
def test_natural_order_repacks_reference_packing(qtype):
    shape = (64, 512)
    raw = _raw(qtype, shape, seed=1)
    _, _, pack, jpack = QUANT[qtype]
    mine, theirs = pack(raw, shape), qmat.natural_order(jpack(raw, shape))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_q4_k_natural_packing_layout():
    """One 16-byte row chunk is one 32-group: byte j holds element 32g+j
    (low nibble) and 32g+16+j (high nibble)."""
    shape = (4, 256)
    raw = _raw("Q4_K", shape, seed=2)
    qt = qmat.pack_q4_k(raw, shape)
    w = qmat.dequant_ref(qmat.to_device(qt, "cpu")).numpy()
    s, mv = qt["scale"], qt["minv"]
    for g in (0, 3, 7):
        for j in (0, 5, 15):
            b = int(qt["qs"][2, 16 * g + j])
            assert w[2, 32 * g + j] == np.float32(np.float32(b & 15) * s[2, g]) - mv[2, g]
            assert w[2, 32 * g + 16 + j] == np.float32(np.float32(b >> 4) * s[2, g]) - mv[2, g]


def _gguf_pair(tmp_path, qtype, shape=(96, 512)):
    w = (np.random.default_rng(3).standard_normal(shape) * 0.1).astype(np.float32)
    path = tmp_path / "m.gguf"
    jw = JaxWriter(path, "llama_backbone")
    jw.add_tensor("m", w, qtype)
    jw.write()
    return path


@pytest.mark.parametrize("qtype", list(QUANT))
def test_get_raw_quant_and_pack_tensor(tmp_path, qtype):
    path = _gguf_pair(tmp_path, qtype)
    kind, raw, shape = GGUFReader(path).get_raw_quant("m")
    jkind, jraw, jshape = JaxReader(path).get_raw_quant("m")
    assert (kind, shape) == (jkind, tuple(jshape)) == (qtype, (96, 512))
    np.testing.assert_array_equal(np.asarray(raw), np.asarray(jraw))
    qt = qmat.pack_tensor(GGUFReader(path), "m")
    want = JaxReader(path).get("m")
    got = qmat.dequant_ref(qmat.to_device(qt, "cpu")).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pack_tensor_rejects_dense(tmp_path):
    path = _gguf_pair(tmp_path, "F32")
    with pytest.raises(ValueError, match="no packed path"):
        qmat.pack_tensor(GGUFReader(path), "m")


@pytest.fixture(scope="module")
def packed():
    """{qtype: (port packed dict on the CPU, codec_tpu packed dict)} for a
    [96, 512] matrix."""
    out = {}
    for qtype, (_, _, pack, jpack) in QUANT.items():
        raw = _raw(qtype, (96, 512), seed=4)
        out[qtype] = (qmat.to_device(pack(raw, (96, 512)), "cpu"),
                      {k: jnp.asarray(v) for k, v in jpack(raw, (96, 512)).items()})
    return out


@pytest.mark.parametrize("qtype", list(QUANT))
@pytest.mark.parametrize("lead", [(3, 5), (1,), (4,), (40,)])
def test_qmatmul_matches_reference_cpu_path(packed, qtype, lead):
    qt, jqt = packed[qtype]
    x = np.random.default_rng(5).standard_normal(lead + (512,)).astype(np.float32)
    got = qmat.qmatmul(torch.from_numpy(x), qt)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt))
    assert got.dtype == torch.float32 and tuple(got.shape) == lead + (96,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qtype,atol", [("Q8_0", 3e-2), ("Q4_K", 8e-2)])
@pytest.mark.parametrize("m", [1, 4])
def test_plain_versions_match_tpu_kernels_interpret(packed, qtype, atol, m):
    """The TPU kernels round x and w·s to bf16 for the MXU, the port keeps
    f32: held at tests/test_qmat_pallas.py's bf16 bounds."""
    qt, jqt = packed[qtype]
    x = np.random.default_rng(6).standard_normal((m, 512)).astype(np.float32)
    if qtype == "Q8_0":
        got = q8_0_matmul(torch.from_numpy(x), qt["qs"], qt["scale"]).numpy()
        want = np.asarray(jq.q8_0_matmul(jnp.asarray(x), jqt["qs"], jqt["scale"],
                                         interpret=True))
    else:
        got = q4_k_matmul(torch.from_numpy(x), qt["qs"], qt["scale"],
                          qt["minv"]).numpy()
        want = np.asarray(jq.q4_k_matmul(jnp.asarray(x), jqt["qs"], jqt["scale"],
                                         jqt["minv"], interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=atol)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_wrappers_on_cpu_run_plain_versions_uncounted(packed):
    qt, _ = packed["Q4_K"]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 512))
                         .astype(np.float32))
    before = (q8_0_matmul.launches, q4_k_matmul.launches)
    got = q4_k_matmul(x, qt["qs"], qt["scale"], qt["minv"])
    torch.testing.assert_close(got, qmat.q4_k_matmul_ref(x, qt["qs"], qt["scale"],
                                                         qt["minv"]), rtol=0, atol=0)
    q8, _ = packed["Q8_0"]
    q8_0_matmul(x, q8["qs"], q8["scale"])
    assert (q8_0_matmul.launches, q4_k_matmul.launches) == before


def test_qmatmul_raises_on_bad_width(packed):
    qt, _ = packed["Q8_0"]
    with pytest.raises(ValueError, match="multiple of 32"):
        qmat.qmatmul(torch.zeros((1, 500)), qt)
    bad = {"qs": torch.zeros((4, 40), dtype=torch.int8),
           "scale": torch.ones((4, 1))}
    with pytest.raises(ValueError, match="multiple of 32"):
        qmat.qmatmul(torch.zeros((1, 40)), bad)
    with pytest.raises(ValueError, match="in % 256"):
        qmat.pack_q4_k(np.zeros(144 * 2, np.uint8), (2, 288))


def test_rms_norm_matches():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("neox", [True, False])
def test_rope_matches(neox):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 4, 6, 64)).astype(np.float32)
    pos = np.arange(40, 46)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=500000.0, neox=neox)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       theta=500000.0, neox=neox))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rope_llama3_freq_factors_match_backbone_rope():
    from codec_tpu_torch.models.lm_init import LLAMA3_SCALING, llama3_freq_factors

    from codec_tpu.convert.backbone import llama3_freq_factors as jff

    ff = llama3_freq_factors(64, 500000.0, LLAMA3_SCALING)
    np.testing.assert_array_equal(ff, jff(64, 500000.0, LLAMA3_SCALING))
    cfg = jbackbone.BackboneConfig(hidden=256, n_layers=1, n_heads=4,
                                   n_kv_heads=4, head_dim=64, ffn_dim=1,
                                   vocab_size=1, rope_theta=500000.0)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((1, 4, 5, 64)).astype(np.float32)
    pos = np.arange(1500, 1505)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=500000.0, freq_factors=torch.from_numpy(ff))
    want = np.asarray(jbackbone._rope(jnp.asarray(x), jnp.asarray(pos), cfg,
                                      jnp.asarray(ff)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- the CUDA kernels' launch plan (ops/qmat_cuda.py::plan) ---------------------

BACKBONE = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]
GPU_TEST_SHAPES = [(96, 512), (520, 256), (64, 2048), (200, 1024), (128, 512),
                   (64, 256), (96, 160)]


@pytest.mark.parametrize("m", [1, 2, 16, 17, 32])
@pytest.mark.parametrize("kind,out_d,in_d", [
    (k, o, i) for k in ("q8_0", "q4_k") for o, i in BACKBONE + GPU_TEST_SHAPES
    if k == "q8_0" or i % 256 == 0])
def test_plan_splits_k_into_whole_chunks(kind, out_d, in_d, m):
    """K splits into equal slices of whole chunks, x passes are whole
    chunks, tensor copies take whole boxes from 16-byte-strided rows, and
    the ring and x fit the block's shared memory."""
    from codec_tpu_torch.ops import qmat_cuda as qc

    p = qc.plan(kind, m, in_d, out_d)
    assert 1 <= p.split <= qc.MAX_SPLIT and p.split * p.kslice == in_d
    assert p.kslice % p.kc == 0 and p.kc % 32 == 0 and p.kc <= qc.KC_MAX
    assert p.xk % p.kc == 0 and p.kslice % p.xk == 0
    assert p.xk == p.kc or qc.m_bucket(m) * p.xk * 4 <= qc.X_BYTES
    assert 1 <= p.stages <= min(qc.MAX_STAGES, p.kslice // p.kc)
    assert p.blocks == -(-out_d // qc.ROWS) * p.split
    if p.bulk:
        # tensor maps: 16-byte row strides; a chunk is whole qs boxes and
        # one scale box whose rows are 16-byte multiples
        qs_row = in_d if kind == "q8_0" else in_d // 2       # global row bytes
        qs_seg = p.kc if kind == "q8_0" else p.kc // 2
        assert qs_row % 16 == 0 and (in_d // 32 * 4) % 16 == 0
        assert qs_seg % qc.BOX == 0 and (p.kc // 32 * 4) % 16 == 0
    # csrc/qmat.cu's layout: a stage is ROWS rows of qs in BOX-byte boxes,
    # then of scales (and mins), in 1024-byte units
    qs = -(-(p.kc if kind == "q8_0" else p.kc // 2) // qc.BOX) * qc.BOX
    stage = -(-qc.ROWS * (qs + p.kc // 8 * (2 if kind == "q4_k" else 1)) // 1024) * 1024
    slots = 4 * p.split * qc.m_bucket(m) * qc.ROWS if p.split > 1 else 0
    smem = 2048 + p.stages * stage + qc.m_bucket(m) * (p.xk + 4) * 4 + slots
    assert smem <= 227 * 1024


@pytest.mark.parametrize("in_d", [32, 96, 160, 224, 256, 384, 512, 2048, 8192,
                                  8192 + 32])
def test_plan_takes_the_cp_async_form_exactly_when_in_is_no_multiple_of_128(in_d):
    from codec_tpu_torch.ops import qmat_cuda as qc

    assert qc.plan("q8_0", 1, in_d, 64).bulk == (in_d % 128 == 0)
    if in_d % 256 == 0:
        assert qc.plan("q4_k", 1, in_d, 64).bulk


@pytest.mark.parametrize("kind", ["q8_0", "q4_k"])
@pytest.mark.parametrize("out_d,in_d", BACKBONE)
def test_plan_fills_the_card_at_the_backbone_shapes(kind, out_d, in_d):
    """At least 64 blocks of at most 4096 columns: the narrow k/v matrices
    (16 row tiles) through a cluster of 4 K slices, down (K 8192) of 2."""
    from codec_tpu_torch.ops import qmat_cuda as qc

    p = qc.plan(kind, 1, in_d, out_d)
    assert p.blocks >= qc.TARGET_BLOCKS and p.kslice <= qc.MAX_KSLICE
    assert p.split == {512: 4, 2048: 2 if in_d == 8192 else 1, 8192: 1}[out_d]


def test_sass_report_reads_ptxas_and_sass():
    from codec_tpu_torch.tools import sass_report

    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N__1a2b3c4d_7_qmat_cu_5e6f7a8b18q4_k_matmul_kernelILi1EfEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N__1a2b3c4d_7_qmat_cu_5e6f7a8b18q4_k_matmul_kernelILi1EfEEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]
"""
    (r,) = sass_report.parse_ptxas(log)
    assert r.name == "_ZN12ANON18q4_k_matmul_kernelILi1EfEEvNS_4ArgsE"
    assert (r.registers, r.stack, r.spill_stores, r.spill_loads) == (72, 8, 4, 4)
    dump = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N__1a2b3c4d_7_qmat_cu_5e6f7a8b18q4_k_matmul_kernelILi1EfEEvNS_4ArgsE
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   I2F.U32 R4, R5 ;
        /*0020*/               @P0 I2F R6, R7 ;
        /*0030*/                   FFMA R8, R4, R6, R8 ;
        /*0040*/                   EXIT ;
"""
    assert sass_report.sass_counts(dump) == {r.name: (2, 5)}


@pytest.mark.parametrize("kind", ["q8_0", "q4_k"])
@pytest.mark.parametrize("out_d,in_d", BACKBONE)
def test_plan_tool_candidates_keep_the_plan_invariants(kind, out_d, in_d):
    """tools/qmat_plans.py times plan()'s choice first, then other splits,
    each of whole chunks and whole tensor-copy boxes."""
    from codec_tpu_torch.ops import qmat_cuda as qc
    from codec_tpu_torch.tools.qmat_plans import candidate_plans

    plans = candidate_plans(kind, 1, in_d, out_d)
    assert plans[0] == qc.plan(kind, 1, in_d, out_d)
    assert len({p.split for p in plans}) == len(plans) >= 3
    for p in plans:
        assert p.split * p.kslice == in_d and p.kslice % p.kc == 0
        assert p.kc % qc.granule(kind, in_d) == 0
        assert p.xk % p.kc == 0 and p.kslice % p.xk == 0
        assert 1 <= p.stages <= min(qc.MAX_STAGES, p.kslice // p.kc)
