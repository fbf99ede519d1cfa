"""PyTorch port: K5v3a and K5v3b, the int4 A/B variants (plain versions, CPU).

The port's ``v3a_matmul_reference`` and ``v3b_matmul_reference`` against
the JAX A/B script's kernel bodies (``scripts/bench_int4_kernel.py``:
``_kernel_v3a``, ``_kernel_v3b``) under ``pl.pallas_call(...,
interpret=True)`` with the script's own BlockSpecs, on the same numpy
inputs: within 1e-5 of the reference's max |value|.  v3b's int8
activations and their scales are bitwise the script's.  The script is
imported by path and never edited.  The kernels themselves are held to
these plain versions on the card by ``chip_smoke.py``.
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

REL_TOL = 1e-5
ROOT = os.path.realpath(os.path.join(os.path.dirname(__file__), os.pardir))
SCRIPT = os.path.join(ROOT, "scripts", "bench_int4_kernel.py")


@pytest.fixture(scope="module")
def script():
    """The JAX A/B script as a module; the process-wide state its import
    sets (a compilation-cache directory, a sys.path entry) is put back.
    The JAX modules it imports are imported first from this checkout, so
    the fixed path the script puts on sys.path is never searched."""
    import multimodal_concept_learning_tpu.ops.int4 as jax_int4
    import multimodal_concept_learning_tpu.ops.quant as jax_quant

    cache_dir = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_bench_int4_kernel", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    for fn in (mod._pick_bout, mod.quantize_weight):
        assert sys.modules[fn.__module__] in (jax_int4, jax_quant)
    for used in (jax_int4, jax_quant):
        assert os.path.realpath(used.__file__).startswith(ROOT + os.sep), used.__file__
    return mod


def _weights(d_in, d_out, rows, seed):
    """(x float32 [rows, d_in], packed int8, scale bf16 as numpy/torch) of a
    normal(0.02) weight quantized by the port (bitwise the JAX quantizer)."""
    from multimodal_concept_learning_tpu_torch.ops.int4 import quantize_weight_int4

    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((d_in, d_out))).astype(np.float32)
    x = rng.standard_normal((rows, d_in)).astype(np.float32)
    packed, scale = quantize_weight_int4(torch.from_numpy(w))
    return x, packed, scale


def _jax_operands(packed, scale):
    return (jnp.asarray(packed.numpy()),
            jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16))


def _v3a_interpret(script, x, packed, scale):
    """The script's ``v3a_matmul`` with ``interpret=True``: its transpose
    of x to [G, rows, 64] in bf16, its BlockSpecs, its kernel body."""
    gs = script.GROUP_SIZE
    rows, d_in = x.shape
    half, d_out = packed.shape
    g_cnt = d_in // gs
    bout = script._pick_bout(d_in, d_out)
    xg = x.reshape(rows, g_cnt, gs).transpose(1, 0, 2).astype(jnp.bfloat16)
    out = pl.pallas_call(
        functools.partial(script._kernel_v3a, group_size=gs),
        grid=(d_out // bout,),
        in_specs=[pl.BlockSpec((g_cnt, rows, gs), lambda j: (0, 0, 0)),
                  pl.BlockSpec((half, bout), lambda j: (0, j)),
                  pl.BlockSpec((g_cnt, bout), lambda j: (0, j))],
        out_specs=pl.BlockSpec((rows, bout), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((rows, d_out), jnp.float32),
        interpret=True,
    )(xg, packed, scale)
    return np.asarray(out.astype(x.dtype))


def _v3b_quantize(x, gs):
    """The script's activation quantization (``v3b_matmul``, :108-112)."""
    rows, d_in = x.shape
    xg = x.astype(jnp.float32).reshape(rows, d_in // gs, gs)
    sx = jnp.maximum(jnp.max(jnp.abs(xg), axis=-1, keepdims=True), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xg / sx), -127, 127).astype(jnp.int8)
    return xq, sx


def _v3b_interpret(script, x, packed, scale):
    """The script's ``v3b_matmul`` with ``interpret=True``."""
    gs = script.GROUP_SIZE
    rows, d_in = x.shape
    half, d_out = packed.shape
    g_cnt = d_in // gs
    bout = script._pick_bout(d_in, d_out)
    xq, sx = _v3b_quantize(x, gs)
    out = pl.pallas_call(
        functools.partial(script._kernel_v3b, group_size=gs),
        grid=(d_out // bout,),
        in_specs=[pl.BlockSpec((g_cnt, rows, gs), lambda j: (0, 0, 0)),
                  pl.BlockSpec((g_cnt, rows, 1), lambda j: (0, 0, 0)),
                  pl.BlockSpec((half, bout), lambda j: (0, j)),
                  pl.BlockSpec((g_cnt, bout), lambda j: (0, j))],
        out_specs=pl.BlockSpec((rows, bout), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((rows, d_out), jnp.float32),
        interpret=True,
    )(xq.transpose(1, 0, 2), sx.transpose(1, 0, 2), packed, scale)
    return np.asarray(out.astype(x.dtype))


SHAPES = [(8, 1152, 256), (2, 256, 384), (3, 384, 128), (16, 512, 128)]


@pytest.mark.parametrize("rows,d_in,d_out", SHAPES)
def test_v3a_reference_matches_jax_kernel(script, rows, d_in, d_out):
    from multimodal_concept_learning_tpu_torch.ops.int4 import v3a_matmul_reference

    x, packed, scale = _weights(d_in, d_out, rows, seed=d_in + rows)
    want = _v3a_interpret(script, jnp.asarray(x), *_jax_operands(packed, scale))
    got = v3a_matmul_reference(torch.from_numpy(x), packed, scale).numpy()
    assert got.shape == want.shape == (rows, d_out)
    np.testing.assert_allclose(got, want, atol=REL_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("rows,d_in,d_out", SHAPES)
def test_v3b_reference_matches_jax_kernel(script, rows, d_in, d_out):
    from multimodal_concept_learning_tpu_torch.ops.int4 import (
        quantize_activations_int8,
        v3b_matmul_reference,
    )

    x, packed, scale = _weights(d_in, d_out, rows, seed=7 * d_in + rows)
    xq, sx = quantize_activations_int8(torch.from_numpy(x))
    want_q, want_sx = _v3b_quantize(jnp.asarray(x), script.GROUP_SIZE)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(want_q).reshape(rows, d_in))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(want_sx)[..., 0])
    want = _v3b_interpret(script, jnp.asarray(x), *_jax_operands(packed, scale))
    got = v3b_matmul_reference(torch.from_numpy(x), packed, scale).numpy()
    np.testing.assert_allclose(got, want, atol=REL_TOL * np.abs(want).max(), rtol=0)


def test_v3a_rounds_otherwise_than_k5():
    """v3a applies the scale after each group's product; K5 rounds code x
    scale to bf16 before one product: two functions, close but not equal."""
    from multimodal_concept_learning_tpu_torch.ops.int4 import (
        int4_matmul_reference,
        v3a_matmul,
        v3b_matmul,
    )

    x, packed, scale = _weights(512, 128, 8, seed=3)
    xt = torch.from_numpy(x)
    k5 = int4_matmul_reference(xt, packed, scale)
    v3a = v3a_matmul(xt, packed, scale)  # CPU tensors: the plain versions
    v3b = v3b_matmul(xt, packed, scale)
    peak = k5.abs().max().item()
    assert 0 < (v3a - k5).abs().max().item() < 1e-2 * peak
    assert (v3b - k5).abs().max().item() < 5e-2 * peak  # int8 activations: lossier
    assert v3a.dtype == v3b.dtype == torch.float32
    assert v3a_matmul(xt.to(torch.bfloat16), packed, scale).dtype == torch.bfloat16


# gemma3-1b's seven decode projections (in, out), then a nano shape
GEMMA_PROJECTIONS = {"q_proj": (1152, 1024), "k_proj": (1152, 256), "v_proj": (1152, 256),
                     "o_proj": (1024, 1152), "gate_proj": (1152, 6912),
                     "up_proj": (1152, 6912), "down_proj": (6912, 1152)}
PLAN_CASES = ([(r, *GEMMA_PROJECTIONS[p]) for p in sorted(GEMMA_PROJECTIONS)
               for r in (1, 8, 16, 64)] + [(8, 512, 128)])


@pytest.mark.parametrize("rows,d_in,d_out", PLAN_CASES)
def test_v3_plan_fills_the_card_with_whole_groups(rows, d_in, d_out):
    """The variants' split plan: at least 264 CTAs (2 an SM of an H100), or
    the most the shapes allow; a cluster the kernel takes; every (group,
    nibble half) item in exactly one rank, none empty; and a CTA's shared
    memory (``v3_smem_bytes``, both variants) within 227 KB."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4
    from multimodal_concept_learning_tpu_torch.ops._build import SMEM_PER_BLOCK

    nc, cs = i4.v3_plan(rows, d_in, d_out)
    tiles = 1 if rows <= 16 else 2 if rows <= 32 else 4
    assert nc in i4.K5_WIDTHS and nc * tiles <= 64 and cs in i4.K5_CLUSTERS and cs <= 16
    groups = d_in // 128  # groups a nibble half = 64-row blocks of the packed rows
    most = max(-(-d_out // w) * c for w in i4.K5_WIDTHS if w * tiles <= 64
               for c in i4.K5_CLUSTERS if c <= groups)
    assert -(-d_out // nc) * cs >= min(i4.K5_TARGET_CTAS, most)
    runs = [range(q * groups // cs, (q + 1) * groups // cs) for q in range(cs)]  # the kernel's
    assert all(len(run) > 0 for run in runs)
    items = sorted((b + h * groups) for run in runs for b in run for h in (0, 1))
    assert items == list(range(2 * groups))  # every group of both halves once
    for variant in ("v3a", "v3b"):
        assert i4.v3_smem_bytes(rows, d_in, d_out, variant) <= SMEM_PER_BLOCK


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes of (x, y)."""
    data = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(data[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _codes4(v, h):
    """The kernel's codes4: int8 codes of the low (h 0) or high nibbles of
    the 4 bytes of v, by byte-wise SIMD (__vsub4 wraps each byte)."""
    w = ((v >> (4 * h)) & 0x0F0F0F0F) ^ 0x08080808
    return [(((w >> (8 * i)) & 0xFF) - 8) for i in range(4)]


@pytest.mark.parametrize("h", [0, 1])
@pytest.mark.parametrize("path", ["ldmatrix", "bytes"])
def test_v3b_k_order_gives_the_integer_sums(path, h):
    """One m16n8k32 step of K5v3b as the kernel assembles it: the x tile
    staged in ``s8_slot`` order, each lane's A registers read from it, its
    B registers from the packed bytes (``ldmatrix.x4.trans`` plus byte
    permutes for a 16-column block, or the bytes one by one for an 8-column
    stripe) and decoded 4 bytes at a time; the fragments put back where
    the PTX layouts say, their product must be the plain version's integer
    sums of xq with the codes, exactly."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    rng = np.random.default_rng(11 + h)
    xq = rng.integers(-127, 128, size=(16, 32))
    packed = rng.integers(-128, 128, size=(32, 16)).astype(np.int8)  # rows of one k-step
    codes = i4.unpack_int4(torch.from_numpy(packed)).numpy().astype(np.int64)[32 * h:32 * h + 32]
    want = xq @ codes  # [16 rows, 16 columns]
    staged = np.zeros_like(xq)
    for p in range(32):
        staged[:, i4.s8_slot(p)] = xq[:, p]
    u8 = packed.view(np.uint8).astype(np.int64)
    a_mat = np.zeros((16, 32), np.int64)
    got = np.zeros((16, 16), np.int64)
    tiles = {"even": np.zeros((32, 8), np.int64), "odd": np.zeros((32, 8), np.int64)}
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg, (row, k0) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
            a_mat[row, k0 + 4 * t:k0 + 4 * t + 4] = staged[row, k0 + 4 * t:k0 + 4 * t + 4]
        if path == "ldmatrix":
            # matrix j: b16 column g (bytes 2g, 2g + 1) of rows 8j + 2t, 8j + 2t + 1
            q = [sum(int(u8[8 * j + 2 * t + (i // 2), 2 * g + i % 2]) << (8 * i)
                     for i in range(4)) for j in range(4)]
            regs = {"even": (_byte_perm(q[0], q[1], 0x6420), _byte_perm(q[2], q[3], 0x6420)),
                    "odd": (_byte_perm(q[0], q[1], 0x7531), _byte_perm(q[2], q[3], 0x7531))}
        else:  # an 8-column stripe: column g, rows 2t, 2t + 1, 2t + 8, 2t + 9 (+ 16)
            regs = {"even": tuple(sum(int(u8[16 * s + 2 * t + r, g]) << (8 * i)
                                      for i, r in enumerate((0, 1, 8, 9))) for s in (0, 1))}
        for tile, (b0, b1) in regs.items():
            tiles[tile][4 * t:4 * t + 4, g] = _codes4(b0, h)
            tiles[tile][16 + 4 * t:16 + 4 * t + 4, g] = _codes4(b1, h)
    if path == "ldmatrix":
        got[:, 0::2] = a_mat @ tiles["even"]  # n-tile 2 blk: columns 2g
        got[:, 1::2] = a_mat @ tiles["odd"]
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(a_mat @ tiles["even"], want[:, :8])


def test_v3b_quantization_divides():
    """K5v3b's quantization in the kernel's float32 arithmetic (numpy
    float32: IEEE division, round half to even) is bitwise the plain
    version's; a multiply by the reciprocal 1/127 (what a division by a
    constant often becomes) gives other scales on the same inputs."""
    from multimodal_concept_learning_tpu_torch.ops.int4 import quantize_activations_int8

    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 1152)).astype(np.float32)
    xq, sx = quantize_activations_int8(torch.from_numpy(x))
    m = np.maximum(np.abs(x.reshape(8, 18, 64)).max(-1), np.float32(1e-8))
    want_sx = m / np.float32(127)
    want_q = np.clip(np.rint(x.reshape(8, 18, 64) / want_sx[..., None]), -127, 127)
    np.testing.assert_array_equal(sx.numpy(), want_sx)
    np.testing.assert_array_equal(xq.numpy(), want_q.reshape(8, 1152).astype(np.int8))
    assert (m * (np.float32(1) / np.float32(127)) != want_sx).any()


def test_v3b_division_is_ieee():
    """K5v3b's division (``divisor`` and ``div_rn`` of
    csrc/int4_matmul_v3.cu) in numpy: a reciprocal within 2 ulp of float32
    (as ``__fdividef`` gives it) refined by two Newton steps in float64, the
    quotient by it with one residual correction, rounded to float32, is
    bitwise the IEEE float32 quotient, on random pairs and on quotients next
    to the half-integers where round-half-to-even decides xq; and so is the
    group scale m / 127 by the float64 1/127."""
    rng = np.random.default_rng(7)
    n = 400_000
    b = (np.abs(rng.standard_normal(n)) * 10.0 ** rng.uniform(-9, 3, n) / 127).astype(np.float32)
    b = np.maximum(b, np.float32(1e-8) / np.float32(127))
    a = (rng.uniform(-127, 127, n) * b).astype(np.float32)
    half = (rng.integers(-127, 127, n) + 0.5).astype(np.float32)
    near = (half.astype(np.float64) * b).astype(np.float32)  # a / b within an ulp of k + 0.5
    for num in (a, near, np.nextafter(near, np.float32(np.inf)),
                np.nextafter(near, np.float32(-np.inf))):
        r0 = np.float32(1) / b
        r0 = np.where(rng.random(n) < 0.5, np.nextafter(np.nextafter(r0, np.float32(0)),
                                                        np.float32(0)),
                      np.nextafter(np.nextafter(r0, np.float32(np.inf)), np.float32(np.inf)))
        bd, ad, r = b.astype(np.float64), num.astype(np.float64), r0.astype(np.float64)
        r = r + r * (1.0 - bd * r)
        r = r + r * (1.0 - bd * r)
        q = ad * r
        q = q + (ad - bd * q) * r
        np.testing.assert_array_equal(q.astype(np.float32), num / b)
    m = np.maximum(np.abs(a), np.float32(1e-8))  # the group scale: m / 127 by 1/127 in float64
    q = m.astype(np.float64) * (1.0 / 127.0)
    q = q + (m.astype(np.float64) - 127.0 * q) * (1.0 / 127.0)
    np.testing.assert_array_equal(q.astype(np.float32), m / np.float32(127))


def test_ab_entry_point_on_cpu(capsys):
    """The A/B script's control flow at toy shapes on the CPU: every variant
    prints its line, chains 2 layers x 2 projections, and all agree with v2
    on the carried value (1e-30 multiples of the outputs)."""
    from multimodal_concept_learning_tpu_torch.scripts import bench_int4_kernel as ab

    results = ab.run(list(ab.VARIANTS), "cpu", shapes=[(256, 128), (128, 256)], layers=2)
    out = capsys.readouterr().out
    for name in ab.VARIANTS:
        assert f"[{name}] decode-step matmuls:" in out
        assert results[name]["calls"] == 4
    assert results["v2"]["launches"] == results["v3a"]["launches"] == 0  # CPU: no kernel
    assert results["int8"]["launches"] is None
    for name in ("v3a", "v3b", "int8"):
        assert abs(results[name]["r"] - results["v2"]["r"]) < 0.05 * abs(results["v2"]["r"])
    with pytest.raises(ValueError, match="unknown variant"):
        ab.run(["v9"], "cpu", shapes=[(256, 128)], layers=1)
