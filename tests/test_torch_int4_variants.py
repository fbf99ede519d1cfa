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


@pytest.mark.parametrize("d_in,d_out", [(1152, 1024), (1152, 256), (1024, 1152),
                                        (1152, 6912), (6912, 1152), (512, 128)])
def test_split_k_covers_every_block_once(d_in, d_out):
    """The variants' split-K: every packed row block in exactly one split,
    no split empty (the kernel's launch check)."""
    from multimodal_concept_learning_tpu_torch.ops.int4 import v3_splits

    blocks = d_in // 128
    splits, per = v3_splits(d_in, d_out)
    covered = [b for s in range(splits) for b in range(s * per, min(blocks, (s + 1) * per))]
    assert covered == list(range(blocks))
    assert (splits - 1) * per < blocks


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
