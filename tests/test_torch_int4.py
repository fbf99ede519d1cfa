"""PyTorch port: int4 weight-only quantization vs the JAX package (CPU).

The quantizer, unpacking and dequantization are bitwise JAX's; the plain
``int4_matmul`` (K5's plain version) is held to the JAX fallback and to
the Pallas kernel in interpret mode within 1e-5 (float32: both sum exact
bf16 x bf16 products in float32, in different orders); the port's
``Int4Linear`` (plain and o_proj form) to JAX ``Int4Dense`` /
``Int4DenseGeneral`` on the same params; the port's converter gives the
JAX converter's bits, and an int4 LM its hidden states within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu.ops import int4 as jint4
from multimodal_concept_learning_tpu_torch.ops import int4 as tint4

ATOL = 1e-5


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(256, 40), (1152, 384)])
def test_quantizer_is_bitwise_jax(shape):
    w = _w(shape)
    jp, js = jint4.quantize_weight_int4(jnp.asarray(w))
    tp_, ts = tint4.quantize_weight_int4(torch.from_numpy(w))
    assert tp_.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))
    # through the nn.Linear orientation: weight [out, in] is quantized as its transpose
    lin = tint4.quantize_linear_int4(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert torch.equal(lin["packed"], tp_) and torch.equal(lin["scale"], ts)


def test_unpack_and_dequantize_are_exact():
    w = _w((256, 48), seed=1)
    jp, js = jint4.quantize_weight_int4(jnp.asarray(w))
    packed, scale = torch.from_numpy(np.array(jp)), torch.from_numpy(
        np.asarray(js, np.float32)).to(torch.bfloat16)
    codes = tint4.unpack_int4(packed)
    assert codes.dtype == torch.int8 and codes.min() >= -8 and codes.max() <= 7
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jint4.unpack_int4(jp)))
    np.testing.assert_array_equal(tint4.dequantize_int4(packed, scale).numpy(),
                                  np.asarray(jint4.dequantize_int4(jp, js)))


@pytest.mark.parametrize("rows,d_in,d_out", [
    (8, 128, 64), (16, 512, 128), (32, 1152, 384),  # the JAX kernel test's shapes
    (1, 1152, 384), (7, 512, 128),
])
def test_plain_matmul_matches_jax_fallback_and_pallas_interpret(rows, d_in, d_out):
    x = (_w((rows, d_in), seed=2) / np.sqrt(d_in)).astype(np.float32)  # unit-scale outputs
    jp, js = jint4.quantize_weight_int4(jnp.asarray(_w((d_in, d_out), seed=3)))
    packed = torch.from_numpy(np.array(jp))
    scale = torch.from_numpy(np.array(js, np.float32)).to(torch.bfloat16)
    out = tint4.int4_matmul(torch.from_numpy(x), packed, scale)
    assert out.dtype == torch.float32 and out.shape == (rows, d_out)
    fallback = np.asarray(jint4.int4_matmul(jnp.asarray(x), jp, js))
    np.testing.assert_allclose(out.numpy(), fallback, atol=ATOL, rtol=0)
    if rows > 1:
        # one row: XLA:CPU runs the interpreted kernel's bf16 dot as a
        # matrix-vector product that drifts ~6e-3 from the float32-accumulated
        # result (ROADMAP.md queue C); the fallback above holds that case
        pallas = np.asarray(jint4._int4_matmul_kernel(jnp.asarray(x), jp, js, 64,
                                                      interpret=True))
        np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL, rtol=0)


def _dense_params(module, x, seed):
    params = module.init(jax.random.key(seed), jnp.asarray(x))["params"]
    if "bias" in params:
        params = dict(params, bias=jnp.asarray(_w(params["bias"].shape, seed=seed + 1)))
    return params


@pytest.mark.parametrize("bias", [False, True])
def test_int4_linear_matches_jax_int4_dense(bias):
    x = _w((2, 5, 256), seed=4)
    jmod = jint4.Int4Dense(features=96, use_bias=bias)
    params = _dense_params(jmod, x, 5)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = tint4.Int4Linear(256, 96, bias=bias)
    sd = {"packed": torch.from_numpy(np.array(params["packed"])),
          "scale": torch.from_numpy(np.array(params["scale"], np.float32)).bfloat16()}
    if bias:
        sd["bias"] = torch.from_numpy(np.array(params["bias"]))
    mod.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), ref, atol=ATOL, rtol=0)


def test_int4_linear_o_proj_form_matches_jax_int4_dense_general():
    """Contract the (heads, head_dim) axes of [B, T, heads, hd] (the o_proj
    case), and split the output into (heads, hd) (the q_proj case)."""
    x = _w((2, 3, 4, 32), seed=6)
    jmod = jint4.Int4DenseGeneral(features=(64,), axis=(-2, -1))
    params = _dense_params(jmod, x, 7)
    mod = tint4.Int4Linear(128, (64,), axis=(-2, -1))
    mod.load_state_dict({"packed": torch.from_numpy(np.array(params["packed"])),
                         "scale": torch.from_numpy(np.array(params["scale"],
                                                              np.float32)).bfloat16()})
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(), ref, atol=ATOL, rtol=0)

    h = _w((2, 3, 128), seed=8)
    jq = jint4.Int4DenseGeneral(features=(4, 32))
    qparams = _dense_params(jq, h, 9)
    q = tint4.Int4Linear(128, (4, 32))
    q.load_state_dict({"packed": torch.from_numpy(np.array(qparams["packed"])),
                       "scale": torch.from_numpy(np.array(qparams["scale"],
                                                            np.float32)).bfloat16()})
    out = q(torch.from_numpy(h))
    assert out.shape == (2, 3, 4, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jq.apply({"params": qparams},
                                                                 jnp.asarray(h))),
                               atol=ATOL, rtol=0)


def _nano_lm(int4: bool):
    from multimodal_concept_learning_tpu.models.lm import LMConfig

    return dataclasses.replace(LMConfig.preset("nano", vocab_size=61), dtype=jnp.float32,
                               int4_weights=int4, use_qk_norm=True, sandwich_norms=True,
                               sliding_window=4, sliding_window_pattern=2,
                               query_pre_attn_scalar=32.0)


@pytest.fixture(scope="module")
def nano_int4():
    """(JAX float config, JAX float params, JAX int4 params) of a nano LM."""
    from multimodal_concept_learning_tpu.models.lm import CausalLM

    fcfg = _nano_lm(False)
    ids = jnp.ones((1, 8), jnp.int32)
    fparams = CausalLM(fcfg).init(jax.random.key(0), ids, jnp.ones_like(ids))["params"]
    rng = np.random.default_rng(10)
    fparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        fparams)
    return fcfg, fparams, jint4.quantize_lm_params_int4(fparams, fcfg)


def _lm_state_dict(params):
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax

    sd = state_dict_from_jax({"language_model": jax.tree_util.tree_map(np.asarray, params)},
                             patch_size=8)
    return {k.removeprefix("language_model."): v for k, v in sd.items()}


def test_converter_gives_jax_bits(nano_int4):
    _, fparams, qparams = nano_int4
    ours = tint4.quantize_lm_params_int4(_lm_state_dict(fparams))
    theirs = _lm_state_dict(qparams)
    assert sorted(ours) == sorted(theirs)
    assert any(k.endswith(".packed") for k in ours)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and torch.equal(ours[k], theirs[k]), k


def test_int4_lm_hidden_states_match_jax(nano_int4):
    from multimodal_concept_learning_tpu.models.lm import CausalLM as JLM
    from multimodal_concept_learning_tpu_torch.models.lm import CausalLM, LMConfig

    fcfg, _, qparams = nano_int4
    qcfg = dataclasses.replace(fcfg, int4_weights=True)
    names = [f.name for f in dataclasses.fields(LMConfig) if f.name != "dtype"]
    port = CausalLM(LMConfig(**{n: getattr(qcfg, n) for n in names}, dtype=torch.float32))
    port.load_state_dict(_lm_state_dict(qparams), strict=True)
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((2, 9, 128)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ref = np.asarray(jax.jit(lambda p, e, m: JLM(qcfg).apply({"params": p}, e, m,
                                                             method=JLM.hidden_states))(
        qparams, jnp.asarray(emb), jnp.asarray(mask)))
    with torch.no_grad():
        out = port.hidden_states(torch.from_numpy(emb), torch.from_numpy(mask),
                                 torch.from_numpy(mask.sum(axis=1).astype(np.int32)))
    valid = mask.astype(bool)
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], atol=1e-4, rtol=0)


def test_int8_and_int4_are_exclusive():
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig

    with pytest.raises(ValueError, match="mutually exclusive"):
        LMConfig(int8_weights=True, int4_weights=True)


def test_cuda_tensor_that_k5_cannot_take_raises():
    """A decode-shaped CUDA call that breaks K5's rules raises before any
    launch (checked on a meta stand-in: the rule check needs no card)."""
    x = torch.zeros((8, 256))
    packed = torch.zeros((128, 40), dtype=torch.int8)  # out 40: not a multiple of 16
    scale = torch.zeros((4, 40), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tint4._check_kernel_args(x, packed, scale, 64)


# gemma3-1b's seven decode projections (in, out), as the serving path runs them
GEMMA_PROJECTIONS = {"q_proj": (1152, 1024), "k_proj": (1152, 256), "v_proj": (1152, 256),
                     "o_proj": (1024, 1152), "gate_proj": (1152, 6912),
                     "up_proj": (1152, 6912), "down_proj": (6912, 1152)}


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("proj", sorted(GEMMA_PROJECTIONS))
def test_k5_plan_fills_the_card_with_no_empty_split(proj, rows):
    """K5's split plan at every gemma3-1b projection: at least 264 CTAs (2
    an SM of an H100), a cluster size the kernel takes, every CTA of a
    stripe's cluster a non-empty run of at most 16 units of 16 packed rows,
    the runs covering the packed rows once, and shared memory within 227 KB."""
    from multimodal_concept_learning_tpu_torch.ops._build import SMEM_PER_BLOCK

    d_in, d_out = GEMMA_PROJECTIONS[proj]
    nc, cs = tint4.k5_plan(rows, d_in, d_out)
    assert nc in tint4.K5_WIDTHS and cs in tint4.K5_CLUSTERS
    assert -(-d_out // nc) * cs >= tint4.K5_TARGET_CTAS
    units = d_in // (2 * tint4.K5_UNIT)
    runs = [(q * units // cs, (q + 1) * units // cs) for q in range(cs)]  # the kernel's split
    assert all(0 < hi - lo <= tint4.K5_CHUNK_UNITS for lo, hi in runs)
    assert [lo for lo, _ in runs[1:]] == [hi for _, hi in runs[:-1]] and runs[-1][1] == units
    assert tint4.k5_smem_bytes(rows, d_in, d_out) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("kind,kernel", [
    pytest.param(kind, kernel, id=kind if kernel == "K5" else f"{kind}-{kernel}")
    for kernel in ("K5", "K5v3a", "K5v3b") for kind in ("strided", "offset")])
def test_kernel_operands_are_copied_not_refused(kind, kernel):
    """A strided view or one at an odd offset (which the JAX function takes)
    becomes a contiguous, 16-byte aligned copy of the same values: what the
    CUDA wrappers of K5, K5v3a and K5v3b (``kernel_operands``), as those of
    K1 and K2, hand their kernels; an operand that is fine is not copied."""
    rng = np.random.default_rng(3)
    packed, scale = tint4.quantize_weight_int4(torch.from_numpy(_w((256, 48))))
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    views = [_layout_view(t, kind) for t in (x, packed, scale)]
    got = tint4.kernel_operands(*views, 64, kernel)
    for g, want in zip(got, (x, packed, scale)):
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        assert torch.equal(g, want)
    aligned = tint4.kernel_operands(*got, 64, kernel)
    assert all(a.data_ptr() == g.data_ptr() for a, g in zip(aligned, got))  # no copy then


def _layout_view(t, kind):
    """The values of ``t`` as a strided view (every other element of a last
    dim twice as long) or at an offset of one element into a flat buffer."""
    if kind == "strided":
        view = torch.zeros((*t.shape[:-1], 2 * t.shape[-1]), dtype=t.dtype)[..., ::2]
    else:
        view = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    view.copy_(t)
    assert not view.is_contiguous() or view.data_ptr() % 16
    return view


@pytest.mark.parametrize("operand", ["q", "page_table", "lens", "pool_k"])
@pytest.mark.parametrize("kind", ["strided", "offset"])
def test_paged_operands_are_copied_not_refused(kind, operand):
    """K3's and K4's wrappers (``kernel_operands``) hand their kernels a
    contiguous, 16-byte aligned copy of a strided or offset q, page table or
    lens, as the K1, K2 and K5 wrappers do; a pool in such a layout raises
    (a copy would copy the whole cache in every layer)."""
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk

    gen = torch.Generator().manual_seed(0)
    args = {"q": torch.randn(3, 1, 8, 64, generator=gen),
            "pool_k": torch.randn(7, 2, 4, 64, generator=gen),
            "pool_v": torch.randn(7, 2, 4, 64, generator=gen),
            "page_table": torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32),
            "lens": torch.tensor([0, 5, 8], dtype=torch.int32)}
    want = args[operand]
    args[operand] = _layout_view(want, kind)
    if operand == "pool_k":
        with pytest.raises(ValueError, match="pool_k must"):
            pk.kernel_operands(**args)
        return
    got = dict(zip(("q", "page_table", "lens"), pk.kernel_operands(**args)))[operand]
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, want)
