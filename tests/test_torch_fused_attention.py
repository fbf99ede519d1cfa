"""PyTorch port: K6, the fused pre-LN attention sublayer (plain versions, CPU).

The port's ``attention_sublayer`` (its plain forward and backward, which CPU
tensors run) against the JAX ``attention_sublayer`` and its custom VJP, with
the Pallas kernels in interpret mode, on the same numpy inputs.  Float32
tolerances: forward 1e-5, gradients 5e-4 abs / 1e-3 rel (those of
``tests/test_fused_attention.py``).  The kernels themselves are held to
these plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

OUT_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
WIDTH, HEADS = 128, 2  # head dim 64, that of the ViT-B and CLIP towers
NAMES = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo")


@pytest.fixture()
def force_fused(monkeypatch):
    """The JAX ViT block takes its fused branch off the TPU (interpret mode)."""
    from multimodal_concept_learning_tpu.models import vit as vit_mod

    monkeypatch.setattr(vit_mod, "_fused_attention_ok",
                        lambda cfg, det: cfg.fused_attention and det)


def _inputs(b, t, seed, width=WIDTH):
    """x, LN scale and bias, packed wqkv / bqkv, wo, bo (JAX layouts) and a
    cotangent, float32 numpy; biases and norm parameters perturbed."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    args = (n(b, t, width), 1 + n(width, s=0.1), n(width, s=0.1), n(width, 3 * width, s=0.05),
            n(3 * width, s=0.1), n(width, width, s=0.05), n(width, s=0.1))
    return args, n(b, t, width)


def _jax_vjp(args, cot, dtype=jnp.float32):
    from multimodal_concept_learning_tpu.ops.fused_attention_block import attention_sublayer

    def f(x, *params):
        return attention_sublayer(x.astype(dtype), *params, heads=HEADS)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *map(jnp.asarray, args))
        grads = vjp(jnp.asarray(cot, dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g, np.float32) for g in grads]


def _port(args, cot, dtype=torch.float32):
    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        attention_sublayer,
    )

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = attention_sublayer(leaves[0].to(dtype), *leaves[1:], HEADS)
    out.backward(torch.from_numpy(cot).to(dtype))
    return out.detach().float().numpy(), [a.grad.float().numpy() for a in leaves]


@pytest.mark.parametrize("t", [50, 64, 77])
def test_plain_k6_forward_matches_jax(t):
    from multimodal_concept_learning_tpu.ops.fused_attention_block import (
        attention_sublayer as jf,
    )

    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        attention_sublayer,
    )

    args, _ = _inputs(3, t, seed=t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jf(*map(jnp.asarray, args), heads=HEADS))
    got = attention_sublayer(*map(torch.from_numpy, args), HEADS)
    assert got.shape == want.shape == (3, t, WIDTH)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("t", [21, 50])
def test_plain_k6_gradients_match_jax_vjp(t):
    """Every input and parameter gradient of the port's backward (its
    recompute, the dqkv plain version, the projection and LN backward)
    against the JAX custom VJP."""
    args, cot = _inputs(2, t, seed=100 + t)
    want_out, want = _jax_vjp(args, cot)
    got_out, got = _port(args, cot)
    np.testing.assert_allclose(got_out, want_out, atol=OUT_TOL, rtol=0)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_bf16_rounding_split():
    """In bf16 the forward computes qkv from the parameters cast to bf16 and
    the backward recomputes it from the float32 ones (the JAX ``_fused_bwd``
    reads the float32 ``ln_scale``, ``ln_bias`` and ``bqkv``): the two qkv
    differ, and the port follows both sides.  Against JAX in bf16: the
    output within one bf16 step of its largest value, each gradient within
    2e-2 of its largest value (float32 sums in another order, then bf16)."""
    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import ln_qkv

    args, cot = _inputs(2, 50, seed=7)
    x16 = torch.from_numpy(args[0]).to(torch.bfloat16)
    params = [torch.from_numpy(a) for a in args[1:5]]
    fwd_qkv = ln_qkv(x16, *(p.to(torch.bfloat16) for p in params), 1e-12)[0]
    bwd_qkv = ln_qkv(x16, *params, 1e-12)[0]
    assert fwd_qkv.dtype == bwd_qkv.dtype == torch.bfloat16
    assert (fwd_qkv != bwd_qkv).float().mean() > 0.05  # the split is real

    want_out, want = _jax_vjp(args, cot, jnp.bfloat16)
    got_out, got = _port(args, cot, torch.bfloat16)
    step = 2.0 ** -7 * np.abs(want_out).max()
    np.testing.assert_allclose(got_out, want_out, atol=step, rtol=0)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=2e-2 * np.abs(w).max(), rtol=0, err_msg=name)


def test_plain_k6_t_real_masks_the_keys_past_it():
    """``fused_attention_sublayer`` with keys at or past ``t_real`` masked
    against the JAX function of the same name (T a multiple of 16)."""
    from multimodal_concept_learning_tpu.ops.fused_attention_block import (
        fused_attention_sublayer as jf,
    )

    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        fused_attention_sublayer,
    )

    args, cot = _inputs(2, 48, seed=3)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jf(*a, HEADS, 37), *map(jnp.asarray, args))
        want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = fused_attention_sublayer(*leaves, HEADS, 37)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=OUT_TOL, rtol=0)
    for name, g, w in zip(NAMES, leaves, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_pack_qkv_matches_jax():
    from multimodal_concept_learning_tpu.ops.fused_attention_block import pack_qkv as jpack

    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import pack_qkv

    rng = np.random.default_rng(0)
    kernels = [rng.standard_normal((64, 4, 16)).astype(np.float32) for _ in range(3)]
    biases = [rng.standard_normal((4, 16)).astype(np.float32) for _ in range(3)]
    want_w, want_b = jpack(*(a for pair in zip(kernels, biases) for a in pair))
    # nn.Linear layout: weight [out, in] = the DenseGeneral kernel reshaped and transposed
    got_w, got_b = pack_qkv(*(torch.from_numpy(t) for k, b in zip(kernels, biases)
                              for t in (k.reshape(64, -1).T, b.reshape(-1))))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def _vit_cfgs(fused: bool):
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JConfig

    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig

    jcfg = JConfig(hidden_size=WIDTH, intermediate_size=2 * WIDTH, num_hidden_layers=1,
                   num_attention_heads=HEADS, patch_size=8, image_size=32, num_labels=0,
                   dtype=jnp.float32, fused_attention=fused)
    cfg = ViTConfig(hidden_size=WIDTH, intermediate_size=2 * WIDTH, num_hidden_layers=1,
                    num_attention_heads=HEADS, patch_size=8, image_size=32, dtype=torch.float32,
                    fused_attention=fused)
    return jcfg, cfg


def test_vit_layer_fused_matches_jax_block(force_fused):
    """The port's ``ViTLayer(fused_attention=True)`` against the JAX
    ``ViTBlock`` on its fused branch, same weights: output, the input's
    gradient and every parameter's."""
    from multimodal_concept_learning_tpu.models.vit import ViTBlock

    from multimodal_concept_learning_tpu_torch.checkpoint import _flatten, _vit_export
    from multimodal_concept_learning_tpu_torch.models.vit import ViTLayer

    jcfg, cfg = _vit_cfgs(True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 50, WIDTH)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    block = ViTBlock(jcfg)
    with pltpu.force_tpu_interpret_mode():
        params = block.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)

    def loss(p, xx):
        return jnp.sum(block.apply({"params": p}, xx) * cot)

    with pltpu.force_tpu_interpret_mode():
        want_out = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
        want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    def to_port(tree):
        return {name.removeprefix("encoder.layer.0."): torch.from_numpy(np.array(a, np.float32))
                for rel, arr in _flatten(tree).items()
                for name, a in _vit_export(f"layer_0/{rel}", np.asarray(arr), 8)}

    layer = ViTLayer(cfg)
    layer.load_state_dict(to_port(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    want_g = to_port(jax.tree_util.tree_map(np.asarray, want_gp))
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_fused_config_clip_tree_loads_strict(force_fused):
    """A JAX CLIP tree initialised on the fused branch (its parameter
    holders) loads into the port's fused-config CLIP with ``strict=True``,
    and the fused and unfused port models compute the same features."""
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel

    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel

    dims = dict(vision_preset="vit-t-8", image_size=32, text_width=64, text_layers=1,
                text_heads=4, context_length=8, embed_dim=16)
    jcfg = JConfig.create(vocab_size=50, attention_layout="bthd", text_attention_core=True,
                          **dims)
    jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision, fused_attention=True))
    # the fused init's tree (names and shapes) without running the kernels,
    # filled with seeded values
    rng = np.random.default_rng(0)
    with pltpu.force_tpu_interpret_mode():
        shapes = jax.eval_shape(JModel(jcfg).init, jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    sd = clip_state_dict_from_jax(params, 8)
    base = CLIPConfig.create(vocab_size=50, dtype=torch.float32, **dims)
    fused = dataclasses.replace(base, vision=dataclasses.replace(base.vision,
                                                                 fused_attention=True))
    models = []
    for cfg in (base, fused):
        model = CLIPModel(cfg)
        model.load_state_dict(sd, strict=True)
        models.append(model)
    images = torch.from_numpy(rng.random((2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        a, b = (m.encode_image(images) for m in models)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", [17, 33])
def test_plain_k6_at_head_dim_16_matches_jax(t):
    """vit-t-8's widths (64 wide, 4 heads of 16; T 17 at 32 px): the
    port's forward and every gradient against the JAX custom VJP."""
    from multimodal_concept_learning_tpu.ops.fused_attention_block import (
        attention_sublayer as jf,
    )

    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        attention_sublayer,
    )

    heads = 4
    args, cot = _inputs(2, t, seed=200 + t, width=64)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda *a: jf(*a, heads=heads), *map(jnp.asarray, args))
        want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = attention_sublayer(*leaves, heads)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=OUT_TOL, rtol=0)
    for name, g, w in zip(NAMES, leaves, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("m,k,n,transpose_a", [(50, 64, 192, False), (96, 50, 64, True),
                                               (7, 128, 3, False)])
def test_backward_products_in_float32(m, k, n, transpose_a):
    """``mm_f32``, the five products of the K6 backward: on the CPU two bf16
    operands give exactly ``a.float() @ b.float()`` in float32, and float32
    operands exactly ``a @ b`` (the card's bf16 product with float32 output
    differs from these only in the order of its sums)."""
    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import mm_f32

    rng = np.random.default_rng(m + k + n)
    a32 = torch.from_numpy(rng.standard_normal((k, m) if transpose_a else (m, k),
                                               dtype=np.float32))
    b32 = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    a32 = a32.t() if transpose_a else a32
    a16, b16 = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    got = mm_f32(a16, b16)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, a16.float() @ b16.float())
    got32 = mm_f32(a32, b32)
    assert got32.dtype == torch.float32 and torch.equal(got32, a32 @ b32)


@pytest.mark.parametrize("width", [512, 768])
@pytest.mark.parametrize("head_dim", [16, 32, 64])
def test_k6_forward_plan_fits_shared_memory_at_max_t(head_dim, width):
    """The bf16 forward's qkv-attention kernel at the largest T it takes
    (320): its shared memory stays within the 227 KB a block may use."""
    from multimodal_concept_learning_tpu_torch.ops._build import SMEM_PER_BLOCK
    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        MAX_T,
        k6_fwd_plan,
    )

    bblk, blocks, bk, smem = k6_fwd_plan(256, MAX_T, head_dim, width)
    assert bblk == 1 and blocks == 256 and bk in (32, 64)
    assert smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("b,t", [(7, 50), (256, 50), (5, 37), (3, 17), (2, 197), (1, 64)])
def test_k6_forward_plan_covers_every_sample_once(b, t):
    """Blocks of whole samples, at most 128 rows a block (one sample past
    that), cover samples 0..B-1 exactly once when B is not a multiple of the
    block."""
    from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
        K6_PASS_ROWS,
        k6_fwd_plan,
    )

    bblk, blocks, _, _ = k6_fwd_plan(b, t, 64, 768)
    assert bblk == 1 or bblk * t <= K6_PASS_ROWS
    covered = [s for i in range(blocks) for s in range(i * bblk, min(b, (i + 1) * bblk))]
    assert covered == list(range(b))
    assert blocks == -(-b // bblk) and (blocks - 1) * bblk < b  # no empty block
