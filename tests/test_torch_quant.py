"""PyTorch port: int8 weight quantization vs the JAX package (CPU).

The quantizer is bitwise JAX's; ``int8_matmul`` (exact int32 products,
float32 scales) within 1e-6 of JAX's on unit-scale inputs, through the
CPU's float64 product and through ``torch._int_mm`` with the row padding
the card needs; ``QuantLinear`` against ``QuantDense`` /
``QuantDenseGeneral``; the converters give the JAX converters' bits; an
int8 MLLM (vit-t-8 + nano, both towers int8) its vision features and LM
hidden states within 1e-4 of JAX's (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from multimodal_concept_learning_tpu.ops import quant as jquant
from multimodal_concept_learning_tpu_torch.ops import quant as tquant

ATOL = 1e-6


def _w(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 48), (128, 4, 32)])
def test_quantizer_is_bitwise_jax(shape):
    w = _w(shape)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows", [1, 8, 33])
def test_int8_matmul_matches_jax(rows):
    x = _w((rows, 128), seed=1, scale=128 ** -0.5)
    jq, js = jquant.quantize_weight(jnp.asarray(_w((128, 64), seed=2)))
    ref = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js))
    out = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(jq)),
                             torch.from_numpy(np.array(js)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows", [8, 17, 30])
def test_padded_int_mm_is_the_exact_product(rows):
    """The card's route (``torch._int_mm`` needs more than 16 rows): 8 rows
    padded to 24 and sliced back give the exact int32 product."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, 64)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (64, 40)).astype(np.int8))
    out = tquant.int_mm_padded(a, b)
    assert out.dtype == torch.int32 and out.shape == (rows, 40)
    assert torch.equal(out, (a.long() @ b.long()).to(torch.int32))


def _params(module, x, seed):
    params = module.init(jax.random.key(seed), jnp.asarray(x))["params"]
    if "bias" in params:
        params = dict(params, bias=jnp.asarray(_w(params["bias"].shape, seed=seed + 1)))
    return params


def _load(mod, params):
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                        strict=True)
    return mod


@pytest.mark.parametrize("bias", [False, True])
def test_quant_linear_matches_jax_quant_dense(bias):
    x = _w((2, 5, 64), seed=4, scale=0.125)
    jmod = jquant.QuantDense(features=48, use_bias=bias)
    params = _params(jmod, x, 5)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    out = _load(tquant.QuantLinear(64, 48, bias=bias), params)(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)


def test_quant_linear_general_forms_match_jax():
    """The q_proj form (output split into heads) with a (heads, hd) bias,
    and the o_proj form (contract the last two axes)."""
    h = _w((2, 3, 64), seed=6, scale=0.125)
    jq = jquant.QuantDenseGeneral(features=(4, 16), use_bias=True)
    qparams = _params(jq, h, 7)
    q = _load(tquant.QuantLinear(64, (4, 16), bias=True), qparams)
    np.testing.assert_allclose(q(torch.from_numpy(h)).detach().numpy(),
                               np.asarray(jq.apply({"params": qparams}, jnp.asarray(h))),
                               atol=ATOL, rtol=0)
    a = _w((2, 3, 4, 16), seed=8, scale=0.125)
    jo = jquant.QuantDenseGeneral(features=(64,), axis=(-2, -1))
    oparams = _params(jo, a, 9)
    o = _load(tquant.QuantLinear(64, (64,), axis=(-2, -1)), oparams)
    np.testing.assert_allclose(o(torch.from_numpy(a)).numpy(),
                               np.asarray(jo.apply({"params": oparams}, jnp.asarray(a))),
                               atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def int8_pair():
    """(JAX float module + params, JAX int8 module + params) of a tiny MLLM
    and the port's int8 MLLM loaded from the JAX int8 tree."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax

    model, params, _ = tp.make_pair()
    jcfg = model.config
    qparams = jquant.quantize_mllm_params(params, jcfg, vision=True, lm=True)
    qcfg = dataclasses.replace(
        jcfg, lm=dataclasses.replace(jcfg.lm, int8_weights=True),
        vision=dataclasses.replace(jcfg.vision, int8_weights=True))
    qparams = jax.tree_util.tree_map(np.asarray, qparams)
    port = build_mllm(tp.port_config(qcfg),
                      state_dict_from_jax(qparams, jcfg.vision.patch_size), "cpu")
    return (model, params), (JaxMLLM(qcfg), qparams), port


def test_converters_give_jax_bits(int8_pair):
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax

    (model, params), (_, qparams), _ = int8_pair
    patch = model.config.vision.patch_size
    ours = tquant.quantize_mllm_params(state_dict_from_jax(params, patch))
    theirs = state_dict_from_jax(qparams, patch)
    assert sorted(ours) == sorted(theirs)
    assert sum(k.endswith(".kernel") for k in ours) == 2 * 6 + 2 * 7  # vit-t-8 + nano
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and torch.equal(ours[k], theirs[k]), k


def test_int8_towers_match_jax(int8_pair):
    _, (qmodel, qparams), port = int8_pair
    images, ids, mask = tp.prompt_batch(qmodel.config, [5, 2, 9])
    apply = jax.jit(lambda p, im, i: qmodel.apply(p, im, i,
                                                  method=lambda m, a, b: m.prompt_embeds(a, b)))
    emb = np.asarray(apply(qparams, jnp.asarray(images), jnp.asarray(ids)))
    hid = jax.jit(lambda p, e, k: qmodel.apply(
        p, e, k, method=lambda m, a, b: m.language_model.hidden_states(a, b)))
    ref = np.asarray(hid(qparams, jnp.asarray(emb), jnp.asarray(mask)))
    with torch.no_grad():
        pemb = port.prompt_embeds(torch.from_numpy(images), torch.from_numpy(ids))
        out = port.language_model.hidden_states(
            pemb, torch.from_numpy(mask), torch.from_numpy(mask.sum(axis=1).astype(np.int32)))
    np.testing.assert_allclose(pemb.numpy(), emb, atol=1e-4, rtol=0)
    valid = mask.astype(bool)
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], atol=1e-4, rtol=0)
