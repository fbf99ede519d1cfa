"""PyTorch port: models vs the JAX package on the same weights (CPU, float32).

Tiny seeded JAX MLLMs (vit-t-8 tower; the nano LM and a small
Gemma-3-shaped LM with qk-norm, sandwich norms, a window below the prompt
length and query_pre_attn_scalar != head_dim) are exported with the
port's ``state_dict_from_jax`` and loaded strictly into the port.
Tolerances: whole-model hidden states and logits in float32 <= 1e-4 abs
(XLA-CPU and ATen sum in different orders); greedy tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

ATOL = 1e-4
LENS = [5, 2, 9]  # text tokens per row: a ragged right-padded batch


@pytest.fixture(scope="module")
def nano_pair():
    return tp.make_pair()


@pytest.fixture(scope="module")
def gemma_pair():
    return tp.make_pair(tp.GEMMA_SMALL)


@pytest.fixture(params=["nano", "gemma3-small"])
def pair(request):
    return request.getfixturevalue("nano_pair" if request.param == "nano" else "gemma_pair")


def _apply(model, params, method, *args):
    """``model.apply`` under one jit (eager flax compiles every op apart)."""
    return jax.jit(lambda p, *a: model.apply(p, *a, method=method))(params, *args)


def _prompt_embeds(model, params, images, ids):
    return np.asarray(_apply(model, params, lambda m, a, b: m.prompt_embeds(a, b),
                             jnp.asarray(images), jnp.asarray(ids)))


def test_vit_encoder_matches_jax(nano_pair):
    model, params, port = nano_pair
    images, _, _ = tp.prompt_batch(model.config, LENS)
    ref = _apply(model, params, lambda m, im: m.vision_model(im), jnp.asarray(images))
    with torch.no_grad():
        out = port.vision_model(torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_hidden_states_match_jax(pair):
    model, params, port = pair
    images, ids, mask = tp.prompt_batch(model.config, LENS)
    emb = _prompt_embeds(model, params, images, ids)
    with torch.no_grad():
        pemb = port.prompt_embeds(torch.from_numpy(images), torch.from_numpy(ids))
        out = port.language_model.hidden_states(pemb, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(pemb.numpy(), emb, atol=ATOL, rtol=0)
    ref = np.asarray(_apply(model, params, lambda m, e, k: m.language_model.hidden_states(e, k),
                            jnp.asarray(emb), jnp.asarray(mask)))
    valid = mask.astype(bool)  # padded positions are never read by real ones
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)


def _jax_decode_step(m, tok, pools, pt, seq_lens):
    lm = m.language_model
    h, pools = lm.decode_step_paged(lm.embed(tok[:, None]), pools, pt, seq_lens)
    return h, pools, lm.lm_head(h[:, 0])


def test_prefill_and_decode_paged_match_jax(pair):
    """prefill_paged then two decode_step_paged steps: hidden states, pools
    and logits equal to JAX's on the same page table."""
    from multimodal_concept_learning_tpu.ops.paged_kv import init_paged_kv_cache as jinit
    from multimodal_concept_learning_tpu_torch.ops.paged_kv import init_paged_kv_cache as tinit

    model, params, port = pair
    cfg = model.config
    images, ids, mask = tp.prompt_batch(cfg, LENS)
    b, t = ids.shape
    ps, np_ = 4, -(-(t + 3) // 4)
    pt = (np.random.default_rng(3).permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    jpools = jinit(cfg.lm, 1 + b * np_, ps)
    tpools = tinit(port.cfg.lm, 1 + b * np_, ps, device="cpu")
    jh, jpools = _apply(model, params, lambda m, *x: m.prefill_paged(*x), jnp.asarray(images),
                        jnp.asarray(ids), jnp.asarray(mask), jpools, jnp.asarray(pt))
    with torch.no_grad():
        th = port.prefill_paged(torch.from_numpy(images), torch.from_numpy(ids),
                                torch.from_numpy(mask), tpools, torch.from_numpy(pt))
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], atol=ATOL, rtol=0)

    lm = port.language_model
    seq_lens = mask.sum(axis=1).astype(np.int32)
    tok = np.asarray([3, 7, 11], np.int32)
    for _ in range(2):
        jd, jpools, jlogits = _apply(model, params, _jax_decode_step, jnp.asarray(tok), jpools,
                                     jnp.asarray(pt), jnp.asarray(seq_lens))
        with torch.no_grad():
            td = lm.decode_step_paged(lm.embed(torch.from_numpy(tok)[:, None]), tpools,
                                      torch.from_numpy(pt), torch.from_numpy(seq_lens))
            tlogits = lm.lm_head(td[:, 0]).numpy()
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tlogits, np.asarray(jlogits), atol=ATOL, rtol=0)
        seq_lens = seq_lens + 1
        tok = tlogits.argmax(axis=-1).astype(np.int32)
    for layer in range(cfg.lm.num_layers):  # every page but the null page
        for kv in ("k", "v"):
            np.testing.assert_allclose(tpools[layer][kv].numpy()[1:],
                                       np.asarray(jpools[layer][kv])[1:], atol=ATOL, rtol=0)


def test_paged_generate_matches_jax(pair):
    from multimodal_concept_learning_tpu.models.mllm import paged_generate as jgen
    from multimodal_concept_learning_tpu_torch.models.mllm import paged_generate as tgen

    model, params, port = pair
    images, ids, mask = tp.prompt_batch(model.config, LENS, seed=5)
    gen = jax.jit(lambda p, *a: jgen(model, p, *a, max_new_tokens=6, page_size=8, eos_id=2))
    ref = np.asarray(gen(params["params"], jnp.asarray(images), jnp.asarray(ids),
                         jnp.asarray(mask)))
    out = tgen(port, torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
               max_new_tokens=6, page_size=8, eos_id=2)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_state_dict_from_jax_matches_torch_interop(gemma_pair):
    """Key for key and value for value the .pt layout of
    checkpoint/torch_interop.mllm_params_to_torch, and it loads strictly."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM

    model, params, _ = gemma_pair
    patch = model.config.vision.patch_size
    ref = mllm_params_to_torch(params, patch_size=patch)
    sd = state_dict_from_jax(params, patch_size=patch)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    port = MLLM(tp.port_config(model.config))
    port.load_state_dict(sd, strict=True)
    assert sorted(port.state_dict()) == sorted(ref)


def test_cast_for_compute_keeps_norms_and_embeddings_float32(gemma_pair):
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    model, params, _ = gemma_pair
    cfg = tp.port_config(model.config)
    cfg = MLLMConfig(vision=cfg.vision, lm=cfg.lm, num_vision_tokens=cfg.num_vision_tokens,
                     dtype=torch.bfloat16)
    port = build_mllm(cfg, state_dict_from_jax(params, 8), "cpu")
    dtypes = {n: p.dtype for n, p in port.named_parameters()}
    assert dtypes["language_model.model.layers.0.self_attn.q_proj.weight"] == torch.bfloat16
    assert dtypes["vision_model.embeddings.patch_embeddings.projection.weight"] == torch.bfloat16
    assert dtypes["projector.bias"] == torch.bfloat16
    for name in ("language_model.model.embed_tokens.weight",
                 "language_model.model.layers.0.self_attn.q_norm.weight",
                 "language_model.model.norm.weight", "vision_model.layernorm.weight",
                 "vision_model.embeddings.cls_token",
                 "vision_model.embeddings.position_embeddings"):
        assert dtypes[name] == torch.float32, name
