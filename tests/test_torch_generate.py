"""PyTorch port: generation on dense KV caches vs the JAX package (CPU, float32).

The port's ``greedy_generate`` must give exactly the JAX
``greedy_generate``'s tokens on the config of ``tests/test_generate.py``
(a 16 px ViT and a Gemma-3-shaped nano LM, with and without a sliding
window of 6 on every other layer) for ragged right-padded rows; its
``prefill`` / ``decode_step`` / ``decode_chunk`` hidden states agree with
JAX's within 1e-4; its ``generate`` gives exactly its own
``paged_generate``'s tokens (float and int4 weights); top-k 1 sampling is
greedy and a fixed generator seed reproduces its draws.  At most 3 new
tokens, so the JAX references stay cheap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

HIDDEN_TOL = 1e-4
N_NEW = 3
NANO_WINDOW = dict(sliding_window=8, sliding_window_pattern=2)  # below the prompt lengths


def _jax_config(sliding: bool):
    """``tests/test_generate.py``'s tiny MLLM config (float32)."""
    from multimodal_concept_learning_tpu.models.lm import LMConfig
    from multimodal_concept_learning_tpu.models.mllm import MLLMConfig
    from multimodal_concept_learning_tpu.models.vit import ViTConfig

    vision = ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                       num_attention_heads=2, patch_size=8, image_size=16, num_labels=0,
                       dtype=jnp.float32)
    lm = dataclasses.replace(LMConfig.preset("nano", vocab_size=97), dtype=jnp.float32,
                             use_qk_norm=True, sandwich_norms=True,
                             sliding_window=6 if sliding else None, sliding_window_pattern=2,
                             query_pre_attn_scalar=32.0)
    return MLLMConfig(vision=vision, lm=lm, num_vision_tokens=5, max_answer_tokens=2,
                      dtype=jnp.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["global", "sliding"])
def pair(request):
    """(jax module, params, port MLLM, ragged prompt batch as numpy)."""
    model, variables, port = tp.make_pair(jcfg=_jax_config(request.param), seed=3, vocab=97)
    rng = np.random.default_rng(3)
    b, text_len, nvt = 3, 9, 5
    images = rng.normal(size=(b, 3, 16, 16)).astype(np.float32)
    ids = np.zeros((b, nvt + text_len), np.int32)
    ids[:, nvt:] = rng.integers(4, 97, size=(b, text_len))
    mask = np.ones((b, nvt + text_len), np.int32)
    mask[1, -3:] = 0  # ragged right padding, longer than the window below
    mask[2, -1:] = 0
    ids[mask == 0] = 0
    return model, variables["params"], port, (images, ids, mask)


def _jax_decode_step(m, *args):
    return m.language_model.decode_step(*args)


def _jax_decode_chunk(m, *args):
    return m.language_model.decode_chunk(*args)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_greedy_generate_matches_jax(pair):
    from multimodal_concept_learning_tpu.models.mllm import greedy_generate as jax_greedy

    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    model, params, port, batch = pair
    run = jax.jit(lambda p, *a: jax_greedy(model, p, *a, max_new_tokens=N_NEW))
    want = np.asarray(run(params, *map(jnp.asarray, batch)))
    got = greedy_generate(port, *_torch(*batch), max_new_tokens=N_NEW)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_decode_step_and_chunk_match_jax(pair):
    """The same prompt prefilled on both sides, one decode step, then a
    chunk of 3 tokens per row (``decode_chunk``, the within-chunk causal
    mask): hidden states within 1e-4, and the caches' written slots too."""
    from multimodal_concept_learning_tpu.models.lm import init_kv_cache as jax_cache
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM

    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache

    model, params, port, (images, ids, mask) = pair
    lm = port.language_model
    b, t = ids.shape
    s = t + 1 + N_NEW
    seq = mask.sum(axis=1).astype(np.int32)
    jc = jax_cache(model.config.lm, b, s)
    pc = init_kv_cache(lm.cfg, b, s, "cpu")
    assert [tuple(c["k"].shape) for c in pc] == [c["k"].shape for c in jc]
    assert pc[0]["v"].dtype == torch.float32
    apply = jax.jit(model.apply, static_argnames="method")
    want_h, jc = apply({"params": params}, *map(jnp.asarray, (images, ids, mask)), jc,
                       method=JaxMLLM.prefill)
    with torch.inference_mode():
        got_h = port.prefill(*_torch(images, ids, mask), pc, kv_lens=torch.from_numpy(seq))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_h.numpy()[valid], np.asarray(want_h)[valid],
                               atol=HIDDEN_TOL, rtol=0)
    for c_p, c_j in zip(pc, jc):
        for part in ("k", "v"):
            np.testing.assert_allclose(c_p[part].numpy()[:, :t][valid],
                                       np.asarray(c_j[part])[:, :t][valid],
                                       atol=HIDDEN_TOL, rtol=0)

    rng = np.random.default_rng(11)
    step_tok = rng.integers(4, 97, size=(b, 1)).astype(np.int32)
    cache_mask = np.pad(mask, ((0, 0), (0, s - t)))
    cache_mask[np.arange(b), seq] = 1
    with torch.inference_mode():
        emb = lm.embed(torch.from_numpy(step_tok))
        got = lm.decode_step(emb, pc, torch.from_numpy(seq), torch.from_numpy(cache_mask))
    want, jc = apply({"params": params}, jnp.asarray(emb.numpy()), jc, jnp.asarray(seq),
                     jnp.asarray(cache_mask), method=_jax_decode_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HIDDEN_TOL, rtol=0)

    chunk = rng.integers(4, 97, size=(b, N_NEW)).astype(np.int32)
    start = seq + 1
    with torch.inference_mode():
        emb = lm.embed(torch.from_numpy(chunk))
        got = lm.decode_chunk(emb, pc, torch.from_numpy(start), torch.from_numpy(cache_mask))
    want, _ = apply({"params": params}, jnp.asarray(emb.numpy()), jc, jnp.asarray(start),
                    jnp.asarray(cache_mask), method=_jax_decode_chunk)
    assert got.shape == (b, N_NEW, lm.cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HIDDEN_TOL, rtol=0)


@pytest.mark.parametrize("int4", [False, True], ids=["float", "int4"])
def test_generate_matches_paged_generate(int4):
    """Dense caches and page pools give the same greedy tokens (vit-t-8 +
    nano with a window of 8 on every other layer, below the prompt length;
    ragged rows; eos); with int4 LM weights both decode through
    ``Int4Linear`` (the K5 wrapper's plain version on the CPU)."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        generate,
        greedy_generate,
        paged_generate,
    )
    from multimodal_concept_learning_tpu_torch.serve.loader import _quantize_for_serving

    _, _, port = tp.make_pair(NANO_WINDOW, seed=5)
    if int4:
        sd, cfg = _quantize_for_serving(port.state_dict(), port.cfg, False, False, False,
                                        int4=True)
        port = build_mllm(cfg, sd, "cpu")
    batch = _torch(*tp.prompt_batch(port.cfg, [9, 3, 6, 1], seed=2))
    free = greedy_generate(port, *batch, max_new_tokens=4)
    eos = int(free[0, 1])
    dense = generate(port, *batch, max_new_tokens=4, eos_id=eos, pad_id=0)
    paged = paged_generate(port, *batch, max_new_tokens=4, page_size=4, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(dense.numpy(), paged.numpy())
    assert (dense[0, 2:] == 0).all()  # pad_id after the row's eos


def test_top_k_one_is_greedy_and_a_seed_reproduces_draws():
    """Sampling at temperature 1 with top_k=1 gives the greedy tokens; with
    top_p 0.9 two generators of one seed draw the same tokens."""
    from multimodal_concept_learning_tpu_torch.models.mllm import generate, greedy_generate

    _, _, port = tp.make_pair(NANO_WINDOW, seed=6)
    batch = _torch(*tp.prompt_batch(port.cfg, [7, 2, 5], seed=4))
    greedy = greedy_generate(port, *batch, max_new_tokens=4)
    top1 = generate(port, *batch, max_new_tokens=4, temperature=1.0, top_k=1,
                    generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(top1.numpy(), greedy.numpy())
    draws = [generate(port, *batch, max_new_tokens=4, temperature=1.0, top_p=0.9,
                      generator=torch.Generator().manual_seed(17)) for _ in range(2)]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    with pytest.raises(ValueError, match="torch.Generator"):
        generate(port, *batch, max_new_tokens=2, temperature=0.7)
