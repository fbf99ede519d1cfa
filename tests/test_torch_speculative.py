"""PyTorch port: self-speculative decoding (``models/speculative.py``) vs
the JAX package (CPU, float32).

``decode_chunk(num_layers=1)``, the early-exit draft's forward, matches
JAX's hidden states within 1e-4; ``speculative_generate`` gives exactly
the JAX function's tokens and the port's greedy tokens at draft depths 1
and 2 and draft lengths 2 and 4, with an EOS; the whole-batch engine's
draft branch gives the JAX engine's texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

N_NEW = 6
HIDDEN_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    model, params, port = tp.make_pair(tp.GEMMA_SMALL, seed=4)
    batch = tp.prompt_batch(port.cfg, [9, 3, 6], seed=5)
    return model, params["params"], port, batch


def _greedy(port, batch, eos=None):
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    return greedy_generate(port, *map(torch.from_numpy, batch), N_NEW, eos_id=eos)


def test_draft_decode_chunk_matches_jax(pair):
    """Prefill, then a 3-token chunk through the first layer only: hidden
    states within 1e-4, and the layers past the draft keep their caches."""
    from multimodal_concept_learning_tpu.models.lm import init_kv_cache as jax_cache
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache

    model, params, port, (images, ids, mask) = pair
    lm = port.language_model
    b, t = ids.shape
    s = t + 4
    seq = mask.sum(axis=1).astype(np.int32)
    apply = jax.jit(model.apply, static_argnames="method")
    _, jc = apply({"params": params}, *map(jnp.asarray, (images, ids, mask)),
                  jax_cache(model.config.lm, b, s), method=JaxMLLM.prefill)
    pc = init_kv_cache(lm.cfg, b, s, "cpu")
    with torch.inference_mode():
        port.prefill(*map(torch.from_numpy, (images, ids, mask)), pc,
                     kv_lens=torch.from_numpy(seq))
    before = pc[1]["k"].clone()
    chunk = np.random.default_rng(6).integers(4, 64, size=(b, 3)).astype(np.int32)
    cache_mask = np.pad(mask, ((0, 0), (0, s - t)))
    with torch.inference_mode():
        emb = lm.embed(torch.from_numpy(chunk))
        got = lm.decode_chunk(emb, pc, torch.from_numpy(seq), torch.from_numpy(cache_mask),
                              num_layers=1)
    want, _ = apply({"params": params}, jnp.asarray(emb.numpy()), jc, jnp.asarray(seq),
                    jnp.asarray(cache_mask),
                    method=lambda m, *a: m.language_model.decode_chunk(*a, num_layers=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HIDDEN_TOL, rtol=0)
    assert torch.equal(pc[1]["k"], before)


@pytest.mark.parametrize("draft_layers", [1, 2])
@pytest.mark.parametrize("draft_len", [2, 4])
def test_speculative_matches_jax_and_greedy(pair, draft_layers, draft_len):
    from multimodal_concept_learning_tpu.models.speculative import (
        speculative_generate as jax_speculative,
    )
    from multimodal_concept_learning_tpu_torch.models.speculative import speculative_generate

    model, params, port, batch = pair
    eos = int(_greedy(port, batch)[1, 2])  # row 1 meets it at its third token
    want = jax_speculative(model, params, *map(jnp.asarray, batch), max_new_tokens=N_NEW,
                           draft_layers=draft_layers, draft_len=draft_len, eos_id=eos)
    got, stats = speculative_generate(port, *map(torch.from_numpy, batch), N_NEW,
                                      draft_layers=draft_layers, draft_len=draft_len,
                                      eos_id=eos, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), _greedy(port, batch, eos).numpy())
    assert (got == eos).any() and got.dtype == torch.int32
    assert stats["full_model_calls"] == stats["iterations"] >= -(-(N_NEW - 1) // draft_len)


def test_speculative_argument_checks(pair):
    from multimodal_concept_learning_tpu_torch.models.speculative import speculative_generate

    _, _, port, batch = pair
    tb = list(map(torch.from_numpy, batch))
    with pytest.raises(ValueError, match="draft_layers"):
        speculative_generate(port, *tb, 2, draft_layers=port.cfg.lm.num_layers + 1)
    with pytest.raises(ValueError, match="draft_len"):
        speculative_generate(port, *tb, 2, draft_layers=1, draft_len=1)


def test_serving_engine_draft_branch_matches_jax(trained_results_dir):
    """ServingEngine(draft_layers=1, draft_len=3): the JAX engine's texts;
    JAX's argument errors word for word."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    kw = dict(batch_size=4, max_new_tokens=4, max_prompt_len=16, draft_layers=1, draft_len=3)
    jax_loaded = tp.jax_serving_load(trained_results_dir)
    want = JEngine(jax_loaded, **kw).generate(tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3])
    port = tp.port_serving_load(trained_results_dir)
    assert ServingEngine(port, **kw).generate(tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3]) == want
    for bad in (dict(num_beams=2), dict(top_k=5), dict(draft_layers=9), dict(draft_len=1)):
        with pytest.raises(ValueError) as err:
            ServingEngine(port, **dict(kw, **bad))
        with pytest.raises(ValueError) as jax_err:
            JEngine(jax_loaded, **dict(kw, **bad))
        assert str(err.value) == str(jax_err.value)
