"""PyTorch port: beam search (``models/beam.py``) vs the JAX package (CPU, float32).

The same weights (``tests/_torch_parity.py``: vit-t-8 tower, a small
Gemma-3-shaped LM with a window below the prompt length) and ragged
right-padded prompts go through the JAX ``beam_generate`` and the port's:
widths 2 and 3, with length penalties 0 and 0.6 and an EOS that finishes
beams early, give JAX's tokens exactly and its scores within 1e-5; width 1
is the port's greedy decoding; the whole-batch engine's beam branch gives
the JAX engine's texts.  With ``copy_init_ood_rows`` (the MLLM trainer's
init) beams tie on equal scores and still give JAX's tokens: among equals
the lower index comes first, as ``jax.lax.top_k`` orders them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

N_NEW = 5
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    model, params, port = tp.make_pair(tp.GEMMA_SMALL, seed=1)
    batch = tp.prompt_batch(port.cfg, [9, 3, 6], seed=2)
    return model, params["params"], port, batch


def _eos(port, batch) -> int:
    """A token greedy decoding emits second in row 1: beams meet it early."""
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    return int(greedy_generate(port, *map(torch.from_numpy, batch), max_new_tokens=2)[1, 1])


def test_width_one_is_greedy(pair):
    from multimodal_concept_learning_tpu_torch.models.beam import beam_generate
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    _, _, port, batch = pair
    tb = list(map(torch.from_numpy, batch))
    eos = _eos(port, batch)
    got = beam_generate(port, *tb, N_NEW, 1, eos_id=eos)
    assert got.dtype == torch.int32 and got.shape == (3, N_NEW)
    np.testing.assert_array_equal(got.numpy(),
                                  greedy_generate(port, *tb, N_NEW, eos_id=eos).numpy())


@pytest.mark.parametrize("width", [2, 3])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_matches_jax(pair, width, length_penalty):
    from multimodal_concept_learning_tpu.models.beam import beam_generate as jax_beam
    from multimodal_concept_learning_tpu_torch.models.beam import beam_generate

    model, params, port, batch = pair
    eos = _eos(port, batch)
    run = jax.jit(lambda p, *a: jax_beam(model, p, *a, max_new_tokens=N_NEW, num_beams=width,
                                         eos_id=eos, length_penalty=length_penalty,
                                         return_scores=True))
    want, want_scores = run(params, *map(jnp.asarray, batch))
    got, scores = beam_generate(port, *map(torch.from_numpy, batch), N_NEW, width, eos_id=eos,
                                length_penalty=length_penalty, return_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=SCORE_TOL, rtol=0)
    assert (got == eos).any()  # an EOS was kept, and what follows it is pad


def test_width_past_the_vocabulary_raises(pair):
    from multimodal_concept_learning_tpu_torch.models.beam import beam_generate

    _, _, port, batch = pair
    with pytest.raises(ValueError, match="vocabulary"):
        beam_generate(port, *map(torch.from_numpy, batch), 2, port.cfg.lm.vocab_size + 1)


def test_serving_engine_beam_branch_matches_jax(trained_results_dir):
    """ServingEngine(num_beams=2, length_penalty=0.6): the JAX engine's
    texts; sampling flags are refused as JAX refuses them."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    kw = dict(batch_size=4, max_new_tokens=4, max_prompt_len=16, num_beams=2,
              length_penalty=0.6)
    want = JEngine(tp.jax_serving_load(trained_results_dir), **kw).generate(
        tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3])
    port = tp.port_serving_load(trained_results_dir)
    assert ServingEngine(port, **kw).generate(tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3]) == want
    with pytest.raises(ValueError, match="deterministic"):
        ServingEngine(port, **dict(kw, temperature=0.7))


@pytest.fixture(scope="module")
def tied_pair(pair):
    """The beam pair with ``copy_init_ood_rows(params, 32)`` on its vocab of
    64: token i and its copy i + 32 get equal logits through the tied head,
    so beams tie on equal scores."""
    from multimodal_concept_learning_tpu.models.mllm import copy_init_ood_rows
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax

    model, params, port, batch = pair
    params = jax.tree_util.tree_map(
        np.asarray, copy_init_ood_rows(jax.tree_util.tree_map(jnp.asarray, params), 32))
    return model, params, build_mllm(port.cfg, state_dict_from_jax(params, 8), "cpu"), batch


@pytest.mark.parametrize("width", [2, 3])
def test_beam_ties_take_jax_order(tied_pair, width):
    """Among equal scores the lower index comes first (``jax.lax.top_k``'s
    order), so tied beams give JAX's tokens exactly and its scores within
    1e-5 (4 new tokens, no EOS)."""
    from multimodal_concept_learning_tpu.models.beam import beam_generate as jax_beam
    from multimodal_concept_learning_tpu_torch.models.beam import _top_k, beam_generate

    values, idx = _top_k(torch.tensor([0.0, 1.0, 1.0, 1.0, 0.5, 1.0]), 3)
    assert idx.tolist() == [1, 2, 3] and values.tolist() == [1.0, 1.0, 1.0]
    model, params, port, batch = tied_pair
    run = jax.jit(lambda p, *a: jax_beam(model, p, *a, max_new_tokens=4, num_beams=width,
                                         return_scores=True))
    want, want_scores = run(params, *map(jnp.asarray, batch))
    got, scores = beam_generate(port, *map(torch.from_numpy, batch), 4, width,
                                return_scores=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=SCORE_TOL, rtol=0)
