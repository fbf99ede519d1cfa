"""PyTorch port: sharded serving (four Gloo ranks on the CPU, a (2 data x
2 model) mesh) vs the JAX package's single process: the counterparts of
every test in ``test_serving_parallel.py``.

``make_sharded_generate`` (float and int8 towers), its sampling,
``make_sharded_paged_generate`` (float and int8 pools) and the continuous
engine through its batcher emit exactly the JAX single-process tokens;
int4 models are refused.  The ranks (``tests/_torch_mesh_worker.py``,
suite ``serving``) start once for the file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
import _torch_parity as tp


def _mllm(int8: bool = False, vocab: int = 97):
    from multimodal_concept_learning_tpu.models.lm import LMConfig
    from multimodal_concept_learning_tpu.models.mllm import MLLM, MLLMConfig
    from multimodal_concept_learning_tpu.models.vit import ViTConfig

    vision = ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                       num_attention_heads=2, patch_size=8, image_size=16,
                       num_labels=0, dtype=jnp.float32)
    lm = dataclasses.replace(LMConfig.preset("nano", vocab_size=vocab),
                             dtype=jnp.float32, int8_weights=int8)
    config = MLLMConfig(vision=vision, lm=lm, num_vision_tokens=5,
                        max_answer_tokens=2, dtype=jnp.float32)
    return MLLM(config), config


def _prompt(config, b=4, text_len=6):
    rng = np.random.default_rng(9)
    nvt = config.num_vision_tokens
    images = rng.normal(size=(b, 3, 16, 16)).astype(np.float32)
    ids = np.zeros((b, nvt + text_len), np.int32)
    ids[:, nvt:] = rng.integers(4, 97, size=(b, text_len))
    mask = np.ones_like(ids)
    mask[1, -2:] = 0  # ragged padding
    ids[mask == 0] = 0
    return images, ids, mask


def _port_cfg(jcfg):
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    p = tp.port_config(jcfg)
    return MLLMConfig(vision=p.vision, lm=p.lm, num_vision_tokens=jcfg.num_vision_tokens,
                      max_answer_tokens=jcfg.max_answer_tokens, dtype=torch.float32)


def _port_sd(params):
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax

    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), 8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from multimodal_concept_learning_tpu.models.mllm import MLLM, greedy_generate, paged_generate
    from multimodal_concept_learning_tpu.ops.quant import quantize_mllm_params
    from multimodal_concept_learning_tpu.serve import ServingEngine
    from multimodal_concept_learning_tpu.serve.loader import LoadedMLLM
    from multimodal_concept_learning_tpu.tokenizer import ConceptTokenizer

    workdir = tmp_path_factory.mktemp("serving")
    procs = tm.start("serving", 4, workdir)

    model, config = _mllm()
    images, ids, mask = _prompt(config)
    init = jax.jit(model.init)
    params = init(jax.random.key(0), images, ids, mask)["params"]
    params2 = init(jax.random.key(2), images, ids, mask)["params"]
    fparams = init(jax.random.key(1), images, ids, mask)["params"]
    qparams = quantize_mllm_params(fparams, config, vision=True, lm=True)
    qconfig = dataclasses.replace(config, lm=dataclasses.replace(config.lm, int8_weights=True),
                                  vision=dataclasses.replace(config.vision, int8_weights=True))
    rng = np.random.default_rng(11)
    c_images = [rng.standard_normal((3, 16, 16)).astype(np.float32) for _ in range(5)]
    prompts = [f"is it {w}?" for w in ("red", "green", "blue", "pink", "tan")]
    n_new, n_new_int8, ps = 5, 4, 4
    # the engine's model covers the tokenizer's ids (the port's embedding
    # raises on an id past its table, where JAX's lookup fills)
    tok = ConceptTokenizer()
    cmodel, cconfig = _mllm(vocab=len(tok))
    cparams = jax.jit(cmodel.init)(jax.random.key(0), images, ids, mask)["params"]

    tm.write_inputs(workdir, {
        "cfg": _port_cfg(config), "sd": _port_sd(params), "sd2": _port_sd(params2),
        "qcfg": _port_cfg(qconfig), "qsd": _port_sd(qparams),
        "prompt": dict(images=images, ids=ids, mask=mask), "n_new": n_new,
        "n_new_int8": n_new_int8, "page_size": ps,
        "continuous": dict(images=c_images, prompts=prompts, n_new=4, plen=8,
                           cfg=_port_cfg(cconfig), sd=_port_sd(cparams)),
    })

    ref = {}
    ref["dense"] = np.asarray(greedy_generate(model, params, images, ids, mask, n_new))
    ref["paged"] = np.asarray(paged_generate(model, params, images, ids, mask, n_new, ps))
    ref["paged_q"] = np.asarray(paged_generate(model, params, images, ids, mask, n_new, ps,
                                               quant_kv=True))
    ref["int8"] = np.asarray(greedy_generate(MLLM(qconfig), qparams, images, ids, mask,
                                             n_new_int8))

    class _Cfg:
        num_vision_tokens = config.num_vision_tokens
        image_size = 16

    loaded = LoadedMLLM(cmodel, tok, cparams, _Cfg(), {}, None)
    engine = ServingEngine(loaded, batch_size=1, max_new_tokens=4, max_prompt_len=8)
    ref["continuous"] = {i: engine.generate([c_images[i]], [prompts[i]])[0] for i in range(5)}
    return tm.collect(procs, workdir), ref


def test_sharded_generate_matches_single_device(run):
    ranks, ref = run
    for r in ranks:  # every rank returns the global token matrix
        np.testing.assert_array_equal(r["generate"], ref["dense"])
        assert r["gate_sharded"]  # TP sharded something: nano's MLP divides 2
        assert r["local_heads"] == (2, 1)  # 4 query heads, 2 KV heads over 2 model ranks
        assert r["generate_counts"].get("all_reduce", 0) > 0
        assert r["generate_counts"].get("all_gather", 0) > 0


def test_sharded_generate_int8(run):
    """Both towers int8: the replicated scales are sliced to the local
    output columns; the row-parallel products sum exact int32 partials."""
    ranks, ref = run
    for r in ranks:
        np.testing.assert_array_equal(r["int8"], ref["int8"])


def test_sharded_generate_sampling_reproducible(run):
    ranks, _ = run
    for r in ranks:
        a, b = r["sampled"]
        np.testing.assert_array_equal(a, b)
        assert a.shape == (4, 4)


def test_sharded_paged_generate_matches_single_device(run):
    ranks, ref = run
    np.testing.assert_array_equal(ref["paged"], ref["dense"])
    for r in ranks:
        np.testing.assert_array_equal(r["paged_False"], ref["dense"])
        np.testing.assert_array_equal(r["paged_True"], ref["paged_q"])


def test_mesh_continuous_engine_matches_isolated(run):
    ranks, ref = run
    assert ranks[0]["continuous"] == ref["continuous"]
    assert all(r["engine_local_slots"] == 2 for r in ranks)  # 4 slots over 2 data ranks
    assert all("must divide num_slots 3" in r["odd_slots"] for r in ranks)


def test_sharded_rejects_int4():
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.parallel.serving import (
        make_sharded_generate,
        make_sharded_paged_generate,
    )

    _, config = _mllm()
    cfg = _port_cfg(config)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, int4_weights=True))
    with torch.device("meta"):
        model = MLLM(cfg)
    with pytest.raises(ValueError, match="int4"):
        make_sharded_generate(model, None, 4)
    with pytest.raises(ValueError, match="int4"):
        make_sharded_paged_generate(model, None, 4)
