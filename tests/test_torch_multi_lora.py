"""PyTorch port: multi-LoRA banks (``ops/multi_lora.py``, the bank
branches of the whole-batch and dense continuous engines,
``serve/loader.load_adapter_bank``) vs the JAX package (CPU, float32).

A bank of three adapters on one base (rank 4; entry 0 the identity, then
two adapters with seeded factors and projectors, as JAX
``tests/test_multi_lora.py:_adapter_tree`` builds them) decodes a mixed
batch with exactly the tokens of JAX's ``multi_lora_generate`` and of each
adapter's own merged model; an int8 bank exactly those of each adapter's
int8 model and of JAX's int8 bank; both serving engines route per-request
adapters as their JAX counterparts do; every refusal raises JAX's message.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

RANK = 4
VOCAB = 1152  # the serving tokenizer's 1142 entries fit
AIDX = [0, 2, 1, 2]
NEW = 5


def _adapter_tree(base, seed):
    """A trained-adapter stand-in: seeded factors and projector."""
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if any(k.endswith("_lora") for k in keys) or "projector" in keys:
            return (0.05 * r.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, base)


@pytest.fixture(scope="module")
def bank_setup():
    from multimodal_concept_learning_tpu.ops.multi_lora import (
        identity_adapter_params,
        stack_adapter_params,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        identity_adapter_params as identity,
    )
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        stack_adapter_params as stack,
    )

    model, params, port = tp.make_pair({"lora_rank": RANK}, seed=5, vocab=VOCAB)
    p0 = params["params"]
    trees = [jax.tree_util.tree_map(np.asarray, identity_adapter_params(p0)),
             _adapter_tree(p0, 1), _adapter_tree(p0, 2)]
    sds = [state_dict_from_jax(t, 8) for t in trees]
    zeroed = identity(state_dict_from_jax(p0, 8))
    assert sorted(zeroed) == sorted(sds[0])
    assert all(torch.equal(t, sds[0][k]) for k, t in zeroed.items())
    batch = tp.prompt_batch(port.cfg, [6, 3, 8, 5], seed=4)
    return {"model": model, "trees": trees, "bank": stack_adapter_params(trees), "port": port,
            "sds": sds, "port_bank": stack(sds), "batch": batch}


def _port_model(sd, cfg, **quant):
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm

    return build_mllm(cfg.quantized(**quant), sd, "cpu")


def test_stack_identity_select_match_jax(bank_setup):
    """``select_adapter_params`` gives back each entry's adapter surface;
    the surface is the one JAX's ``adapter_in_axes`` maps."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.ops.multi_lora import adapter_in_axes
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        is_adapter_name,
        select_adapter_params,
    )

    s = bank_setup
    bank, sds = s["port_bank"], s["sds"]
    for i, sd in enumerate(sds):
        sel = select_adapter_params(bank, torch.tensor([i]))
        for name, t in sd.items():
            got = sel[name][0] if is_adapter_name(name) else sel[name]
            assert torch.equal(got, t if is_adapter_name(name) else sds[0][name]), (i, name)
    axes = adapter_in_axes(s["trees"][0])
    marks = jax.tree_util.tree_map(lambda a, p: np.full(np.shape(p), float(a == 0), np.float32),
                                   axes, s["trees"][0], is_leaf=lambda x: x is None)
    want = {k: bool(v.all()) for k, v in mllm_params_to_torch(marks, patch_size=8).items()}
    assert want == {k: is_adapter_name(k) for k in sds[0]} and sum(want.values()) == 2 + 28


def test_bank_generate_matches_jax_and_merged(bank_setup):
    """A mixed batch: the tokens of JAX's ``multi_lora_generate`` and, row
    by row, of the row's adapter merged into a rank-0 model."""
    from multimodal_concept_learning_tpu.ops.multi_lora import multi_lora_generate as jgen
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate
    from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import multi_lora_generate

    s = bank_setup
    images, ids, mask = s["batch"]
    want = np.asarray(jgen(s["model"], s["bank"], jnp.asarray(AIDX, jnp.int32),
                           *map(jnp.asarray, s["batch"]), max_new_tokens=NEW, eos_id=None,
                           pad_id=0))
    base = _port_model(s["sds"][0], s["port"].cfg)
    got = multi_lora_generate(base, s["port_bank"], torch.tensor(AIDX),
                              *map(torch.from_numpy, s["batch"]), max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    cfg = s["port"].cfg
    cfg0 = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, lora_rank=0))
    for a in sorted(set(AIDX)):
        merged = _port_model(merge_lora_params(s["sds"][a], cfg.lm.lora_alpha), cfg0)
        rows = [i for i, x in enumerate(AIDX) if x == a]
        ref = greedy_generate(merged, *(torch.from_numpy(x[rows]) for x in (images, ids, mask)),
                              NEW).numpy()
        np.testing.assert_array_equal(got[rows], ref, err_msg=f"adapter {a}")


def test_int8_bank_matches_per_adapter_int8(bank_setup):
    """Quantizing the stacked bank quantizes the shared base only: the
    factors and projectors keep their bank axis in float, and each row
    decodes as its adapter's own int8 model and as JAX's int8 bank."""
    from multimodal_concept_learning_tpu.ops.multi_lora import multi_lora_generate as jgen
    from multimodal_concept_learning_tpu.ops.quant import quantize_mllm_params as jquant
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        is_adapter_name,
        multi_lora_generate,
    )
    from multimodal_concept_learning_tpu_torch.ops.quant import quantize_mllm_params

    s = bank_setup
    images, ids, mask = s["batch"]
    cfg = s["port"].cfg
    qbank = quantize_mllm_params(s["port_bank"], vision=False, lm=True)
    lora_a = qbank["language_model.model.layers.0.self_attn.q_proj_lora.a"]
    assert lora_a.shape[0] == 3 and lora_a.dtype == torch.float32
    assert qbank["projector.weight"].shape[0] == 3
    assert qbank["language_model.model.layers.0.self_attn.q_proj.kernel"].dtype == torch.int8
    base = {k: v[0] if is_adapter_name(k) else v for k, v in qbank.items()}
    got = multi_lora_generate(_port_model(base, cfg, int8=True), qbank, torch.tensor(AIDX),
                              *map(torch.from_numpy, s["batch"]), max_new_tokens=NEW).numpy()
    for a in sorted(set(AIDX)):
        rows = [i for i, x in enumerate(AIDX) if x == a]
        own = _port_model(quantize_mllm_params(s["sds"][a], vision=False, lm=True), cfg,
                          int8=True)
        ref = greedy_generate(own, *(torch.from_numpy(x[rows]) for x in (images, ids, mask)),
                              NEW).numpy()
        np.testing.assert_array_equal(got[rows], ref, err_msg=f"adapter {a}")
    jcfg = s["model"].config
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM

    qmodel = JaxMLLM(dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm,
                                                                     int8_weights=True)))
    want = jgen(qmodel, jquant(jax.tree_util.tree_map(jnp.asarray, s["bank"]), jcfg,
                               vision=False, lm=True),
                jnp.asarray(AIDX, jnp.int32), *map(jnp.asarray, s["batch"]),
                max_new_tokens=NEW, eos_id=None, pad_id=0)
    np.testing.assert_array_equal(got, np.asarray(want))


# -- serving engines on a bank ------------------------------------------------------


class _ServeCfg:
    num_vision_tokens = 17
    image_size = 32
    seed = 0


def _port_loaded(model, bank=None, n=0):
    from multimodal_concept_learning_tpu_torch.serve.loader import LoadedMLLM
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    surface = None
    if bank is not None:
        from multimodal_concept_learning_tpu_torch.ops.multi_lora import is_adapter_name

        surface = {k: v for k, v in bank.items() if is_adapter_name(k)}
    return LoadedMLLM(model, ConceptTokenizer(), _ServeCfg(), {}, torch.device("cpu"),
                      bank=surface, num_adapters=n)


def _jax_loaded(model, params, n=0):
    from multimodal_concept_learning_tpu.serve.loader import LoadedMLLM
    from multimodal_concept_learning_tpu.tokenizer import ConceptTokenizer

    return LoadedMLLM(model, ConceptTokenizer(), params, _ServeCfg(), {}, None,
                      num_adapters=n)


@pytest.fixture(scope="module")
def engines(bank_setup):
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    s = bank_setup
    kw = dict(batch_size=3, max_new_tokens=4, max_prompt_len=8)
    cfg = s["port"].cfg
    bank = ServingEngine(_port_loaded(_port_model(s["sds"][0], cfg), s["port_bank"], 3), **kw)
    single = [ServingEngine(_port_loaded(_port_model(sd, cfg)), **kw) for sd in s["sds"]]
    return bank, single


REQUESTS = [(tp.SERVE_IMAGES[i], p) for i, p in enumerate(
    ["Is the circle red?", "Is the circle green?", "Is it blue?"])]


def test_serving_engine_bank(bank_setup, engines):
    """Whole-batch engine: each row's tokens are its adapter's own model's,
    and the texts the JAX bank engine's."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JaxEngine

    s = bank_setup
    bank, single = engines
    assert bank.num_adapters == 3
    imgs, prompts = [r[0] for r in REQUESTS], [r[1] for r in REQUESTS]
    adapters = [0, 2, 1]
    got = bank.generate_tokens(imgs, prompts, adapters)
    for i, a in enumerate(adapters):
        np.testing.assert_array_equal(got[i], single[a].generate_tokens([imgs[i]],
                                                                        [prompts[i]])[0])
    jax_engine = JaxEngine(_jax_loaded(s["model"], s["bank"], 3), batch_size=3,
                           max_new_tokens=4, max_prompt_len=8)
    assert bank.generate(imgs, prompts, adapters) == jax_engine.generate(imgs, prompts,
                                                                         adapters=adapters)


def test_continuous_engine_bank(bank_setup, engines):
    """Dense continuous engine: admitted with mixed adapters and stepped
    (the step gathers the slots' factors once a call), each slot decodes
    its adapter's tokens; through the batcher from three threads each
    request gets its adapter's text."""
    from multimodal_concept_learning_tpu_torch.serve.continuous import (
        ContinuousBatcher,
        ContinuousEngine,
    )

    s = bank_setup
    _, single = engines
    loaded = _port_loaded(_port_model(s["sds"][0], s["port"].cfg), s["port_bank"], 3)
    eng = ContinuousEngine(loaded, num_slots=3, max_new_tokens=4, max_prompt_len=8,
                           steps_per_call=2)
    assert eng.num_adapters == 3
    adapters = [1, 0, 2]
    firsts = eng.admit_many([(slot, img, p, a) for slot, ((img, p), a)
                             in zip((2, 0, 1), zip(REQUESTS, adapters))])
    toks = np.concatenate([eng.step(np.ones(3, bool)) for _ in range(2)], axis=1)
    for (img, p), a, slot, first in zip(REQUESTS, adapters, (2, 0, 1), firsts):
        want = single[a].generate_tokens([img], [p])[0]
        assert [first, *toks[slot][:3]] == want.tolist(), (slot, a)

    batcher = ContinuousBatcher(ContinuousEngine(loaded, num_slots=3, max_new_tokens=4,
                                                 max_prompt_len=8))
    try:
        results = {}
        threads = [threading.Thread(target=lambda i, a: results.__setitem__(
            i, batcher.submit(*REQUESTS[i], adapter=a)), args=(i, a))
            for i, a in enumerate(adapters)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i, a in enumerate(adapters):
            assert results[i] == single[a].generate([REQUESTS[i][0]], [REQUESTS[i][1]])[0]
    finally:
        batcher.shutdown()


def _refusal(kind, s):
    """(port call, JAX call) that must raise with one message."""
    from multimodal_concept_learning_tpu.serve.chunked import ChunkedContinuousEngine as JChunked
    from multimodal_concept_learning_tpu.serve.continuous import ContinuousEngine as JCont
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JServe
    from multimodal_concept_learning_tpu.serve.paged import PagedContinuousEngine as JPaged
    from multimodal_concept_learning_tpu_torch.serve.chunked import ChunkedContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine
    from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

    cfg = s["port"].cfg
    port_bank = _port_loaded(_port_model(s["sds"][0], cfg), s["port_bank"], 3)
    port_plain = _port_loaded(_port_model(s["sds"][1], cfg))
    jax_bank = _jax_loaded(s["model"], s["bank"], 3)
    jax_plain = _jax_loaded(s["model"], s["trees"][1])
    img, prompt = REQUESTS[0]
    kw = dict(batch_size=2, max_new_tokens=2, max_prompt_len=8)
    slot_kw = dict(num_slots=2, max_new_tokens=2, max_prompt_len=8)
    return {
        "paged": (lambda: PagedContinuousEngine(port_bank, **slot_kw),
                  lambda: JPaged(jax_bank, **slot_kw)),
        "chunked": (lambda: ChunkedContinuousEngine(port_bank, **slot_kw),
                    lambda: JChunked(jax_bank, **slot_kw)),
        "draft": (lambda: ServingEngine(port_bank, draft_layers=1, **kw),
                  lambda: JServe(jax_bank, draft_layers=1, **kw)),
        "beams": (lambda: ServingEngine(port_bank, num_beams=2, **kw),
                  lambda: JServe(jax_bank, num_beams=2, **kw)),
        "no-bank": (lambda: ServingEngine(port_plain, **kw).generate([img], [prompt], [1]),
                    lambda: JServe(jax_plain, **kw).generate([img], [prompt], adapters=[1])),
        "continuous-no-bank": (
            lambda: ContinuousEngine(port_plain, **slot_kw).admit_many([(0, img, prompt, 1)]),
            lambda: JCont(jax_plain, **slot_kw).admit_many([(0, img, prompt, 1)])),
        "out-of-range": (lambda: ServingEngine(port_bank, **kw).generate([img], [prompt], [3]),
                         lambda: JServe(jax_bank, **kw).generate([img], [prompt],
                                                                 adapters=[3])),
    }[kind]


@pytest.mark.parametrize("kind", ["paged", "chunked", "draft", "beams", "no-bank",
                                  "continuous-no-bank", "out-of-range"])
def test_refusals_match_jax(bank_setup, kind):
    """Each refusal raises the JAX package's message word for word (JAX
    asserts the adapter range; the port raises ValueError)."""
    port_call, jax_call = _refusal(kind, bank_setup)
    with pytest.raises(ValueError) as err:
        port_call()
    with pytest.raises((ValueError, AssertionError)) as jax_err:
        jax_call()
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["lora-free base", "lora-free adapter", "other rank"])
def test_load_adapter_bank_refusals_match_jax(tmp_path, case):
    """``load_adapter_bank`` refuses a base without adapters and an adapter
    of another structure, with the JAX loader's messages.  An adapter of
    another rank (same names, other shapes) gets the structure message
    from the port; JAX's structure check passes it and its stacking fails."""
    from multimodal_concept_learning_tpu.serve.loader import load_adapter_bank as jax_bank
    from multimodal_concept_learning_tpu_torch.serve.loader import load_adapter_bank

    lora_free = dict(lm_lora_rank=0, trainable_params_setting="language_embed_only")
    if case == "lora-free base":
        base = tp.write_lora_results_dir(tmp_path / "base", **lora_free)
        adapters = [base]
    else:
        base = tp.write_lora_results_dir(tmp_path / "base")
        other = lora_free if case == "lora-free adapter" else dict(lm_lora_rank=2)
        adapters = [tp.write_lora_results_dir(tmp_path / "other", **other)]
    with pytest.raises(ValueError) as err:
        load_adapter_bank(base, adapters, device="cpu", dtype=torch.float32, verbose=False)
    with pytest.raises(ValueError) as jax_err:
        jax_bank(base, adapters, verbose=False)
    if case == "other rank":
        assert "has a different parameter structure" in str(err.value)
    else:
        assert str(err.value) == str(jax_err.value)


def test_load_adapter_bank_matches_jax(tmp_path):
    """A bank loaded from results dirs (base, two adapters): the port's
    whole-batch engine gives each request its adapter's merged-model
    tokens, and the JAX bank engine's texts (float32)."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JaxEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    base = tp.write_lora_results_dir(tmp_path / "base")
    dirs = [base, tp.adapter_copy(base, tmp_path / "a2", seed=2)]
    kw = dict(batch_size=3, max_new_tokens=3, max_prompt_len=16)
    bank = tp.port_bank_load(base, dirs)
    assert bank.num_adapters == 3 and bank.model.cfg.lm.lora_rank == tp.LORA_RANK
    images, prompts = tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3]
    adapters = [2, 0, 1]
    got = ServingEngine(bank, **kw).generate_tokens(images, prompts, adapters)
    for i, a in enumerate(adapters):
        if a:  # adapter 0 is the base with its factors zeroed: no results dir of its own
            own = ServingEngine(tp.port_serving_load(dirs[a - 1]), **kw)
            np.testing.assert_array_equal(
                got[i], own.generate_tokens(images[i:i + 1], prompts[i:i + 1])[0])
    want = JaxEngine(tp.jax_bank_load(base, dirs), **kw).generate(images, prompts,
                                                                  adapters=adapters)
    assert ServingEngine(bank, **kw).generate(images, prompts, adapters) == want


def test_bench_script_rehearses_on_cpu():
    """``scripts/bench_multi_lora.py --tiny --device cpu``: both runs at
    every length, a fitted line each, the bank's tokens of every shape."""
    from multimodal_concept_learning_tpu_torch.scripts import bench_multi_lora

    res = bench_multi_lora.main(["--tiny", "--device", "cpu", "--batch", "3", "--k", "3",
                                 "--lengths", "2,3"])
    for name in ("plain", "bank"):
        assert sorted(res[name]["ms"]) == [2, 3]
        assert np.isfinite(res[name]["ms_per_token"]) and np.isfinite(res[name]["fixed_ms"])
        assert res["tokens"][name].shape == (3, 3)
