"""PyTorch port: the paged serving path vs the JAX package (CPU, float32).

Both packages load the same 1-epoch-trained tiny results dir (the
``trained_results_dir`` fixture, reference layout) at float32; the port's
paged engine must produce exactly the JAX ``PagedContinuousEngine``'s
greedy tokens, and the port's HTTP server the JAX front's texts; so must
the quantized models (``int4``; ``int8`` with ``int8_vision``), each side
quantizing the same float checkpoint.  Also: ``make_server`` refuses
what the JAX server refuses with the same messages, and multi-LoRA banks
(unported) loudly; sampling filters match JAX.  The other fronts:
``tests/test_torch_serve_fronts.py``.
"""

import base64
import dataclasses
import http.client
import io
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import SERVE_IMAGES as IMAGES
from _torch_parity import SERVE_PROMPTS as PROMPTS
from _torch_parity import jax_serving_load as _jax_load
from _torch_parity import port_serving_load

ENGINE_KW = dict(num_slots=4, max_new_tokens=4, max_prompt_len=16, page_size=8,
                 steps_per_call=2)


@pytest.fixture(scope="module")
def jax_loaded(trained_results_dir):
    return _jax_load(trained_results_dir)


@pytest.fixture(scope="module")
def port_loaded(trained_results_dir):
    return port_serving_load(trained_results_dir)


def test_paged_engine_tokens_match_jax(jax_loaded, port_loaded):
    """admit_many / step / release / re-admit: the same greedy tokens for
    every active slot, and the same page accounting."""
    _engines_agree(jax_loaded, port_loaded)


QUANT_MODES = [{"int4": True}, {"int8": True, "int8_vision": True}]


@pytest.mark.parametrize("quant", QUANT_MODES, ids=["int4", "int8+int8_vision"])
def test_quantized_paged_engine_tokens_match_jax(trained_results_dir, quant):
    """The same float checkpoint quantized by each package's loader: the
    weights agree bit for bit and the paged engines' greedy tokens match."""
    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm

    port = load_trained_mllm(trained_results_dir, device="cpu", dtype=torch.float32,
                             verbose=False, **quant)
    cfg = port.model.cfg
    assert cfg.lm.int4_weights == quant.get("int4", False)
    assert cfg.lm.int8_weights == cfg.vision.int8_weights == quant.get("int8", False)
    sd = port.model.state_dict()
    leaf = "packed" if quant.get("int4") else "kernel"
    assert sd[f"language_model.model.layers.0.mlp.up_proj.{leaf}"].dtype == torch.int8
    _engines_agree(_jax_load(trained_results_dir, **quant), port)


def _engines_agree(jax_loaded, port_loaded):
    from multimodal_concept_learning_tpu.serve.paged import PagedContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.paged import (
        PagedContinuousEngine as TEngine,
    )

    jeng, teng = JEngine(jax_loaded, **ENGINE_KW), TEngine(port_loaded, **ENGINE_KW)
    reqs = [(2, IMAGES[0], PROMPTS[0]), (0, IMAGES[1], PROMPTS[1]), (3, IMAGES[2], PROMPTS[2])]
    assert teng.admit_many(reqs) == jeng.admit_many(reqs)
    active = np.asarray([True, False, True, True])
    for _ in range(2):
        np.testing.assert_array_equal(teng.step(active)[active], jeng.step(active)[active])
    for eng in (jeng, teng):
        eng.release(2)
    assert teng.allocator.available == jeng.allocator.available
    assert (teng.page_table[2] == 0).all()
    reqs = [(1, IMAGES[3], PROMPTS[3]), (2, IMAGES[0], PROMPTS[1])]
    assert teng.admit_many(reqs) == jeng.admit_many(reqs)
    active = np.ones(4, bool)
    np.testing.assert_array_equal(teng.step(active), jeng.step(active))
    assert teng.decode_steps == 3 * ENGINE_KW["steps_per_call"]


def test_paged_server_matches_jax_front(jax_loaded, trained_results_dir):
    """The port's HTTP server (make_server --paged) answers with the JAX
    paged front's texts; /healthz and /metrics answer over the socket."""
    from multimodal_concept_learning_tpu.serve.continuous import ContinuousBatcher as JBatcher
    from multimodal_concept_learning_tpu.serve.paged import PagedContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    jbatcher = JBatcher(JEngine(jax_loaded, **ENGINE_KW))
    try:
        expected = [jbatcher.submit(img, p) for img, p in zip(IMAGES, PROMPTS)]
    finally:
        jbatcher.shutdown()

    httpd, batcher = make_server(trained_results_dir, port=0, paged=True, batch_size=4,
                                 max_new_tokens=4, max_prompt_len=16, page_size=8,
                                 steps_per_call=2, device="cpu", dtype=torch.float32)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        got = [None] * len(PROMPTS)

        def submit(i):
            got[i] = batcher.submit(IMAGES[i], PROMPTS[i])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == expected

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray((IMAGES[1].transpose(1, 2, 0) * 255).astype(np.uint8)).save(buf, "PNG")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        conn.request("POST", "/generate", body=json.dumps({
            "prompt": PROMPTS[1], "image_b64": base64.b64encode(buf.getvalue()).decode()}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 200 and body["text"] == expected[1]
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["ok"] is True
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        metrics = json.loads(r.read())
        assert metrics["completed"] == len(PROMPTS) + 1 and metrics["latency_p50_ms"] > 0
        conn.request("POST", "/generate", body=json.dumps({"prompt": "x"}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        assert r.status == 400
        conn.close()
    finally:
        httpd.shutdown()
        batcher.shutdown()
    # every request retired and returned its pages
    eng = batcher.engine
    assert eng.allocator.available == eng.num_pages - 1


@pytest.mark.parametrize("kwargs,match", [
    ({"chunked_prefill": 8}, "requires --continuous"),
    ({"continuous": True, "adapters": ["a"]}, "--adapters"),
    ({"continuous": True, "paged": True, "chunked_prefill": 8}, "excludes --paged"),
    ({"continuous": True, "int8_kv": True}, "requires --paged"),
    ({"int8": True, "int8_vision": True, "adapters": ["a"]}, "--adapters"),
    ({"continuous": True, "num_beams": 2}, "whole-batch front only"),
    ({"paged": True, "draft_layers": 1}, "whole-batch front only"),
    ({"paged": True, "adapters": ["a"]}, "exclude --paged"),
    ({"int4": True, "adapters": ["a"]}, "not --int4"),
])
def test_make_server_refuses_unported_modes(tmp_path, kwargs, match):
    """The JAX server's ValueErrors (``serve/server.py:214-238``): both
    packages raise them with the same message before any model loads.  The
    two ``--adapters`` cases that JAX accepts build a multi-LoRA bank server
    on tiny ``language_lora`` results dirs (a base and one adapter) and
    answer a request under adapter 1, then one out of the bank's range."""
    from multimodal_concept_learning_tpu.serve.server import make_server as jax_make_server
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    if match == "--adapters":
        base = tp.write_lora_results_dir(tmp_path / "base")
        adapter = tp.adapter_copy(base, tmp_path / "adapter", seed=1)
        httpd, batcher = make_server(base, port=0, device="cpu", dtype=torch.float32,
                                     max_new_tokens=2, **dict(kwargs, adapters=[adapter]))
        try:
            assert batcher.engine.num_adapters == 2
            assert type(batcher.engine).__name__ == (
                "ContinuousEngine" if kwargs.get("continuous") else "ServingEngine")
            assert isinstance(batcher.submit(IMAGES[0], PROMPTS[0], adapter=1), str)
            with pytest.raises(ValueError, match="out of range"):
                batcher.submit(IMAGES[0], PROMPTS[0], adapter=2)
        finally:
            httpd.server_close()
            batcher.shutdown()
        return
    with pytest.raises(ValueError, match=match) as err:
        make_server(str(tmp_path), device="cpu", **kwargs)
    with pytest.raises(ValueError) as jax_err:
        jax_make_server(str(tmp_path), **kwargs)
    assert str(err.value) == str(jax_err.value)


def test_quantized_server_matches_jax_front(trained_results_dir):
    """make_server(paged, int4, int8_vision) on the CPU answers with the JAX
    paged front's texts for the same quantized model."""
    from multimodal_concept_learning_tpu.serve.continuous import ContinuousBatcher as JBatcher
    from multimodal_concept_learning_tpu.serve.paged import PagedContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    quant = {"int4": True, "int8_vision": True}
    jbatcher = JBatcher(JEngine(_jax_load(trained_results_dir, **quant), **ENGINE_KW))
    try:
        expected = [jbatcher.submit(img, p) for img, p in zip(IMAGES[:2], PROMPTS[:2])]
    finally:
        jbatcher.shutdown()
    httpd, batcher = make_server(trained_results_dir, port=0, paged=True, batch_size=4,
                                 max_new_tokens=4, max_prompt_len=16, page_size=8,
                                 steps_per_call=2, device="cpu", dtype=torch.float32, **quant)
    try:
        assert [batcher.submit(img, p) for img, p in zip(IMAGES[:2], PROMPTS[:2])] == expected
    finally:
        httpd.server_close()
        batcher.shutdown()


def test_make_server_refuses_int8_with_int4(tmp_path):
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    with pytest.raises(ValueError, match="mutually exclusive"):
        make_server(str(tmp_path), paged=True, int8=True, int4=True, device="cpu")


def test_loader_refuses_vocab_mismatch(trained_results_dir, tmp_path):
    """A checkpoint whose embedding rows differ from the rebuilt tokenizer
    (here: the labels mapping with its OOD token is gone) is refused."""
    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm

    src = f"{trained_results_dir}/models"
    dst = tmp_path / "models"
    dst.mkdir()
    shutil.copy(f"{src}/best_model.pt", dst / "best_model.pt")
    with open(f"{src}/training_config.json") as f:
        cfg = json.load(f)
    cfg["labels_mapping_path"] = str(tmp_path / "missing.json")
    (dst / "training_config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="embedding rows"):
        load_trained_mllm(str(tmp_path), device="cpu", verbose=False)


@pytest.mark.parametrize("k,p", [(5, None), (None, 0.7), (4, 0.5)])
def test_sampling_filters_match_jax(k, p):
    from multimodal_concept_learning_tpu.ops import sampling as jsamp
    from multimodal_concept_learning_tpu_torch.ops import sampling as tsamp

    logits = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32) * 2
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if k is not None:
        jl, tl = jsamp.top_k_mask(jl, k), tsamp.top_k_mask(tl, k)
    if p is not None:
        jl, tl = jsamp.top_p_mask(jl, p), tsamp.top_p_mask(tl, p)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tsamp.sample_logits(torch.from_numpy(logits), None).numpy(),
                                  np.asarray(jsamp.sample_logits(jnp.asarray(logits), None)))
    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample_logits(torch.from_numpy(logits), gen, temperature=0.7, top_k=k,
                                top_p=p)
    kept = np.asarray(jl) > -1e29  # every draw lies in the filtered support
    assert draws.dtype == torch.int32 and kept[np.arange(3), draws.numpy()].all()


def test_sampling_needs_a_generator():
    from multimodal_concept_learning_tpu_torch.ops.sampling import sample_logits

    with pytest.raises(ValueError, match="Generator"):
        sample_logits(torch.zeros((1, 4)), None, temperature=1.0)
