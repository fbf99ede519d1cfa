"""PyTorch port: the paged serving path vs the JAX package (CPU, float32).

Both packages load the same 1-epoch-trained tiny results dir (the
``trained_results_dir`` fixture, reference layout) at float32; the port's
paged engine must produce exactly the JAX ``PagedContinuousEngine``'s
greedy tokens, and the port's HTTP server the JAX front's texts.  Also:
the unported fronts refuse loudly, sampling filters match JAX.
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

PROMPTS = [
    "Is the color of the circle red?",
    "Is the color of the circle green?",
    "Is the color of the circle blue?",
    "Is the color of the circle orange?",
]
ENGINE_KW = dict(num_slots=4, max_new_tokens=4, max_prompt_len=16, page_size=8,
                 steps_per_call=2)


def _circle(rgb, size=32):
    """[3, size, size] float image in [0, 1] (the ToTensor eval transform), no PIL."""
    yy, xx = np.mgrid[:size, :size]
    inside = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 <= (size // 3) ** 2
    img = np.ones((3, size, size), np.float32)
    img[:, inside] = np.asarray(rgb, np.float32)[:, None] / 255.0
    return img


IMAGES = [_circle([255, 0, 0]), _circle([0, 255, 0]), _circle([0, 0, 255]),
          _circle([255, 128, 0])]


@pytest.fixture(scope="module")
def jax_loaded(trained_results_dir):
    """The JAX package's loaded model, switched to float32 compute."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM
    from multimodal_concept_learning_tpu.serve import load_trained_mllm

    loaded = load_trained_mllm(trained_results_dir, verbose=False)
    cfg = loaded.model.config
    f32 = dataclasses.replace(cfg, dtype=jnp.float32,
                              vision=dataclasses.replace(cfg.vision, dtype=jnp.float32),
                              lm=dataclasses.replace(cfg.lm, dtype=jnp.float32))
    return loaded._replace(model=MLLM(f32))


@pytest.fixture(scope="module")
def port_loaded(trained_results_dir):
    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm

    return load_trained_mllm(trained_results_dir, device="cpu", dtype=torch.float32,
                             verbose=False)


def test_paged_engine_tokens_match_jax(jax_loaded, port_loaded):
    """admit_many / step / release / re-admit: the same greedy tokens for
    every active slot, and the same page accounting."""
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
    ({}, "whole-batch front"),
    ({"continuous": True}, "dense continuous front"),
    ({"paged": True, "int8": True}, "--int8"),
    ({"paged": True, "int4": True}, "--int4"),
    ({"paged": True, "int8_kv": True}, "--int8_kv"),
    ({"paged": True, "adapters": ["a"]}, "--adapters"),
    ({"continuous": True, "chunked_prefill": 8}, "--chunked_prefill"),
    ({"num_beams": 2}, "--num_beams"),
    ({"draft_layers": 1}, "--draft_layers"),
])
def test_make_server_refuses_unported_modes(tmp_path, kwargs, match):
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    with pytest.raises(NotImplementedError, match=match) as err:
        make_server(str(tmp_path), device="cpu", **kwargs)
    assert "ROADMAP.md" in str(err.value)


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
