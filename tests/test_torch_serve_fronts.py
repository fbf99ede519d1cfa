"""PyTorch port: the whole-batch, dense continuous, chunked-prefill and
int8-pool serving fronts vs the JAX package (CPU, float32).

Both packages load the same 1-epoch-trained tiny results dir (the
``trained_results_dir`` fixture) at float32 and serve the same requests:
the port's engines must give exactly the JAX engines' greedy tokens and
texts, with float, int4 and int8 weights; the dense continuous engine
also the port's isolated ``greedy_generate``, the chunked engine its
one-shot admission's; the HTTP server with no front flag, and with
``continuous=True, chunked_prefill=4``, the JAX fronts' texts.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import SERVE_IMAGES as IMAGES
from _torch_parity import SERVE_PROMPTS as PROMPTS
from _torch_parity import jax_serving_load, port_serving_load

N_NEW = 4
WHOLE_KW = dict(batch_size=4, max_new_tokens=N_NEW, max_prompt_len=16)
SLOT_KW = dict(num_slots=4, max_new_tokens=N_NEW, max_prompt_len=16)
REQS = [(2, IMAGES[0], PROMPTS[0]), (0, IMAGES[1], PROMPTS[1]), (3, IMAGES[2], PROMPTS[3])]


@pytest.fixture(scope="module")
def jax_loaded(trained_results_dir):
    return jax_serving_load(trained_results_dir)


@pytest.fixture(scope="module")
def port_loaded(trained_results_dir):
    return port_serving_load(trained_results_dir)


def _whole_batch_texts(engine_cls, loaded, **gen_kw):
    return engine_cls(loaded, **WHOLE_KW).generate(IMAGES[:3], PROMPTS[:3], **gen_kw)


QUANT_MODES = [{}, {"int4": True}, {"int8": True, "int8_vision": True}]


@pytest.mark.parametrize("quant", QUANT_MODES, ids=["float", "int4", "int8+int8_vision"])
def test_whole_batch_engine_matches_jax(trained_results_dir, jax_loaded, port_loaded, quant):
    """ServingEngine.generate: the JAX engine's texts, each package
    quantizing the same float checkpoint."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    jl = jax_serving_load(trained_results_dir, **quant) if quant else jax_loaded
    pl = port_serving_load(trained_results_dir, **quant) if quant else port_loaded
    want = _whole_batch_texts(JEngine, jl)
    assert _whole_batch_texts(ServingEngine, pl) == want
    assert all(isinstance(t, str) for t in want)


def test_whole_batch_caps_and_padding_rows(jax_loaded, port_loaded):
    """Per-request ``max_tokens`` and ``stop`` cut on the host as JAX cuts
    them; a batch of 3 in an engine of 4 gives each request's text alone;
    an adapter on a bankless engine raises JAX's ValueError."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    engine = ServingEngine(port_loaded, **WHOLE_KW)
    free = engine.generate(IMAGES[:3], PROMPTS[:3])
    assert [engine.generate([IMAGES[i]], [PROMPTS[i]])[0] for i in range(3)] == free
    marker = next(t[len(t) // 2:] for t in free if len(t) > 1)
    caps = dict(max_tokens=[1, None, 2], stop=[None, [marker], [marker, "zz"]])
    got = engine.generate(IMAGES[:3], PROMPTS[:3], **caps)
    assert got == JEngine(jax_loaded, **WHOLE_KW).generate(IMAGES[:3], PROMPTS[:3], **caps)
    assert got != free
    with pytest.raises(ValueError, match="no adapter bank"):
        engine.generate(IMAGES[:1], PROMPTS[:1], adapters=[1])


def _drive(engine, reqs, steps: int, active_slots=None):
    """Admit ``reqs``, finish chunked admissions, then ``steps`` engine
    steps over the admitted slots: {slot: [first, step tokens ...]}."""
    firsts = engine.admit_many(reqs)
    out = {slot: [f] for (slot, *_), f in zip(reqs, firsts)}
    while any(f is None for f in (toks[0] for toks in out.values())):
        for slot, first in engine.advance_prefill():
            out[slot][0] = first
    active = np.zeros(engine.num_slots, bool)
    active[active_slots if active_slots is not None else list(out)] = True
    for _ in range(steps):
        toks = engine.step(active)
        for slot in out:
            out[slot] += [int(t) for t in toks[slot]]
    return out


def _isolated_greedy(engine, reqs, n_new: int):
    """Each request alone through the port's ``greedy_generate``, staged as
    the engine stages it."""
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    out = {}
    for req in reqs:
        _, img, ids, mask, _ = engine._staging_arrays([req])
        batch = (torch.from_numpy(x) for x in (img, ids, mask))
        tok = greedy_generate(engine.loaded.model, *batch, max_new_tokens=n_new)
        out[req[0]] = tok[0].tolist()
    return out


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_continuous_engine_matches_jax_and_greedy(jax_loaded, port_loaded, steps_per_call):
    """ContinuousEngine admit_many / step, then a re-admission into a freed
    slot beside live ones: the JAX engine's tokens, and each request's
    isolated greedy tokens."""
    from multimodal_concept_learning_tpu.serve.continuous import ContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine

    kw = dict(SLOT_KW, steps_per_call=steps_per_call)
    steps = -(-(N_NEW - 1) // steps_per_call)
    jeng, teng = JEngine(jax_loaded, **kw), ContinuousEngine(port_loaded, **kw)
    got = _drive(teng, REQS, steps)
    assert got == _drive(jeng, REQS, steps)
    want = _isolated_greedy(teng, REQS, N_NEW)
    assert {s: toks[:N_NEW] for s, toks in got.items()} == want
    again = [(0, IMAGES[3], PROMPTS[2])]  # slot 0 again, slots 2 and 3 still live
    got = _drive(teng, again, 1, active_slots=[0, 2, 3])
    assert got == _drive(jeng, again, 1, active_slots=[0, 2, 3])
    assert got[0][:2] == _isolated_greedy(teng, again, 2)[0]
    assert teng.decode_steps == (steps + 1) * steps_per_call


def test_continuous_batcher_frees_a_slot_on_eos_and_fails_all_on_error(port_loaded):
    """An early EOS retires its request at once and frees the slot for the
    next; a step that raises fails every in-flight request with its error."""
    from multimodal_concept_learning_tpu_torch.serve.continuous import (
        ContinuousBatcher,
        ContinuousEngine,
    )

    engine = ContinuousEngine(port_loaded, **dict(SLOT_KW, num_slots=1, steps_per_call=2))
    toks = _drive(engine, [(0, IMAGES[0], PROMPTS[0])], 1)[0]
    engine.eos_id = toks[0]  # the request's first token ends it, 3 tokens early
    batcher = ContinuousBatcher(engine)
    try:
        streamed = []
        assert batcher.submit(IMAGES[0], PROMPTS[0], on_token=streamed.append) == ""
        assert streamed == toks[:1]
        assert batcher.metrics()["in_flight"] == 0 and batcher.stats["requests"] == 1
        assert isinstance(batcher.submit(IMAGES[1], PROMPTS[1]), str)  # the slot was freed
    finally:
        batcher.shutdown()

    engine = ContinuousEngine(port_loaded, **SLOT_KW)
    step = engine.step

    def broken(active):
        """Steps on until the second request is admitted, then fails."""
        if active.sum() >= 2:
            raise RuntimeError("device lost")
        deadline = time.monotonic() + 30
        while batcher._q.qsize() == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        return step(active)

    engine.step = broken
    batcher = ContinuousBatcher(engine)
    errors = [None, None]

    def run(i):
        try:
            batcher.submit(IMAGES[i], PROMPTS[i], timeout=60)
        except RuntimeError as e:
            errors[i] = str(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.shutdown()
    assert errors == ["device lost", "device lost"]


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_engine_matches_jax_and_one_shot(jax_loaded, port_loaded, chunk):
    """ChunkedContinuousEngine: staging, one chunk an advance_prefill, the
    finish: the JAX chunked engine's tokens and the one-shot admission's."""
    from multimodal_concept_learning_tpu.serve.chunked import ChunkedContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.chunked import ChunkedContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine

    kw = dict(SLOT_KW, steps_per_call=2)
    teng = ChunkedContinuousEngine(port_loaded, chunk_size=chunk, **kw)
    assert teng.admit_many(REQS[:1]) == [None] and teng.prefilling_slots == {2}
    teng = ChunkedContinuousEngine(port_loaded, chunk_size=chunk, **kw)
    got = _drive(teng, REQS, 2)
    assert got == _drive(JEngine(jax_loaded, chunk_size=chunk, **kw), REQS, 2)
    assert got == _drive(ContinuousEngine(port_loaded, **kw), REQS, 2)
    assert teng.prefilling_slots == set()


def test_chunked_admission_mid_flight_streams_and_finishes(port_loaded):
    """A request admitted while another decodes is staged, chunked between
    decode steps (``prefilling`` in /metrics), streams its tokens and
    finishes with the text it has alone."""
    from multimodal_concept_learning_tpu_torch.serve.chunked import ChunkedContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousBatcher

    kw = dict(SLOT_KW, max_new_tokens=6, steps_per_call=1)
    alone = ContinuousBatcher(ChunkedContinuousEngine(port_loaded, chunk_size=4, **kw))
    try:
        want = [alone.submit(IMAGES[i], PROMPTS[i]) for i in range(2)]
    finally:
        alone.shutdown()
    engine = ChunkedContinuousEngine(port_loaded, chunk_size=4, **kw)
    batcher = ContinuousBatcher(engine)
    seen, got, streamed = [], [None, None], []
    step = engine.step

    def watched(active):
        seen.append(batcher.metrics()["prefilling"])
        return step(active)

    engine.step = watched

    def run(i, **kw):
        got[i] = batcher.submit(IMAGES[i], PROMPTS[i], **kw)

    try:
        first = threading.Thread(target=run, args=(0,))
        first.start()
        while batcher.stats["steps"] == 0 and first.is_alive():
            time.sleep(0.001)
        run(1, on_token=streamed.append)
        first.join(timeout=60)
        metrics = batcher.metrics()
    finally:
        batcher.shutdown()
    assert got == want and len(streamed) >= 1
    assert max(seen) == 1 and metrics["prefilling"] == 0 and metrics["completed"] == 2


def test_int8_pool_engine_matches_jax(jax_loaded, port_loaded):
    """PagedContinuousEngine(quant_kv=True): int8 pools holding the JAX
    engine's codes after admission, and its tokens; about half the float
    pool's bytes."""
    from multimodal_concept_learning_tpu.serve.paged import PagedContinuousEngine as JEngine
    from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

    kw = dict(SLOT_KW, page_size=8, steps_per_call=2)
    jeng = JEngine(jax_loaded, quant_kv=True, **kw)
    teng = PagedContinuousEngine(port_loaded, quant_kv=True, **kw)
    assert teng.admit_many(REQS) == jeng.admit_many(REQS)
    codes, jcodes = teng.pools[0]["k"].numpy(), np.asarray(jeng.pools[0]["k"])
    assert codes.dtype == np.int8 and np.abs(codes[1:].astype(int) - jcodes[1:]).max() <= 1
    active = np.asarray([True, False, True, True])
    for _ in range(2):
        np.testing.assert_array_equal(teng.step(active)[active], jeng.step(active)[active])
    flat = PagedContinuousEngine(port_loaded, **kw)
    assert teng.pool_bytes() < 0.6 * flat.pool_bytes()


def test_int8_pool_serving_is_independent_of_contention(port_loaded):
    """quant_kv serving: 3 slots under page backpressure give each
    request's 1-slot text, and every page comes back."""
    from multimodal_concept_learning_tpu_torch.ops.paged_kv import pages_needed
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousBatcher
    from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

    kw = dict(max_new_tokens=N_NEW, max_prompt_len=16, page_size=8, quant_kv=True)
    alone = ContinuousBatcher(PagedContinuousEngine(port_loaded, num_slots=1, **kw))
    try:
        want = [alone.submit(IMAGES[i], p) for i, p in enumerate(PROMPTS)]
    finally:
        alone.shutdown()
    per_req = pages_needed(port_loaded.config.num_vision_tokens + 16 + N_NEW + 1, 8)
    engine = PagedContinuousEngine(port_loaded, num_slots=3, num_pages=2 * per_req + 1, **kw)
    batcher = ContinuousBatcher(engine)
    got = [None] * len(PROMPTS)

    def run(i):
        got[i] = batcher.submit(IMAGES[i], PROMPTS[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(PROMPTS))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.shutdown()
    assert got == want
    assert engine.allocator.available == engine.num_pages - 1


def _jax_front(loaded, front: dict):
    """The JAX server's front for ``front`` (as its make_server builds it)
    over a float32-compute model."""
    from multimodal_concept_learning_tpu.serve.chunked import ChunkedContinuousEngine
    from multimodal_concept_learning_tpu.serve.continuous import ContinuousBatcher
    from multimodal_concept_learning_tpu.serve.engine import Batcher, ServingEngine

    if front:
        return ContinuousBatcher(ChunkedContinuousEngine(
            loaded, chunk_size=front["chunked_prefill"], **dict(SLOT_KW, steps_per_call=2)))
    return Batcher(ServingEngine(loaded, **WHOLE_KW), max_wait_ms=5.0)


@pytest.mark.parametrize("front", [{}, {"continuous": True, "chunked_prefill": 4}],
                         ids=["whole-batch", "chunked"])
def test_server_fronts_match_jax(trained_results_dir, jax_loaded, front):
    """make_server with no front flag (the whole-batch front, the JAX
    server's default) and with continuous chunked prefill: the JAX fronts'
    texts, for requests from threads and one over HTTP; /metrics counts
    every request."""
    import base64
    import io

    from PIL import Image

    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    jbatcher = _jax_front(jax_loaded, front)
    try:
        want = [jbatcher.submit(img, p) for img, p in zip(IMAGES, PROMPTS)]
    finally:
        jbatcher.shutdown()

    httpd, batcher = make_server(trained_results_dir, port=0, batch_size=4,
                                 max_new_tokens=N_NEW, max_prompt_len=16, max_wait_ms=5.0,
                                 steps_per_call=2, device="cpu", dtype=torch.float32, **front)
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
        buf = io.BytesIO()
        Image.fromarray((IMAGES[2].transpose(1, 2, 0) * 255).astype(np.uint8)).save(buf, "PNG")
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("POST", "/generate", body=json.dumps({
            "prompt": PROMPTS[2], "image_b64": base64.b64encode(buf.getvalue()).decode()}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        batcher.shutdown()
        httpd.server_close()
    assert got == want
    assert r.status == 200 and body["text"] == want[2]
    assert metrics["completed"] == len(PROMPTS) + 1
    assert ("prefilling" in metrics) == bool(front)
