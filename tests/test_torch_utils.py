"""PyTorch port: ``utils/{seeding,profiling,debugging}.py`` vs the JAX
package's (CPU).  ``set_seed`` reseeds the host generators as JAX's does;
``host_rng`` gives JAX's streams for integer names and, for string names,
the same stream in every process (two subprocesses with different
``PYTHONHASHSEED``), where JAX's string-named streams change with the
hash salt; ``checked`` and ``assert_finite_tree`` behave as JAX's;
``trace`` writes a Chrome trace holding a ``span``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_set_seed_reseeds_the_host_and_returns_a_generator():
    import random

    from multimodal_concept_learning_tpu_torch.utils.seeding import set_seed

    g = set_seed(123)
    a, b, c = random.random(), np.random.random(), torch.rand(1).item()
    draw = torch.rand(1, generator=g).item()
    g2 = set_seed(123)
    assert (random.random(), np.random.random(), torch.rand(1).item()) == (a, b, c)
    assert torch.rand(1, generator=g2).item() == draw


def test_host_rng_streams():
    from multimodal_concept_learning_tpu.utils.seeding import host_rng as jax_rng
    from multimodal_concept_learning_tpu_torch.utils.seeding import host_rng

    # integer names: JAX's value is stable, and the port's stream is JAX's
    np.testing.assert_array_equal(host_rng(5, 7, 11).random(4), jax_rng(5, 7, 11).random(4))
    assert host_rng(0, "collator").random() == host_rng(0, "collator").random()
    assert host_rng(0, "collator").random() != host_rng(0, "shuffle").random()
    assert host_rng(0, "collator").random() != host_rng(1, "collator").random()


_PROBE = ("import sys, json; sys.path.insert(0, {repo!r}); "
          "from multimodal_concept_learning_tpu.utils.seeding import host_rng as j; "
          "from multimodal_concept_learning_tpu_torch.utils.seeding import host_rng as p; "
          "print(json.dumps([j(0, 'collator').random(), p(0, 'collator').random()]))")


def test_host_rng_is_stable_across_hash_salts():
    """Two processes with different hash salts: the port's string-named
    stream is the same in both, JAX's is not (ROADMAP.md, queue C)."""
    runs = []
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=salt, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)], env=env,
                             capture_output=True, text=True, timeout=120, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert runs[0][1] == runs[1][1]
    assert runs[0][0] != runs[1][0]


def test_trace_writes_a_chrome_trace(tmp_path):
    from multimodal_concept_learning_tpu_torch.utils.profiling import span, trace

    with trace(str(tmp_path)) as prof:
        with span("probe_span"):
            torch.ones(8) @ torch.ones(8)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "probe_span" for e in events)
    assert prof.key_averages()


def test_checked_matches_jax():
    import jax.numpy as jnp

    from multimodal_concept_learning_tpu.utils.debugging import checked as jchecked
    from multimodal_concept_learning_tpu_torch.utils.debugging import checked

    for x, bad in ((-1.0, True), (2.0, False)):
        jerr, jout = jchecked(jnp.log)(jnp.asarray(x))
        err, out = checked(torch.log)(torch.tensor(x))
        np.testing.assert_allclose(out.item(), float(jout), rtol=1e-6, equal_nan=True)
        for e in (jerr, err):
            if bad:
                with pytest.raises(Exception):
                    e.throw()
            else:
                e.throw()
        assert (err.get() is not None) == bad
    err, _ = checked(lambda: {"a": [torch.ones(2), torch.tensor([float("inf")])]})()
    with pytest.raises(FloatingPointError, match=r"\['a'\]\[1\]"):
        err.throw()


def test_assert_finite_tree_matches_jax():
    from multimodal_concept_learning_tpu.utils.debugging import assert_finite_tree as jassert
    from multimodal_concept_learning_tpu_torch.utils.debugging import assert_finite_tree

    assert_finite_tree({"a": torch.ones(3), "n": torch.arange(3)}, "ok")
    tree = {"a": {"b": np.array([1.0, np.nan, np.inf])}}
    msgs = []
    for fn, t in ((jassert, tree), (assert_finite_tree, tree),
                  (assert_finite_tree, {"a": {"b": torch.tensor([1.0, float("nan"),
                                                                  float("inf")])}})):
        with pytest.raises(FloatingPointError) as e:
            fn(t, "bad")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2] == "bad['a']['b'] has 2 non-finite values"


def test_enable_nan_checks_flips_anomaly_mode():
    from multimodal_concept_learning_tpu_torch.utils.debugging import enable_nan_checks

    enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
