"""PyTorch port: ring attention (four Gloo ranks on the CPU) vs the JAX
package's ring (on its virtual devices) and its dense attention: the
counterparts of ``test_ring_attention.py``.

Forward at 2 and 4 sequence shards x 4 and 2 KV heads (GQA repeated to
the query heads) under a causal, ragged padding bias; rows whose keys are
all masked (the uniform average of V, as JAX's ring and dense softmax
give); the gradients of q, k and v at a non-default scale.  Tolerance
2e-6 (gradients rtol 2e-5, atol 2e-6), JAX's.  The ranks
(``tests/_torch_mesh_worker.py``, suite ``ring``) start once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as tm

FORWARD = [(n, hk) for n in (2, 4) for hk in (4, 2)]


def _qkv(b=2, t=16, h=4, hk=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, d)).astype(np.float32),
            rng.normal(size=(b, t, hk, d)).astype(np.float32),
            rng.normal(size=(b, t, hk, d)).astype(np.float32))


def _bias(mask):
    from multimodal_concept_learning_tpu.ops.attention import make_attention_bias

    t = mask.shape[1]
    return np.asarray(make_attention_bias(jnp.asarray(mask), causal=True, q_len=t, k_len=t))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from multimodal_concept_learning_tpu.ops.attention import multi_head_attention
    from multimodal_concept_learning_tpu.parallel.mesh import make_mesh
    from multimodal_concept_learning_tpu.parallel.ring_attention import (
        make_ring_attention,
        shard_seq,
    )

    workdir = tmp_path_factory.mktemp("ring")
    procs = tm.start("ring", 4, workdir)

    cases = {}
    for n, hk in FORWARD:
        q, k, v = _qkv(hk=hk)
        mask = np.ones((2, 16), np.int32)
        mask[0, -5:] = 0  # ragged padding
        cases[f"fwd_{n}_{hk}"] = dict(shards=n, q=q, k=k, v=v, bias=_bias(mask))
    q, k, v = _qkv(seed=3)
    mask = np.ones((2, 16), np.int32)
    mask[1, :] = 0  # every key masked for batch row 1
    cases["masked"] = dict(shards=4, q=q, k=k, v=v, bias=_bias(mask))
    q, k, v = _qkv(seed=1)
    cases["grad"] = dict(shards=4, q=q, k=k, v=v, bias=_bias(np.ones((2, 16), np.int32)),
                         scale=0.3, grad=True)
    tm.write_inputs(workdir, {"cases": cases})

    devices = jax.devices()
    ref = {}
    for key, c in cases.items():
        mesh = make_mesh(devices[:c["shards"]], axis_names=("seq",))
        ring = make_ring_attention(mesh)
        q, k, v, bias = (jnp.asarray(c[x]) for x in ("q", "k", "v", "bias"))
        scale = c.get("scale")
        ref[key] = dict(
            ring=np.asarray(jax.jit(lambda a, b_, c_, d: ring(a, b_, c_, d, scale=scale))(
                shard_seq(q, mesh), shard_seq(k, mesh), shard_seq(v, mesh), bias)),
            dense=np.asarray(multi_head_attention(q, k, v, bias=bias, use_flash=False,
                                                  scale=scale)))
        if c.get("grad"):
            def loss(q_, k_, v_, bias=bias, scale=scale):
                o = multi_head_attention(q_, k_, v_, bias=bias, use_flash=False, scale=scale)
                return (o * jnp.arange(o.size).reshape(o.shape)).sum() / o.size

            ref[key]["grads"] = [np.asarray(g) for g in
                                 jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]
    return tm.collect(procs, workdir), ref


@pytest.mark.parametrize("n_shards,hk", FORWARD)
def test_ring_matches_jax_forward(run, n_shards, hk):
    ranks, ref = run
    key = f"fwd_{n_shards}_{hk}"
    np.testing.assert_allclose(ref[key]["ring"], ref[key]["dense"], rtol=2e-6, atol=2e-6)
    for r in ranks:
        np.testing.assert_allclose(r[key]["out"], ref[key]["ring"], rtol=2e-6, atol=2e-6)


def test_ring_fully_masked_rows_match_jax(run):
    """Rows whose keys are all masked degrade identically (uniform average)."""
    ranks, ref = run
    for r in ranks:
        out = r["masked"]["out"]
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref["masked"]["dense"], rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(out, ref["masked"]["ring"], rtol=2e-6, atol=2e-6)


def test_ring_gradients_match_dense(run):
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["grad"]["out"], ref["grad"]["dense"], rtol=2e-6, atol=2e-6)
        for name, want in zip("qkv", ref["grad"]["grads"]):
            np.testing.assert_allclose(r["grad"]["grads"][name], want, rtol=2e-5, atol=2e-6,
                                       err_msg=name)
