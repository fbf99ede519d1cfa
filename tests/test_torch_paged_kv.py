"""PyTorch port: paged KV cache ops vs the JAX package (CPU, plain versions).

The K3 plain version is held to the JAX Pallas paged kernel in interpret
mode, including a row of length 0 and a window that drops whole pages.
Tolerance: single ops in float32, <= 1e-5 abs on unit-scale inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu.ops import paged_kv as jpkv
from multimodal_concept_learning_tpu_torch.ops import paged_kv as tpkv

ATOL = 1e-5


def test_page_allocator():
    alloc = tpkv.PageAllocator(6)  # pages 1..5 usable
    assert alloc.available == 5
    a = alloc.alloc(3)
    assert len(a) == 3 and 0 not in a
    with pytest.raises(tpkv.PagePoolExhausted):
        alloc.alloc(3)
    assert alloc.available == 2  # a failed alloc takes nothing
    b = alloc.alloc(2)
    assert set(a).isdisjoint(b)
    alloc.free(a)
    c = alloc.alloc(3)
    assert set(c) <= set(a)  # freed pages get reissued
    with pytest.raises(ValueError, match="double free"):
        alloc.free(c + c[:1])
    alloc.free(b)
    assert alloc.available == 5
    with pytest.raises(ValueError, match="bad page"):
        alloc.free([0])


def _pools(rng, p, hk, ps, d):
    return (rng.standard_normal((p, hk, ps, d)).astype(np.float32),
            rng.standard_normal((p, hk, ps, d)).astype(np.float32))


@pytest.mark.parametrize("gqa_group", [1, 4])
@pytest.mark.parametrize("window", [-1, 5])
def test_paged_decode_matches_pallas_interpret(gqa_group, window):
    """Plain K3 version == the JAX Pallas paged kernel (interpret mode)
    across GQA grouping, windows (5 drops whole 8-token pages of the long
    rows) and ragged lengths including 0; pages are scattered in the pool."""
    rng = np.random.default_rng(0)
    b, np_, ps, hk, d = 4, 4, 8, 2, 64
    hq = hk * gqa_group
    p = 1 + b * np_
    pk, pv = _pools(rng, p, hk, ps, d)
    pt = (rng.permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    lens = np.asarray([0, 1, 13, 32], np.int32)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)

    ref = jpkv.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pt), jnp.asarray(lens),
        window=jnp.int32(window), use_kernel=True, interpret=True)
    out = tpkv.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), torch.from_numpy(pt),
        torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert (out[0] == 0).all()  # the length-0 row


def test_paged_decode_matches_jax_gather_path():
    """Rows of length >= 1: the plain version == the JAX gather fallback."""
    rng = np.random.default_rng(1)
    b, np_, ps, hk, d = 3, 3, 4, 1, 32
    pk, pv = _pools(rng, 1 + b * np_, hk, ps, d)
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    lens = np.asarray([2, 7, 12], np.int32)
    q = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
    ref = jpkv.paged_decode_attention(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                      jnp.asarray(pt), jnp.asarray(lens), scale=0.3,
                                      window=jnp.int32(6), use_kernel=False)
    out = tpkv.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(pk),
                                      torch.from_numpy(pv), torch.from_numpy(pt),
                                      torch.from_numpy(lens), scale=0.3, window=6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_write_ops_and_gather_match_jax():
    """write_prompt_kv / write_token_kv (in place here, functional in JAX)
    and gather_pages give the JAX results on every page but the null page,
    whose contents are write-order dependent and never read unmasked."""
    rng = np.random.default_rng(2)
    b, np_, ps, hk, d = 2, 3, 4, 2, 8
    p = 1 + b * np_
    pt = np.arange(1, 1 + b * np_, dtype=np.int32).reshape(b, np_)
    pool = np.full((p, hk, ps, d), 7.0, np.float32)
    kv = rng.standard_normal((b, 10, hk, d)).astype(np.float32)
    lens = np.asarray([10, 3], np.int32)
    tok = rng.standard_normal((b, hk, d)).astype(np.float32)

    jpool = jpkv.write_prompt_kv(jnp.asarray(pool), jnp.asarray(pt), jnp.asarray(lens),
                                 jnp.asarray(kv))
    jpool = jpkv.write_token_kv(jpool, jnp.asarray(pt), jnp.asarray(lens), jnp.asarray(tok))
    tpool = torch.from_numpy(pool.copy())
    tpkv.write_prompt_kv(tpool, torch.from_numpy(pt), torch.from_numpy(lens),
                         torch.from_numpy(kv))
    tpkv.write_token_kv(tpool, torch.from_numpy(pt), torch.from_numpy(lens),
                        torch.from_numpy(tok))
    np.testing.assert_array_equal(tpool.numpy()[1:], np.asarray(jpool)[1:])
    g_ref = np.asarray(jpkv.gather_pages(jpool, jnp.asarray(pt)))
    g = tpkv.gather_pages(tpool, torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(g, g_ref)  # the table names no null page
    np.testing.assert_array_equal(g[0, :11], np.concatenate([kv[0], tok[0][None]]))


@pytest.mark.parametrize("window", [-1, 3])
def test_paged_attention_mask_matches_jax(window):
    lens = np.asarray([0, 2, 9], np.int32)
    ref = jpkv.paged_attention_mask(jnp.asarray(lens), 12, jnp.int32(window))
    out = tpkv.paged_attention_mask(torch.from_numpy(lens), 12, window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_write_past_the_table_lands_on_the_null_page():
    """A position past a row's page-table columns writes page 0, never a
    real page (JAX would clamp the column onto the row's last page)."""
    pool = torch.zeros((3, 1, 2, 4))
    pt = torch.tensor([[1, 2]], dtype=torch.int32)
    tpkv.write_token_kv(pool, pt, torch.tensor([4]), torch.ones((1, 1, 4)))
    assert pool[1:].abs().sum() == 0 and pool[0].abs().sum() == 4


def test_init_paged_kv_cache_layout():
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig

    cfg = LMConfig.preset("nano", vocab_size=8)
    pools = tpkv.init_paged_kv_cache(cfg, num_pages=5, page_size=4, device="cpu")
    assert len(pools) == cfg.num_layers
    assert pools[0]["k"].shape == (5, cfg.num_kv_heads, 4, cfg.head_dim)
    assert pools[0]["v"].dtype == cfg.dtype and not pools[0]["k"].any()
    assert tpkv.pages_needed(17, 8) == 3 and tpkv.pages_needed(16, 8) == 2
