"""PyTorch port: paged KV cache ops vs the JAX package (CPU, plain versions).

The K3 plain version is held to the JAX Pallas paged kernel in interpret
mode, including a row of length 0 and a window that drops whole pages.
Int8 pools: ``quantize_kv``'s codes equal JAX's, the dequantizing gather
read equals JAX's, and an LM decoding over an int8 pool stays within JAX's
0.05 of the dense float decode.
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


# int8 pools (init_paged_kv_cache quantized=True)


def test_quantize_kv_matches_jax_and_its_roundtrip_bound():
    """The codes equal JAX's exactly and the scales within 1e-7 relative;
    the elementwise roundtrip error is at most amax/254, and an all-zero
    row (padding) dequantizes to exact zeros."""
    rng = np.random.default_rng(3)
    kv = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    kv[1, 2] = 0.0
    jq, js = jpkv.quantize_kv(jnp.asarray(kv))
    q, s = tpkv.quantize_kv(torch.from_numpy(kv))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == kv.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    deq = q.float().numpy() * s.numpy()[..., None]
    amax = np.abs(kv).max(axis=-1, keepdims=True)
    assert np.all(np.abs(deq - kv) <= amax / 254 + 1e-9)
    assert np.all(deq[1, 2] == 0.0)


def _int8_pools(rng, p, hk, ps, d):
    """(codes, scales) of two random int8 pools, as the JAX write ops make them."""
    out = []
    for _ in range(2):
        q, s = jpkv.quantize_kv(jnp.asarray(rng.standard_normal((p, hk, ps, d)), jnp.float32))
        out += [np.array(q), np.array(s)]
    return out


def test_gather_pages_dequant_and_int8_decode_match_jax():
    """gather_pages_dequant and the int8-pool paged_decode_attention (the
    dequantizing gather read, with a window) == JAX's within 1e-5; the
    pool's scales are what the read takes, whatever MCL_PAGED_KERNEL says."""
    rng = np.random.default_rng(4)
    b, np_, ps, hk, d = 3, 3, 4, 2, 32
    pk, sk, pv, sv = _int8_pools(rng, 1 + b * np_, hk, ps, d)
    pt = (rng.permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    lens = np.asarray([2, 7, 12], np.int32)
    q = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
    g_ref = jpkv.gather_pages_dequant(jnp.asarray(pk), jnp.asarray(sk), jnp.asarray(pt),
                                      jnp.float32)
    g = tpkv.gather_pages_dequant(torch.from_numpy(pk), torch.from_numpy(sk),
                                  torch.from_numpy(pt), torch.float32)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=ATOL, rtol=0)
    args = (q, pk, pv, pt, lens)
    ref = jpkv.paged_decode_attention(*map(jnp.asarray, args), scale=0.3, window=jnp.int32(5),
                                      pool_k_scale=jnp.asarray(sk), pool_v_scale=jnp.asarray(sv))
    out = tpkv.paged_decode_attention(*map(torch.from_numpy, args), scale=0.3, window=5,
                                      pool_k_scale=torch.from_numpy(sk),
                                      pool_v_scale=torch.from_numpy(sv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="float pages only"):
        tpkv.paged_decode_attention(*map(torch.from_numpy, args), use_kernel="2",
                                    pool_k_scale=torch.from_numpy(sk),
                                    pool_v_scale=torch.from_numpy(sv))


def test_init_quantized_pool_layout():
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig

    cfg = LMConfig.preset("nano", vocab_size=8)
    pools = tpkv.init_paged_kv_cache(cfg, num_pages=5, page_size=4, device="cpu",
                                     quantized=True)
    assert len(pools) == cfg.num_layers and set(pools[0]) == {"k", "v", "k_scale", "v_scale"}
    assert pools[0]["k"].dtype == torch.int8 and pools[0]["v_scale"].dtype == torch.float32
    assert pools[0]["k_scale"].shape == (5, cfg.num_kv_heads, 4)
    assert not any(t.any() for t in pools[0].values())


def test_lm_int8_pool_decode_close_to_dense_and_to_jax():
    """JAX's own bound (tests/test_paged_kv.py): the int8-pool decode of a
    Gemma-3-featured LM stays within 0.05 of the dense float decode, and
    above 0 (it does quantize); its prefill hidden states are the dense
    ones (prefill attends the fresh float K/V), the written codes are
    JAX's, and its decode hidden states JAX's int8-pool decode's (1e-5)."""
    import jax

    from multimodal_concept_learning_tpu.models.lm import CausalLM as JLM
    from multimodal_concept_learning_tpu.models.lm import LMConfig as JCfg
    from multimodal_concept_learning_tpu.models.lm import init_kv_cache as jax_cache
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.lm import CausalLM, LMConfig, init_kv_cache

    fields = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
                  num_heads=4, num_kv_heads=2, head_dim=16, use_qk_norm=True,
                  sandwich_norms=True, sliding_window=6, sliding_window_pattern=2,
                  query_pre_attn_scalar=16.0)
    jcfg = JCfg(**fields, dtype=jnp.float32)
    jmodel = JLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    lm = CausalLM(LMConfig(**fields, dtype=torch.float32))
    sd = state_dict_from_jax({"language_model": jax.tree_util.tree_map(np.asarray, params)},
                             patch_size=8)
    lm.load_state_dict({k.removeprefix("language_model."): v for k, v in sd.items()})

    b, t, n_new, ps = 2, 10, 4, 4
    s = t + n_new
    rng = np.random.default_rng(1)
    embeds = (rng.standard_normal((b, t, 64)) * 0.1).astype(np.float32)
    plens = np.asarray([10, 7], np.int32)
    mask = (np.arange(t)[None, :] < plens[:, None]).astype(np.int32)
    np_max = -(-s // ps)
    pt = np.arange(1, 1 + b * np_max, dtype=np.int32).reshape(b, np_max)
    caches = init_kv_cache(lm.cfg, b, s, "cpu")
    pools = tpkv.init_paged_kv_cache(lm.cfg, 1 + b * np_max, ps, "cpu", quantized=True)
    jpools = jpkv.init_paged_kv_cache(jcfg, 1 + b * np_max, ps, quantized=True)
    emb_t, mask_t, pt_t = map(torch.from_numpy, (embeds, mask, pt))
    with torch.inference_mode():
        hid_d = lm.prefill(emb_t, mask_t, caches)
        hid_p = lm.prefill_paged(emb_t, mask_t, pools, pt_t)
    _, jpools = jmodel.apply({"params": params}, jnp.asarray(embeds), jnp.asarray(mask), jpools,
                             jnp.asarray(pt), method=JLM.prefill_paged)
    for i in range(b):
        np.testing.assert_allclose(hid_p[i, : plens[i]].numpy(), hid_d[i, : plens[i]].numpy(),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(pools[0]["k"].numpy()[1:], np.asarray(jpools[0]["k"])[1:])
    assert float(pools[0]["k_scale"].max()) > 0

    seq = torch.from_numpy(plens)
    cache_mask = torch.nn.functional.pad(mask_t, (0, n_new))
    rows = torch.arange(b)
    worst = 0.0
    for _ in range(n_new):
        emb = (rng.standard_normal((b, 1, 64)) * 0.1).astype(np.float32)
        cache_mask[rows, seq.long()] = 1
        with torch.inference_mode():
            hd = lm.decode_step(torch.from_numpy(emb), caches, seq, cache_mask)
            hp = lm.decode_step_paged(torch.from_numpy(emb), pools, pt_t, seq)
        hj, jpools = jmodel.apply({"params": params}, jnp.asarray(emb), jpools, jnp.asarray(pt),
                                  jnp.asarray(seq.numpy()), method=JLM.decode_step_paged)
        np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
        worst = max(worst, float((hp - hd).abs().max() / hd.abs().max()))
        seq = seq + 1
    assert 0.0 < worst < 0.05, worst
