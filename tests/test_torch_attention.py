"""PyTorch port: attention ops vs the JAX package (CPU, plain versions).

Inputs are seeded numpy arrays handed to both sides.  Tolerances: single
ops in float32, <= 1e-5 abs on unit-scale inputs (XLA-CPU and ATen sum in
different orders; nothing else differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_concept_learning_tpu.ops import attention as jattn
from multimodal_concept_learning_tpu.ops import flash_attention as jflash
from multimodal_concept_learning_tpu_torch.ops import attention as tattn
from multimodal_concept_learning_tpu_torch.ops import flash_attention as tflash

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _right_padded_mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)


@pytest.mark.parametrize("hk", [4, 1])  # GQA groups 1 and 4
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("scale", [None, 0.2])
def test_multi_head_attention_matches_jax(hk, with_bias, scale):
    b, t, hq, d = 2, 9, 4, 16
    q, k, v = _rand((b, t, hq, d), 0), _rand((b, t, hk, d), 1), _rand((b, t, hk, d), 2)
    bias = None
    if with_bias:  # per-q-head bias plus a key-padding/causal mask
        bias = _rand((b, hq, t, t), 3) + np.asarray(jattn.make_attention_bias(
            jnp.asarray(_right_padded_mask([9, 6], t)), causal=True, q_len=t, k_len=t))
    ref = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     bias=None if bias is None else jnp.asarray(bias),
                                     use_flash=False, scale=scale)
    out = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     None if bias is None else torch.from_numpy(bias),
                                     scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window,with_mask,q_len", [
    (True, None, True, 7), (False, 3, False, 7), (True, 3, True, 7), (True, 2, True, 4),
])
def test_make_attention_bias_matches_jax(causal, window, with_mask, q_len):
    k_len = 7
    mask = _right_padded_mask([7, 4], k_len) if with_mask else None
    ref = jattn.make_attention_bias(None if mask is None else jnp.asarray(mask), causal,
                                    q_len, k_len, window=window)
    out = tattn.make_attention_bias(None if mask is None else torch.from_numpy(mask), causal,
                                    q_len, k_len, window=window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t,hq,hk,window", [(197, 12, 12, None), (261, 4, 1, None),
                                            (261, 4, 1, 200)])
def test_descriptor_masks_match_jax_bias(t, hq, hk, window):
    """The kernel's mask descriptors (kv_lens, causal, window) == the JAX
    dense path with the equivalent make_attention_bias bias, at the serving
    path's lengths (197 ViT tokens; 261 prompt tokens, head_dim 256)."""
    d = 64 if hq == 12 else 256
    lens = [t, t - 60]
    q, k, v = _rand((2, t, hq, d), 0), _rand((2, t, hk, d), 1), _rand((2, t, hk, d), 2)
    causal = hq != 12  # the ViT shape attends without any mask
    mask = _right_padded_mask(lens, t)
    scale = 1 / 16 if d == 256 else None
    bias = jattn.make_attention_bias(jnp.asarray(mask), causal=causal, q_len=t, k_len=t,
                                     window=window)
    ref = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                bias=bias, use_flash=False, scale=scale))
    before = tflash.flash_attention.launches
    out = tattn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale,
        kv_lens=torch.tensor(lens, dtype=torch.int32), causal=causal, window=window).numpy()
    assert tflash.flash_attention.launches == before  # CPU tensors: the plain version
    # rows with no attendable key (only padded queries far past a short row
    # under the window) are zero in the port and unread by any real row
    ok = tflash.key_mask(2, t, t, kv_lens=torch.tensor(lens), causal=causal, window=window)
    rows = ok.expand(2, 1, t, t).any(dim=-1)[:, 0].numpy()  # [B, Tq]
    np.testing.assert_allclose(out[rows], ref[rows], atol=ATOL, rtol=0)
    assert (out[~rows] == 0).all()


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_reference_matches_pallas_interpret(with_bias):
    """The K1 plain version == the JAX Pallas flash kernel in interpret mode (T=128)."""
    b, t, h, d = 2, 128, 2, 64
    q, k, v = _rand((b, t, h, d), 4), _rand((b, t, h, d), 5), _rand((b, t, h, d), 6)
    bias = None
    if with_bias:
        bias = np.array(jattn.make_attention_bias(
            jnp.asarray(_right_padded_mask([128, 111], t)), causal=True, q_len=t, k_len=t))
    with pltpu.force_tpu_interpret_mode():
        ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     None if bias is None else jnp.asarray(bias))
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_attention_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tflash.flash_attention(q, q, q)
