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


def _mha_cases():
    """(hk, bias kind, scale, (b, tq, tk, hq, d)): GQA groups 1 and 4 at
    T 9, with and without a per-q-head bias, default scale and 0.2 (ids as
    before: scale-with_bias-hk); then K1's bf16 kernel tiles at head dim
    64: the dense decode step (Tq 1 against the cache, GQA 4, the [B, 1, 1,
    Tk] float32 cache bias) and T 50 and 65 (around a 64-row tile)."""
    cases = [pytest.param(hk, "per_head" if with_bias else None, scale, (2, 9, 9, 4, 16),
                          id=f"{scale}-{with_bias}-{hk}")
             for scale in (None, 0.2) for with_bias in (False, True) for hk in (4, 1)]
    return cases + [
        pytest.param(1, "cache", 1 / 8, (2, 1, 21, 4, 64), id="decode-tq1-tk21-gqa4-cache_bias"),
        pytest.param(2, None, None, (2, 50, 50, 2, 64), id="d64-t50"),
        pytest.param(2, None, None, (2, 65, 65, 2, 64), id="d64-t65"),
    ]


@pytest.mark.parametrize("hk,bias_kind,scale,shape", _mha_cases())
def test_multi_head_attention_matches_jax(hk, bias_kind, scale, shape):
    b, tq, tk, hq, d = shape
    q, k, v = _rand((b, tq, hq, d), 0), _rand((b, tk, hk, d), 1), _rand((b, tk, hk, d), 2)
    bias = None
    if bias_kind == "per_head":  # per-q-head bias plus a key-padding/causal mask
        bias = _rand((b, hq, tq, tk), 3) + np.asarray(jattn.make_attention_bias(
            jnp.asarray(_right_padded_mask([tk, tk - 3], tk)), causal=True, q_len=tq, k_len=tk))
    elif bias_kind == "cache":  # 0 on written slots, the finite -1e30 elsewhere
        bias = np.zeros((b, 1, 1, tk), np.float32)
        bias[:, :, :, -4:] = -1e30
        bias[1, :, :, 2:7] = -1e30
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


# -- K1 backward ------------------------------------------------------------
# The plain backward (what CPU autograd runs, and what chip_smoke.py holds
# the CUDA dQ and dK/dV kernels to) against jax.grad.  Tolerance 2e-5 abs
# on unit-scale inputs and cotangents (float32; sums in different orders).
GRAD_ATOL = 2e-5


def _torch_grads(q, k, v, do, bias=None, **kw):
    """(dq, dk, dv, dbias) of sum(flash_attention(...) * do) through CPU autograd."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = tflash.flash_attention(tq, tk, tv, tb, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    return [None if t is None else t.grad.numpy() for t in (tq, tk, tv, tb)]


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_backward_matches_pallas_interpret(with_bias):
    """dQ, dK, dV (and dbias from dS) == jax.grad through the Pallas K1
    kernels (_dq_kernel, _dkv_kernel) in interpret mode: T = 128, hq == hk,
    a causal + key-padding bias."""
    b, t, h, d = 2, 128, 2, 64
    q, k, v, do = (_rand((b, t, h, d), s) for s in (10, 11, 12, 13))
    bias = None
    if with_bias:
        bias = np.asarray(jattn.make_attention_bias(
            jnp.asarray(_right_padded_mask([128, 111], t)), causal=True, q_len=t, k_len=t))

    def loss(q, k, v, bias):
        return jnp.sum(jflash.flash_attention(q, k, v, bias) * do)

    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=argnums)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              None if bias is None else jnp.asarray(bias))
    got = _torch_grads(q, k, v, do, bias)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_ATOL, rtol=0)
    assert (got[3] is None) == (not with_bias)


@pytest.mark.parametrize("t,hq,hk,lens,window,scale", [
    (37, 4, 1, [37, 30], None, 1 / 16),  # GQA group 4, ragged T, causal + kv_lens
    (37, 4, 1, [37, 30], 9, 1 / 16),     # sliding window
    (29, 4, 2, [29, 25], 5, None),        # group 2, default scale
])
def test_flash_backward_matches_dense_jax_grad(t, hq, hk, lens, window, scale):
    """GQA without repeated K/V, windows and ragged T through the mask
    descriptors == jax.grad of the dense multi_head_attention with the
    equivalent make_attention_bias bias (every row has a key to attend)."""
    d = 32
    q, k, v = _rand((2, t, hq, d), 20), _rand((2, t, hk, d), 21), _rand((2, t, hk, d), 22)
    do = _rand((2, t, hq, d), 23)
    bias = jattn.make_attention_bias(jnp.asarray(_right_padded_mask(lens, t)), causal=True,
                                     q_len=t, k_len=t, window=window)

    def loss(q, k, v):
        out = jattn.multi_head_attention(q, k, v, bias=bias, use_flash=False, scale=scale)
        return jnp.sum(out * do)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _torch_grads(q, k, v, do, scale=scale, kv_lens=torch.tensor(lens, dtype=torch.int32),
                       causal=True, window=window)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=GRAD_ATOL, rtol=0)


def test_flash_backward_reference_is_the_autograd_backward():
    """The plain backward from the saved (o, lse) == autograd through the
    plain forward itself, including dbias unbroadcast to [B, 1, Tq, Tk] and
    an empty row (lse = +inf, no gradient)."""
    b, t, hq, hk, d = 2, 11, 4, 2, 16
    q, k, v = (torch.tensor(_rand(s, i), requires_grad=True)
               for i, s in enumerate([(b, t, hq, d), (b, t, hk, d), (b, t, hk, d)]))
    bias = torch.tensor(_rand((b, 1, t, t), 7), requires_grad=True)
    do = torch.from_numpy(_rand((b, t, hq, d), 8))
    kw = dict(scale=0.3, kv_lens=torch.tensor([11, 4], dtype=torch.int32), causal=True,
              window=3)  # row 1's queries 6.. see no key
    out = tflash.flash_attention_reference(q, k, v, bias, **kw)
    (out * do).sum().backward()
    with torch.no_grad():
        o, lse = tflash.flash_attention_reference(q, k, v, bias, return_lse=True, **kw)
        grads = tflash.flash_attention_backward_reference(q, k, v, o, lse, do, bias, **kw)
    assert torch.isinf(lse[1, :, 6:]).all() and (o[1, 6:] == 0).all()
    for got, t_ in zip(grads, (q, k, v, bias)):
        np.testing.assert_allclose(got.numpy(), t_.grad.numpy(), atol=GRAD_ATOL, rtol=0)


def test_flash_attention_autograd_only_when_needed():
    """No gradient wanted: the plain forward alone; a CUDA-less device
    other than the CPU is refused before any work."""
    q = torch.from_numpy(_rand((1, 5, 2, 16), 0))
    out = tflash.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    assert tflash.flash_attention(qg, q, q, causal=True).grad_fn is not None
    with torch.no_grad():
        assert tflash.flash_attention(qg, q, q, causal=True).grad_fn is None
