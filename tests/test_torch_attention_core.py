"""PyTorch port: K2, the token-major attention core (plain versions, CPU).

The port's ``attention_core_padded`` and ``attention_core`` (their plain
forward and backward, which CPU tensors run) against the JAX functions of
the same names in interpret mode, on the same numpy inputs in float32: outputs within 1e-5, gradients
(of a random cotangent) within 1e-4.  The kernels themselves are held to
these plain versions on the card by ``chip_smoke.py``.  Also in bf16 at
the text tower's shape (4e-3 of the JAX value's max), and past the float32
kernels' 640 rows, where only the bf16 backward runs on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(b, t, heads, d, seed, mask_kind):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, t, 3 * heads * d)).astype(np.float32)
    cot = rng.standard_normal((b, t, heads * d)).astype(np.float32)
    if mask_kind is None:
        return qkv, cot, None
    mask = np.zeros((b, t), np.int32)
    if mask_kind == "right_padded":
        for i, n in enumerate(rng.integers(1, t + 1, size=b)):
            mask[i, :n] = 1
    elif mask_kind == "caption":  # right-padded to a caption's ~13 tokens
        for i, n in enumerate(rng.integers(8, 17, size=b)):
            mask[i, :n] = 1
    else:  # holes anywhere; key 0 kept so every causal row has a valid key
        mask = (rng.random((b, t)) < 0.6).astype(np.int32)
        mask[:, 0] = 1
    return qkv, cot, mask


def _jax(qkv, cot, mask, heads, causal):
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core_padded

    kv = None if mask is None else jnp.asarray(mask)

    def f(x):
        return attention_core_padded(x, heads, causal=causal, kv_mask=kv, interpret=True,
                                     block_diag=False)

    out, vjp = jax.vjp(f, jnp.asarray(qkv))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _port(qkv, cot, mask, heads, causal):
    from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded

    x = torch.from_numpy(qkv).requires_grad_(True)
    kv = None if mask is None else torch.from_numpy(mask)
    out = attention_core_padded(x, heads, causal=causal, kv_mask=kv)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("b,t,heads,d,causal,mask_kind", [
    (4, 21, 4, 16, True, "right_padded"),
    (3, 17, 4, 16, False, None),
    (3, 19, 2, 16, True, "holes"),
    (2, 23, 4, 16, False, "holes"),
    (2, 50, 2, 64, False, None),  # the CLIP vision tower's T and head dim
    (2, 77, 2, 64, True, "caption"),  # the text tower's
])
def test_plain_k2_matches_jax(b, t, heads, d, causal, mask_kind):
    qkv, cot, mask = _inputs(b, t, heads, d, seed=t, mask_kind=mask_kind)
    want_out, want_grad = _jax(qkv, cot, mask, heads, causal)
    got_out, got_grad = _port(qkv, cot, mask, heads, causal)
    np.testing.assert_allclose(got_out, want_out, atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(got_grad, want_grad, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("t,t_real,causal,mask_kind", [
    (32, 21, False, None),
    (32, 27, True, "holes"),
    (48, 40, True, "right_padded"),
])
def test_plain_k2_t_real_below_t_matches_jax(t, t_real, causal, mask_kind):
    """``attention_core`` with keys at or past ``t_real`` masked, against the
    JAX ``attention_core`` (T a multiple of 16, as that wrapper takes it)."""
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core as jax_core

    from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core

    heads = 2
    qkv, cot, mask = _inputs(3, t, heads, 16, seed=t_real, mask_kind=mask_kind)
    kv = None if mask is None else jnp.asarray(mask)
    want_out, vjp = jax.vjp(lambda x: jax_core(x, heads, t_real, causal=causal, kv_mask=kv,
                                                interpret=True, block_diag=False),
                            jnp.asarray(qkv))
    want_grad = vjp(jnp.asarray(cot))[0]
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = attention_core(x, heads, t_real, causal=causal,
                         kv_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=GRAD_TOL, rtol=0)


def test_short_kv_mask_is_zero_padded():
    """A kv_mask shorter than T masks the keys past its end, as the JAX
    wrapper's zero pad does."""
    qkv, cot, mask = _inputs(2, 18, 2, 16, seed=5, mask_kind="right_padded")
    short = mask[:, :11]
    want = _jax(qkv, cot, short, 2, False)
    got = _port(qkv, cot, short, 2, False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0)


def test_rows_without_a_valid_key_differ_from_jax_by_design():
    """Sample 1 masks every key.  JAX averages V uniformly over all T_pad
    keys (the -1e30 scores all tie); the port returns zeros and no gradient
    for those rows.  Rows with a valid key agree."""
    b, t, heads, d = 2, 13, 2, 16
    qkv, cot, _ = _inputs(b, t, heads, d, seed=7, mask_kind=None)
    mask = np.ones((b, t), np.int32)
    mask[1] = 0
    want_out, want_grad = _jax(qkv, cot, mask, heads, False)
    got_out, got_grad = _port(qkv, cot, mask, heads, False)
    np.testing.assert_allclose(got_out[0], want_out[0], atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(got_grad[0], want_grad[0], atol=GRAD_TOL, rtol=0)
    assert not got_out[1].any() and not got_grad[1].any()
    v = qkv[1, :, 2 * heads * d:]  # the JAX row: every key (T padded to 16) weighs 1/16
    np.testing.assert_allclose(want_out[1], np.broadcast_to(v.sum(0) / 16, (t, heads * d)),
                               atol=OUT_TOL, rtol=0)


def test_lse_of_the_plain_forward():
    """return_lse gives logsumexp of the valid scaled scores, +inf on a row
    with no valid key (what the kernels' backward reads as p = 0)."""
    from multimodal_concept_learning_tpu_torch.ops.attention_core import (
        attention_core_reference,
    )

    qkv, _, _ = _inputs(2, 9, 2, 16, seed=3, mask_kind=None)
    mask = np.ones((2, 9), np.int32)
    mask[1] = 0
    _, lse = attention_core_reference(torch.from_numpy(qkv), 2, 9, causal=True,
                                      kv_mask=torch.from_numpy(mask), return_lse=True)
    q = qkv[0, :, :16]
    k = qkv[0, :, 32:48]
    s = q @ k.T / 4.0
    s[np.triu_indices(9, 1)] = -np.inf
    want = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    np.testing.assert_allclose(lse[0, 0].numpy(), want, atol=1e-5, rtol=0)
    assert torch.isinf(lse[1]).all() and (lse[1] > 0).all()


BD_CASES = [(8, 50, 12, 16, False, False), (4, 77, 8, 16, True, True),
            (6, 21, 4, 32, True, True)]  # those of tests/test_fused_attention.py


def _bd_mask(rng, b, t):
    """Right-padded masks of 5..t-1 keys (every causal row keeps key 0)."""
    m = np.ones((b, t), np.int32)
    for i in range(b):
        m[i, rng.integers(5, t):] = 0
    return m


@pytest.mark.parametrize("b,t,heads,d,causal,use_mask", BD_CASES)
def test_plain_k2bd_matches_jax_block_diag(b, t, heads, d, causal, use_mask):
    """The port's block-diagonal plain versions (``block_diag=True``)
    against the JAX ``attention_core_padded(block_diag=True)`` in interpret
    mode: output 1e-5, gradients 5e-4 abs / 1e-3 rel."""
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core_padded as jf

    from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded

    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((b, t, 3 * heads * d)).astype(np.float32)
    cot = rng.standard_normal((b, t, heads * d)).astype(np.float32)
    mask = _bd_mask(rng, b, t) if use_mask else None
    kv = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda x: jf(x, heads, causal, kv, interpret=True, block_diag=True),
                        jnp.asarray(qkv))
    want_grad = vjp(jnp.asarray(cot))[0]
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = attention_core_padded(x, heads, causal=causal, block_diag=True,
                                kv_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("env,block_diag,want_bd", [
    ("1", None, True), ("0", None, False), (None, None, False), ("1", False, False),
    ("0", True, True),
])
def test_block_diag_reads_the_environment_at_each_call(monkeypatch, env, block_diag, want_bd):
    """``block_diag=None`` takes K2-bd exactly when ``MCL_ATTN_CORE_BD=1``
    at the time of the call (forward and backward); an explicit value wins."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac

    taken = []
    for name in ("attention_core_reference", "attention_core_backward_reference",
                 "attention_core_bd_reference", "attention_core_bd_backward_reference"):
        real = getattr(ac, name)
        monkeypatch.setattr(ac, name, lambda *a, _r=real, _n=name, **k: (taken.append(_n),
                                                                         _r(*a, **k))[1])
    if env is None:
        monkeypatch.delenv("MCL_ATTN_CORE_BD", raising=False)
    else:
        monkeypatch.setenv("MCL_ATTN_CORE_BD", env)
    qkv, cot, _ = _inputs(2, 9, 2, 16, seed=1, mask_kind=None)
    x = torch.from_numpy(qkv).requires_grad_(True)
    ac.attention_core(x, 2, 9, causal=True, block_diag=block_diag).backward(
        torch.from_numpy(cot))
    with torch.no_grad():
        ac.attention_core(x, 2, 9, block_diag=block_diag)
    bd = "attention_core_bd_reference"
    want = ([bd, "attention_core_bd_backward_reference", bd] if want_bd else
            ["attention_core_reference", "attention_core_backward_reference",
             "attention_core_reference"])
    assert taken == want


@pytest.mark.parametrize("causal,mask_kind", [(True, "holes"), (False, "right_padded")])
def test_k2bd_plain_versions_do_not_depend_on_the_merge(causal, mask_kind):
    """Merging 1, 2, 3 or 5 samples (5 does not divide B) gives K2's output,
    lse and gradient: cross-sample keys are masked and a row with no valid
    key is zero in the port whatever the block (float32, 1e-6)."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac

    qkv, cot, mask = _inputs(7, 19, 2, 16, seed=4, mask_kind=mask_kind)
    mask[3] = 0  # a sample with no valid key
    args = (torch.from_numpy(qkv), 2, 17, causal, torch.from_numpy(mask))
    want, want_lse = ac.attention_core_reference(*args, return_lse=True)
    want_d = ac.attention_core_backward_reference(args[0], torch.from_numpy(cot), *args[1:])
    assert not want[3].any() and torch.isinf(want_lse[3]).all()
    for bblk in (1, 2, 3, 5):
        out, lse = ac.attention_core_bd_reference(*args, bblk=bblk, return_lse=True)
        dqkv = ac.attention_core_bd_backward_reference(args[0], torch.from_numpy(cot), *args[1:],
                                                       bblk=bblk)
        torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=0)
        torch.testing.assert_close(dqkv, want_d, atol=1e-6, rtol=0)


def test_k2bd_rows_without_a_valid_key_differ_from_jax_by_design(monkeypatch):
    """Sample 1 masks every key.  The JAX block-diagonal kernels (block of 2
    samples pinned with ``MCL_ATTN_CORE_BBLK=2``) give its rows a uniform
    average of V over every key of the merged block, the other sample's and
    the padding's included (R = 2 x 16 keys), and send those rows'
    cotangent into sample 0's k and v; the port gives zeros and no gradient.
    Sample 0's output and dq agree (1e-5, 1e-4), and all of its gradient
    once the empty rows' cotangent is zero."""
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core_padded as jf

    from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded

    monkeypatch.setenv("MCL_ATTN_CORE_BBLK", "2")
    b, t, heads, d = 2, 13, 2, 16
    qkv, cot, _ = _inputs(b, t, heads, d, seed=9, mask_kind=None)
    mask = np.ones((b, t), np.int32)
    mask[1] = 0
    want, vjp = jax.vjp(lambda x: jf(x, heads, False, jnp.asarray(mask), interpret=True,
                                      block_diag=True), jnp.asarray(qkv))
    want = np.asarray(want)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = attention_core_padded(x, heads, kv_mask=torch.from_numpy(mask), block_diag=True)
    got = out.detach().numpy()
    np.testing.assert_allclose(got[0], want[0], atol=OUT_TOL, rtol=0)
    assert not got[1].any()
    quiet = cot.copy()
    quiet[1] = 0
    for c, cols in ((cot, slice(0, heads * d)), (quiet, slice(None))):
        want_grad = np.asarray(vjp(jnp.asarray(c))[0])
        x.grad = None
        out.backward(torch.from_numpy(c), retain_graph=True)
        got_grad = x.grad.numpy()
        np.testing.assert_allclose(got_grad[0, :, cols], want_grad[0, :, cols], atol=GRAD_TOL,
                                   rtol=0)
        assert not got_grad[1].any()
    assert np.abs(want_grad[1]).max() == 0 and np.abs(np.asarray(
        vjp(jnp.asarray(cot))[0])[0, :, heads * d:] - got_grad[0, :, heads * d:]).max() > 1e-3
    v = qkv[:, :, 2 * heads * d:]  # both samples' real keys; the 2 x 3 pad rows are zero
    np.testing.assert_allclose(want[1], np.broadcast_to(v.sum((0, 1)) / 32, (t, heads * d)),
                               atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("head_dim,rows,max_rows,ok", [
    (16, None, 640, True),    # vit-t-8
    (64, 640, 640, True),     # every ViT-B/L and CLIP text tower; the float32 backward's cap
    (32, 320, 320, True),     # K6's forward at its cap
    (128, None, 640, False),  # not built: K6 and the float32 backward's dQ tile would not fit
    (48, 17, 640, False),
    (16, 641, 640, False),    # one row past the float32 backward's cap
    (64, 321, 320, False),    # one row past K6's forward cap
    (64, 641, "bfloat16", True),      # the bf16 backward keeps no [rows, D] tile: no cap
    (16, 100_000, "bfloat16", True),
    (64, 0, "bfloat16", False),       # but at least one row
    (64, 641, "float32", False),      # the float32 backward keeps its 640
    (64, 640, "float32", True),
])
def test_kernel_shape_check(head_dim, rows, max_rows, ok):
    """The one check of the shapes K2, K2-bd and K6 are built for (the CUDA
    wrappers call it before every launch): head dims 16, 32 and 64, rows
    within the caps (a dtype name: the backward's cap in that dtype,
    ``backward_max_rows``); anything else a ValueError naming the supported
    set."""
    from multimodal_concept_learning_tpu_torch.ops.attention_core import (
        HEAD_DIMS,
        backward_max_rows,
        check_kernel_shape,
    )

    assert HEAD_DIMS == (16, 32, 64)
    if isinstance(max_rows, str):
        max_rows = backward_max_rows(getattr(torch, max_rows))
    if ok:
        check_kernel_shape("K", head_dim, rows, max_rows)
        return
    with pytest.raises(ValueError, match=r"head dim in \(16, 32, 64\)|rows <= "):
        check_kernel_shape("K", head_dim, rows, max_rows)


@pytest.mark.parametrize("dtype,given,ok", [
    ("bfloat16", False, True),   # the tensor-core pair recomputes lse from qkv and dA
    ("bfloat16", True, False),   # so it refuses the forward's out and lse
    ("float32", True, True),     # the CUDA-core kernel reads both
    ("float32", False, False),
])
def test_backward_forward_residuals(dtype, given, ok):
    """What the K2 and K2-bd backward wrappers pass on of the forward's
    outputs: out and lse in float32, neither in bfloat16; anything else a
    ValueError before a launch."""
    from multimodal_concept_learning_tpu_torch.ops.attention_core import _forward_residuals

    qkv = torch.zeros(2, 5, 3 * 16, dtype=getattr(torch, dtype))
    out = torch.zeros(2, 5, 16, dtype=qkv.dtype) if given else None
    lse = torch.zeros(2, 1, 5) if given else None
    if not ok:
        with pytest.raises(ValueError, match="out"):
            _forward_residuals("K", qkv, out, lse)
        return
    want = (out.data_ptr(), lse.data_ptr()) if given else (None, None)
    assert _forward_residuals("K", qkv, out, lse) == want


BF16_TOL = 4e-3  # bf16: one bf16 ulp (2**-8) of the JAX value's max |value|


@pytest.mark.parametrize("block_diag", [False, True])
def test_plain_backward_bf16_matches_jax_captions(block_diag):
    """bf16 (the CLIP path's compute dtype): the port's plain K2 and K2-bd
    backward (``attention_core_backward_reference``,
    ``attention_core_bd_backward_reference``, which the card's tensor-core
    backward is held to) against the JAX ``_bwd_kernel`` / ``_bwd_kernel_bd``
    in interpret mode, on the text tower's shape: T 77, causal, captions of
    8-16 tokens, head dim 64.  Outputs and gradients within 4e-3 of the JAX
    value's max |value| (one bf16 ulp there): the two frameworks round
    dS·D**-0.5 and P to bf16 at the same points (on this CPU they agree
    exactly), from float32 sums that may be taken in different orders."""
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core_padded as jf

    from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded

    heads = 2
    qkv, cot, mask = _inputs(3, 77, heads, 64, seed=77, mask_kind="caption")
    want, vjp = jax.vjp(lambda x: jf(x, heads, True, jnp.asarray(mask), interpret=True,
                                      block_diag=block_diag),
                        jnp.asarray(qkv).astype(jnp.bfloat16))
    want_grad = np.asarray(vjp(jnp.asarray(cot).astype(jnp.bfloat16))[0].astype(jnp.float32))
    want = np.asarray(want.astype(jnp.float32))
    x = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_(True)
    out = attention_core_padded(x, heads, causal=True, kv_mask=torch.from_numpy(mask),
                                block_diag=block_diag)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert out.dtype == x.grad.dtype == torch.bfloat16
    got, got_grad = out.detach().float().numpy(), x.grad.float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got_grad, want_grad, atol=BF16_TOL * np.abs(want_grad).max(),
                               rtol=0)


@pytest.mark.parametrize("block_diag", [False, True])
def test_plain_backward_past_640_rows_matches_jax(monkeypatch, block_diag):
    """Past the float32 kernels' 640 rows, where the bf16 backward now runs:
    K2 at T 650 (one sample's rows) and K2-bd at 9 samples of T 80 merged
    into 720 rows (``MCL_ATTN_CORE_BBLK=9`` on the JAX side, ``bblk=9`` on
    the port's), causal with holes, against the JAX kernels in interpret
    mode in float32: outputs 1e-5, gradients 1e-4."""
    from multimodal_concept_learning_tpu.ops.attention_core import attention_core_padded as jf

    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac

    heads, d = 2, 16
    b, t = (1, 650) if block_diag is False else (9, 80)
    qkv, cot, mask = _inputs(b, t, heads, d, seed=t, mask_kind="holes")
    if block_diag:
        monkeypatch.setenv("MCL_ATTN_CORE_BBLK", "9")
    want, vjp = jax.vjp(lambda x: jf(x, heads, True, jnp.asarray(mask), interpret=True,
                                      block_diag=block_diag), jnp.asarray(qkv))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    x, kv, dout = torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(cot)
    if block_diag:
        got = ac.attention_core_bd_reference(x, heads, t, True, kv, bblk=9)
        got_grad = ac.attention_core_bd_backward_reference(x, dout, heads, t, True, kv, bblk=9)
    else:
        got = ac.attention_core_reference(x, heads, t, True, kv)
        got_grad = ac.attention_core_backward_reference(x, dout, heads, t, True, kv)
    rows = 9 * t if block_diag else t
    assert rows > ac.MAX_T_BWD and ac.backward_max_rows(torch.bfloat16) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, atol=GRAD_TOL, rtol=0)
